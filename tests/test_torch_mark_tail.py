"""The merge's tail after its text phase, ``kernels.mark_tail_plain`` (the
plain version of ``cuda_kernels.mark_tail``), against the JAX package.

Inputs are random states and op rows made with numpy from a seed.  The JAX
side is ``merge_step_pallas_full`` in interpret mode (its text kernel, the
vmapped ``_permute_boundaries``, ``mark_phase_pallas`` and
``_update_mark_table``), as ``tests/test_torch_kernels.py`` runs it; the
port's side is ``mark_tail_plain`` on that text kernel's outputs.  Every
``DocState`` field must agree byte for byte (tolerance 0).  At C = 32768,
the width where the card runs the mark kernel as a cluster, one replica
goes through the XLA merge (``merge_step_batch``): the Pallas functions
take replicas in blocks of 8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops import pallas_kernels as JP
from peritext_tpu.ops.state import DocState as JaxState
from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import FIELDS, map_state, state_from_numpy, state_to_numpy

R, C, WORDS, TEXT_ROWS, MARK_ROWS, ACTORS = 8, 128, 2, 16, 12, 6
CASES = ("marked_spans", "past_capacity", "table_overflow", "no_mark_rows")


def _state(rng, r, c, words, fill, mark_count):
    """Live prefixes of ``fill`` elements with unique ids, tombstones,
    definedness on a third of the slots, random mask words (dead slots
    included) and a mark table filled to ``mark_count``."""
    m = 32 * words
    length = np.full(r, fill, np.int32)
    ec = np.zeros((r, c), np.int32)
    ea = np.zeros((r, c), np.int32)
    for i in range(r):
        ec[i, :fill] = rng.permutation(np.arange(1, 4 * c))[:fill]
        ea[i, :fill] = rng.integers(0, ACTORS, fill)
    live = np.arange(c)[None, :] < fill
    table = {name: rng.integers(0, 9, (r, m)).astype(np.int32)
             for name in ("mark_ctr", "mark_act", "mark_action", "mark_type", "mark_attr")}
    return {
        "elem_ctr": ec, "elem_act": ea,
        "deleted": (rng.random((r, c)) < 0.2) & live,
        "chars": np.where(live, rng.integers(32, 127, (r, c)), 0).astype(np.int32),
        "bnd_def": rng.random((r, 2 * c)) < 0.35,
        "bnd_mask": rng.integers(0, 1 << 32, (r, 2 * c, words), dtype=np.uint32),
        **table,
        "length": length,
        "mark_count": np.full(r, mark_count, np.int32),
    }


def _ref(rng, st, i, inserted, absent=True):
    """An id of a live element, one this batch inserted, HEAD, or with
    ``absent`` an id nobody holds (not for an insert: the Pallas text
    kernel drops such an insert where XLA and the port place it after
    element 0, a difference the port's tests pin)."""
    u = rng.random()
    if u < 0.1:
        return 0, 0
    if u < 0.15 and absent:
        return 999_999, 1
    if u < 0.35 and inserted:
        return inserted[rng.integers(len(inserted))]
    j = rng.integers(st["length"][i])
    return st["elem_ctr"][i, j], st["elem_act"][i, j]


def _ops(rng, st, text_rows, mark_rows, marks=True, run_len=(1, 9)):
    """Inserts, runs and deletes at live references (so inside and at the
    edges of marked spans), then mark rows anchored on old and new ids."""
    r = st["length"].shape[0]
    text = np.zeros((r, text_rows, K.OP_FIELDS), np.int32)
    mark = np.zeros((r, mark_rows, K.OP_FIELDS), np.int32)
    char_buf = rng.integers(32, 127, (r, 256)).astype(np.int32)
    for i in range(r):
        inserted = []
        for l in range(text_rows):
            kind = rng.choice([K.KIND_INSERT, K.KIND_INSERT, K.KIND_INSERT_RUN, K.KIND_DELETE, K.KIND_PAD])
            row = text[i, l]
            row[K.K_KIND] = kind
            row[K.K_CTR] = 10_000 + 100 * l
            row[K.K_ACT] = i % ACTORS
            row[K.K_REF_CTR], row[K.K_REF_ACT] = _ref(rng, st, i, inserted, absent=kind == K.KIND_DELETE)
            if kind == K.KIND_INSERT_RUN:
                row[K.K_RUN_LEN] = rng.integers(*run_len)
                row[K.K_PAYLOAD] = rng.integers(0, 256 - K.MAX_RUN_LEN + 1)  # a window in the buffer
                inserted += [(row[K.K_CTR] + k, row[K.K_ACT]) for k in range(row[K.K_RUN_LEN])]
            elif kind == K.KIND_INSERT:
                row[K.K_PAYLOAD] = rng.integers(32, 127)
                inserted.append((row[K.K_CTR], row[K.K_ACT]))
        for l in range(mark_rows):
            row = mark[i, l]
            row[K.K_KIND] = K.KIND_MARK if marks and rng.random() < 0.85 else K.KIND_PAD
            row[K.K_CTR] = 20_000 + l
            row[K.K_ACT] = rng.integers(0, ACTORS)
            row[K.K_MACTION] = rng.integers(0, 2)
            row[K.K_MTYPE] = rng.integers(0, 4)
            row[K.K_MATTR] = rng.integers(-1, 5)
            row[K.K_SKIND] = rng.integers(0, 2)
            row[K.K_SCTR], row[K.K_SACT] = _ref(rng, st, i, inserted)
            row[K.K_EKIND] = rng.integers(0, 3)
            row[K.K_ECTR], row[K.K_EACT] = _ref(rng, st, i, inserted)
    return text, mark, char_buf


def _case(name, seed):
    rng = np.random.default_rng(seed)
    fill = C - 6 if name == "past_capacity" else C // 2
    count = 32 * WORDS - 4 if name == "table_overflow" else 5
    st = _state(rng, R, C, WORDS, fill, count)
    text, mark, char_buf = _ops(rng, st, TEXT_ROWS, MARK_ROWS, marks=name != "no_mark_rows")
    ranks = rng.permutation(ACTORS).astype(np.int32)
    return st, text, mark, ranks, char_buf


def _port(np_state):
    return state_from_numpy({f: np_state[f] for f in FIELDS}, device="cpu")


def _jax(np_state):
    return JaxState(**{f: jnp.asarray(np_state[f]) for f in FIELDS})


@jax.jit
def _pallas(st, text, mark, ranks, char_buf):
    """The Pallas text phase's outputs, and ``merge_step_pallas_full`` (the
    same text phase, then the tail), in interpret mode; compiled once for
    the file's shape."""
    text_out = JP.text_phase_pallas(st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, text, ranks,
                                     char_buf=char_buf, interpret=True)
    return text_out, JP.merge_step_pallas_full(st, text, mark, ranks, char_buf=char_buf, interpret=True)


def _with_tail(st, text_out, mark):
    """The port's tail on a text phase's outputs ``(elem_ctr, elem_act,
    deleted, chars, orig_idx, length)``, with the element fields set from
    them: ``merge_step_full``'s result."""
    ec, ea, dl, ch, oi, ln = text_out
    out = K.mark_tail_plain(_port(st), ec, ea, oi, ln, torch.from_numpy(mark))
    return dataclasses.replace(out, elem_ctr=ec, elem_act=ea, deleted=dl, chars=ch, length=ln)


def _new_elements_in_spans(st, oi, length):
    """Whether some element this batch inserted lies inside a marked span
    (the nearest defined boundary left of it carries marks), and whether
    one lies just before one (its right neighbour is old and its
    before-slot is defined with marks), on the permuted planes."""
    pdef, pmask = K._permute_boundaries(torch.from_numpy(st["bnd_def"]),
                                        torch.from_numpy(st["bnd_mask"].view(np.int32)), oi)
    pdef, marked, oi = pdef.numpy(), pmask.numpy().any(axis=-1), oi.numpy()
    inside = before = False
    for i in range(oi.shape[0]):
        for p in np.flatnonzero(oi[i, :int(length[i])] == -1):
            left = np.flatnonzero(pdef[i, :2 * p])
            inside |= bool(left.size) and bool(marked[i, left[-1]])
            nxt = 2 * (p + 1)
            before |= p + 1 < oi.shape[1] and oi[i, p + 1] >= 0 and bool(pdef[i, nxt] and marked[i, nxt])
    return inside, before


def _assert_equal(want, got):
    got = state_to_numpy(got)
    for f in FIELDS:
        ref = np.asarray(getattr(want, f))
        assert got[f].dtype == ref.dtype and got[f].shape == ref.shape, f
        assert (got[f] == ref).all(), f"field {f} diverged"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_mark_tail_plain_matches_pallas_full(name, seed):
    """The tail on the Pallas text phase's outputs equals the Pallas
    composite on every field (past C the Pallas text phase parts from XLA's
    and the port's, so the port's own text phase is not used here)."""
    st, text, mark, ranks, char_buf = _case(name, seed)
    text_out, want = _pallas(_jax(st), *(jnp.asarray(a) for a in (text, mark, ranks, char_buf)))
    text_out = [torch.from_numpy(np.array(a)) for a in text_out]
    got = _with_tail(st, text_out, mark)
    _assert_equal(want, got)
    oi = text_out[4]
    # Each case reaches what it is named for.
    is_mark = mark[..., K.K_KIND] == K.KIND_MARK
    if name == "marked_spans":
        inside, before = _new_elements_in_spans(st, oi, got.length)
        assert inside and before
    elif name == "past_capacity":
        assert (got.length > C).any()
    elif name == "table_overflow":
        assert (st["mark_count"] + is_mark.sum(axis=1) > 32 * WORDS).any()
        assert (got.mark_count.numpy() > 32 * WORDS).any()
    else:
        assert not is_mark.any()
        assert (got.mark_count.numpy() == st["mark_count"]).all()


def test_mark_tail_plain_at_the_cluster_width_matches_xla():
    """One replica at C = 32768 (a cluster of two blocks on the card) with
    a handful of rows, against the XLA merge."""
    rng = np.random.default_rng(7)
    c, words = 32768, 4
    st = _state(rng, 1, c, words, 30_000, 100)
    text, mark, _ = _ops(rng, st, 6, 5)
    text[..., K.K_KIND] = np.where(text[..., K.K_KIND] == K.KIND_INSERT_RUN, K.KIND_INSERT,
                                   text[..., K.K_KIND])
    ranks = rng.permutation(ACTORS).astype(np.int32)
    want = JK.merge_step_batch(_jax(st), jnp.asarray(text), jnp.asarray(mark), jnp.asarray(ranks))
    pst = _port(st)
    text_out = K.text_phase_plain(pst.elem_ctr, pst.elem_act, pst.deleted, pst.chars, pst.length,
                                  torch.from_numpy(text), torch.from_numpy(ranks))
    _assert_equal(want, _with_tail(st, text_out, mark))
    assert (text_out[4] == -1).any() and (mark[..., K.K_KIND] == K.KIND_MARK).any()


@pytest.mark.parametrize("name", CASES)
def test_cpu_merge_step_full_equals_merge_step_plain(name):
    """On CPU tensors the composite runs the two plain versions and counts
    no launch."""
    st, text, mark, ranks, char_buf = _case(name, 2)
    args = (torch.from_numpy(text), torch.from_numpy(mark), torch.from_numpy(ranks), torch.from_numpy(char_buf))
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.merge_step_full(_port(st), *args)
    want = K.merge_step_plain(_port(st), *args)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0, "digest": 0}


def _shares_memory(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_mark_tail_wrapper_returns_fresh_outputs_and_refuses_foreign_devices():
    """On CPU tensors the wrapper is the plain version, every output a
    tensor of its own (the stream reuses its cohort buffers); any other
    device, or a mix, raises."""
    st, text, mark, ranks, char_buf = _case("marked_spans", 3)
    pst = _port(st)
    ec, ea, _, _, oi, ln = K.text_phase_plain(
        pst.elem_ctr, pst.elem_act, pst.deleted, pst.chars, pst.length, torch.from_numpy(text),
        torch.from_numpy(ranks), torch.from_numpy(char_buf),
    )
    mark_ops = torch.from_numpy(mark)
    want = K.mark_tail_plain(pst, ec, ea, oi, ln, mark_ops)
    fresh = cuda_kernels.mark_tail(pst, ec, ea, oi, ln, mark_ops)
    for f in FIELDS:
        assert torch.equal(getattr(fresh, f), getattr(want, f)), f
    for f in ("bnd_def", "bnd_mask", "mark_ctr", "mark_act", "mark_action", "mark_type", "mark_attr", "mark_count"):
        assert not _shares_memory(getattr(fresh, f), getattr(pst, f)), f
    # Another device, or a mix of devices, raises: nothing falls back.
    meta = dataclasses.replace(pst, bnd_mask=torch.empty(pst.bnd_mask.shape, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        cuda_kernels.mark_tail(meta, ec, ea, oi, ln, mark_ops)
    on_meta = [t.to("meta") for t in (ec, ea, oi, ln, mark_ops)]
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_kernels.mark_tail(map_state(lambda t: t.to("meta"), pst), *on_meta)


def test_mark_tail_plain_with_an_empty_table():
    """M = 0 (no mask words, no table columns; the JAX merges take no such
    state): with no mark row the tail is the boundary permute alone and
    mark_count stays.  The card's form is held against this."""
    rng = np.random.default_rng(11)
    st = _state(rng, R, C, 0, C // 2, 0)
    text, mark, char_buf = _ops(rng, st, TEXT_ROWS, MARK_ROWS, marks=False)
    ranks = rng.permutation(ACTORS).astype(np.int32)
    pst = _port(st)
    ec, ea, _, _, oi, ln = K.text_phase_plain(
        pst.elem_ctr, pst.elem_act, pst.deleted, pst.chars, pst.length, torch.from_numpy(text),
        torch.from_numpy(ranks), torch.from_numpy(char_buf),
    )
    got = cuda_kernels.mark_tail(pst, ec, ea, oi, ln, torch.from_numpy(mark))
    want_def, _ = K._permute_boundaries(pst.bnd_def, pst.bnd_mask, oi)
    assert torch.equal(got.bnd_def, want_def) and not torch.equal(got.bnd_def, pst.bnd_def)
    assert got.bnd_mask.shape == pst.bnd_mask.shape and got.mark_ctr.shape == (R, 0)
    assert torch.equal(got.mark_count, pst.mark_count)
