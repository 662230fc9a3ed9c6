"""The port's plain merge functions against the JAX package, byte for byte.

Inputs come from the JAX package's benchmark workload (numpy seeds); the
Pallas functions run in interpret mode on the CPU, as tests/test_pallas.py
runs them.  Integer and bit state must agree exactly (tolerance 0), digests
included, and every state field must stay int32/bool after a merge.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops import pallas_kernels as JP
from peritext_tpu.ops.encode import fuse_insert_runs, pad_buffer, pad_rows
from peritext_tpu.schema import allow_multiple_array
from peritext_tpu_torch.bench import bounds
from peritext_tpu_torch.bench.workloads import insert_heavy_text_ops, text_row_mix
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import DocState, state_from_numpy, state_to_numpy

FIELDS = [f.name for f in dataclasses.fields(DocState)]


def _np(x):
    return np.array(jax.device_get(x))


def _port_state(jax_state):
    return state_from_numpy({f: _np(getattr(jax_state, f)) for f in FIELDS}, device="cpu")


def _assert_state_equal(jax_state, port_state):
    got = state_to_numpy(port_state)
    for f in FIELDS:
        ref = _np(getattr(jax_state, f))
        assert got[f].dtype == ref.dtype, f
        assert (got[f] == ref).all(), f"field {f} diverged"


def _assert_int32_state(st):
    for f in FIELDS:
        want = torch.bool if f in ("deleted", "bnd_def") else torch.int32
        assert getattr(st, f).dtype == want, f


def _batch(seed, replicas=8, ops=24, doc_len=100):
    workload = make_merge_workload(
        doc_len=doc_len, ops_per_merge=ops, num_streams=4, with_marks=True, seed=seed
    )
    return build_device_batch(workload, num_replicas=replicas, capacity=256, max_mark_ops=64)


def _fused(batch):
    """Fused insert runs + char buffers, as test_pallas_fused_runs_match_xla
    builds them."""
    fused, bufs = [], []
    for r in range(batch["text_ops"].shape[0]):
        fr, fb, _ = fuse_insert_runs(batch["text_ops"][r])
        fused.append(fr)
        bufs.append(fb)
    text_pad = max(max(f.shape[0] for f in fused), 1)
    buf_pad = 1
    while buf_pad < max(max(b.shape[0] for b in bufs), JK.MAX_RUN_LEN):
        buf_pad *= 2
    text = np.stack([pad_rows(f, text_pad) for f in fused])
    char_buf = np.stack([pad_buffer(b, buf_pad) for b in bufs])
    assert (text[..., JK.K_KIND] == JK.KIND_INSERT_RUN).any()
    return text, char_buf


def test_op_row_layout_matches_jax():
    names = [n for n in dir(JK) if n.startswith(("K_", "KIND_"))] + ["OP_FIELDS", "MAX_RUN_LEN"]
    for n in names:
        assert getattr(K, n) == getattr(JK, n), n


@pytest.mark.parametrize("seed", [0, 1])
def test_text_phase_plain_matches_pallas_and_xla(seed):
    batch = _batch(seed)
    text, char_buf = _fused(batch)
    st = batch["states"]
    ref = JP.text_phase_pallas(
        st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length,
        jnp.asarray(text), jnp.asarray(batch["ranks"]), char_buf=jnp.asarray(char_buf),
        interpret=None,
    )
    pst = _port_state(st)
    out = K.text_phase_plain(
        pst.elem_ctr, pst.elem_act, pst.deleted, pst.chars, pst.length,
        torch.from_numpy(text), torch.from_numpy(batch["ranks"]), torch.from_numpy(char_buf),
    )
    for name, a, b in zip(("elem_ctr", "elem_act", "deleted", "chars", "orig_idx", "length"), ref, out):
        a = _np(a)
        assert b.numpy().dtype == a.dtype, name
        assert (b.numpy() == a).all(), f"{name} diverged from Pallas"
    # The text half of the XLA fused merge.
    xla = JK.merge_step_fused_batch(
        st, jnp.asarray(text), jnp.asarray(batch["mark_ops"]), jnp.asarray(batch["ranks"]),
        jnp.asarray(char_buf),
    )
    for name, b in zip(("elem_ctr", "elem_act", "deleted", "chars"), out[:4]):
        assert (b.numpy() == _np(getattr(xla, name))).all(), f"{name} diverged from XLA"
    assert (out[5].numpy() == _np(xla.length)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_mark_phase_plain_matches_pallas(seed):
    batch = _batch(seed)
    text, char_buf = _fused(batch)
    st = batch["states"]
    ec, ea, _, _, oi, ln = JP.text_phase_pallas(
        st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length,
        jnp.asarray(text), jnp.asarray(batch["ranks"]), char_buf=jnp.asarray(char_buf),
        interpret=None,
    )
    bnd_def, bnd_mask = jax.vmap(JK._permute_boundaries)(st.bnd_def, st.bnd_mask, oi)
    mark_ops = jnp.asarray(batch["mark_ops"])
    ref_def, ref_mask = JP.mark_phase_pallas(
        bnd_def, bnd_mask, ec, ea, ln, st.mark_count, mark_ops, interpret=None
    )
    # The port's permute on the same orig_idx must give the same inputs.
    p_def, p_mask = K._permute_boundaries(
        torch.from_numpy(_np(st.bnd_def)),
        torch.from_numpy(_np(st.bnd_mask).view(np.int32)),
        torch.from_numpy(_np(oi)),
    )
    assert (p_def.numpy() == _np(bnd_def)).all()
    assert (p_mask.numpy().view(np.uint32) == _np(bnd_mask)).all()
    out_def, out_mask = K.mark_phase_plain(
        p_def, p_mask, torch.from_numpy(_np(ec)), torch.from_numpy(_np(ea)),
        torch.from_numpy(_np(ln)), torch.from_numpy(_np(st.mark_count)),
        torch.from_numpy(batch["mark_ops"]),
    )
    assert (batch["mark_ops"][..., JK.K_KIND] == JK.KIND_MARK).any()
    assert out_def.dtype == torch.bool and out_mask.dtype == torch.int32
    assert (out_def.numpy() == _np(ref_def)).all()
    assert (out_mask.numpy().view(np.uint32) == _np(ref_mask)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_step_plain_matches_pallas_full_and_xla(seed):
    batch = _batch(seed)
    text, char_buf = _fused(batch)
    st = batch["states"]
    args = (jnp.asarray(text), jnp.asarray(batch["mark_ops"]), jnp.asarray(batch["ranks"]))
    xla = JK.merge_step_fused_batch(st, *args, jnp.asarray(char_buf))
    pallas = JP.merge_step_pallas_full(st, *args, char_buf=jnp.asarray(char_buf), interpret=None)
    out = K.merge_step_plain(
        _port_state(st), torch.from_numpy(text), torch.from_numpy(batch["mark_ops"]),
        torch.from_numpy(batch["ranks"]), torch.from_numpy(char_buf),
    )
    _assert_int32_state(out)
    _assert_state_equal(xla, out)
    _assert_state_equal(pallas, out)
    # The wrapper on CPU tensors is the plain version, and counts nothing.
    cuda_kernels.reset_launch_counts()
    again = cuda_kernels.merge_step_full(
        _port_state(st), torch.from_numpy(text), torch.from_numpy(batch["mark_ops"]),
        torch.from_numpy(batch["ranks"]), torch.from_numpy(char_buf),
    )
    _assert_state_equal(xla, again)
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0, "digest": 0}


def test_unfused_rows_match_xla_merge_step_batch():
    """Without a char buffer (plain one-char inserts), against
    K.merge_step_batch."""
    batch = _batch(3, replicas=4, ops=24)
    st = batch["states"]
    ref = JK.merge_step_batch(
        st, jnp.asarray(batch["text_ops"]), jnp.asarray(batch["mark_ops"]),
        jnp.asarray(batch["ranks"]),
    )
    out = K.merge_step_plain(
        _port_state(st), torch.from_numpy(batch["text_ops"]),
        torch.from_numpy(batch["mark_ops"]), torch.from_numpy(batch["ranks"]),
    )
    _assert_state_equal(ref, out)


def test_unresolved_insert_reference_follows_xla():
    """An insert whose reference element is absent goes after element 0
    (XLA's argmax over all-False); the Pallas kernel would drop it.  The
    port follows XLA, the path the JAX universe runs."""
    batch = _batch(0, replicas=8, ops=8)
    st = batch["states"]
    text = np.zeros((8, 2, JK.OP_FIELDS), np.int32)
    text[:, 0, JK.K_KIND] = JK.KIND_INSERT
    text[:, 0, JK.K_CTR] = 5000
    text[:, 0, JK.K_ACT] = 1
    text[:, 0, JK.K_REF_CTR] = 4999  # no such element
    text[:, 0, JK.K_REF_ACT] = 1
    text[:, 0, JK.K_PAYLOAD] = ord("Z")
    marks = np.zeros((8, 1, JK.OP_FIELDS), np.int32)
    ref = JK.merge_step_fused_batch(
        st, jnp.asarray(text), jnp.asarray(marks), jnp.asarray(batch["ranks"]),
        jnp.zeros((8, 64), jnp.int32),
    )
    out = K.merge_step_plain(
        _port_state(st), torch.from_numpy(text), torch.from_numpy(marks),
        torch.from_numpy(batch["ranks"]), torch.zeros((8, 64), dtype=torch.int32),
    )
    _assert_state_equal(ref, out)
    assert (out.chars[:, 1] == ord("Z")).all()
    assert (out.length == int(st.length[0]) + 1).all()


def test_mark_table_overflow_drops_like_jax():
    """Mark ops past the table (m >= M) set no bit and append no row, but
    still write their anchor slots and count."""
    batch = _batch(1, replicas=8, ops=32)
    st = dataclasses.replace(
        batch["states"], mark_count=jnp.full((8,), 62, jnp.int32)
    )
    marks = np.array(batch["mark_ops"])
    assert ((marks[..., JK.K_KIND] == JK.KIND_MARK).sum(axis=1) > 2).any()
    ref = JK.merge_step_batch(
        st, jnp.asarray(batch["text_ops"]), jnp.asarray(marks), jnp.asarray(batch["ranks"])
    )
    out = K.merge_step_plain(
        _port_state(st), torch.from_numpy(batch["text_ops"]), torch.from_numpy(marks),
        torch.from_numpy(batch["ranks"]),
    )
    _assert_state_equal(ref, out)


def _merged(seed):
    batch = _batch(seed)
    text, char_buf = _fused(batch)
    st = JK.merge_step_fused_batch(
        batch["states"], jnp.asarray(text), jnp.asarray(batch["mark_ops"]),
        jnp.asarray(batch["ranks"]), jnp.asarray(char_buf),
    )
    return st, batch["ranks"]


@pytest.mark.parametrize("seed", [0, 1])
def test_views_match_jax(seed):
    st, ranks = _merged(seed)
    port = _port_state(st)
    mask, has = JK.flatten_sources_batch(st)
    p_mask, p_has = K.flatten_sources(port)
    assert (p_mask.numpy().view(np.uint32) == _np(mask)).all()
    assert (p_has.numpy() == _np(has)).all()

    present = jax.vmap(lambda m: JK.expand_mask_bits(m, st.max_mark_ops))(mask)
    p_present = K.expand_mask_bits(p_mask, port.max_mark_ops)
    assert (p_present.numpy() == _np(present)).all()
    multi = allow_multiple_array()
    winners = jax.vmap(JK.resolve_winners, in_axes=(0, 0, None, None))(
        st, present, jnp.asarray(ranks), jnp.asarray(multi)
    )
    p_win = K.resolve_winners(port, p_present, torch.from_numpy(ranks), torch.from_numpy(multi))
    assert p_present.any() and (p_win.numpy() == _np(winners)).all()

    digest = _np(JK.convergence_digest_batch(st, jnp.asarray(ranks), jnp.asarray(multi)))
    for chunk in (1 << 24, 1):  # one chunk, and one replica per chunk
        got = K.convergence_digest(port, torch.from_numpy(ranks), torch.from_numpy(multi), chunk)
        assert got.dtype == torch.int64
        assert (got.numpy().astype(np.uint32) == digest).all()
        assert (got.numpy() == digest.astype(np.int64)).all()  # a uint32 value, wrapped


@pytest.mark.parametrize("seed", [0, 1])
def test_digest_wrapper_on_cpu_is_the_plain_version(seed):
    """On CPU tensors ``cuda_kernels.convergence_digest`` returns the plain
    digest (equal to the JAX package's) and counts no launch."""
    st, ranks = _merged(seed)
    port = _port_state(st)
    multi = allow_multiple_array()
    args = (port, torch.from_numpy(ranks), torch.from_numpy(multi))
    want = K.convergence_digest(*args)
    cuda_kernels.reset_launch_counts()
    assert torch.equal(cuda_kernels.convergence_digest(*args), want)
    digest = _np(JK.convergence_digest_batch(st, jnp.asarray(ranks), jnp.asarray(multi)))
    assert (want.numpy() == digest.astype(np.int64)).all()
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0, "digest": 0}


def test_digest_kernel_has_no_merge_kernel_name():
    """The merge kernels' roofline sums the device time of kernels whose
    names hold ``text_phase`` or ``mark_phase``: no kernel of
    ``csrc/digest.cu`` may take such a name."""
    src = (_build.CSRC_DIR / "digest.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert names == ["digest_kernel"]
    assert not any("text_phase" in n or "mark_phase" in n for n in names)
    assert "digest" in _build.KERNELS and "digest" in cuda_kernels.LAUNCHES
    assert "digest" not in cuda_kernels.CLUSTER_LAUNCHES  # one block a replica at every capacity


def test_digest_wrapper_on_cpu_takes_a_table_past_the_kernels():
    """The CPU route has no shared-memory limit: a table of 8,192 columns,
    which one block of the digest kernel cannot hold, gets the plain
    digest, and no launch is counted."""
    from peritext_tpu_torch.ops.state import make_empty_state, map_state

    r, c, m = 3, 16, 8192
    rng = np.random.default_rng(7)
    st = map_state(lambda x: x.unsqueeze(0).expand(r, *x.shape).clone(), make_empty_state(c, m, "cpu"))
    st = dataclasses.replace(
        st,
        chars=torch.from_numpy(rng.integers(32, 0x10FFFF, (r, c)).astype(np.int32)),
        length=torch.tensor([0, 9, 16], dtype=torch.int32),
        bnd_def=torch.from_numpy(rng.random((r, 2 * c)) < 0.3),
        bnd_mask=torch.from_numpy(rng.integers(-(2**31), 2**31, (r, 2 * c, m // 32)).astype(np.int32)),
        mark_count=torch.tensor([0, 100, m], dtype=torch.int32),
        mark_ctr=torch.from_numpy(rng.integers(1, 40, (r, m)).astype(np.int32)),
        mark_type=torch.from_numpy(rng.integers(0, 4, (r, m)).astype(np.int32)),
    )
    ranks, multi = torch.arange(4, dtype=torch.int32), torch.from_numpy(allow_multiple_array())
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.convergence_digest(st, ranks, multi)
    assert torch.equal(got, K.convergence_digest(st, ranks, multi))
    assert int(got[0]) == 2166136261 and int(got[1]) != int(got[2])
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0, "digest": 0}


def test_digest_bound_counts_what_the_digest_reads():
    """The digest's byte bound: per replica 3 B for each element below
    length (tombstone, two definedness flags), 4 B for each live char, the
    mask words of its live columns at each source slot, 20 B a live table
    column; length, mark_count, ranks and flags; 8 B out a replica."""
    from peritext_tpu_torch.ops.state import make_empty_state, map_state

    r, c, m = 2, 8, 64
    st = map_state(lambda x: x.unsqueeze(0).expand(r, *x.shape).clone(), make_empty_state(c, m, "cpu"))
    st = dataclasses.replace(
        st,
        length=torch.tensor([5, 9], dtype=torch.int32),  # the second clamps to C
        mark_count=torch.tensor([33, 0], dtype=torch.int32),
        deleted=torch.zeros((r, c), dtype=torch.bool).index_fill_(1, torch.tensor([1]), True),
    )
    bnd_def = torch.zeros((r, 2 * c), dtype=torch.bool)
    bnd_def[0, 0] = True  # element 0's before slot: a source
    bnd_def[0, 5] = True  # element 2's after slot: element 3 is a source
    bnd_def[0, 9] = True  # element 4's after slot: element 5 is past length
    bnd_def[1, 2] = True  # element 1's before slot: a source
    st = dataclasses.replace(st, bnd_def=bnd_def)
    ranks, multi = torch.zeros(4, dtype=torch.int32), torch.zeros(12, dtype=torch.bool)
    first = 3 * 5 + 4 * 4 + 4 * 2 * 2 + 20 * 33
    second = 3 * 8 + 4 * 7 + 0 + 0
    fixed = 4 * r + 4 * r + 4 * 4 + 12 + 8 * r
    assert bounds.convergence_digest_bytes(st, ranks, multi) == first + second + fixed


def test_digest_wraps_like_uint32_on_large_codepoints():
    st, ranks = _merged(2)
    chars = _np(st.chars).copy()
    chars[:, :50] = 0x10FFFF - np.arange(50)  # products far past 2**32
    st = dataclasses.replace(st, chars=jnp.asarray(chars))
    multi = allow_multiple_array()
    digest = _np(JK.convergence_digest_batch(st, jnp.asarray(ranks), jnp.asarray(multi)))
    got = K.convergence_digest(_port_state(st), torch.from_numpy(ranks), torch.from_numpy(multi))
    assert (got.numpy() == digest.astype(np.int64)).all()


def test_wrappers_refuse_other_devices_and_never_fall_back():
    batch = _batch(0, replicas=2, ops=8)
    meta = [torch.empty((2, 256), dtype=torch.int32, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_kernels.text_phase(
            meta[0], meta[1], meta[2].bool(), meta[3],
            torch.empty((2,), dtype=torch.int32, device="meta"),
            torch.empty((2, 4, 15), dtype=torch.int32, device="meta"),
            torch.empty((4,), dtype=torch.int32, device="meta"),
        )
    st = _port_state(batch["states"])
    with pytest.raises(ValueError, match="several devices"):
        cuda_kernels.mark_phase(
            st.bnd_def, st.bnd_mask, st.elem_ctr, st.elem_act, st.length,
            st.mark_count, torch.empty((2, 1, 15), dtype=torch.int32, device="meta"),
        )


def test_digest_wrapper_refuses_other_devices():
    st = _port_state(_batch(0, replicas=2, ops=8)["states"])
    meta = K.map_state(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), st)
    ranks, multi = torch.zeros(4, dtype=torch.int32), torch.zeros(12, dtype=torch.bool)
    with pytest.raises(ValueError, match="several devices"):
        cuda_kernels.convergence_digest(meta, ranks, multi)
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_kernels.convergence_digest(meta, ranks.to("meta"), multi.to("meta"))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A CUDA call that cannot build its kernel raises; it does not run the
    plain version instead."""
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("text_phase")
    with pytest.raises(ValueError, match="unknown kernel"):
        _build.build_all(["nope"])


def test_shared_memory_limits():
    """Both kernels hold C = 16384 (the 10k-char document) in one block;
    the text kernel does not hold C = 32768.  At C = 2048 the text kernel
    leaves room for eight blocks per SM (228 KiB, 1 KiB reserved each)."""
    limit = cuda_kernels.MAX_SHARED_BYTES
    assert cuda_kernels.text_phase_smem_bytes(16384) <= limit
    assert cuda_kernels.text_phase_smem_bytes(32768) > limit
    assert cuda_kernels.mark_phase_smem_bytes(16384, 32) <= limit
    assert cuda_kernels.mark_phase_smem_bytes(32768, 32) > limit
    assert 8 * (cuda_kernels.text_phase_smem_bytes(2048) + 1024) <= 228 * 1024
    # The footprints per element: 12 bytes (text) and 10 bytes (mark).
    assert cuda_kernels.text_phase_smem_bytes(4096) - cuda_kernels.text_phase_smem_bytes(2048) == 12 * 2048
    assert cuda_kernels.mark_phase_smem_bytes(4096, 32) - cuda_kernels.mark_phase_smem_bytes(2048, 32) == 10 * 2048


def test_text_phase_bound_counts_what_each_row_kind_reads():
    """The text kernel's byte bound: all four planes, length and ranks in,
    the five planes and length out, and per op row only the fields its kind
    reads (pad 4 B, delete 12 B, insert 24 B, run 28 B plus its clamped
    chars; a run is a pad without a char buffer)."""
    r, c, a = 2, 8, 4
    planes = [torch.zeros((r, c), dtype=torch.int32) for _ in range(2)]
    deleted = torch.zeros((r, c), dtype=torch.bool)
    chars = torch.zeros((r, c), dtype=torch.int32)
    length = torch.zeros(r, dtype=torch.int32)
    ops = torch.zeros((r, 5, K.OP_FIELDS), dtype=torch.int32)
    ops[:, :, K.K_KIND] = torch.tensor(
        [K.KIND_PAD, K.KIND_DELETE, K.KIND_INSERT, K.KIND_INSERT_RUN, K.KIND_INSERT_RUN])
    ops[:, 3, K.K_RUN_LEN] = 3
    ops[:, 4, K.K_RUN_LEN] = 100  # reads MAX_RUN_LEN chars at most
    ranks = torch.zeros(a, dtype=torch.int32)
    buf = torch.zeros((r, K.MAX_RUN_LEN), dtype=torch.int32)
    args = (*planes, deleted, chars, length, ops, ranks)
    out = bounds.nbytes(*K.text_phase_plain(*args, buf))
    assert out == 4 * r * c * 4 + r * c + 4 * r
    inputs = 3 * 4 * r * c + r * c + 4 * r + 4 * a
    rows = 4 + 12 + 24 + (28 + 4 * 3) + (28 + 4 * K.MAX_RUN_LEN)
    assert bounds.text_phase_bytes(*args, buf) == inputs + r * rows + out
    assert bounds.text_phase_bytes(*args) == inputs + r * (4 + 12 + 24 + 4 + 4) + out
    assert bounds.bound(bounds.HBM_BYTES_PER_S * 1e-3, 0) == (1.0, "bytes")
    assert bounds.bound(0, bounds.CORE_OPS_PER_S * 2e-3) == (2.0, "operations")


def test_merge_step_bound_moves_the_state_once_and_the_stages_as_run():
    """``merge_step_full``'s byte bound reads the state and writes it once,
    with the op rows as the text bound counts them, the ranks and the mark
    rows; its two launches as run add the orig-index plane out and in and
    the tail's reads of the text kernel's ``elem_ctr``, ``elem_act`` and
    ``length``."""
    batch = _batch(3)
    text, char_buf = _fused(batch)
    st = _port_state(batch["states"])
    text_ops, mark_ops, ranks, buf = (torch.from_numpy(a) for a in
                                      (text, batch["mark_ops"], batch["ranks"], char_buf))
    args = (st, text_ops, mark_ops, ranks, buf)
    text_in = (st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, text_ops, ranks, buf)
    rows = (bounds.text_phase_bytes(*text_in) - bounds.nbytes(*text_in[:5], ranks)
            - bounds.nbytes(*K.text_phase_plain(*text_in)))
    out = K.merge_step_plain(*args)

    def state(s):
        return bounds.nbytes(*(getattr(s, f) for f in FIELDS))

    full = bounds.merge_step_full_bytes(*args)
    assert full == state(st) + state(out) + rows + bounds.nbytes(ranks, mark_ops)
    extra = 2 * bounds.nbytes(st.elem_ctr) + bounds.nbytes(st.elem_ctr, st.elem_act, st.length)
    assert bounds.merge_step_stage_bytes(*args) == full + extra


def test_text_row_mix_counts_per_replica():
    ops = torch.zeros((2, 4, K.OP_FIELDS), dtype=torch.int32)
    ops[0, :, K.K_KIND] = torch.tensor([K.KIND_DELETE, K.KIND_DELETE, K.KIND_INSERT, K.KIND_PAD])
    ops[1, :, K.K_KIND] = torch.tensor([K.KIND_INSERT_RUN, K.KIND_DELETE, K.KIND_PAD, K.KIND_PAD])
    ops[1, 0, K.K_RUN_LEN] = 7
    buf = torch.zeros((2, K.MAX_RUN_LEN), dtype=torch.int32)
    assert text_row_mix(ops, buf) == (
        "deletes 1-2, inserts 0-1, runs 0-1, chars inserted 1-7 per replica; "
        "most rows in a replica 3 of 4")
    assert text_row_mix(ops, None).startswith("deletes 1-2, inserts 0-1, runs 0-0, chars inserted 0-1")


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_heavy_rows_match_xla(seed):
    """The insert-heavy rows chip_smoke times (a quarter each of pads,
    inserts, deletes and runs; HEAD, absent and live references; run
    payloads past the char window; runs that push the length past C)
    through the port's plain text phase and the XLA merge the JAX universe
    runs."""
    batch = _batch(seed, replicas=8)
    st = batch["states"]
    pst = _port_state(st)
    ops, char_buf = insert_heavy_text_ops(np.random.default_rng(seed), pst, 24, 128)
    kinds = ops[..., K.K_KIND]
    assert all((kinds == k).any() for k in (K.KIND_INSERT, K.KIND_DELETE, K.KIND_INSERT_RUN))
    out = K.text_phase_plain(
        pst.elem_ctr, pst.elem_act, pst.deleted, pst.chars, pst.length, ops,
        torch.from_numpy(batch["ranks"]), char_buf,
    )
    xla = JK.merge_step_fused_batch(
        st, jnp.asarray(ops.numpy()), jnp.asarray(batch["mark_ops"][:, :0]),
        jnp.asarray(batch["ranks"]), jnp.asarray(char_buf.numpy()),
    )
    for name, b in zip(("elem_ctr", "elem_act", "deleted", "chars"), out[:4]):
        assert (b.numpy() == _np(getattr(xla, name))).all(), f"{name} diverged from XLA"
    assert (out[5].numpy() == _np(xla.length)).all()
    assert (out[5] > pst.elem_ctr.shape[1]).any()  # some replica grew past C


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_step_matches_merge_step_pallas_and_xla(seed):
    """``cuda_kernels.merge_step`` (``merge_step_pallas``'s counterpart; on
    CPU tensors the text phase's plain version, then the permute and the
    per-op mark scan) equals ``merge_step_pallas`` in interpret mode and the
    XLA merge on every state field."""
    batch = _batch(seed)
    st = batch["states"]
    args = (jnp.asarray(batch["text_ops"]), jnp.asarray(batch["mark_ops"]), jnp.asarray(batch["ranks"]))
    pallas = JP.merge_step_pallas(st, *args, interpret=None)
    xla = JK.merge_step_batch(st, *args)
    out = cuda_kernels.merge_step(
        _port_state(st), *(torch.from_numpy(np.asarray(a)) for a in
                           (batch["text_ops"], batch["mark_ops"], batch["ranks"])),
    )
    _assert_int32_state(out)
    _assert_state_equal(pallas, out)
    _assert_state_equal(xla, out)


def test_merge_step_latency_shape_matches_pallas():
    """``test_pallas_latency_shape_matches_xla``'s configuration cut to the
    CPU (a 1000-char document at C = 2048 instead of 10,000 at 16384): one
    8-replica block of replica 0's fused runs and char buffer tiled, with
    marks, through ``merge_step`` against ``merge_step_pallas`` and the XLA
    fused merge.  Seed 2's replica 0 carries both runs and marks (the JAX
    test's seed 3 has neither at this size)."""
    workload = make_merge_workload(doc_len=1000, ops_per_merge=64, num_streams=2, with_marks=True, seed=2)
    batch = build_device_batch(workload, num_replicas=8, capacity=2048, max_mark_ops=256)
    fr, fb, _ = fuse_insert_runs(batch["text_ops"][0])
    text = np.repeat(fr[None], 8, axis=0)
    char_buf = np.repeat(pad_buffer(fb, max(fb.shape[0], JK.MAX_RUN_LEN))[None], 8, axis=0)
    mark_ops = np.repeat(np.asarray(batch["mark_ops"][0])[None], 8, axis=0)
    ranks = np.asarray(batch["ranks"])
    assert (text[..., JK.K_KIND] == JK.KIND_INSERT_RUN).any() and (mark_ops[..., JK.K_KIND] == JK.KIND_MARK).any()
    st = batch["states"]
    jargs = tuple(jnp.asarray(a) for a in (text, mark_ops, ranks))
    pallas = JP.merge_step_pallas(st, *jargs, char_buf=jnp.asarray(char_buf), interpret=None)
    xla = JK.merge_step_fused_batch(st, *jargs, jnp.asarray(char_buf))
    out = cuda_kernels.merge_step(
        _port_state(st), *(torch.from_numpy(np.ascontiguousarray(a)) for a in (text, mark_ops, ranks)),
        char_buf=torch.from_numpy(np.ascontiguousarray(char_buf)),
    )
    _assert_state_equal(pallas, out)
    _assert_state_equal(xla, out)
