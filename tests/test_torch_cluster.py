"""Past C = 16384 both kernels run as thread-block clusters of C / 16384
blocks, each holding an equal slice of a replica's slots.

Here on the CPU: the cluster sizes and per-slice footprints the wrappers
launch with, and the plain twins (what a cluster kernel is held against on
the card) at C = 32768 against the Pallas kernels in interpret mode, as
tests/test_pallas.py runs them, and against XLA where the Pallas text
kernel differs (it drops an insert whose reference is absent).  Inputs
are made from numpy seeds and aimed at the cluster form's slice edge at
16384: references, delete targets and runs on both sides of it, skip runs
across it, documents that end before it, at it and near C, and marks whose
range starts past the edge with no defined boundary between it and the
first slice.  Tolerance 0: every output equal, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops import pallas_kernels as JP
from peritext_tpu.ops.state import DocState as JaxDocState
from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops import kernels as K

C = 32768
EDGE = C // 2  # the slice edge of a two-block cluster
R = 8  # the Pallas kernels' replica block
# Replica lengths: empty, inside the first slice, around the edge, in the
# second slice and nearly full (runs push elements off the end).
LENGTHS = (0, 9000, EDGE - 40, EDGE, EDGE + 30, 24000, C - 200, C - 20)
BUF = 128


@pytest.mark.parametrize("words", [1, 2, 32, 512])
def test_cluster_size_and_limit_at_every_mask_width(words):
    """One block up to C = 16384, then clusters of 2, 4 and 8 blocks up to
    C = 131072, which is the capacity limit; nothing holds C = 262144."""
    assert cuda_kernels.kernel_capacity_limit(words) == 131072
    for c, blocks in ((256, 1), (2048, 1), (16384, 1), (32768, 2), (65536, 4), (131072, 8), (262144, 0)):
        assert cuda_kernels.cluster_size(c, words) == blocks, c


@pytest.mark.parametrize("words", [1, 2, 32, 512])
def test_slice_footprints_fit_one_block(words):
    """At S = 2, 4 and 8 each block's slice of C = 16384 * S fits one
    block's shared memory; half as many blocks would not.  A slice costs
    what C = 16384 costs one block, plus the halo and the cluster-min
    slots (text) or the cluster-min slots (mark)."""
    limit = cuda_kernels.MAX_SHARED_BYTES
    text_one = cuda_kernels.text_phase_smem_bytes(16384)
    mark_one = cuda_kernels.mark_phase_smem_bytes(16384, words)
    for blocks in (2, 4, 8):
        c = 16384 * blocks
        text = cuda_kernels.text_phase_smem_bytes(c, blocks)
        mark = cuda_kernels.mark_phase_smem_bytes(c, words, blocks)
        assert text <= limit and mark <= limit
        assert text == text_one + 12 * 64 + 4 * 32
        assert mark == mark_one + 4 * 32
        assert cuda_kernels.text_phase_smem_bytes(c, blocks // 2 or 1) > limit
    # Slices split C evenly, in multiples of four slots for the text kernel.
    assert cuda_kernels.cluster_size(32768 + 8, 1) == 2
    assert cuda_kernels.cluster_size(32768 + 2, 1) == 0


def _state(rng, words):
    """R replicas of unique element ids with the lengths above, random
    tombstones, chars, definedness and masks (numpy)."""
    ec = np.zeros((R, C), np.int32)
    ea = np.zeros((R, C), np.int32)
    length = np.array(LENGTHS, np.int32)
    for i, n in enumerate(LENGTHS):
        ec[i, :n] = rng.permutation(np.arange(1, 4 * C))[:n]
        ea[i, :n] = rng.integers(0, 5, size=n)
    live = np.arange(C)[None, :] < length[:, None]
    deleted = (rng.random((R, C)) < 0.3) & live
    chars = np.where(live, rng.integers(32, 0x10FFFF, (R, C)), 0).astype(np.int32)
    bnd_def = rng.random((R, 2 * C)) < 0.2
    bnd_mask = rng.integers(0, 2**32, size=(R, 2 * C, words), dtype=np.uint64).astype(np.uint32)
    return ec, ea, deleted, chars, length, bnd_def, bnd_mask


def _near_edge(rng, n):
    """A live position within MAX_RUN_LEN + 8 slots of the edge or of the
    document's end (-1 when there is none)."""
    centre = EDGE if rng.random() < 0.7 else n
    j = centre + int(rng.integers(-(K.MAX_RUN_LEN + 8), 8))
    return j if 0 <= j < n else -1


def _text_rows(rng, ec, ea, length, num_ops, absent):
    """Inserts, runs (a third exactly MAX_RUN_LEN long), deletes and pads,
    most referring near the edge; a quarter of the inserts with a small
    counter, so the skip run past the reference crosses the edge; with
    ``absent``, one reference in eight names no element."""
    ops = np.zeros((R, num_ops, K.OP_FIELDS), np.int32)
    kinds = [K.KIND_PAD, K.KIND_INSERT, K.KIND_INSERT_RUN, K.KIND_DELETE, K.KIND_DELETE]
    for i in range(R):
        n = int(length[i])
        for l in range(num_ops):
            kind = kinds[rng.integers(0, len(kinds))]
            op = ops[i, l]
            op[K.K_KIND] = kind
            op[K.K_CTR] = rng.integers(1, 64) if rng.random() < 0.25 else rng.integers(4 * C, 8 * C)
            op[K.K_ACT] = rng.integers(0, 5)
            j = _near_edge(rng, n) if rng.random() < 0.8 else (int(rng.integers(0, n)) if n else -1)
            if absent and rng.random() < 0.125:
                op[K.K_REF_CTR], op[K.K_REF_ACT] = 999_999, 3
            elif j >= 0:
                op[K.K_REF_CTR], op[K.K_REF_ACT] = ec[i, j], ea[i, j]
            if kind == K.KIND_INSERT_RUN:
                op[K.K_RUN_LEN] = K.MAX_RUN_LEN if rng.random() < 0.33 else rng.integers(1, K.MAX_RUN_LEN)
                op[K.K_PAYLOAD] = rng.integers(0, BUF - K.MAX_RUN_LEN)
            else:
                op[K.K_PAYLOAD] = rng.integers(32, 127)
    return ops


def _text_inputs(seed, absent):
    rng = np.random.default_rng(seed)
    ec, ea, deleted, chars, length, _, _ = _state(rng, 1)
    ops = _text_rows(rng, ec, ea, length, 40, absent)
    ranks = rng.permutation(8).astype(np.int32)
    char_buf = rng.integers(32, 0x10FFFF, (R, BUF)).astype(np.int32)
    return ec, ea, deleted, chars, length, ops, ranks, char_buf


def _plain_text(ec, ea, deleted, chars, length, ops, ranks, char_buf):
    t = torch.from_numpy
    out = K.text_phase_plain(t(ec), t(ea), t(deleted), t(chars), t(length), t(ops), t(ranks), t(char_buf))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_text_twin_at_32768_matches_pallas(seed):
    """Replicas 0-5, whose documents never fill: there every reference
    resolves.  (In the nearly full 6 and 7 elements fall off the end and
    later references to them are absent, where Pallas differs; the next
    test holds those against XLA.)"""
    ec, ea, deleted, chars, length, ops, ranks, char_buf = _text_inputs(seed, absent=False)
    ref = JP.text_phase_pallas(
        jnp.asarray(ec), jnp.asarray(ea), jnp.asarray(deleted), jnp.asarray(chars),
        jnp.asarray(length), jnp.asarray(ops), jnp.asarray(ranks), char_buf=jnp.asarray(char_buf),
        interpret=None,
    )
    got = _plain_text(ec, ea, deleted, chars, length, ops, ranks, char_buf)
    held = slice(0, 6)
    assert (got[5][held] < C).all()
    for name, a, b in zip(("elem_ctr", "elem_act", "deleted", "chars", "orig_idx", "length"), ref, got):
        a = np.asarray(jax.device_get(a))
        assert b.dtype == a.dtype, name
        assert (b[held] == a[held]).all(), f"{name} diverged from Pallas"
    # The inputs reach what the cluster form splits: elements moved across
    # the edge and inserts on both sides of it.
    oi = got[4][held]
    moved = (oi >= 0) & (oi < EDGE) & (np.arange(C)[None, :] >= EDGE)
    inserted = oi == -1
    assert moved.any() and inserted[:, :EDGE].any() and inserted[:, EDGE:].any()


def test_plain_text_twin_at_32768_follows_xla_on_absent_references():
    """Where a reference names no element (one in eight here, and in the
    nearly full replicas those pushed off the end) the Pallas kernel drops
    the insert; the port, like the XLA merge the JAX universe runs, puts it
    after element 0."""
    ec, ea, deleted, chars, length, ops, ranks, char_buf = _text_inputs(2, absent=True)
    assert (ops[..., K.K_REF_CTR] == 999_999).any()
    z = lambda *shape, dtype=jnp.int32: jnp.zeros((R, *shape), dtype)  # noqa: E731
    st = JaxDocState(
        elem_ctr=jnp.asarray(ec), elem_act=jnp.asarray(ea), deleted=jnp.asarray(deleted),
        chars=jnp.asarray(chars), bnd_def=z(2 * C, dtype=bool), bnd_mask=z(2 * C, 1, dtype=jnp.uint32),
        mark_ctr=z(32), mark_act=z(32), mark_action=z(32), mark_type=z(32), mark_attr=z(32),
        length=jnp.asarray(length), mark_count=jnp.zeros(R, jnp.int32),
    )
    xla = JK.merge_step_fused_batch(
        st, jnp.asarray(ops), jnp.zeros((R, 1, K.OP_FIELDS), jnp.int32), jnp.asarray(ranks),
        jnp.asarray(char_buf),
    )
    got = _plain_text(ec, ea, deleted, chars, length, ops, ranks, char_buf)
    for name, b in zip(("elem_ctr", "elem_act", "deleted", "chars", "length"), got[:4] + got[5:]):
        assert (b == np.asarray(jax.device_get(getattr(xla, name)))).all(), f"{name} diverged from XLA"
    assert (got[5][6:] > C).all()  # the nearly full replicas pushed elements off the end


def _mark_rows(rng, ec, ea, length, num_ops, sparse):
    """Mark rows anchored near the edge, spanning it, or (rows of the
    ``sparse`` replicas) starting past it; a few anchors absent."""
    ops = np.zeros((R, num_ops, K.OP_FIELDS), np.int32)
    for i in range(R):
        n = int(length[i])
        for l in range(num_ops):
            op = ops[i, l]
            op[K.K_KIND] = K.KIND_MARK if rng.random() < 0.85 else K.KIND_PAD
            op[K.K_CTR] = rng.integers(1, 1000)
            op[K.K_ACT] = rng.integers(0, 5)
            op[K.K_SKIND] = rng.integers(0, 2)
            op[K.K_EKIND] = rng.integers(0, 3)
            for ctr, act in ((K.K_SCTR, K.K_SACT), (K.K_ECTR, K.K_EACT)):
                if i in sparse and n > EDGE:
                    j = int(rng.integers(EDGE, n))
                elif rng.random() < 0.1:
                    op[ctr], op[act] = 999_999, 3
                    continue
                else:
                    j = _near_edge(rng, n) if rng.random() < 0.6 else (int(rng.integers(0, n)) if n else -1)
                if j >= 0:
                    op[ctr], op[act] = ec[i, j], ea[i, j]
    return ops


@pytest.mark.parametrize("seed,words", [(3, 2), (4, 1)])
def test_plain_mark_twin_at_32768_matches_pallas(seed, words):
    """Replicas 4 and 6 keep no defined boundary past the edge, so their
    marks, all starting past it, carry rows from the first slice; replica
    7's table overflows (marks past M drop their bit)."""
    rng = np.random.default_rng(seed)
    ec, ea, _, _, length, bnd_def, bnd_mask = _state(rng, words)
    sparse = (4, 6)
    for i in sparse:
        bnd_def[i, 2 * EDGE:] = False
    ops = _mark_rows(rng, ec, ea, length, 32, sparse)
    counts = np.zeros(R, np.int32)
    counts[7] = 32 * words - 3
    ref_def, ref_mask = JP.mark_phase_pallas(
        jnp.asarray(bnd_def), jnp.asarray(bnd_mask), jnp.asarray(ec), jnp.asarray(ea),
        jnp.asarray(length), jnp.asarray(counts), jnp.asarray(ops), interpret=None,
    )
    t = torch.from_numpy
    got_def, got_mask = K.mark_phase_plain(
        t(bnd_def), t(bnd_mask.view(np.int32)), t(ec), t(ea), t(length), t(counts), t(ops),
    )
    assert (got_def.numpy() == np.asarray(jax.device_get(ref_def))).all()
    assert (got_mask.numpy().view(np.uint32) == np.asarray(jax.device_get(ref_mask))).all()
    # The sparse replicas' marks wrote rows past the edge, carried from
    # before it.
    for i in sparse:
        written = got_mask.numpy()[i, 2 * EDGE:] != bnd_mask.view(np.int32)[i, 2 * EDGE:]
        assert written.any()
