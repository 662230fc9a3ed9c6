"""The CUDA kernels against their plain versions on the card, on random and
edge-case inputs the benchmark workload never reaches: unresolved
references, runs that push elements off the end, capacities that are not a
multiple of the block size, mark tables that overflow, end anchors left of
start anchors, long delete runs across op tiles with duplicate ids and ids
inserted later in the batch, and C = 16384.  Byte-equal or fail.  Last, a
``TorchUniverse`` on the card grows past 8192 elements against the oracle.

Needs a CUDA device; without one every test skips.  This file imports no
JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.bench.workloads import make_writer_rounds
from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.oracle import Doc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_state(rng, r, c, words, fill):
    """Element planes with ``fill`` live elements of unique ids, random
    tombstones, definedness and masks (dead slots zero)."""
    length = rng.integers(0, fill + 1, size=r).astype(np.int32)
    ec = np.zeros((r, c), np.int32)
    ea = np.zeros((r, c), np.int32)
    for i in range(r):
        n = length[i]
        ec[i, :n] = rng.permutation(np.arange(1, 4 * c))[:n]
        ea[i, :n] = rng.integers(0, 5, size=n)
    deleted = (rng.random((r, c)) < 0.3) & (np.arange(c)[None, :] < length[:, None])
    chars = np.where(np.arange(c)[None, :] < length[:, None], rng.integers(32, 0x10FFFF, (r, c)), 0)
    bnd_def = rng.random((r, 2 * c)) < 0.2
    bnd_mask = rng.integers(-(2**31), 2**31, size=(r, 2 * c, words), dtype=np.int64).astype(np.int32)
    return ec, ea, deleted, chars.astype(np.int32), length, bnd_def, bnd_mask


def _pick_ref(rng, ec, ea, i, length):
    """An existing element id, HEAD, or an id nobody holds."""
    u = rng.random()
    if u < 0.15 or length[i] == 0:
        return 0, 0
    if u < 0.25:
        return 999999, 3
    j = rng.integers(0, length[i])
    return ec[i, j], ea[i, j]


def _text_ops(rng, ec, ea, length, num_ops, buf_len):
    r = ec.shape[0]
    ops = np.zeros((r, num_ops, K.OP_FIELDS), np.int32)
    for i in range(r):
        for l in range(num_ops):
            kind = rng.choice([K.KIND_PAD, K.KIND_INSERT, K.KIND_DELETE, K.KIND_INSERT_RUN])
            ops[i, l, K.K_KIND] = kind
            ops[i, l, K.K_CTR] = rng.integers(1, 8 * ec.shape[1])
            ops[i, l, K.K_ACT] = rng.integers(0, 5)
            ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = _pick_ref(rng, ec, ea, i, length)
            if kind == K.KIND_INSERT_RUN:
                ops[i, l, K.K_RUN_LEN] = rng.integers(1, K.MAX_RUN_LEN + 1)
                ops[i, l, K.K_PAYLOAD] = rng.integers(0, buf_len + 20)  # some clamp
            else:
                ops[i, l, K.K_PAYLOAD] = rng.integers(32, 127)
    return ops


def _mark_ops(rng, ec, ea, length, num_ops):
    r = ec.shape[0]
    ops = np.zeros((r, num_ops, K.OP_FIELDS), np.int32)
    for i in range(r):
        for l in range(num_ops):
            ops[i, l, K.K_KIND] = K.KIND_MARK if rng.random() < 0.8 else K.KIND_PAD
            ops[i, l, K.K_CTR] = rng.integers(1, 1000)
            ops[i, l, K.K_ACT] = rng.integers(0, 5)
            ops[i, l, K.K_SKIND] = rng.integers(0, 2)
            ops[i, l, K.K_SCTR], ops[i, l, K.K_SACT] = _pick_ref(rng, ec, ea, i, length)
            ops[i, l, K.K_EKIND] = rng.integers(0, 3)
            ops[i, l, K.K_ECTR], ops[i, l, K.K_EACT] = _pick_ref(rng, ec, ea, i, length)
    return ops


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _delete_runs(rng, ec, ea, ops):
    """Turn rows 3..len/2 into a long delete run (one pad in eight) across
    op tiles: targets are existing ids, ids a run row inserts earlier or
    later in the batch, absent ids and repeats; and give two live elements
    of each replica the same id."""
    r, num_ops, _ = ops.shape
    for i in range(r):
        ec[i, 5], ea[i, 5] = ec[i, 2], ea[i, 2]  # a duplicate element id
        inserted = [(ops[i, l, K.K_CTR] + rng.integers(0, max(ops[i, l, K.K_RUN_LEN], 1)),
                     ops[i, l, K.K_ACT])
                    for l in range(num_ops) if ops[i, l, K.K_KIND] in (K.KIND_INSERT, K.KIND_INSERT_RUN)]
        targets = []
        for l in range(3, num_ops // 2):
            if rng.random() < 0.125:
                ops[i, l, K.K_KIND] = K.KIND_PAD
                continue
            u = rng.random()
            if u < 0.4 or not inserted:
                j = rng.integers(0, ec.shape[1])
                tgt = (ec[i, j], ea[i, j])
            elif u < 0.7:
                tgt = inserted[rng.integers(0, len(inserted))]
            elif u < 0.8 or not targets:
                tgt = (999999, 4)
            else:
                tgt = targets[rng.integers(0, len(targets))]
            targets.append(tgt)
            ops[i, l, K.K_KIND] = K.KIND_DELETE
            ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = tgt
    assert (ec[:, 5] == ec[:, 2]).all()


@pytest.mark.parametrize("r,c,fill,num_ops,seed,delete_runs", [
    (3, 96, 90, 40, 0, False),     # nearly full: runs push elements off the end
    (5, 700, 400, 64, 1, False),   # C not a multiple of the block size
    (2, 2048, 1500, 128, 2, False),
    (4, 2048, 1800, 300, 3, True),
    (3, 4096, 3000, 200, 6, True),    # each capacity's block size: 256 ...
    (2, 8192, 6000, 200, 7, False),   # ... and 512 threads
    (2, 16384, 9000, 200, 4, False),
    (2, 16384, 16300, 400, 5, True),  # nearly full at the largest capacity
])
def test_text_kernel_matches_plain(card, r, c, fill, num_ops, seed, delete_runs):
    rng = np.random.default_rng(seed)
    ec, ea, deleted, chars, length, _, _ = _random_state(rng, r, c, 1, fill)
    buf_len = 128
    ops = _text_ops(rng, ec, ea, length, num_ops, buf_len)
    if delete_runs:
        _delete_runs(rng, ec, ea, ops)
    ranks = torch.from_numpy(rng.permutation(8).astype(np.int32)).to(card)
    char_buf = torch.from_numpy(rng.integers(32, 0x10FFFF, (r, buf_len)).astype(np.int32)).to(card)
    args = [torch.from_numpy(x).to(card) for x in (ec, ea, deleted, chars, length, ops)]
    for buf in (char_buf, None):
        want = K.text_phase_plain(*args, ranks, buf)
        cuda_kernels.reset_launch_counts()
        got = cuda_kernels.text_phase(*args, ranks, buf)
        assert cuda_kernels.LAUNCHES["text_phase"] == 1
        torch.cuda.synchronize()
        _same(got, want)
    if delete_runs:
        assert not torch.equal(want[2], args[2])  # the runs tombstoned something


@pytest.mark.parametrize("c,offset", [(99, 0), (96, 1)])
def test_text_kernel_scalar_paths(card, c, offset):
    """C not a multiple of 4, and planes that start 4 bytes past a 16-byte
    boundary: the kernel moves slots one by one instead of in 16-byte
    words, with the same result."""
    rng = np.random.default_rng(10 + c)
    r, num_ops = 3, 60
    ec, ea, deleted, chars, length, _, _ = _random_state(rng, r, c, 1, c - 10)
    ops = _text_ops(rng, ec, ea, length, num_ops, 128)
    _delete_runs(rng, ec, ea, ops)

    def shifted(x):
        flat = torch.zeros(x.size + offset, dtype=torch.from_numpy(x).dtype, device=card)
        flat[offset:] = torch.from_numpy(x).to(card).reshape(-1)
        return flat[offset:].view(x.shape)

    args = [shifted(x) for x in (ec, ea, deleted, chars)] + [
        torch.from_numpy(x).to(card) for x in (length, ops)]
    if offset:
        assert args[0].data_ptr() % 16 != 0
    ranks = torch.from_numpy(rng.permutation(8).astype(np.int32)).to(card)
    char_buf = torch.from_numpy(rng.integers(32, 0x10FFFF, (r, 128)).astype(np.int32)).to(card)
    want = K.text_phase_plain(*args, ranks, char_buf)
    got = cuda_kernels.text_phase(*args, ranks, char_buf)
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.parametrize("r,c,words,fill,num_ops,seed,near_full", [
    (3, 37, 1, 30, 40, 0, True),     # odd plane size; the table overflows
    (4, 600, 4, 500, 64, 1, False),
    (2, 2048, 32, 1800, 48, 2, True),
    (2, 16384, 32, 12000, 48, 3, False),
])
def test_mark_kernel_matches_plain(card, r, c, words, fill, num_ops, seed, near_full):
    rng = np.random.default_rng(seed)
    ec, ea, _, _, length, bnd_def, bnd_mask = _random_state(rng, r, c, words, fill)
    ops = _mark_ops(rng, ec, ea, length, num_ops)
    m = 32 * words
    counts = np.full(r, m - 3 if near_full else 0, np.int32)
    args = [torch.from_numpy(x).to(card) for x in (bnd_def, bnd_mask, ec, ea, length, counts, ops)]
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.mark_phase(*args)
    assert cuda_kernels.LAUNCHES["mark_phase"] == 1
    want = K.mark_phase_plain(*args)
    torch.cuda.synchronize()
    _same(got, want)
    assert not torch.equal(got[1], args[1])


def test_wrappers_check_their_inputs(card):
    r, c = 2, 64
    z = torch.zeros((r, c), dtype=torch.int32, device=card)
    ln = torch.zeros(r, dtype=torch.int32, device=card)
    ops = torch.zeros((r, 4, K.OP_FIELDS), dtype=torch.int32, device=card)
    ranks = torch.zeros(4, dtype=torch.int32, device=card)
    dl = torch.zeros((r, c), dtype=torch.bool, device=card)
    with pytest.raises(TypeError, match="deleted"):
        cuda_kernels.text_phase(z, z, z, z, ln, ops, ranks)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.text_phase(z, z.t().contiguous().t(), dl, z, ln, ops, ranks)
    with pytest.raises(ValueError, match="MAX_RUN_LEN"):
        cuda_kernels.text_phase(z, z, dl, z, ln, ops, ranks, torch.zeros((r, 8), dtype=torch.int32, device=card))
    ok = torch.zeros((1, 16384), dtype=torch.int32, device=card)
    out = cuda_kernels.text_phase(ok, ok, ok.bool(), ok, ln[:1], ops[:1], ranks)
    torch.cuda.synchronize()
    assert out[0].shape == (1, 16384)
    mark = cuda_kernels.mark_phase(
        torch.zeros((1, 2 * 16384), dtype=torch.bool, device=card),
        torch.zeros((1, 2 * 16384, 32), dtype=torch.int32, device=card),
        ok, ok, ln[:1], ln[:1], ops[:1],
    )
    torch.cuda.synchronize()
    assert mark[1].shape == (1, 2 * 16384, 32)
    big = torch.zeros((1, 32768), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match=r"shared memory.*C <= 16384 fits"):
        cuda_kernels.text_phase(big, big, big.bool(), big, ln[:1], ops[:1], ranks)
    with pytest.raises(ValueError, match=r"shared memory.*C <= 16384 fits"):
        cuda_kernels.mark_phase(
            torch.zeros((1, 2 * 32768), dtype=torch.bool, device=card),
            torch.zeros((1, 2 * 32768, 32), dtype=torch.int32, device=card),
            big, big, ln[:1], ln[:1], ops[:1],
        )


def test_universe_on_the_card_grows_past_8192(card):
    """Two replicas ingest an 8300-char genesis, one round of two concurrent
    writers each and then each other's round: the universe re-buckets from
    C = 8192 to 16384, both kernels run there, and the result is the
    oracle's."""
    wl = make_writer_rounds(doc_len=8300, ops_per_round=32, num_writers=2, rounds=1, seed=3)
    (w0, w1), = wl["rounds"]
    uni = TorchUniverse(["a", "b"], capacity=8192, max_mark_ops=64, device=card)
    cuda_kernels.reset_launch_counts()
    uni.apply_changes([[wl["genesis"]], [wl["genesis"]]])
    uni.apply_changes([w0, w1])
    uni.apply_changes([w1, w0])
    assert uni.capacity == 16384 and uni.stats["capacity_growths"] >= 1
    assert cuda_kernels.LAUNCHES == {"text_phase": 3, "mark_phase": 3} == {
        k: uni.stats["launches"] for k in ("text_phase", "mark_phase")
    }
    oracle = Doc("oracle")
    for c in [wl["genesis"], *w0, *w1]:
        oracle.apply_change(c)
    expect = oracle.get_text_with_formatting(["text"])
    assert max(uni.lengths) > 8192
    assert uni.texts() == ["".join(s["text"] for s in expect)] * 2
    assert uni.spans_batch() == [expect, expect]
    assert len(set(uni.digests().tolist())) == 1
