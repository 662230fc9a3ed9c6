"""The CUDA kernels against their plain versions on the card, on random and
edge-case inputs the benchmark workload never reaches: unresolved
references, runs that push elements off the end, capacities that are not a
multiple of the block size, mark tables that overflow, end anchors left of
start anchors.  Byte-equal or fail.

Needs a CUDA device; without one every test skips.  This file imports no
JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops import kernels as K

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


@pytest.mark.parametrize("r,c,fill,num_ops,seed", [
    (3, 96, 90, 40, 0),     # nearly full: runs push elements off the end
    (5, 700, 400, 64, 1),   # C not a multiple of the block size
    (2, 2048, 1500, 128, 2),
])
def test_text_kernel_matches_plain(card, r, c, fill, num_ops, seed):
    rng = np.random.default_rng(seed)
    ec, ea, deleted, chars, length, _, _ = _random_state(rng, r, c, 1, fill)
    buf_len = 128
    ops = _text_ops(rng, ec, ea, length, num_ops, buf_len)
    ranks = torch.from_numpy(rng.permutation(8).astype(np.int32)).to(card)
    char_buf = torch.from_numpy(rng.integers(32, 0x10FFFF, (r, buf_len)).astype(np.int32)).to(card)
    args = [torch.from_numpy(x).to(card) for x in (ec, ea, deleted, chars, length, ops)]
    for buf in (char_buf, None):
        cuda_kernels.reset_launch_counts()
        got = cuda_kernels.text_phase(*args, ranks, buf)
        assert cuda_kernels.LAUNCHES["text_phase"] == 1
        want = K.text_phase_plain(*args, ranks, buf)
        torch.cuda.synchronize()
        _same(got, want)


@pytest.mark.parametrize("r,c,words,fill,num_ops,seed,near_full", [
    (3, 37, 1, 30, 40, 0, True),     # odd plane size; the table overflows
    (4, 600, 4, 500, 64, 1, False),
    (2, 2048, 32, 1800, 48, 2, True),
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
    big = torch.zeros((1, 16384), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_kernels.text_phase(
            big, big, big.bool(), big, ln[:1], ops[:1], ranks,
        )
