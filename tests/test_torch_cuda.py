"""The CUDA kernels against their plain versions on the card, on random and
edge-case inputs the benchmark workload never reaches: unresolved
references, runs that push elements off the end, capacities that are not a
multiple of the block size, mark tables that overflow, end anchors left of
start anchors, long delete runs across op tiles with duplicate ids and ids
inserted later in the batch, and C = 16384; past it, both kernels' cluster
forms at C = 32768, 65536 and 131072 on inputs aimed at the slice edges.
The merge's tail (``mark_tail``: the boundary gather through orig_idx, the
marks and the table append in one launch) at one-block and cluster widths,
its refusal to gather in place, and ``merge_step_full`` as two launches.
Byte-equal or fail.  Then a
``TorchUniverse`` on the card grows past 8192 elements against the oracle
on the scan path, the default path (sorted, windowed or not) equals the
scan path at C = 4096, the per-op patch path's records on the card equal
those on the CPU, and a ``TorchDoc`` session on the card equals the oracle.
A universe grows past C = 16384 on the cluster kernels (and, under a
lowered limit, on the capacity route), the stream at C = 32768 runs the
cluster kernels, and
the patched sorted route gives the per-op loop's streams.  A sharded
serving plane on the card (a migration and an evict/hydrate round trip
included) equals the same run on the CPU, and kernel launches from two
threads count and land on the card.  A universe sharded over a logical
2x2 mesh of the card merges once per replica group and equals an
unsharded one on the CPU, as do the sequence-parallel placement and
flatten.  The stream over logical meshes of the card equals the resident
merge, and an NCCL world of one runs the multi-host step.

Needs a CUDA device; without one every test skips.  This file imports no
JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch

from peritext_tpu_torch import TorchDoc, TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import (
    RESIDENT_TEXT_SHAPES, build_device_batch, doc_session, document_planes, make_merge_workload,
    make_writer_rounds, resident_text_batch, round_text_rows, wire_rounds,
)
from peritext_tpu_torch.ids import ActorRegistry
from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops import universe as port_universe
from peritext_tpu_torch.ops.encode import AttrRegistry, encode_changes, pad_rows
from peritext_tpu_torch.ops.state import FIELDS, DocState, make_empty_state, map_state
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.schema import allow_multiple_array

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
        # Past C = 8192 the rows' piece table fits: the piece form runs.
        assert cuda_kernels.PIECE_LAUNCHES["text_phase"] == (1 if c > 8192 else 0)
        torch.cuda.synchronize()
        _same(got, want)
    if delete_runs:
        assert not torch.equal(want[2], args[2])  # the runs tombstoned something


@pytest.mark.parametrize("c,offset", [(99, 0), (96, 1), (9001, 0), (16384, 1)])
def test_text_kernel_scalar_paths(card, c, offset):
    """C not a multiple of 4, and planes that start 4 bytes past a 16-byte
    boundary: the kernel moves slots one by one instead of in 16-byte
    words, with the same result (the plane form at C = 99 and 96, the
    piece form at 9001 and 16384)."""
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


PIECE_C = 16384


def _piece_same(card, ec, ea, deleted, chars, length, ops, seed, buf_len=256):
    """The text kernel at C = 16384 in its piece form, byte-equal to the
    plain version with and without a run buffer; returns the plain
    outputs with the buffer."""
    rng = np.random.default_rng(seed)
    r, c = ec.shape
    assert cuda_kernels.text_form(c, ops.shape[1]) == "piece"
    args = [torch.from_numpy(x).to(card) for x in (ec, ea, deleted, chars, length, ops)]
    ranks = torch.from_numpy(rng.permutation(8).astype(np.int32)).to(card)
    char_buf = torch.from_numpy(rng.integers(32, 0x10FFFF, (r, buf_len)).astype(np.int32)).to(card)
    first = None
    for buf in (char_buf, None):
        want = K.text_phase_plain(*args, ranks, buf)
        cuda_kernels.reset_launch_counts()
        got = cuda_kernels.text_phase(*args, ranks, buf)
        assert cuda_kernels.LAUNCHES["text_phase"] == cuda_kernels.PIECE_LAUNCHES["text_phase"] == 1
        torch.cuda.synchronize()
        _same(got, want)
        first = first or want
    return first


@pytest.mark.parametrize("shape,r", [("genesis", 13), ("round", 13), ("all_to_all", 13), ("all_to_all", 1)])
def test_piece_kernel_matches_plain_on_the_resident_shapes(card, shape, r):
    """The resident cell's three merges at C = 16384 (``RESIDENT_TEXT_SHAPES``):
    157 runs appended to an empty document (L = 256), a round of 4
    inserts, 5 runs and 42 deletes (L = 64), the all-to-all of 7 inserts,
    23 runs and 259 deletes (L = 512) on a 10,000-char document."""
    b = resident_text_batch(shape, r, 40 + r, capacity=PIECE_C)
    ops = b["text_ops"].numpy()
    assert ops.shape[1] == RESIDENT_TEXT_SHAPES[shape]["num_ops"]
    planes = [b[k].numpy() for k in ("elem_ctr", "elem_act", "deleted", "chars", "length")]
    want = _piece_same(card, *planes, ops, r)
    if shape == "genesis":
        assert (want[5] == 10000).all() and (want[4][:, :10000] == -1).all()
    else:  # deletes landed
        assert (want[2].sum(dim=1) > torch.from_numpy(planes[2].sum(axis=1)).to(card)).all()


@pytest.mark.parametrize("case,r", [
    ("deletes_around_inserts", 13), ("deletes_around_inserts", 1), ("absent_and_head", 13),
    ("duplicates", 13), ("nearly_full", 13), ("lengths", 13),
])
def test_piece_kernel_edge_cases(card, case, r):
    """The twin's rules in the piece form: deletes of elements the batch
    inserts, before and after the insert; absent and HEAD references;
    duplicate ids (the first live match is the reference, a delete takes
    every copy, an insert may repeat a live id); a nearly full document
    (16,300) whose runs push slots past C; empty, negative and past-C
    lengths (nothing is live until the length reaches 1); each with and
    without a run buffer."""
    rng = np.random.default_rng(sum(map(ord, case)) + r)
    num_ops = 128
    if case == "lengths":
        ec, ea, deleted, chars, length = document_planes(rng, r, PIECE_C, 3000)
        length[:] = rng.choice([0, -3, 1, PIECE_C + 100, 2], size=r)
        length[:5] = (0, 0, -3, PIECE_C + 100, 1)
    else:
        n = 16300 if case == "nearly_full" else 3000
        ec, ea, deleted, chars, length = document_planes(rng, r, PIECE_C, n)
    ops = round_text_rows(rng, ec, ea, np.clip(length, 1, 3000), num_ops, 20, 30, 40)
    for i in range(r):
        rows = [l for l in range(num_ops) if ops[i, l, K.K_KIND] in (K.KIND_INSERT, K.KIND_INSERT_RUN)]
        dels = [l for l in range(num_ops) if ops[i, l, K.K_KIND] == K.KIND_DELETE]
        if case == "deletes_around_inserts":
            for d in dels:  # each delete's target: one the batch inserts, earlier or later
                l = rows[rng.integers(0, len(rows))]
                ops[i, d, K.K_REF_CTR] = ops[i, l, K.K_CTR] + rng.integers(0, max(ops[i, l, K.K_RUN_LEN], 1))
                ops[i, d, K.K_REF_ACT] = ops[i, l, K.K_ACT]
        elif case == "absent_and_head":
            for l in rows[::2]:
                ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = (0, 0) if rng.random() < 0.5 else (777777, 2)
        elif case == "duplicates":
            for j in rng.integers(0, length[i], 12):  # copies of the id at slot 7
                ec[i, j], ea[i, j] = ec[i, 7], ea[i, 7]
            for l in rows[::3]:
                ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = ec[i, 7], ea[i, 7]
            for d in dels[::3]:
                ops[i, d, K.K_REF_CTR], ops[i, d, K.K_REF_ACT] = ec[i, 7], ea[i, 7]
            for l in rows[1::4]:  # an insert repeats a live id, and one another insert's
                ops[i, l, K.K_CTR], ops[i, l, K.K_ACT] = ec[i, 11], ea[i, 11]
            ops[i, rows[-1], K.K_CTR], ops[i, rows[-1], K.K_ACT] = ops[i, rows[0], K.K_CTR], ops[i, rows[0], K.K_ACT]
        elif case == "nearly_full":
            for l in rows:  # references near the end, long runs
                j = int(length[i]) - 1 - int(rng.integers(0, 200))
                ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = ec[i, j], ea[i, j]
                if ops[i, l, K.K_KIND] == K.KIND_INSERT_RUN:
                    ops[i, l, K.K_RUN_LEN] = K.MAX_RUN_LEN
        elif case == "lengths" and length[i] < 1:
            if rng.random() < 0.5 and rows:  # the first insert's reference is absent
                ops[i, rows[0], K.K_REF_CTR], ops[i, rows[0], K.K_REF_ACT] = 999999, 3
            ec[i, 0], ea[i, 0] = ops[i, dels[0], K.K_REF_CTR], ops[i, dels[0], K.K_REF_ACT]
    want = _piece_same(card, ec, ea, deleted, chars, length, ops, r + 7)
    if case == "nearly_full":
        assert (want[5] > PIECE_C).all()  # runs went past the end
    if case == "deletes_around_inserts":
        assert (want[2] & (want[4] == -1)).any()  # an inserted element tombstoned


def test_piece_form_falls_back_past_its_table(card):
    """At C = 16384, L = 1024 rows make a piece table past a quarter of an
    SM: the plane form runs, counted in LAUNCHES alone, byte-equal."""
    rng = np.random.default_rng(50)
    r, num_ops = 3, 1024
    assert cuda_kernels.text_form(PIECE_C, num_ops) == "plane"
    ec, ea, deleted, chars, length = document_planes(rng, r, PIECE_C, 9000)
    ops = round_text_rows(rng, ec, ea, length, num_ops, 40, 60, 500)
    args = [torch.from_numpy(x).to(card) for x in (ec, ea, deleted, chars, length, ops)]
    ranks = torch.from_numpy(rng.permutation(8).astype(np.int32)).to(card)
    char_buf = torch.from_numpy(rng.integers(32, 0x10FFFF, (r, 256)).astype(np.int32)).to(card)
    want = K.text_phase_plain(*args, ranks, char_buf)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.text_phase(*args, ranks, char_buf)
    assert cuda_kernels.LAUNCHES["text_phase"] == 1 and cuda_kernels.PIECE_LAUNCHES["text_phase"] == 0
    torch.cuda.synchronize()
    _same(got, want)


def test_piece_form_shared_memory_and_occupancy(card):
    """The library's piece-form footprint equals the wrapper's, and at L <=
    512 the card holds at least four replicas an SM."""
    lib = cuda_kernels._build.load("text_phase")
    lib.pt_text_phase_piece_smem.restype = ctypes.c_size_t
    lib.pt_text_phase_piece_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    for num_ops in (0, 8, 64, 256, 512, 1024):
        assert lib.pt_text_phase_piece_smem(PIECE_C, num_ops) == cuda_kernels.text_piece_smem_bytes(PIECE_C, num_ops)
    for num_ops in (64, 256, 512):
        assert cuda_kernels.text_piece_blocks_per_sm(PIECE_C, num_ops, card) >= 4


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
    big = torch.zeros((1, 262144), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match=r"shared memory.*C <= 131072 fits"):
        cuda_kernels.text_phase(big, big, big.bool(), big, ln[:1], ops[:1], ranks)
    with pytest.raises(ValueError, match=r"shared memory.*C <= 131072 fits"):
        cuda_kernels.mark_phase(
            torch.zeros((1, 2 * 262144), dtype=torch.bool, device=card),
            torch.zeros((1, 2 * 262144, 32), dtype=torch.int32, device=card),
            big, big, ln[:1], ln[:1], ops[:1],
        )


def _fill_first(rng, state, fill):
    """Replica 0 of a ``_random_state`` holds exactly ``fill`` live
    elements, so its held prefix ends where the test wants it."""
    ec, ea, deleted, chars, length, _, _ = state
    c = ec.shape[1]
    length[0] = fill
    ec[0] = 0
    ea[0] = 0
    ec[0, :fill] = rng.permutation(np.arange(1, 4 * c))[:fill]
    ea[0, :fill] = rng.integers(0, 5, size=fill)
    deleted[0] = (rng.random(c) < 0.3) & (np.arange(c) < fill)
    chars[0] = np.where(np.arange(c) < fill, rng.integers(32, 0x10FFFF, c), 0)
    return state


def _near_edge(rng, slices, c, n):
    """A live position within MAX_RUN_LEN + 8 slots of a slice edge of the
    cluster form (or of the document's end), or -1 when none is live."""
    edge = c // slices
    centre = edge * int(rng.integers(1, slices)) if slices > 1 and rng.random() < 0.8 else n
    j = centre + int(rng.integers(-(K.MAX_RUN_LEN + 8), 8))
    return j if 0 <= j < n else -1


def _edge_text_ops(rng, ec, ea, length, num_ops, buf_len, slices):
    """``_text_ops`` aimed at the cluster form's slice edges: most
    references and delete targets near an edge, runs as long as
    MAX_RUN_LEN, and small counters whose skip runs cross one or more
    edges."""
    r, c = ec.shape
    ops = _text_ops(rng, ec, ea, length, num_ops, buf_len)
    for i in range(r):
        for l in range(num_ops):
            kind = ops[i, l, K.K_KIND]
            if kind == K.KIND_PAD or rng.random() < 0.3:
                continue
            j = _near_edge(rng, slices, c, int(length[i]))
            if j >= 0:
                ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = ec[i, j], ea[i, j]
            if kind == K.KIND_INSERT_RUN and rng.random() < 0.5:
                ops[i, l, K.K_RUN_LEN] = K.MAX_RUN_LEN
            if kind != K.KIND_DELETE and rng.random() < 0.25:
                ops[i, l, K.K_CTR] = rng.integers(1, 64)  # most ids after it are greater
    return ops


@pytest.mark.parametrize("r,c,fill,num_ops,seed,delete_runs", [
    (3, 32768, 20000, 200, 20, False),
    (2, 32768, 32700, 300, 21, True),     # nearly full: the last slice's tail falls off
    (2, 65536, 40000, 200, 22, True),
    (2, 131072, 100000, 200, 23, False),
    (2, 131072, 131000, 300, 24, True),   # nearly full at the largest capacity
])
def test_cluster_text_kernel_matches_plain(card, r, c, fill, num_ops, seed, delete_runs):
    """Past C = 16384 the text kernel runs as a cluster of C / 16384
    blocks: byte-equal to its plain version on inputs aimed at the slice
    edges, with and without a run buffer."""
    rng = np.random.default_rng(seed)
    ec, ea, deleted, chars, length, _, _ = _fill_first(rng, _random_state(rng, r, c, 1, fill), fill)
    blocks = cuda_kernels.cluster_size(c, 1)
    assert blocks == c // 16384
    buf_len = 128
    ops = _edge_text_ops(rng, ec, ea, length, num_ops, buf_len, blocks)
    if delete_runs:
        _delete_runs(rng, ec, ea, ops)
    ranks = torch.from_numpy(rng.permutation(8).astype(np.int32)).to(card)
    char_buf = torch.from_numpy(rng.integers(32, 0x10FFFF, (r, buf_len)).astype(np.int32)).to(card)
    args = [torch.from_numpy(x).to(card) for x in (ec, ea, deleted, chars, length, ops)]
    for buf in (char_buf, None):
        want = K.text_phase_plain(*args, ranks, buf)
        cuda_kernels.reset_launch_counts()
        got = cuda_kernels.text_phase(*args, ranks, buf)
        assert cuda_kernels.LAUNCHES["text_phase"] == cuda_kernels.CLUSTER_LAUNCHES["text_phase"] == 1
        torch.cuda.synchronize()
        _same(got, want)
    assert (want[4] == -1).any(dim=1).all()  # every replica took inserts
    active = [n for (name, b, _, _), n in cuda_kernels.ACTIVE_CLUSTERS.items()
              if name == "text_phase" and b == blocks]
    assert active and all(n > 0 for n in active)


def _edge_mark_ops(rng, ec, ea, length, num_ops, slices, last_slice):
    """``_mark_ops`` with most anchors near a slice edge, or, with
    ``last_slice``, every anchor in the cluster's last slice."""
    r, c = ec.shape
    ops = _mark_ops(rng, ec, ea, length, num_ops)
    lo = (slices - 1) * (c // slices)
    for i in range(r):
        n = int(length[i])
        for l in range(num_ops):
            for ctr, act in ((K.K_SCTR, K.K_SACT), (K.K_ECTR, K.K_EACT)):
                if last_slice and n > lo:
                    j = int(rng.integers(lo, n))
                elif rng.random() < 0.7:
                    j = _near_edge(rng, slices, c, n)
                else:
                    continue
                if j >= 0:
                    ops[i, l, ctr], ops[i, l, act] = ec[i, j], ea[i, j]
    return ops


@pytest.mark.parametrize("r,c,words,fill,num_ops,seed,sparse", [
    (2, 32768, 4, 30000, 48, 30, False),
    (2, 65536, 32, 60000, 48, 31, True),
    (2, 131072, 4, 120000, 64, 32, True),
    (2, 131072, 32, 100000, 48, 33, False),
])
def test_cluster_mark_kernel_matches_plain(card, r, c, words, fill, num_ops, seed, sparse):
    """The mark kernel's cluster form, byte-equal to its plain version:
    anchors near the slice edges, a table that overflows (seed 33), and
    with ``sparse`` no defined slot in the middle slices, so a mark whose
    range starts in the last slice carries a boundary from the first."""
    rng = np.random.default_rng(seed)
    ec, ea, _, _, length, bnd_def, bnd_mask = _fill_first(rng, _random_state(rng, r, c, words, fill), fill)
    blocks = cuda_kernels.cluster_size(c, words)
    assert blocks == c // 16384
    edge = c // blocks
    if sparse:
        bnd_def[:, 2 * edge:2 * (blocks - 1) * edge] = False
        bnd_def[:, 2 * (blocks - 1) * edge:] &= rng.random((r, 2 * edge)) < 0.01
    ops = _edge_mark_ops(rng, ec, ea, length, num_ops, blocks, last_slice=sparse)
    counts = np.full(r, 32 * words - 3 if seed == 33 else 0, np.int32)
    args = [torch.from_numpy(x).to(card) for x in (bnd_def, bnd_mask, ec, ea, length, counts, ops)]
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.mark_phase(*args)
    assert cuda_kernels.LAUNCHES["mark_phase"] == cuda_kernels.CLUSTER_LAUNCHES["mark_phase"] == 1
    want = K.mark_phase_plain(*args)
    torch.cuda.synchronize()
    _same(got, want)
    assert not torch.equal(got[1], args[1])
    active = [n for (name, b, _, _), n in cuda_kernels.ACTIVE_CLUSTERS.items()
              if name == "mark_phase" and b == blocks]
    assert active and all(n > 0 for n in active)


def _text_orig_idx(rng, r, c):
    """A text phase's orig_idx: the old positions in order with a tenth of
    the slots new (-1), the tail pushed past C falling off; the last
    replica's sources at random, so a cluster block reads rows from every
    slice."""
    oi = np.empty((r, c), np.int32)
    for i in range(r):
        new = rng.random(c) < 0.1
        oi[i] = np.where(new, -1, np.cumsum(~new) - 1)
    oi[-1] = rng.integers(-1, c, c)
    return oi


def _tail_inputs(card, rng, r, c, words, fill, num_ops, mark_count, slices=1, unaligned=False):
    """A pre-text-phase state on the card (random planes and a random mark
    table), the text phase's ids, orig_idx and length, and mark rows
    anchored on those ids (near the slice edges past one block)."""
    ec, ea, deleted, chars, length, bnd_def, bnd_mask = _fill_first(rng, _random_state(rng, r, c, words, fill), fill)
    m = 32 * words
    table = {name: rng.integers(-1, 1 << 20, (r, m)).astype(np.int32)
             for name in ("mark_ctr", "mark_act", "mark_action", "mark_type", "mark_attr")}
    fields = dict(elem_ctr=ec, elem_act=ea, deleted=deleted, chars=chars, bnd_def=bnd_def, bnd_mask=bnd_mask,
                  length=length, mark_count=np.full(r, mark_count, np.int32), **table)
    st = {f: torch.from_numpy(np.ascontiguousarray(v)).to(card) for f, v in fields.items()}
    if unaligned:  # the planes 4 bytes past a 16-byte boundary: the kernel's word-wise moves
        buf = torch.empty(bnd_mask.size + 1, dtype=torch.int32, device=card)
        st["bnd_mask"] = buf[1:].view(bnd_mask.shape).copy_(st["bnd_mask"])
        assert st["bnd_mask"].data_ptr() % 16 != 0
    ops = _edge_mark_ops(rng, ec, ea, length, num_ops, slices, last_slice=False) if slices > 1 \
        else _mark_ops(rng, ec, ea, length, num_ops)
    text_out = [torch.from_numpy(x).to(card) for x in (ec, ea, _text_orig_idx(rng, r, c), length)]
    return DocState(**st), text_out, torch.from_numpy(ops).to(card)


def _shares_memory(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _held_tail(states, text_out, ops, blocks):
    """``mark_tail`` on the card against its plain version, every field it
    returns; one launch (a cluster launch past one block), and every
    output a tensor of its own."""
    want = K.mark_tail_plain(states, *text_out, ops)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.mark_tail(states, *text_out, ops)
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 1, "digest": 0}
    assert cuda_kernels.CLUSTER_LAUNCHES["mark_phase"] == (blocks > 1)
    torch.cuda.synchronize()
    names = ("bnd_def", "bnd_mask", "mark_ctr", "mark_act", "mark_action", "mark_type", "mark_attr", "mark_count")
    _same([getattr(got, f) for f in names], [getattr(want, f) for f in names])
    for f in names:
        assert not _shares_memory(getattr(got, f), getattr(states, f)), f
    assert not torch.equal(want.bnd_mask, K._permute_boundaries(states.bnd_def, states.bnd_mask, text_out[2])[1])
    return got, want


@pytest.mark.parametrize("r,c,words,fill,num_ops,count,unaligned", [
    (3, 37, 1, 30, 40, 29, False),      # odd plane, one-word rows; the table overflows
    (4, 600, 4, 500, 64, 0, False),     # 16-byte rows
    (4, 600, 4, 500, 64, 3, True),      # ... not on a 16-byte boundary
    (2, 2048, 32, 1800, 48, 1021, False),  # 128-byte rows, the table overflows
    (2, 16384, 32, 12000, 48, 5, False),
])
def test_mark_tail_matches_plain(card, r, c, words, fill, num_ops, count, unaligned):
    """The merge's tail in one launch (gather through orig_idx, marks,
    table append) byte-equal to ``mark_tail_plain`` in one block."""
    rng = np.random.default_rng(c + words)
    inputs = _tail_inputs(card, rng, r, c, words, fill, num_ops, count, unaligned=unaligned)
    assert cuda_kernels.cluster_size(c, words) == 1
    got, _ = _held_tail(*inputs, blocks=1)
    if count + num_ops > 32 * words:
        assert (got.mark_count > 32 * words).any()


@pytest.mark.parametrize("r,c,words,fill,num_ops,count", [
    (2, 32768, 4, 30000, 48, 0),
    (2, 65536, 32, 60000, 48, 7),
    (2, 131072, 4, 120000, 64, 0),
    (2, 131072, 32, 100000, 48, 1021),  # the table overflows
])
def test_cluster_mark_tail_matches_plain(card, r, c, words, fill, num_ops, count):
    """The tail's cluster form: each block gathers its slots from every
    slice of the input plane, and only rank 0 writes the table."""
    rng = np.random.default_rng(c + words + 1)
    blocks = cuda_kernels.cluster_size(c, words)
    assert blocks == c // 16384
    _held_tail(*_tail_inputs(card, rng, r, c, words, fill, num_ops, count, slices=blocks), blocks=blocks)


def test_mark_tail_refuses_to_gather_in_place(card):
    """A gather cannot run in place: the C entry point refuses an output
    plane on its input's memory.  The wrapper allocates every output
    afresh, so it never passes one, and it raises for a mix of devices."""
    states, text_out, ops = _tail_inputs(card, np.random.default_rng(5), 2, 256, 4, 200, 16, 0)
    with pytest.raises(ValueError, match="several devices"):
        cuda_kernels.mark_tail(states, *text_out, ops.cpu())
    ec, ea, oi, ln = text_out
    table = [getattr(states, name).data_ptr() for name, _ in K._TABLE_FIELDS]
    fresh = [torch.empty_like(getattr(states, name)).data_ptr() for name, _ in K._TABLE_FIELDS]
    fn = cuda_kernels._fn("mark_phase", "pt_mark_tail")
    for def_out, mask_out in ((torch.empty_like(states.bnd_def), states.bnd_mask),
                              (states.bnd_def, torch.empty_like(states.bnd_mask))):
        err = fn(states.bnd_def.data_ptr(), states.bnd_mask.data_ptr(), ec.data_ptr(), ea.data_ptr(),
                 ln.data_ptr(), states.mark_count.data_ptr(), ops.data_ptr(), ops.shape[1], oi.data_ptr(),
                 *table, def_out.data_ptr(), mask_out.data_ptr(), *fresh,
                 torch.empty_like(states.mark_count).data_ptr(), 2, 256, 4, 128, 1,
                 torch.cuda.current_stream().cuda_stream)
        assert err != 0
    torch.cuda.synchronize()


def test_mark_tail_with_an_empty_table(card):
    """M = 0: no mask words and no table columns; the gather still moves
    the definedness bytes and mark_count comes back as it went in."""
    rng = np.random.default_rng(9)
    states, text_out, ops = _tail_inputs(card, rng, 3, 256, 0, 200, 16, 4)
    ops[..., K.K_KIND] = K.KIND_PAD
    want = K.mark_tail_plain(states, *text_out, ops)
    got = cuda_kernels.mark_tail(states, *text_out, ops)
    torch.cuda.synchronize()
    _same([got.bnd_def, got.bnd_mask, got.mark_count], [want.bnd_def, want.bnd_mask, want.mark_count])
    assert torch.equal(got.mark_count, states.mark_count)
    assert not torch.equal(got.bnd_def, states.bnd_def)


def test_merge_step_full_is_two_launches_on_the_card(card):
    """``merge_step_full`` launches the text kernel and the tail once each
    and equals ``merge_step_plain`` on every field."""
    b = build_device_batch(make_merge_workload(300, 24, 4, True, seed=3), 8, 512, 64, device=card)
    args = (b["states"], b["text_ops"], b["mark_ops"], b["ranks"], b["char_buf"])
    want = K.merge_step_plain(*args)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.merge_step_full(*args)
    assert cuda_kernels.LAUNCHES == {"text_phase": 1, "mark_phase": 1, "digest": 0}
    torch.cuda.synchronize()
    _same([getattr(got, f) for f in FIELDS], [getattr(want, f) for f in FIELDS])


def test_universe_on_the_card_grows_past_8192(card, monkeypatch):
    """Two replicas ingest an 8300-char genesis, one round of two concurrent
    writers each and then each other's round on the scan path: the
    universe re-buckets from C = 8192 to 16384, both kernels run there, and
    the result is the oracle's."""
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "scan")
    wl = make_writer_rounds(doc_len=8300, ops_per_round=32, num_writers=2, rounds=1, seed=3)
    (w0, w1), = wl["rounds"]
    uni = TorchUniverse(["a", "b"], capacity=8192, max_mark_ops=64, device=card)
    cuda_kernels.reset_launch_counts()
    uni.apply_changes([[wl["genesis"]], [wl["genesis"]]])
    uni.apply_changes([w0, w1])
    uni.apply_changes([w1, w0])
    assert uni.capacity == 16384 and uni.stats["capacity_growths"] >= 1
    assert cuda_kernels.LAUNCHES == {"text_phase": 3, "mark_phase": 3, "digest": 0}
    assert uni.stats["launches"] == 3
    oracle = Doc("oracle")
    for c in [wl["genesis"], *w0, *w1]:
        oracle.apply_change(c)
    expect = oracle.get_text_with_formatting(["text"])
    assert max(uni.lengths) > 8192
    assert uni.texts() == ["".join(s["text"] for s in expect)] * 2
    assert uni.spans_batch() == [expect, expect]
    assert len(set(uni.digests().tolist())) == 1


@pytest.mark.parametrize("window", ["1", "0"])
def test_sorted_universe_on_the_card_equals_the_scan_path(card, monkeypatch, window):
    """At C = 4096, eight replicas follow four writers editing 128-char
    hotspots of a 3000-char document for three rounds, then merge all to
    all.  The sorted route (PERITEXT_MERGE_PATH=sorted, windowed unless
    PERITEXT_MERGE_WINDOW=0) gives the default scan path's states field by
    field and the writers' and the oracle's spans; it launches a merge
    kernel only for a counted scan fallback."""
    for var in ("PERITEXT_SORTED_CHUNK", "PERITEXT_PATCH_CHUNK", "PERITEXT_MERGE_WINDOW_MIN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", window)
    wl = make_writer_rounds(doc_len=3000, ops_per_round=32, num_writers=4, rounds=3, seed=5, locality=128)
    names = [f"r{i}" for i in range(8)]
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(4)]
    steps = [[[wl["genesis"]]] * 8] + [[rnd[i % 4] for i in range(8)] for rnd in wl["rounds"]]
    a2a = [[c for w in range(4) if w != i % 4 for c in history[w]] for i in range(8)]
    unis = {}
    for path in ("scan", "sorted"):
        if path == "scan":
            monkeypatch.delenv("PERITEXT_MERGE_PATH", raising=False)
        else:
            monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
        uni = unis[path] = TorchUniverse(names, capacity=4096, max_mark_ops=256, device=card)
        cuda_kernels.reset_launch_counts()
        for batch in steps:
            uni.apply_changes(batch)
        if path == "sorted":
            assert uni.stats["windowed_launches"] >= (1 if window == "1" else 0)
            for r in range(8):
                assert uni.spans(r) == wl["writers"][r % 4].get_text_with_formatting(["text"])
        uni.apply_changes(a2a)
        n = uni.stats["scan_fallbacks"] if path == "sorted" else uni.stats["launches"]
        assert cuda_kernels.LAUNCHES == {"text_phase": n, "mark_phase": n, "digest": 0}
    a, b = state_to_numpy(unis["scan"].states), state_to_numpy(unis["sorted"].states)
    assert all((a[f] == b[f]).all() for f in a)
    oracle = Doc("oracle")
    for c in [wl["genesis"], *(c for h in history for c in h)]:
        oracle.apply_change(c)
    assert unis["sorted"].spans_batch() == [oracle.get_text_with_formatting(["text"])] * 8
    assert unis["sorted"].states.elem_ctr.device.type == "cuda"


@pytest.mark.parametrize("readback", ["compact", "planes"])
def test_patch_records_on_the_card_equal_the_cpus(card, readback):
    """Six replicas hold the genesis plus writer (r + 1) % 4's stream and
    take writer r % 4's as unfused op rows: the per-op patch loop gives the
    same records and states from CUDA tensors as from CPU tensors."""
    wl = make_merge_workload(60, 20, 4, True, seed=4)
    actors, attrs = ActorRegistry(), AttrRegistry()
    text_obj = wl["genesis"]["ops"][0]["opId"]
    g_rows, _, _ = encode_changes([wl["genesis"]], actors, attrs)
    streams = [encode_changes(s, actors, attrs, text_obj=text_obj)[0] for s in wl["streams"]]
    ranks = np.zeros(64, np.int32)
    ranks[: len(actors.ranks())] = actors.ranks()
    pad = max(s.shape[0] for s in streams)
    first = np.stack([np.concatenate([g_rows, pad_rows(streams[(r + 1) % 4], pad)]) for r in range(6)])
    empty = map_state(lambda x: x.expand(6, *x.shape).contiguous(), make_empty_state(256, 64, device="cpu"))
    base = K.apply_ops(empty, torch.from_numpy(first), torch.from_numpy(ranks))
    ops = torch.from_numpy(np.stack([pad_rows(streams[r % 4], pad) for r in range(6)]))
    multi = torch.from_numpy(allow_multiple_array())
    want_state, want = K.apply_ops_patched(base, ops, torch.from_numpy(ranks), multi, readback=readback)
    got_state, got = K.apply_ops_patched(
        map_state(lambda x: x.to(card), base), ops.to(card), torch.from_numpy(ranks).to(card),
        multi.to(card), readback=readback,
    )
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name].cpu(), want[name]), f"record {name} differs on the card"
    a, b = state_to_numpy(got_state), state_to_numpy(want_state)
    assert all((a[f] == b[f]).all() for f in a)
    assert got_state.elem_ctr.device.type == "cuda"


def test_torchdoc_session_on_the_card_equals_the_oracle(card):
    """Two TorchDocs on the card and an oracle Doc make 40 random edits
    with marks, syncing every 5: every change and every applied change
    returns the oracle twin's patches, and the docs converge."""
    genesis, _ = Doc("author").change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("collaborative text on a card")},
    ])
    docs = [TorchDoc("t1", device=card), TorchDoc("t2", device=card), Doc("o1")]
    out = doc_session(docs, genesis, edits=40, sync_every=5, seed=2)
    assert any(span["marks"] for span in out["spans"])
    assert docs[0]._uni.states.elem_ctr.device.type == "cuda"


def test_served_cohort_with_an_injected_retry_on_the_card(card):
    """A ServePlane over a universe on the card flushes one cohort of four
    sessions while a ``device_readback`` fault fails the first attempt
    after its loop ran: one retry, and every session's patches and all 13
    fields equal a fault-free universe's on the CPU."""
    from peritext_tpu_torch.runtime import ServePlane, faults

    wl = make_writer_rounds(80, 12, 2, 2, True, seed=9)
    names = [f"r{i}" for i in range(4)]
    unis = {d: TorchUniverse(names, capacity=256, device=d) for d in (card, "cpu")}
    for u in unis.values():
        u.apply_changes([[wl["genesis"]]] * 4)
    want = unis["cpu"].apply_changes_with_patches(
        [wl["rounds"][0][i % 2] + wl["rounds"][1][i % 2] for i in range(4)]
    )
    plane = ServePlane(unis[card], start=False, batch_target=1024)
    sessions = [plane.session(f"s{i}", replica=n, record_stream=True) for i, n in enumerate(names)]
    for i, s in enumerate(sessions):
        for rnd in wl["rounds"]:
            s.submit(rnd[i % 2])
    faults.reset()
    try:
        with faults.injected("device_readback:fail=1") as plan:
            assert plane.drain() == 0
    finally:
        faults.reset()
    assert plan.stats["device_readback"]["failed"] == 1
    assert plane.stats["flushes"] == 1 and unis[card].stats["launch_retries"] == 1
    assert [s.patch_log for s in sessions] == [want[n] for n in names]
    a, b = state_to_numpy(unis[card].states), state_to_numpy(unis["cpu"].states)
    assert all((a[f] == b[f]).all() for f in a)
    assert unis[card].states.elem_ctr.device.type == "cuda"


def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """save_universe / load_universe of a universe on the card (it loads
    onto the card), a row exported from it imported on the CPU, and
    resume_universe replaying a log tail through the kernels: all equal."""
    from peritext_tpu_torch.runtime import ChangeLog
    from peritext_tpu_torch.runtime import checkpoint as ckpt

    wl = make_writer_rounds(300, 16, 2, 3, True, seed=10)
    names = ["a", "b"]
    uni = TorchUniverse(names, capacity=512, device=card)
    log = ChangeLog()
    log.record(wl["genesis"])
    uni.apply_changes([[wl["genesis"]]] * 2)
    for k, rnd in enumerate(wl["rounds"]):
        for c in rnd[0] + rnd[1]:
            log.record(c)
        if k < 2:
            uni.apply_changes([rnd[0], rnd[1]])
    path = str(tmp_path / "snap")
    ckpt.save_universe(uni, path)
    loaded = ckpt.load_universe(path)
    assert loaded.states.elem_ctr.device.type == "cuda"
    a, b = state_to_numpy(loaded.states), state_to_numpy(uni.states)
    assert all(a[f].dtype == b[f].dtype and (a[f] == b[f]).all() for f in a)
    assert loaded.spans_batch() == uni.spans_batch()
    cpu = TorchUniverse(["x"], capacity=512, device="cpu")
    ckpt.import_replica(cpu, "x", ckpt.export_replica(uni, "b"))
    assert cpu.digests()[0] == uni.digests()[1] and cpu.spans("x") == uni.spans("b")
    cuda_kernels.reset_launch_counts()
    resumed = ckpt.resume_universe(path, log)
    assert cuda_kernels.LAUNCHES == {"text_phase": 1, "mark_phase": 1, "digest": 0}
    uni.apply_changes({n: log.missing_changes(log.clock(), uni.clock(n)) for n in names})
    a, b = state_to_numpy(resumed.states), state_to_numpy(uni.states)
    assert all((a[f] == b[f]).all() for f in a)
    assert len(set(resumed.digests().tolist())) == 1


@pytest.mark.parametrize("failure", ["launch", "build", "breaker"])
def test_failing_kernel_on_the_card_raises_instead_of_degrading(card, monkeypatch, tmp_path, failure):
    """With ``PERITEXT_DEGRADE`` unset, a universe on the card never moves a
    batch to the oracle: a kernel launch that keeps returning an error is
    retried to the budget and ends in ``DeviceLaunchError``; a kernel that
    does not build raises ``KernelBuildError`` at once, with no retry; and
    a plane under ``on_open="degrade"`` with the breaker open fails its
    cohort with ``DeviceLaunchError``.  Nothing is committed."""
    from peritext_tpu_torch.ops import _build
    from peritext_tpu_torch.ops.universe import DeviceLaunchError
    from peritext_tpu_torch.runtime import ServePlane, health

    monkeypatch.delenv("PERITEXT_DEGRADE", raising=False)
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "2")
    monkeypatch.setenv("PERITEXT_LAUNCH_BACKOFF", "0.001")
    wl = make_writer_rounds(80, 12, 2, 1, True, seed=4)
    uni = TorchUniverse(["a", "b"], capacity=256, device=card)
    uni.apply_changes([[wl["genesis"]]] * 2)
    before, clocks = state_to_numpy(uni.states), [dict(c) for c in uni.clocks]
    batch = [wl["rounds"][0][0], wl["rounds"][0][1]]
    calls = []
    if failure == "launch":
        def failing(*args):
            calls.append(1)
            return 1  # cudaErrorInvalidValue, as the library returns an error

        monkeypatch.setitem(cuda_kernels._fns, "pt_text_phase", failing)
        with pytest.raises(DeviceLaunchError) as excinfo:
            uni.apply_changes(batch)
        assert "text_phase kernel launch failed" in str(excinfo.value.cause)
        assert len(calls) == 3 and uni.stats["launch_retries"] == 2
    elif failure == "build":
        monkeypatch.setenv("NVCC", "false")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_loaded", {})
        monkeypatch.setattr(cuda_kernels, "_fns", {})
        with pytest.raises(_build.KernelBuildError):
            uni.apply_changes(batch)
        assert uni.stats["launch_retries"] == 0
    else:
        plane = ServePlane(uni, start=False, on_open="degrade")
        subs = [plane.session(n, replica=n).submit(c) for n, c in zip(["a", "b"], batch)]
        with health.guarded("device_launch:threshold=1,cooldown=600"):
            health.breaker("device_launch").record_failure()
            with pytest.raises(DeviceLaunchError):
                plane.drain()
        plane.close()
        for sub in subs:
            with pytest.raises(DeviceLaunchError):
                sub.result(timeout=1.0)
        assert uni.stats["fastfails"] == 1
    assert uni.stats["degraded_batches"] == 0
    after = state_to_numpy(uni.states)
    assert all((after[f] == before[f]).all() for f in before)
    assert [dict(c) for c in uni.clocks] == clocks


def test_capacity_route_on_the_card_grows_past_16384(card, monkeypatch):
    """Four replicas at C = 16384 take a 16,300-char genesis through both
    kernels, then runs that push the document past 16384: every later
    merge runs both kernels' cluster form (no capacity route), and the
    states equal the same merges on the CPU.  Under a limit lowered to
    16384 the same merges take the capacity route (counted, no kernel
    launch, no ValueError) and give the same states."""
    for var in ("PERITEXT_MERGE_PATH", "PERITEXT_SORTED_MAX_ROUNDS", "PERITEXT_MERGE_WINDOW"):
        monkeypatch.delenv(var, raising=False)
    hist = wire_rounds(16_300, 2, 2, 128, seed=5)
    history = [[c for rnd in hist["rounds"] for c in rnd[w]] for w in range(2)]
    steps = [[[hist["genesis"]]] * 4] + [[rnd[i % 2] for i in range(4)] for rnd in hist["rounds"]]
    steps.append([history[1 - i % 2] for i in range(4)])

    def run(device):
        uni = TorchUniverse([f"r{i}" for i in range(4)], capacity=16384, max_mark_ops=256, device=device)
        for batch in steps:
            uni.apply_changes(batch)
        return uni

    on_cpu = state_to_numpy(run("cpu").states)
    cuda_kernels.reset_launch_counts()
    on_card = run(card)
    assert on_card.capacity == 32768
    assert on_card.stats["capacity_routes"] == 0
    assert cuda_kernels.LAUNCHES == {"text_phase": len(steps), "mark_phase": len(steps), "digest": 0}
    assert cuda_kernels.CLUSTER_LAUNCHES == {"text_phase": len(steps) - 1, "mark_phase": len(steps) - 1}
    a = state_to_numpy(on_card.states)
    assert all((a[f] == on_cpu[f]).all() for f in a)
    assert len(set(on_card.digests().tolist())) == 1

    monkeypatch.setattr(port_universe, "kernel_capacity_limit", lambda words: 16384)
    cuda_kernels.reset_launch_counts()
    routed = run(card)
    assert routed.stats["capacity_routes"] == len(steps) - 1
    assert cuda_kernels.LAUNCHES == {"text_phase": 1, "mark_phase": 1, "digest": 0}
    assert cuda_kernels.CLUSTER_LAUNCHES == {"text_phase": 0, "mark_phase": 0}
    b = state_to_numpy(routed.states)
    assert all((b[f] == on_cpu[f]).all() for f in b)


@pytest.mark.parametrize("window", ["1", "0"])
def test_patched_sorted_route_on_the_card_equals_the_per_op_loop(card, monkeypatch, window):
    """64 replicas at C = 2048 load a 1000-char genesis (hotspot edits) and
    round 1 through the kernels, then take rounds 2-3 with patches: the
    patched sorted route (windowed unless PERITEXT_MERGE_WINDOW=0) gives
    the per-op loop's streams, with and without positions, and its states,
    and launches no kernel."""
    for var in ("PERITEXT_PATCH_PATH", "PERITEXT_PATCH_CHUNK", "PERITEXT_SORTED_CHUNK",
                "PERITEXT_MERGE_WINDOW_MIN", "PERITEXT_MERGE_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", window)
    wl = make_writer_rounds(doc_len=1000, ops_per_round=32, num_writers=4, rounds=3, seed=6, locality=128)
    names = [f"r{i}" for i in range(64)]
    runs = {}
    for route in ("scan", "sorted"):
        monkeypatch.delenv("PERITEXT_MERGE_PATH", raising=False)
        uni = TorchUniverse(names, capacity=2048, max_mark_ops=256, device=card)
        uni.apply_changes([[wl["genesis"]]] * 64)
        uni.apply_changes([wl["rounds"][0][i % 4] for i in range(64)])
        if route == "sorted":
            monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
        cuda_kernels.reset_launch_counts()
        outs = [uni.apply_changes_with_patches([rnd[i % 4] for i in range(64)], with_positions=k == 0)
                for k, rnd in enumerate(wl["rounds"][1:])]
        assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0, "digest": 0}
        runs[route] = (uni, outs)
    (scan, want), (srt, got) = runs["scan"], runs["sorted"]
    assert got == want
    if window == "1":
        # A windowed call from a cold start leaves no cache (as in JAX).
        assert srt.stats["windowed_launches"] >= 1
    else:
        assert srt._wcaches is not None and srt._wcaches.device.type == "cuda"
    a, b = state_to_numpy(scan.states), state_to_numpy(srt.states)
    assert all((a[f] == b[f]).all() for f in a)
    for r in range(4):
        assert srt.spans(r) == wl["writers"][r].get_text_with_formatting(["text"])


def _sharded_run(devices, store):
    """A manual sharded plane: a two-session doc group and two lone
    sessions over 2 shards; one session migrates, one is evicted and
    hydrates on its next submit.  Returns each session's stream."""
    from peritext_tpu_torch.runtime import DocLifecycle, ShardedServePlane, migrate_session

    wl = make_writer_rounds(120, 16, 2, 3, True, seed=12)
    plane = ShardedServePlane(2, start=False, capacity=256, devices=devices)
    lc = DocLifecycle(plane, directory=str(store), start=False)
    group = [plane.session(f"g{w}", replica=f"g{w}", doc="doc", record_stream=True) for w in range(2)]
    lone = [plane.session(f"l{w}", replica=f"l{w}", record_stream=True) for w in range(2)]
    for sessions in (group, lone):
        sessions[0].submit([wl["genesis"]])
    lone[1].submit([wl["genesis"]])
    for k, rnd in enumerate(wl["rounds"]):
        for w in range(2):
            group[w].submit(rnd[w])
            lone[w].submit(rnd[w])
        assert plane.drain() == 0
        if k == 0:
            migrate_session(plane, "g0", 1 - group[0].shard)
            lc.evict("l1")
    plane.anti_entropy()
    assert plane.drain() == 0
    assert lc.stats["hydrations"] == 1
    streams = [s.patch_log for s in group + lone]
    spans = [plane.spans(s.replica) for s in group + lone]
    plane.close()
    return plane, streams, spans


def test_sharded_plane_on_the_card_equals_the_cpus(card, tmp_path):
    """ShardedServePlane with devices=None puts every shard on the card;
    with a migration and an evict/hydrate round trip, every stream and
    spans equal the same run with devices=["cpu"]."""
    plane, streams, spans = _sharded_run(None, tmp_path / "card")
    assert all(s.universe.device.type == "cuda" for s in plane.shards)
    _, want_streams, want_spans = _sharded_run(["cpu"], tmp_path / "cpu")
    assert streams == want_streams and spans == want_spans
    assert spans[0] == spans[1]


def test_kernel_launches_from_threads_count_and_land_on_the_card(card):
    """Two threads merge into two universes on the card at once (as the
    scheduler threads of a sharded plane may): every launch counts, and
    the states equal the same merges on the CPU."""
    import threading

    wl = make_writer_rounds(200, 16, 2, 4, True, seed=13)

    def run(uni):
        uni.apply_changes([[wl["genesis"]]] * 2)
        for rnd in wl["rounds"]:
            uni.apply_changes([rnd[0], rnd[1]])

    unis = [TorchUniverse(["a", "b"], capacity=512, device=card) for _ in range(2)]
    cuda_kernels.reset_launch_counts()
    threads = [threading.Thread(target=run, args=(u,)) for u in unis]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    merges = sum(u.stats["launches"] for u in unis)
    assert merges == 2 * (1 + len(wl["rounds"]))
    assert cuda_kernels.LAUNCHES == {"text_phase": merges, "mark_phase": merges, "digest": 0}
    cpu = TorchUniverse(["a", "b"], capacity=512, device="cpu")
    run(cpu)
    want = state_to_numpy(cpu.states)
    for u in unis:
        got = state_to_numpy(u.states)
        assert all((got[f] == want[f]).all() for f in want)


def _stream_population(replicas, capacity, max_marks, seed):
    """A ``make_merge_workload`` batch of 4 streams tiled over ``replicas``,
    as host numpy (the stream's inputs)."""
    from peritext_tpu_torch.ops.encode import prepare_sorted_batch

    wl = make_merge_workload(doc_len=300, ops_per_merge=32, num_streams=4, with_marks=True, seed=seed)
    from peritext_tpu_torch.bench.workloads import build_device_batch

    batch = build_device_batch(wl, replicas, capacity, max_marks)
    sp = prepare_sorted_batch([batch["text_ops"][r].numpy() for r in range(replicas)])
    return (state_to_numpy(batch["states"]), sp["text"], sp["rounds"], sp["num_rounds"],
            batch["mark_ops"].numpy(), batch["ranks"].numpy(), sp["bufs"], sp["maxk"])


def test_stream_at_depth_two_equals_the_resident_kernel_merge(card):
    """Cohorts of 24 over 100 replicas (a padded tail), two in flight on
    the copy, compute and D2H streams, give the resident merge_step_full's
    fields and digests byte for byte (and it merge_step_plain's), and
    launch each kernel once a cohort."""
    from peritext_tpu_torch.ops.state import state_from_numpy
    from peritext_tpu_torch.parallel import stream_merge_sorted

    args = _stream_population(100, 1024, 64, seed=12)
    st = state_from_numpy(args[0], device=card)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    ranks = to(args[5])
    resident = cuda_kernels.merge_step_full(st, to(args[1]), to(args[4]), ranks, to(args[6]))
    want_dg = K.convergence_digest(resident, ranks, to(allow_multiple_array())).cpu().numpy()
    want = state_to_numpy(resident)
    plain = state_to_numpy(K.merge_step_plain(st, to(args[1]), to(args[4]), ranks, to(args[6])))
    for f in want:
        np.testing.assert_array_equal(plain[f], want[f], err_msg=f"{f}: kernels vs merge_step_plain")
    cuda_kernels.reset_launch_counts()
    out, dg, stats = stream_merge_sorted(*args, cohort=24, depth=2, device=card)
    assert stats["route"] == "kernels" and stats["n_cohorts"] == 5 and stats["padded_tail"]
    assert cuda_kernels.LAUNCHES == {"text_phase": 5, "mark_phase": 5, "digest": 5}
    np.testing.assert_array_equal(dg, want_dg.astype(np.uint32))
    for f in want:
        assert out[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(out[f], want[f], err_msg=f)
    assert all(t["merge_ms"] > 0 and t["h2d_ms"] > 0 for t in stats["timings"])


def test_stream_past_16384_runs_the_cluster_kernels(card):
    """At C = 32768 the stream takes the kernels, whose cluster form runs
    once a cohort, and equals one resident ``merge_step_full`` and
    ``merge_step_plain`` byte for byte, digests included."""
    from peritext_tpu_torch.ops.state import state_from_numpy
    from peritext_tpu_torch.parallel import stream_merge_sorted

    args = _stream_population(40, 32768, 64, seed=13)
    st = state_from_numpy(args[0], device=card)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    ranks = to(args[5])
    resident = cuda_kernels.merge_step_full(st, to(args[1]), to(args[4]), ranks, to(args[6]))
    want_dg = K.convergence_digest(resident, ranks, to(allow_multiple_array())).cpu().numpy()
    want = state_to_numpy(resident)
    plain = state_to_numpy(K.merge_step_plain(st, to(args[1]), to(args[4]), ranks, to(args[6])))
    for f in want:
        np.testing.assert_array_equal(plain[f], want[f], err_msg=f"{f}: kernels vs merge_step_plain")
    cuda_kernels.reset_launch_counts()
    out, dg, stats = stream_merge_sorted(*args, cohort=16, depth=2, device=card)
    assert stats["route"] == "kernels" and stats["capacity_routes"] == 0 and stats["n_cohorts"] == 3
    assert cuda_kernels.LAUNCHES == {"text_phase": 3, "mark_phase": 3, "digest": 3}
    assert cuda_kernels.CLUSTER_LAUNCHES == {"text_phase": 3, "mark_phase": 3}
    np.testing.assert_array_equal(dg, want_dg.astype(np.uint32))
    for f in want:
        np.testing.assert_array_equal(out[f], want[f], err_msg=f)


def test_stream_whose_kernel_launch_fails_raises_and_leaves_no_lane_open(card, monkeypatch, tmp_path):
    """The text kernel's C entry returns an error on the third cohort: the
    sweep raises the launch error (no retry, no fallback), and every
    cohort lane in the trace ends."""
    import json
    import pathlib
    import subprocess
    import sys

    from peritext_tpu_torch.parallel import stream_merge_sorted
    from peritext_tpu_torch.runtime import telemetry

    args = _stream_population(40, 512, 64, seed=13)
    cuda_kernels._fn("text_phase", "pt_text_phase")  # build and bind first
    real = cuda_kernels._fns["pt_text_phase"]
    calls = []

    def failing(*a):
        calls.append(1)
        return 1 if len(calls) == 3 else real(*a)

    monkeypatch.setitem(cuda_kernels._fns, "pt_text_phase", failing)
    trace = tmp_path / "trace.jsonl"
    telemetry.reset()
    telemetry.enable(trace=str(trace))
    try:
        with pytest.raises(RuntimeError, match="text_phase kernel launch failed"):
            stream_merge_sorted(*args, cohort=8, depth=2, readback_states=False, device=card)
        telemetry.flush_trace()
    finally:
        telemetry.reset()
    assert len(calls) == 3
    names = {json.loads(line).get("name") for line in trace.read_text().splitlines() if line.strip()}
    assert {"stream.launch", "stream.drain", "stream.abort"} <= names
    report = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "trace_report.py"
    proc = subprocess.run([sys.executable, str(report), str(trace)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "problems=0" in proc.stdout, proc.stdout + proc.stderr


def test_stream_records_its_host_waits_on_the_card(card):
    """Each cohort's host waits (the slot's previous H2D before staging,
    the D2H before the drain reads) are ``stream.wait`` spans."""
    from peritext_tpu_torch.parallel import stream_merge_sorted
    from peritext_tpu_torch.runtime import telemetry

    args = _stream_population(40, 512, 64, seed=13)
    telemetry.reset()
    telemetry.enable()
    try:
        _, _, stats = stream_merge_sorted(*args, cohort=16, depth=2, readback_states=False, device=card)
        waits = telemetry.snapshot()["histograms"]["span.stream.wait.seconds"]
    finally:
        telemetry.reset()
    assert stats["n_cohorts"] == 3 and waits["count"] >= 3


def _append_with_nonzero(states, mark_ops):
    """The mark-table append as it was before it became sync-free
    (``nonzero`` picks the rows), kept as the reference."""
    import dataclasses

    is_mark = mark_ops[:, :, K.K_KIND] == K.KIND_MARK
    order = torch.cumsum(is_mark.to(torch.int32), dim=1) - 1
    idx = states.mark_count[:, None] + order
    rr, ll = (is_mark & (idx < states.max_mark_ops)).nonzero(as_tuple=True)
    cols = idx[rr, ll].long()
    updates = {}
    for name, field in K._TABLE_FIELDS:
        col = getattr(states, name).clone()
        col[rr, cols] = mark_ops[rr, ll, field]
        updates[name] = col
    updates["mark_count"] = (states.mark_count + is_mark.sum(dim=1)).to(torch.int32)
    return dataclasses.replace(states, **updates)


def _winners_with_unique(states, present, ranks, multi):
    """The winner resolution as it was before it became sync-free
    (``torch.unique`` numbers the groups), kept as the reference."""
    mp = present.shape[-1]
    mtype = states.mark_type[:, :mp].long()
    attr = states.mark_attr[:, :mp].long()
    is_multi = multi.to(torch.bool)[mtype.clamp(0, multi.shape[0] - 1)]
    n_attr = int(attr.max().item()) + 2 if attr.numel() else 1
    gkey = mtype * n_attr + torch.where(is_multi, attr + 1, 0)
    _, group = torch.unique(gkey, return_inverse=True)
    n_groups = int(group.max().item()) + 1 if group.numel() else 1
    rank = K._gather_clamped(ranks, states.mark_act[:, :mp].reshape(-1)).reshape(mtype.shape)
    key = states.mark_ctr[:, :mp].long() * (ranks.shape[0] + 1) + rank.long()
    m_live = torch.arange(mp, device=present.device)[None, :] < states.mark_count[:, None]
    cand = present & m_live[:, None, :]
    vals = torch.where(cand, key[:, None, :], -1)
    best = torch.full(present.shape[:2] + (n_groups,), -1, dtype=torch.int64, device=present.device)
    idx = group[:, None, :].expand_as(vals)
    best.scatter_reduce_(2, idx, vals, reduce="amax")
    return cand & (torch.gather(best, 2, idx) == key[:, None, :])


def test_sync_free_append_and_digest_equal_the_old_forms(card, monkeypatch):
    """On the card the masked-scatter append equals the ``nonzero`` append
    (a table that overflows included), and the digest with first-match
    groups, with and without a host-known column bound, equals the digest
    through ``torch.unique``."""
    rng = np.random.default_rng(21)
    r, c, m = 16, 256, 64
    ec, ea, dl, ch, ln, bdef, bmask = _random_state(rng, r, c, m // 32, fill=200)
    st = make_empty_state(c, m, card)
    st = map_state(lambda x: x.unsqueeze(0).expand(r, *x.shape).contiguous(), st)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    import dataclasses

    counts = rng.integers(0, m, size=r).astype(np.int32)
    counts[:3] = [m - 2, m, 0]
    st = dataclasses.replace(
        st, elem_ctr=to(ec), elem_act=to(ea), deleted=to(dl), chars=to(ch), length=to(ln),
        bnd_def=to(bdef), bnd_mask=to(bmask), mark_count=to(counts),
        mark_ctr=to(rng.integers(1, 500, (r, m)).astype(np.int32)),
        mark_act=to(rng.integers(0, 4, (r, m)).astype(np.int32)),
        mark_action=to(rng.integers(0, 2, (r, m)).astype(np.int32)),
        mark_type=to(rng.integers(0, 4, (r, m)).astype(np.int32)),
        mark_attr=to(rng.integers(-1, 3, (r, m)).astype(np.int32)),
    )
    ops = np.zeros((r, 12, K.OP_FIELDS), np.int32)
    ops[:, :, K.K_KIND] = np.where(rng.random((r, 12)) < 0.7, K.KIND_MARK, K.KIND_PAD)
    for f in (K.K_CTR, K.K_ACT, K.K_MACTION, K.K_MTYPE, K.K_MATTR):
        ops[:, :, f] = rng.integers(0, 4, (r, 12))
    got, want = K.append_mark_table(st, to(ops)), _append_with_nonzero(st, to(ops))
    for f in ("mark_ctr", "mark_act", "mark_action", "mark_type", "mark_attr", "mark_count"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    ranks, multi = to(np.array([0, 3, 1, 2], np.int32)), to(allow_multiple_array())
    new = K.convergence_digest(want, ranks, multi)
    bounded = K.convergence_digest(want, ranks, multi, mark_cols=m)
    monkeypatch.setattr(K, "resolve_winners", _winners_with_unique)
    old = K.convergence_digest(want, ranks, multi)
    assert torch.equal(new, old) and torch.equal(bounded, old)


def _digest_is_the_twins(st, ranks, multi=None):
    """The digest kernel on ``st``, one launch, equal byte for byte to the
    plain digest on the card and on the CPU; returns the digests."""
    multi = torch.from_numpy(allow_multiple_array()).to(st.chars.device) if multi is None else multi
    before = cuda_kernels.LAUNCHES["digest"]
    got = cuda_kernels.convergence_digest(st, ranks, multi)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["digest"] == before + 1
    assert got.dtype == torch.int64 and got.shape == st.length.shape
    assert torch.equal(got, K.convergence_digest(st, ranks, multi))
    on_cpu = K.convergence_digest(map_state(lambda x: x.cpu(), st), ranks.cpu(), multi.cpu())
    assert torch.equal(got.cpu(), on_cpu)
    return got


def _random_table_state(rng, r, c, m, fill, card, types=None, attrs=3, dense=0.2):
    """``_random_state``'s planes under a random mark table: ``types`` to
    draw the type column from (default every type, and out-of-range ones
    the clamp must catch), counts from empty to past M."""
    import dataclasses

    ec, ea, dl, ch, ln, _, bmask = _random_state(rng, r, c, m // 32, fill)
    bdef = rng.random((r, 2 * c)) < dense
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    st = map_state(lambda x: x.unsqueeze(0).expand(r, *x.shape).contiguous(), make_empty_state(c, m, card))
    types = np.arange(-1, 6) if types is None else np.asarray(types)
    return dataclasses.replace(
        st, elem_ctr=to(ec), elem_act=to(ea), deleted=to(dl), chars=to(ch), length=to(ln),
        bnd_def=to(bdef), bnd_mask=to(bmask),
        mark_count=to(rng.integers(0, m + 8, size=r).astype(np.int32)),
        mark_ctr=to(rng.integers(1, 40, (r, m)).astype(np.int32)),
        mark_act=to(rng.integers(-1, 6, (r, m)).astype(np.int32)),
        mark_action=to(rng.integers(0, 2, (r, m)).astype(np.int32)),
        mark_type=to(rng.choice(types, (r, m)).astype(np.int32)),
        mark_attr=to(rng.integers(-1, attrs, (r, m)).astype(np.int32)),
    )


@pytest.mark.parametrize("c,doc_len,writers,replicas,max_marks,seed", [
    (2048, 1000, 4, 64, 1024, 0),
    (16384, 6000, 2, 33, 128, 1),
])
def test_digest_kernel_equals_the_twin_on_merged_states(card, c, doc_len, writers, replicas, max_marks, seed):
    """``make_merge_workload`` documents merged by the kernels, at C = 2048
    (chip_smoke phase 2's table, M = 1024) and C = 16384 (M = 128)."""
    b = build_device_batch(make_merge_workload(doc_len, 64, writers, True, seed=seed), replicas, c, max_marks,
                           device=card)
    merged = cuda_kernels.merge_step_full(b["states"], b["text_ops"], b["mark_ops"], b["ranks"], b["char_buf"])
    assert int(merged.mark_count.max()) > 0 and int(merged.length.min()) >= doc_len
    _digest_is_the_twins(merged, b["ranks"])


def test_digest_kernel_equals_the_twin_at_32768(card):
    """Random planes at C = 32768 (64 tiles of a block), lengths from 0 to
    full, random tombstones, definedness and masks, a random table."""
    st = _random_table_state(np.random.default_rng(31), 7, 32768, 128, 32768, card)
    _digest_is_the_twins(st, torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=card))


def test_digest_kernel_equals_the_twin_under_a_full_table(card):
    """``bench/kernel_ab.py``'s full table: every one of M = 1024 columns
    live, random masks on half the slots of C = 256 documents."""
    from peritext_tpu_torch.bench.kernel_ab import _full_table_state
    from peritext_tpu_torch.ops.state import state_from_numpy

    full = state_from_numpy(_full_table_state(np.random.default_rng(1), replicas=96), device=card)
    _digest_is_the_twins(full, torch.arange(4, dtype=torch.int32, device=card))


def test_digest_kernel_resolves_allow_multiple_groups(card):
    """Tables of comments (allowMultiple: one group per comment id) and
    links (one group for every url) with many ids and duplicate keys; the
    flags change the digest, so the groups are exercised."""
    from peritext_tpu_torch.schema import MARK_TYPE_ID

    types = [MARK_TYPE_ID["comment"], MARK_TYPE_ID["link"]]
    st = _random_table_state(np.random.default_rng(32), 24, 1024, 256, 1024, card, types=types, attrs=12,
                             dense=0.4)
    ranks = torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=card)
    got = _digest_is_the_twins(st, ranks)
    lww = torch.zeros_like(torch.from_numpy(allow_multiple_array())).to(card)
    assert not torch.equal(_digest_is_the_twins(st, ranks, lww), got)


def test_digest_kernel_on_tombstones_carrying_after_slots(card):
    """Every element's only defined slot is its "after" slot and most
    elements are tombstones: the sources are the tombstones' after slots."""
    import dataclasses

    st = _random_table_state(np.random.default_rng(33), 16, 2048, 64, 2048, card)
    after = torch.rand((16, 2048), device=card) < 0.3
    bnd_def = torch.stack([torch.zeros_like(after), after], dim=2).reshape(16, 4096)
    st = dataclasses.replace(st, bnd_def=bnd_def, deleted=torch.rand((16, 2048), device=card) < 0.8,
                             mark_count=torch.full((16,), 64, dtype=torch.int32, device=card))
    _digest_is_the_twins(st, torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=card))


def test_digest_kernel_on_empty_replicas(card):
    """Replicas with length 0 and mark count 0, alone and among full ones:
    an empty replica's digest is the FNV offset basis, 2166136261."""
    import dataclasses

    ranks = torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=card)
    st = _random_table_state(np.random.default_rng(34), 9, 4096, 128, 4000, card)
    empty = torch.tensor([True, False] * 4 + [True], device=card)
    st = dataclasses.replace(st, length=torch.where(empty, 0, st.length),
                             mark_count=torch.where(empty, 0, st.mark_count))
    got = _digest_is_the_twins(st, ranks)
    assert (got[empty] == 2166136261).all()
    alone = map_state(lambda x: x[:1].contiguous(), st)
    assert int(_digest_is_the_twins(alone, ranks)[0]) == 2166136261


def test_digest_shared_memory_grows_with_the_table_alone(card):
    """The kernel's shared memory is 28 bytes a table column and a fixed
    6,656 bytes, at every capacity: a table of 7,968 columns (229,760 bytes)
    runs and equals the twin; one of 8,192 (236,032 bytes, past one
    block's 232,448) is refused before any launch, with no error left
    behind for the next launch."""
    ranks = torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=card)
    _digest_is_the_twins(_random_table_state(np.random.default_rng(36), 3, 96, 7968, 96, card), ranks)
    big = _random_table_state(np.random.default_rng(37), 2, 64, 8192, 64, card)
    before = cuda_kernels.LAUNCHES["digest"]
    with pytest.raises(RuntimeError, match="digest kernel launch failed"):
        cuda_kernels.convergence_digest(big, ranks, torch.from_numpy(allow_multiple_array()).to(card))
    assert cuda_kernels.LAUNCHES["digest"] == before
    _digest_is_the_twins(_random_table_state(np.random.default_rng(38), 5, 256, 128, 256, card), ranks)


@pytest.mark.parametrize("replicas", [1, 13])
def test_digest_kernel_at_one_and_an_odd_number_of_replicas(card, replicas):
    st = _random_table_state(np.random.default_rng(35 + replicas), replicas, 1000, 96, 1000, card)
    _digest_is_the_twins(st, torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=card))


def test_stream_sweep_launches_one_digest_a_cohort_and_equals_the_cpus(card):
    """A sweep on the card launches the digest kernel once a cohort, and
    its digests equal the same sweep's on the CPU (the plain digest)."""
    from peritext_tpu_torch.parallel import stream_merge_sorted

    args = _stream_population(100, 1024, 64, seed=14)
    cuda_kernels.reset_launch_counts()
    _, dg, stats = stream_merge_sorted(*args, cohort=24, depth=2, readback_states=False, device=card)
    assert stats["n_cohorts"] == 5
    assert cuda_kernels.LAUNCHES == {"text_phase": 5, "mark_phase": 5, "digest": 5}
    _, want, _ = stream_merge_sorted(*args, cohort=24, depth=2, readback_states=False, device="cpu")
    np.testing.assert_array_equal(dg, want)
    assert all(t["digest_ms"] > 0 for t in stats["timings"])


@pytest.mark.parametrize("mode", ["sort", "scatter", "roll"])
def test_splices_on_the_card_equal_the_cpu_and_sort(card, monkeypatch, mode):
    """Each splice of the sorted placement, on insert-heavy random rows in
    three rounds (some replicas overfill C = 256) and through the whole
    sorted merge: the card's planes equal the CPU's under the same splice
    and the card's under "sort"."""
    from peritext_tpu_torch.bench.workloads import build_device_batch, insert_heavy_text_ops
    from peritext_tpu_torch.ops import sorted_merge

    wl = make_merge_workload(doc_len=100, ops_per_merge=24, num_streams=4, with_marks=True, seed=1)
    b = build_device_batch(wl, 6, 256, 64, device="cpu")
    st = b["states"]
    ops, buf = insert_heavy_text_ops(np.random.default_rng(1), st, 24, 128)
    rounds = torch.from_numpy(np.random.default_rng(8).integers(0, 3, size=ops.shape[:2]).astype(np.int32))
    marks, ranks = b["mark_ops"], b["ranks"]

    def run(device, splice):
        monkeypatch.setattr(sorted_merge, "_SPLICE_MODE", splice)
        s = map_state(lambda x: x.to(device), st)
        args = [t.to(device) for t in (ops, rounds)]
        placed = sorted_merge.place_text_batch(s.elem_ctr, s.elem_act, s.deleted, s.chars, s.length, *args, 3,
                                               ranks.to(device), buf.to(device), 64)
        merged = sorted_merge.merge_step_sorted_batch(s, *args, 3, marks.to(device), ranks.to(device),
                                                      buf.to(device), 64)
        return [p.cpu() for p in placed], state_to_numpy(merged)

    got, got_st = run(card, mode)
    for want, want_st in (run("cpu", mode), run(card, "sort")):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all((got_st[f] == want_st[f]).all() for f in got_st)
    assert (got[-1] > 256).any()


@pytest.mark.parametrize("mode", ["scatter", "roll"])
def test_sorted_universe_on_the_card_under_each_splice(card, monkeypatch, mode):
    """Eight replicas on the windowed sorted route at C = 4096 under a
    splice give the "sort" splice's states field by field."""
    from peritext_tpu_torch.ops import sorted_merge

    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "1")
    monkeypatch.delenv("PERITEXT_MERGE_WINDOW_MIN", raising=False)
    wl = make_writer_rounds(doc_len=3000, ops_per_round=32, num_writers=4, rounds=3, seed=5, locality=128)
    names = [f"r{i}" for i in range(8)]
    steps = [[[wl["genesis"]]] * 8] + [[rnd[i % 4] for i in range(8)] for rnd in wl["rounds"]]
    states = {}
    for splice in ("sort", mode):
        monkeypatch.setattr(sorted_merge, "_SPLICE_MODE", splice)
        uni = TorchUniverse(names, capacity=4096, max_mark_ops=256, device=card)
        for batch in steps:
            uni.apply_changes(batch)
        assert uni.stats["windowed_launches"] >= 1
        states[splice] = state_to_numpy(uni.states)
    assert all((states["sort"][f] == states[mode][f]).all() for f in states["sort"])


def test_visible_text_of_a_card_state(card):
    from peritext_tpu_torch.ops.state import index_state, visible_text

    uni = TorchUniverse(["a", "b"], device=card)
    wl = make_writer_rounds(doc_len=200, ops_per_round=16, num_writers=2, rounds=2, seed=3)
    uni.apply_changes([[wl["genesis"]]] * 2)
    uni.apply_changes([wl["rounds"][0][0], wl["rounds"][0][1]])
    assert uni.states.chars.device.type == "cuda"
    for r in range(2):
        assert visible_text(index_state(uni.states, r)) == uni.texts()[r]


def test_sharded_universe_on_a_logical_mesh_equals_the_cpus(card):
    """``TorchUniverse.shard`` over a 2x2 mesh of the one card: each merge
    launches each kernel once per replica group, and the states equal an
    unsharded universe's on the CPU; the sequence-parallel flatten and
    placement equal the unsharded ones there too."""
    from peritext_tpu_torch.ops import sorted_merge
    from peritext_tpu_torch.ops.encode import prepare_sorted_batch
    from peritext_tpu_torch.parallel import mesh as M
    from peritext_tpu_torch.parallel import shard as S

    wl = make_writer_rounds(300, 32, 4, 3, True, seed=4)
    names = [f"r{i}" for i in range(8)]
    unis = [TorchUniverse(names, capacity=512, max_mark_ops=128, device=d) for d in (card, "cpu")]
    unis[0].shard(M.make_mesh([card] * 4, 2, 2))
    for batch in [{n: [wl["genesis"]] for n in names}] + [
        {n: rnd[i % 4] for i, n in enumerate(names)} for rnd in wl["rounds"]
    ]:
        cuda_kernels.reset_launch_counts()
        for uni in unis:
            uni.apply_changes(batch)
        assert cuda_kernels.LAUNCHES == {"text_phase": 2, "mark_phase": 2, "digest": 0}
        assert M.is_sharded(unis[0]._states)
    got, want = (state_to_numpy(u.states) for u in unis)
    for f in FIELDS:
        assert (got[f] == want[f]).all(), f
    assert unis[0].texts() == unis[1].texts()

    b = build_device_batch(make_merge_workload(200, 32, 4, True, seed=6), 8, 512, 128, device=card)
    sp = prepare_sorted_batch([b["stream_rows"][r % 4] for r in range(8)])
    st = b["states"]
    mesh = M.make_mesh([card] * 4, 1, 4)
    args = [torch.from_numpy(sp[k]).to(card) for k in ("text", "rounds")]
    bufs = torch.from_numpy(sp["bufs"]).to(card)
    placed = S.place_text_sp(mesh, 64, sp["maxk"])(
        st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, *args, sp["num_rounds"], b["ranks"], bufs
    )
    cpu = map_state(lambda x: x.cpu(), st)
    want = sorted_merge.place_text_batch(
        cpu.elem_ctr, cpu.elem_act, cpu.deleted, cpu.chars, cpu.length, *(a.cpu() for a in args),
        sp["num_rounds"], b["ranks"].cpu(), bufs.cpu(), sp["maxk"],
    )
    for g, w in zip(placed, want):
        assert torch.equal(g.full().cpu(), w)
    mask, has = S.flatten_sources_sp(mesh)(st.deleted, st.bnd_def, st.bnd_mask, st.length)
    ref_mask, ref_has = K.flatten_sources(cpu)
    live = torch.arange(512)[None, :] < cpu.length[:, None]
    assert torch.equal(mask.full().cpu() * live[..., None], ref_mask * live[..., None])
    assert torch.equal(has.full().cpu() & live, ref_has & live)


@pytest.mark.parametrize("shape,shard_seq", [((4, 1), True), ((2, 2), True), ((2, 2), False)])
def test_stream_on_a_logical_mesh_of_the_card_equals_the_resident_merge(card, shape, shard_seq):
    """The stream over ``n x cuda:0`` (each entry a logical shard, every
    entry sharing the card's three streams): each cohort merges once per
    replica group on the kernels, and states and digests equal one
    resident ``merge_step_full`` byte for byte, at depth 2 and 1."""
    from peritext_tpu_torch.ops.state import state_from_numpy
    from peritext_tpu_torch.parallel import make_mesh, stream_merge_sorted

    args = _stream_population(100, 1024, 64, seed=12)
    st = state_from_numpy(args[0], device=card)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    ranks = to(args[5])
    resident = cuda_kernels.merge_step_full(st, to(args[1]), to(args[4]), ranks, to(args[6]))
    want_dg = K.convergence_digest(resident, ranks, to(allow_multiple_array())).cpu().numpy()
    want = state_to_numpy(resident)
    mesh = make_mesh([card] * (shape[0] * shape[1]), *shape)
    for depth in (2, 1):
        cuda_kernels.reset_launch_counts()
        out, dg, stats = stream_merge_sorted(*args, cohort=22, mesh=mesh, shard_seq=shard_seq, depth=depth)
        cohort = -(-22 // shape[0]) * shape[0]
        assert stats["cohort"] == cohort and stats["n_cohorts"] == -(-100 // cohort)
        n = stats["n_cohorts"] * shape[0]
        assert cuda_kernels.LAUNCHES == {"text_phase": n, "mark_phase": n, "digest": n}
        np.testing.assert_array_equal(dg, want_dg.astype(np.uint32))
        for f in want:
            assert out[f].dtype == want[f].dtype, f
            np.testing.assert_array_equal(out[f], want[f], err_msg=f)
        assert all(t["merge_ms"] > 0 and t["d2h_ms"] > 0 for t in stats["timings"])


def test_nccl_world_of_one_on_the_card(card):
    """``initialize_distributed`` over NCCL at a world of one: the global
    mesh over the card, the assembled batch and ``sharded_apply`` (its
    global digest through an NCCL ``all_reduce``) equal one
    ``merge_step_full`` and its digests; no group outlives the test."""
    import socket

    import torch.distributed as dist

    from peritext_tpu_torch.parallel import (
        assemble_global_states, global_mesh, initialize_distributed, local_replica_slice, sharded_apply,
    )
    from peritext_tpu_torch.parallel.mesh import gather_states

    b = build_device_batch(make_merge_workload(200, 32, 4, True, seed=6), 64, 512, 128, device=card)
    multi = torch.from_numpy(allow_multiple_array()).to(card)
    want = cuda_kernels.merge_step_full(b["states"], b["text_ops"], b["mark_ops"], b["ranks"], b["char_buf"])
    want_dg = K.convergence_digest(want, b["ranks"], multi)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        initialize_distributed(f"127.0.0.1:{port}", 1, 0)
        assert dist.get_backend() == "nccl"
        mesh = global_mesh(devices=[card] * 2)
        sl = local_replica_slice(64)
        st = assemble_global_states(map_state(lambda x: x[sl], b["states"]), b["states"], mesh)
        new, digests, total = sharded_apply(mesh)(st, b["text_ops"][sl], b["mark_ops"][sl], b["ranks"], multi,
                                                   b["char_buf"][sl])
        got = gather_states(new)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(digests.full(), want_dg)
        assert int(total) == int(want_dg.sum().item()) & 0xFFFFFFFF
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
