"""The CUDA kernels against their plain versions on the card, on random and
edge-case inputs the benchmark workload never reaches: unresolved
references, runs that push elements off the end, capacities that are not a
multiple of the block size, mark tables that overflow, end anchors left of
start anchors, long delete runs across op tiles with duplicate ids and ids
inserted later in the batch, and C = 16384.  Byte-equal or fail.  Then a
``TorchUniverse`` on the card grows past 8192 elements against the oracle
on the scan path, the default path (sorted, windowed or not) equals the
scan path at C = 4096, the per-op patch path's records on the card equal
those on the CPU, and a ``TorchDoc`` session on the card equals the oracle.
A universe grows past the kernels' C = 16384 on the capacity route, and
the patched sorted route gives the per-op loop's streams.  A sharded
serving plane on the card (a migration and an evict/hydrate round trip
included) equals the same run on the CPU, and kernel launches from two
threads count and land on the card.

Needs a CUDA device; without one every test skips.  This file imports no
JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from peritext_tpu_torch import TorchDoc, TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import doc_session, make_merge_workload, make_writer_rounds, wire_rounds
from peritext_tpu_torch.ids import ActorRegistry
from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.encode import AttrRegistry, encode_changes, pad_rows
from peritext_tpu_torch.ops.state import make_empty_state, map_state
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
        assert cuda_kernels.LAUNCHES == {"text_phase": n, "mark_phase": n}
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
    assert all(n == 1 for n in cuda_kernels.LAUNCHES.values())
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
    merge takes the capacity route (counted, no kernel launch, no
    ValueError), and the states equal the same merges on the CPU."""
    for var in ("PERITEXT_MERGE_PATH", "PERITEXT_SORTED_MAX_ROUNDS", "PERITEXT_MERGE_WINDOW"):
        monkeypatch.delenv(var, raising=False)
    hist = wire_rounds(16_300, 2, 2, 128, seed=5)
    history = [[c for rnd in hist["rounds"] for c in rnd[w]] for w in range(2)]
    steps = [[[hist["genesis"]]] * 4] + [[rnd[i % 2] for i in range(4)] for rnd in hist["rounds"]]
    steps.append([history[1 - i % 2] for i in range(4)])
    unis = [TorchUniverse([f"r{i}" for i in range(4)], capacity=16384, max_mark_ops=256, device=d)
            for d in (card, "cpu")]
    cuda_kernels.reset_launch_counts()
    for k, batch in enumerate(steps):
        for uni in unis:
            uni.apply_changes(batch)
        if k == 0:
            assert cuda_kernels.LAUNCHES == {"text_phase": 1, "mark_phase": 1}
    on_card = unis[0]
    assert on_card.capacity == 32768
    assert on_card.stats["capacity_routes"] == len(steps) - 1
    assert cuda_kernels.LAUNCHES == {"text_phase": 1, "mark_phase": 1}
    a, b = state_to_numpy(on_card.states), state_to_numpy(unis[1].states)
    assert all((a[f] == b[f]).all() for f in a)
    assert len(set(on_card.digests().tolist())) == 1


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
        assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0}
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
    assert all(n == merges for n in cuda_kernels.LAUNCHES.values())
    cpu = TorchUniverse(["a", "b"], capacity=512, device="cpu")
    run(cpu)
    want = state_to_numpy(cpu.states)
    for u in unis:
        got = state_to_numpy(u.states)
        assert all((got[f] == want[f]).all() for f in want)
