"""The document lifecycle of the PyTorch port (``peritext_tpu_torch.
runtime.lifecycle`` over ``TorchUniverse(device="cpu")`` shards):
tests/test_lifecycle.py's scenarios.  A session evicted to a durable
checkpoint and hydrated back (through corrupt generations, full log
replays, and protocol failures at ANY step of either protocol — the
``doc_evict`` / ``doc_hydrate`` fault sites) produces a patch stream
byte-identical to an always-resident run, while the fleet holds fewer
device rows than it serves documents.

Parity: the same seeded traffic and evictions go through the JAX
package's plane and DocLifecycle, and every per-submission patch list is
equal; a generation the port writes hydrates in the JAX package's
lifecycle, and the reverse.
"""
import glob
import os
import random
import shutil
from timeit import repeat as timeit_repeat

import pytest

from peritext_tpu.runtime import faults as jax_faults
from peritext_tpu.runtime import health as jax_health
from peritext_tpu.runtime.lifecycle import DocLifecycle as JaxDocLifecycle
from peritext_tpu.runtime.serve_shard import ShardedServePlane as JaxShardedServePlane
from peritext_tpu_torch.oracle import accumulate_patches
from peritext_tpu_torch.runtime import faults, health, lifecycle, telemetry
from peritext_tpu_torch.runtime.elastic import migrate_session
from peritext_tpu_torch.runtime.faults import FaultError, FaultPlan
from peritext_tpu_torch.runtime.lifecycle import DocLifecycle, EvictionError, HydrationError
from peritext_tpu_torch.runtime.serve_shard import ShardedServePlane

from test_torch_serve import author_stream, detached_telemetry, direct_streams  # noqa: F401


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    for name in ("PERITEXT_FAULTS", "PERITEXT_BREAKER", "PERITEXT_SERVE_SHARD_BUCKET",
                 "PERITEXT_SERVE_PLACEMENT", "PERITEXT_ELASTIC", "PERITEXT_LIFECYCLE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PERITEXT_LAUNCH_BACKOFF", "0.001")
    for mod in (faults, health, jax_faults, jax_health):
        mod.reset()
    yield
    for mod in (faults, health, jax_faults, jax_health):
        mod.reset()


def _mk_plane(shards, jax=False, **kw):
    kw.setdefault("start", False)
    kw.setdefault("batch_target", 64)
    kw.setdefault("deadline_ms", 10**9)
    if jax:
        kw.setdefault("bucket", "exact")
        return JaxShardedServePlane(shards, **kw)
    kw.setdefault("devices", ["cpu"])
    return ShardedServePlane(shards, **kw)


def _mk_lifecycle(plane, tmp_path, jax=False, **kw):
    kw.setdefault("start", False)
    kw.setdefault("watermark", 0)
    kw.setdefault("keep", 2)
    kw.setdefault("cooldown", 0.0)
    cls = JaxDocLifecycle if jax else DocLifecycle
    return cls(plane, directory=str(tmp_path), **kw)


def _rows(plane):
    return sum(len(s.universe.replica_ids) for s in plane.shards if s.universe)


# ---------------------------------------------------------------------------
# Byte-identity through evict → hydrate round trips
# ---------------------------------------------------------------------------


def test_evict_hydrate_round_trip_byte_identity(tmp_path):
    """Evict a session mid-stream (the device row frees), then a plain
    submit transparently hydrates it; the stream equals direct per-change
    ingest and the triggering submission resolves with exactly its own
    patches, latency-classed cold."""
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path)
    names = ["ra", "rb"]
    streams = [author_stream(n, 10, seed=10 + i) for i, n in enumerate(names)]
    sess = [
        plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
        for i in range(2)
    ]
    warm = [sess[i].submit(streams[i][:5]) for i in range(2)]
    assert plane.drain() == 0
    rows_before = _rows(plane)
    assert rows_before == 2
    lc.evict("s0")
    assert plane._sessions["s0"]._cold
    assert _rows(plane) < rows_before
    cold = sess[0].submit(streams[0][5:])
    sess[1].submit(streams[1][5:])
    assert plane.drain() == 0
    assert not plane._sessions["s0"]._cold
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
        assert accumulate_patches(sess[i].patch_log) == plane.spans(n)
    patches = cold.result(timeout=5.0)
    assert patches and sess[0].patch_log[-len(patches):] == patches
    assert cold.lat_class == "cold"
    assert warm[0].lat_class == "warm"
    assert lc.stats["evictions"] == 1 and lc.stats["hydrations"] == 1
    plane.close()


def _round_trip_run(tmp_path, seed, jax):
    rng = random.Random(seed)
    plane = _mk_plane(3, jax=jax)
    lc = _mk_lifecycle(plane, tmp_path, jax=jax)
    names = [f"m{i}" for i in range(5)]
    streams = [author_stream(n, 10, seed=60 + i) for i, n in enumerate(names)]
    sess = [
        plane.session(f"s{i}", replica=names[i], record_stream=True)
        for i in range(5)
    ]
    subs, evictions = [], []
    cursors = [0] * 5
    while any(c < len(streams[i]) for i, c in enumerate(cursors)):
        i = rng.randrange(5)
        if cursors[i] >= len(streams[i]):
            continue
        k = min(rng.choice([1, 2, 3]), len(streams[i]) - cursors[i])
        subs.append(sess[i].submit(streams[i][cursors[i] : cursors[i] + k]))
        cursors[i] += k
        if rng.random() < 0.3:
            plane.step()
        if rng.random() < 0.25:
            j = rng.randrange(5)
            try:
                plane.drain()
                lc.evict(f"s{j}")
                evictions.append(j)
            except ValueError:
                pass  # already cold
    assert plane.drain() == 0
    for i in range(5):
        lc.hydrate(f"s{i}")
    assert plane.drain() == 0
    return plane, lc, names, streams, sess, [s.result(timeout=5.0) for s in subs], evictions


@pytest.mark.parametrize("seed", [0, 7])
def test_round_trip_matrix_byte_identity(tmp_path, seed):
    """rng-interleaved submissions with random evictions across 3 shards:
    residency churn stays invisible in the streams, and the JAX plane and
    lifecycle given the same traffic agree submission for submission."""
    plane, lc, names, streams, sess, results, evictions = _round_trip_run(tmp_path / "port", seed, False)
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
        assert accumulate_patches(sess[i].patch_log) == plane.spans(n)
    assert lc.stats["evictions"] >= 1
    jplane, jlc, _, _, jsess, jresults, jevictions = _round_trip_run(tmp_path / "jax", seed, True)
    assert jevictions == evictions
    assert jresults == results
    assert [s.patch_log for s in jsess] == [s.patch_log for s in sess]
    assert jlc.stats == lc.stats
    plane.close()
    jplane.close()


def test_validation_errors(tmp_path):
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path)
    s0 = plane.session("s0", "va", shard=0)
    with pytest.raises(KeyError):
        lc.evict("nope")
    with pytest.raises(KeyError):
        lc.hydrate("nope")
    lc.hydrate("s0")  # warm: idempotent no-op
    lc.evict("s0")
    with pytest.raises(ValueError, match="already evicted"):
        lc.evict("s0")
    lc.hydrate("s0")
    s0._parked = []
    with pytest.raises(ValueError, match="migrating"):
        lc.evict("s0")
    s0._parked = None
    plane.close()


# ---------------------------------------------------------------------------
# Chaos: rollback at every protocol step
# ---------------------------------------------------------------------------


def _failing_fire(monkeypatch, site, step):
    calls = {"n": 0}
    real_fire = faults.fire

    def counting_fire(s, **kw):
        if s == site:
            calls["n"] += 1
            if calls["n"] == step:
                raise FaultError(s, f"induced at step {step}")
        return real_fire(s, **kw)

    monkeypatch.setattr(lifecycle.faults, "fire", counting_fire)
    return real_fire


def test_evict_rollback_at_every_protocol_step(tmp_path, monkeypatch):
    """Fail the doc_evict chokepoint at step k for k=1..4: each attempt
    raises EvictionError, leaves the session resident and unparked, and
    the streams stay byte-identical; a real eviction afterwards works."""
    names = ["ea", "eb"]
    streams = [author_stream(n, 10, seed=80 + i) for i, n in enumerate(names)]
    _, want = direct_streams(names, streams)
    for fail_step in range(1, 5):
        plane = _mk_plane(2)
        lc = _mk_lifecycle(plane, tmp_path / f"e{fail_step}")
        sess = [
            plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
            for i in range(2)
        ]
        for i in range(2):
            sess[i].submit(streams[i][:5])
        assert plane.drain() == 0
        real_fire = _failing_fire(monkeypatch, "doc_evict", fail_step)
        with pytest.raises(EvictionError):
            lc.evict("s0")
        monkeypatch.setattr(lifecycle.faults, "fire", real_fire)
        s = plane._sessions["s0"]
        assert s._parked is None
        assert not s._cold
        for i in range(2):
            sess[i].submit(streams[i][5:])
        assert plane.drain() == 0
        for i, n in enumerate(names):
            assert sess[i].patch_log == want[n], (fail_step, n)
        lc.evict("s0")
        assert plane._sessions["s0"]._cold
        assert lc.stats["rollbacks"] == 1
        plane.close()


def test_hydrate_rollback_at_every_protocol_step(tmp_path, monkeypatch):
    """Fail the doc_hydrate chokepoint at step k for k=1..5: each attempt
    raises HydrationError and leaves the session COLD (the provisioned
    row unwinds); a clean hydrate afterwards restores byte-identity."""
    names = ["ha", "hb"]
    streams = [author_stream(n, 10, seed=90 + i) for i, n in enumerate(names)]
    _, want = direct_streams(names, streams)
    for fail_step in range(1, 6):
        plane = _mk_plane(2)
        lc = _mk_lifecycle(plane, tmp_path / f"h{fail_step}")
        sess = [
            plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
            for i in range(2)
        ]
        for i in range(2):
            sess[i].submit(streams[i][:5])
        assert plane.drain() == 0
        lc.evict("s0")
        rows_cold = _rows(plane)
        real_fire = _failing_fire(monkeypatch, "doc_hydrate", fail_step)
        with pytest.raises(HydrationError):
            lc.hydrate("s0")
        monkeypatch.setattr(lifecycle.faults, "fire", real_fire)
        s = plane._sessions["s0"]
        assert s._cold
        assert s._parked is None
        assert _rows(plane) == rows_cold
        lc.hydrate("s0")
        assert not s._cold
        for i in range(2):
            sess[i].submit(streams[i][5:])
        assert plane.drain() == 0
        for i, n in enumerate(names):
            assert sess[i].patch_log == want[n], (fail_step, n)
        assert lc.stats["hydrate_failures"] == 1
        assert lc.stats["rollbacks"] == 1
        plane.close()


def test_crash_between_checkpoint_and_free(tmp_path, monkeypatch):
    """Fail at the commit gate (step 4): a stale generation stays on disk,
    the session stays resident, and the next clean round trip prefers the
    newest generation and stays byte-identical."""
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path)
    n = "ka"
    stream = author_stream(n, 10, seed=11)
    sess = plane.session("s0", replica=n, shard=0, record_stream=True)
    sess.submit(stream[:4])
    assert plane.drain() == 0
    real_fire = _failing_fire(monkeypatch, "doc_evict", 4)
    with pytest.raises(EvictionError):
        lc.evict("s0")
    monkeypatch.setattr(lifecycle.faults, "fire", real_fire)
    assert len(glob.glob(os.path.join(lc._doc_dir("s0"), "*.npz"))) == 1
    assert not plane._sessions["s0"]._cold
    sess.submit(stream[4:7])
    assert plane.drain() == 0
    lc.evict("s0")
    assert len(glob.glob(os.path.join(lc._doc_dir("s0"), "*.npz"))) == 2
    sess.submit(stream[7:])
    assert plane.drain() == 0
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    plane.close()


# ---------------------------------------------------------------------------
# The corruption chain: newest → older generation → full log replay
# ---------------------------------------------------------------------------


def _truncate(path, size=64):
    with open(path, "r+b") as f:
        f.truncate(size)


def test_corruption_fallback_chain(tmp_path, detached_telemetry):
    """Corrupt the newest generation: hydrate falls back one generation
    and replays the gap with the patch sink detached; corrupt ALL
    generations: full replay from genesis — byte-identical either way,
    with exactly one deduped dump per failing doc."""
    telemetry.enable(blackbox=str(tmp_path / "bb"))
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path / "store", keep=4)
    n = "ca"
    stream = author_stream(n, 12, seed=12)
    sess = plane.session("s0", replica=n, shard=0, record_stream=True)
    sess.submit(stream[:4])
    assert plane.drain() == 0
    lc.evict("s0")          # gen 0 @ clock 4
    lc.hydrate("s0")
    sess.submit(stream[4:8])
    assert plane.drain() == 0
    lc.evict("s0")          # gen 1 @ clock 8
    gens = sorted(glob.glob(os.path.join(lc._doc_dir("s0"), "*.npz")))
    assert len(gens) == 2
    _truncate(gens[-1])
    lc.hydrate("s0")
    assert lc.stats["corrupt_fallbacks"] == 1
    assert lc.stats["full_replays"] == 0
    sess.submit(stream[8:10])
    assert plane.drain() == 0
    _, want = direct_streams([n], [stream[:10]])
    assert sess.patch_log == want[n]
    lc.evict("s0")
    for g in glob.glob(os.path.join(lc._doc_dir("s0"), "*.npz")):
        _truncate(g, 8)
    lc.hydrate("s0")
    assert lc.stats["full_replays"] == 1
    sess.submit(stream[10:])
    assert plane.drain() == 0
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    assert accumulate_patches(sess.patch_log) == plane.spans(n)
    dumps = [p for p in os.listdir(str(tmp_path / "bb")) if p.endswith(".json")]
    assert len(dumps) == 1, dumps
    assert telemetry.snapshot()["counters"].get("blackbox.deduped", 0) >= 1
    plane.close()


def test_generation_rotation(tmp_path):
    """The store keeps only ``keep`` generations."""
    plane = _mk_plane(1)
    lc = _mk_lifecycle(plane, tmp_path, keep=2)
    n = "rka"
    stream = author_stream(n, 9, seed=13)
    sess = plane.session("s0", replica=n, record_stream=True)
    for lo, hi in ((0, 3), (3, 6), (6, 10)):
        sess.submit(stream[lo:hi])
        assert plane.drain() == 0
        lc.evict("s0")
        lc.hydrate("s0")
    d = lc._doc_dir("s0")
    assert len(glob.glob(os.path.join(d, "*.npz"))) == 2
    assert len(glob.glob(os.path.join(d, "*.json"))) == 2
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    plane.close()


# ---------------------------------------------------------------------------
# Either engine hydrates what the other evicted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_generation_written_by_one_engine_hydrates_in_the_other(tmp_path, writer):
    """Both engines serve the same session over ONE generation directory.
    The hydrating engine evicts first; the writing engine then evicts, so
    its generation is the newest, and the hydrating engine's own is
    deleted.  The next submit there hydrates the other engine's file (no
    fallback, no full replay) and streams what direct ingest gives."""
    n = "xe"
    stream = author_stream(n, 10, text="cross engine", seed=17)
    engines = {}
    for name, jax in (("port", False), ("jax", True)):
        plane = _mk_plane(2, jax=jax)
        lc = _mk_lifecycle(plane, tmp_path, jax=jax, keep=4)
        sess = plane.session("s0", replica=n, shard=1, record_stream=True)
        sess.submit(stream[:6])
        assert plane.drain() == 0
        engines[name] = (plane, lc, sess)
    reader = "jax" if writer == "port" else "port"
    engines[reader][1].evict("s0")
    (own,) = glob.glob(os.path.join(tmp_path, "s0", "gen-*.npz"))
    engines[writer][1].evict("s0")
    for suffix in (".npz", ".json"):
        os.remove(own[: -len(".npz")] + suffix)
    gens = glob.glob(os.path.join(tmp_path, "s0", "gen-*.npz"))
    assert len(gens) == 1 and gens[0] != own
    plane, lc, sess = engines[reader]
    sub = sess.submit(stream[6:])
    assert plane.drain() == 0
    assert lc.stats["hydrations"] == 1
    assert lc.stats["corrupt_fallbacks"] == 0 and lc.stats["full_replays"] == 0
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    patches = sub.result(timeout=5.0)
    assert patches and want[n][-len(patches):] == patches
    for p, _, _ in engines.values():
        p.close()


# ---------------------------------------------------------------------------
# Migration vs eviction: the two protocols must serialize
# ---------------------------------------------------------------------------


def test_migration_vs_eviction_race(tmp_path):
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path)
    n = "xa"
    stream = author_stream(n, 8, seed=14)
    sess = plane.session("s0", replica=n, shard=0, record_stream=True)
    sess.submit(stream[:4])
    assert plane.drain() == 0
    lc.evict("s0")
    with pytest.raises(ValueError, match="cold"):
        migrate_session(plane, "s0", 1)
    lc.hydrate("s0")
    s = plane._sessions["s0"]
    s._parked = []
    with pytest.raises(ValueError, match="migrating"):
        lc.evict("s0")
    s._cold = True
    with pytest.raises(ValueError, match="migrating"):
        lc.hydrate("s0")
    s._cold = False
    s._parked = None
    migrate_session(plane, "s0", 1)
    lc.evict("s0")
    sess.submit(stream[4:])
    assert plane.drain() == 0
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    plane.close()


# ---------------------------------------------------------------------------
# Doc groups: the cold gap replays from the group log
# ---------------------------------------------------------------------------


def test_doc_group_cold_gap_convergence(tmp_path):
    """A sibling keeps writing while one member is cold: live fan-out to
    the cold member drops, hydration replays the group-log tail, and
    anti-entropy converges the group byte-for-byte."""
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path)
    s1 = plane.session("d1", "da", doc="shared", shard=0, record_stream=True)
    plane.session("d2", "db", doc="shared", shard=1, record_stream=True)
    stream = author_stream("da", 8, seed=3)
    s1.submit(stream[:4])
    assert plane.drain() == 0
    plane.anti_entropy()
    assert plane.drain() == 0
    lc.evict("d2")
    s1.submit(stream[4:])
    assert plane.drain() == 0
    lc.hydrate("d2")
    assert plane.drain() == 0
    plane.anti_entropy()
    assert plane.drain() == 0
    assert plane.spans("da") == plane.spans("db")
    plane.close()


# ---------------------------------------------------------------------------
# Policy: LRU idle reaping + capacity-pressure watermark
# ---------------------------------------------------------------------------


def test_tick_idle_lru_eviction(tmp_path):
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path, idle_s=10.0)
    names = ["ia", "ib"]
    for i, n in enumerate(names):
        plane.session(f"s{i}", replica=n, shard=i, record_stream=True)
        plane._sessions[f"s{i}"].submit(author_stream(n, 3, seed=20 + i))
    assert plane.drain() == 0
    now = max(lc._last_active.values())
    assert lc.tick(now=now + 1.0) is None
    lc._last_active["s1"] = now + 5.0
    assert lc.tick(now=now + 11.0) == "evict"
    assert plane._sessions["s0"]._cold
    assert not plane._sessions["s1"]._cold
    assert lc.last_eviction["reason"] == "idle"
    lc.cooldown = 100.0
    assert lc.tick(now=now + 20.0) is None
    plane.close()


def test_watermark_pressure_tenancy(tmp_path):
    """With watermark M, admitting N > M sessions holds the resident
    population at M — the fleet serves more docs than it holds rows, and
    hydration evicts someone else to make room."""
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path, watermark=2)
    names = [f"w{i}" for i in range(5)]
    streams = [author_stream(n, 6, seed=30 + i) for i, n in enumerate(names)]
    sess = []
    for i, n in enumerate(names):
        s = plane.session(f"s{i}", replica=n, record_stream=True)
        sess.append(s)
        s.submit(streams[i][:3])
        assert plane.drain() == 0
    assert len([s for s in plane._sessions.values() if not s._cold]) <= 2
    assert lc.stats["pressure_evictions"] >= 3
    for i in range(5):
        sess[i].submit(streams[i][3:])
        assert plane.drain() == 0
    assert len([s for s in plane._sessions.values() if not s._cold]) <= 2
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
    st = lc._status()
    assert st["docs"] == 5
    assert st["tenancy_ratio"] is not None and st["tenancy_ratio"] > 1.0
    assert st["cold_start_p95_ms"] is not None
    plane.close()


# ---------------------------------------------------------------------------
# Observability: status block, warm/cold histograms, fault-plan mirror
# ---------------------------------------------------------------------------


def test_status_surface(tmp_path, detached_telemetry):
    telemetry.enable()
    plane = _mk_plane(2, name="lifecycle_status")
    lc = _mk_lifecycle(plane, tmp_path)
    plane.session("s0", "sta", shard=0, record_stream=True)
    plane._sessions["s0"].submit(author_stream("sta", 2, seed=40))
    assert plane.drain() == 0
    lc.evict("s0")
    st = telemetry.status()
    blocks = [b for b in st.get("lifecycle", []) if b["plane"] == "lifecycle_status"]
    assert blocks, st.keys()
    blk = blocks[-1]
    assert blk["resident"] == 0 and blk["evicted"] == 1 and blk["docs"] == 1
    assert blk["evictions"] == 1
    assert {"tenancy_ratio", "watermark", "cold_start_p95_ms",
            "last_eviction", "full_replays"} <= set(blk)
    plane.close()


def test_warm_cold_latency_histograms(tmp_path, detached_telemetry):
    """Submissions to a lifecycle-managed plane class their admit-to-
    applied latency warm vs cold — the SLO-able split."""
    telemetry.enable()
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path)
    n = "la"
    stream = author_stream(n, 6, seed=41)
    sess = plane.session("s0", replica=n, shard=0, record_stream=True)
    sub = sess.submit(stream[:3])
    assert plane.drain() == 0
    sub.result(timeout=5.0)
    assert sub.lat_class == "warm"
    lc.evict("s0")
    sub = sess.submit(stream[3:])
    assert plane.drain() == 0
    sub.result(timeout=5.0)
    assert sub.lat_class == "cold"
    hists = telemetry.snapshot()["histograms"]
    assert hists["e2e.admit_to_applied_warm"]["count"] >= 1
    assert hists["e2e.admit_to_applied_cold"]["count"] >= 1
    assert hists["e2e.admit_to_applied"]["count"] >= 2
    plane.close()


def test_fault_plan_spec_rollback_and_blackbox(tmp_path, detached_telemetry):
    """The seeded grammar drives both sites; failures dump once per doc
    and the stats mirror exactly as faults.<site>.<key>."""
    telemetry.enable(blackbox=str(tmp_path / "bb"))
    plane = _mk_plane(2)
    lc = _mk_lifecycle(plane, tmp_path / "store")
    n = "fa"
    stream = author_stream(n, 8, seed=42)
    sess = plane.session("s0", replica=n, shard=0, record_stream=True)
    sess.submit(stream[:4])
    assert plane.drain() == 0
    plan = FaultPlan.from_spec("seed=7;doc_evict:fail=1;doc_hydrate:fail=1")
    with faults.injected(plan):
        with pytest.raises(EvictionError):
            lc.evict("s0")
        assert plan.stats["doc_evict"]["failed"] == 1
        lc.evict("s0")
        with pytest.raises(HydrationError):
            lc.hydrate("s0")
        assert plan.stats["doc_hydrate"]["failed"] == 1
        lc.hydrate("s0")
    dumps = [p for p in os.listdir(str(tmp_path / "bb")) if p.endswith(".json")]
    assert len(dumps) == 2, dumps
    snap = telemetry.snapshot()
    assert snap["counters"].get("faults.doc_evict.failed") == 1
    assert snap["counters"].get("faults.doc_hydrate.failed") == 1
    assert snap["counters"].get("lifecycle.rollbacks") == 2
    sess.submit(stream[4:])
    assert plane.drain() == 0
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    plane.close()


def test_corrupt_drill_via_spec(tmp_path):
    """doc_evict:corrupt=1 truncates the just-written generation; the
    next hydrate falls back (or full-replays) and stays byte-identical."""
    plane = _mk_plane(1)
    lc = _mk_lifecycle(plane, tmp_path)
    n = "cda"
    stream = author_stream(n, 8, seed=43)
    sess = plane.session("s0", replica=n, record_stream=True)
    sess.submit(stream[:4])
    assert plane.drain() == 0
    plan = FaultPlan.from_spec("seed=7;doc_evict:corrupt=1")
    with faults.injected(plan):
        lc.evict("s0")
        assert plan.stats["doc_evict"]["corrupted"] == 1
    lc.hydrate("s0")
    assert lc.stats["corrupt_fallbacks"] + lc.stats["full_replays"] >= 1
    sess.submit(stream[4:])
    assert plane.drain() == 0
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    plane.close()


# ---------------------------------------------------------------------------
# Attachment + the disabled-path contract
# ---------------------------------------------------------------------------


def test_lifecycle_attaches_to_its_plane(monkeypatch, tmp_path):
    """Constructing a DocLifecycle attaches it to the plane, whose close
    closes it; it stores under ``directory`` or a fresh temporary one.
    PERITEXT_LIFECYCLE and PERITEXT_LIFECYCLE_DIR are not read."""
    monkeypatch.setenv("PERITEXT_LIFECYCLE", "1")
    monkeypatch.setenv("PERITEXT_LIFECYCLE_DIR", str(tmp_path / "env"))
    plane = _mk_plane(2)
    assert plane.lifecycle is None
    lc = DocLifecycle(plane, directory=str(tmp_path), start=False)
    assert plane.lifecycle is lc and lc.directory == str(tmp_path)
    plane.close()
    assert lc._closed
    plane2 = _mk_plane(2)
    lc2 = DocLifecycle(plane2, start=False)
    assert os.path.isdir(lc2.directory) and lc2.directory != str(tmp_path / "env")
    plane2.close()
    shutil.rmtree(lc2.directory)


def test_warm_submit_pays_one_attr_check():
    """With no lifecycle attached, the serving hot path's only lifecycle
    cost is the ``plane.lifecycle is None`` check — bounded relative to an
    empty call, best-of-N mins."""

    class P:
        lifecycle = None

    p = P()

    def guarded_site():
        if p.lifecycle is not None:
            raise AssertionError

    def empty_call():
        pass

    site_best = min(timeit_repeat(guarded_site, number=20000, repeat=7))
    base_best = min(timeit_repeat(empty_call, number=20000, repeat=7))
    assert site_best < base_best * 8 + 0.01, (site_best, base_best)


def test_unmanaged_plane_still_byte_identical():
    """A plane with no lifecycle attached behaves exactly as before."""
    names = [f"u{i}" for i in range(3)]
    streams = [author_stream(n, 8, seed=50 + i) for i, n in enumerate(names)]
    plane = _mk_plane(2)
    assert plane.lifecycle is None
    sess = [
        plane.session(f"s{i}", replica=names[i], record_stream=True)
        for i in range(3)
    ]
    for i in range(3):
        sess[i].submit(streams[i])
    assert plane.drain() == 0
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
    plane.close()
