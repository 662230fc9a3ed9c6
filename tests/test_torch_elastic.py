"""Elastic serving in the PyTorch port (``peritext_tpu_torch.runtime.
elastic`` over ``TorchUniverse(device="cpu")`` shards):
tests/test_elastic.py's scenarios.  A session migrated mid-stream (any
number of times, between any shards) produces a patch stream
byte-identical to an unmigrated run, and a migration that fails at ANY
protocol step (the ``shard_migrate`` fault site) rolls back to the source
shard with the same guarantee.  The autoscaler splits a hot shard and
merges a quiet fleet.

Parity: the same seeded traffic and migrations go through the JAX
package's ShardedServePlane over TpuUniverse at exact widths (the port
keeps no pow2 pad rows); every per-submission patch list, session stream
and shard width must be equal.
"""
import os
import random
from timeit import repeat as timeit_repeat

import pytest

from peritext_tpu.runtime import elastic as jax_elastic
from peritext_tpu.runtime import faults as jax_faults
from peritext_tpu.runtime import health as jax_health
from peritext_tpu.runtime.serve_shard import ShardedServePlane as JaxShardedServePlane
from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.oracle import accumulate_patches
from peritext_tpu_torch.runtime import checkpoint, elastic, faults, health, slo, telemetry
from peritext_tpu_torch.runtime.elastic import ElasticController, MigrationError, migrate_session
from peritext_tpu_torch.runtime.faults import FaultError, FaultPlan
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


def _mk_plane(shards, **kw):
    kw.setdefault("start", False)
    kw.setdefault("batch_target", 64)
    kw.setdefault("deadline_ms", 10**9)
    kw.setdefault("devices", ["cpu"])
    return ShardedServePlane(shards, **kw)


def _mk_jax_plane(shards, **kw):
    kw.setdefault("bucket", "exact")
    kw.setdefault("start", False)
    kw.setdefault("batch_target", 64)
    kw.setdefault("deadline_ms", 10**9)
    return JaxShardedServePlane(shards, **kw)


# ---------------------------------------------------------------------------
# Byte-identity under live migration
# ---------------------------------------------------------------------------


def test_single_migration_byte_identity():
    """Move every session to the other shard mid-stream; each session's
    concatenated patch stream must equal direct per-change ingest."""
    plane = _mk_plane(2)
    names = [f"a{i}" for i in range(4)]
    streams = [author_stream(n, 12, seed=40 + i) for i, n in enumerate(names)]
    sess = [
        plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
        for i in range(4)
    ]
    for i in range(4):
        sess[i].submit(streams[i][:6])
    assert plane.drain() == 0
    for i in range(4):
        migrate_session(plane, f"s{i}", 1)
        assert sess[i].shard == 1
    for i in range(4):
        sess[i].submit(streams[i][6:])
    assert plane.drain() == 0
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
    assert [len(s.real) for s in plane.shards] == [0, 4]
    plane.close()


def _migration_run(make, migrate, seed):
    """rng-interleaved submissions with random mid-stream migrations across
    3 shards.  Returns the plane, the sessions, each submission's patches
    and the migrations made."""
    rng = random.Random(seed)
    plane = make(3)
    names = [f"m{i}" for i in range(5)]
    streams = [author_stream(n, 10, seed=60 + i) for i, n in enumerate(names)]
    sess = [
        plane.session(f"s{i}", replica=names[i], record_stream=True)
        for i in range(5)
    ]
    subs, moves = [], []
    cursors = [0] * 5
    while any(c < len(streams[i]) for i, c in enumerate(cursors)):
        i = rng.randrange(5)
        if cursors[i] >= len(streams[i]):
            continue
        k = min(rng.choice([1, 2, 3]), len(streams[i]) - cursors[i])
        subs.append(sess[i].submit(streams[i][cursors[i] : cursors[i] + k]))
        cursors[i] += k
        if rng.random() < 0.25:
            plane.step()
        if rng.random() < 0.2:
            j = rng.randrange(5)
            target = (sess[j].shard + rng.randrange(1, 3)) % 3
            migrate(plane, f"s{j}", target)
            moves.append((j, target))
    assert plane.drain() == 0
    return plane, names, streams, sess, [s.result(timeout=5.0) for s in subs], moves


@pytest.mark.parametrize("seed", [0, 7])
def test_migration_matrix_byte_identity(seed):
    """Placement churn must stay invisible in the streams; the JAX plane
    given the same traffic and migrations agrees submission for
    submission, and ends with the same shard widths."""
    plane, names, streams, sess, results, moves = _migration_run(_mk_plane, migrate_session, seed)
    assert moves
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
        assert accumulate_patches(sess[i].patch_log) == plane.spans(n)
    jplane, _, _, jsess, jresults, jmoves = _migration_run(_mk_jax_plane, jax_elastic.migrate_session, seed)
    assert jmoves == moves
    assert jresults == results
    assert [s.patch_log for s in jsess] == [s.patch_log for s in sess]
    assert [s.shard for s in jsess] == [s.shard for s in sess]
    assert [len(s.universe.replica_ids) for s in jplane.shards] == [
        len(s.universe.replica_ids) for s in plane.shards
    ]
    plane.close()
    jplane.close()


def test_migration_across_capacities():
    """A migrated row lands in a shard whose universe has grown past the
    row's capacity (the row grows to the target's buckets), and a grown row
    lands in a smaller universe (the target grows to fit it)."""
    plane = _mk_plane(2, capacity=32, max_mark_ops=32)
    long_doc = author_stream("wide", 6, text="x" * 80, seed=3)
    short = author_stream("narrow", 6, text="ab", seed=4)
    s_long = plane.session("long", replica="wide", shard=1, record_stream=True)
    s_short = plane.session("short", replica="narrow", shard=0, record_stream=True)
    s_long.submit(long_doc[:4])
    s_short.submit(short[:4])
    assert plane.drain() == 0
    assert plane.shards[1].universe.capacity >= 128
    assert plane.shards[0].universe.capacity == 32
    migrate_session(plane, "short", 1)  # small row into the grown universe
    s_short.submit(short[4:])
    assert plane.drain() == 0
    migrate_session(plane, "long", 0)  # grown row into the fresh shard 0
    s_long.submit(long_doc[4:])
    assert plane.drain() == 0
    _, want = direct_streams(["wide", "narrow"], [long_doc, short])
    assert s_long.patch_log == want["wide"]
    assert s_short.patch_log == want["narrow"]
    assert plane.shards[0].universe.capacity >= 128
    plane.close()


def test_migrate_validation_errors():
    plane = _mk_plane(2)
    plane.session("s0", "a0", shard=0)
    with pytest.raises(KeyError):
        migrate_session(plane, "nope", 1)
    with pytest.raises(ValueError):
        migrate_session(plane, "s0", 0)  # already there
    with pytest.raises(ValueError):
        migrate_session(plane, "s0", 9)  # out of range
    plane.close()


# ---------------------------------------------------------------------------
# Chaos: rollback at every protocol step
# ---------------------------------------------------------------------------


def test_rollback_at_every_protocol_step(monkeypatch):
    """Fail the shard_migrate chokepoint at step k for k=1..5: each attempt
    raises MigrationError, leaves the source shard authoritative and the
    park buffer empty, and the streams stay byte-identical once the
    traffic finishes; a real migration afterwards still works."""
    names = ["ra", "rb"]
    streams = [author_stream(n, 10, seed=80 + i) for i, n in enumerate(names)]
    _, want = direct_streams(names, streams)
    for fail_step in range(1, 6):
        plane = _mk_plane(2)
        sess = [
            plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
            for i in range(2)
        ]
        for i in range(2):
            sess[i].submit(streams[i][:5])
        assert plane.drain() == 0

        calls = {"n": 0}
        real_fire = faults.fire

        def counting_fire(site, **kw):
            if site == "shard_migrate":
                calls["n"] += 1
                if calls["n"] == fail_step:
                    raise FaultError(site, f"induced at step {fail_step}")
            return real_fire(site, **kw)

        monkeypatch.setattr(elastic.faults, "fire", counting_fire)
        with pytest.raises(MigrationError):
            migrate_session(plane, "s0", 1)
        monkeypatch.setattr(elastic.faults, "fire", real_fire)

        assert sess[0]._parked is None
        assert sess[0].shard == 0
        assert [len(s.real) for s in plane.shards] == [2, 0]
        for i in range(2):
            sess[i].submit(streams[i][5:])
        assert plane.drain() == 0
        for i, n in enumerate(names):
            assert sess[i].patch_log == want[n], (fail_step, n)
        migrate_session(plane, "s0", 1)
        assert sess[0].shard == 1
        plane.close()


def test_fault_plan_spec_rollback_and_blackbox(tmp_path, detached_telemetry):
    """The seeded grammar drives the site; a failed migration fires exactly
    one black-box dump and the fleet keeps byte-identity."""
    telemetry.enable(blackbox=str(tmp_path))
    names = ["fa", "fb"]
    streams = [author_stream(n, 8, seed=90 + i) for i, n in enumerate(names)]
    plane = _mk_plane(2)
    sess = [
        plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
        for i in range(2)
    ]
    for i in range(2):
        sess[i].submit(streams[i][:4])
    assert plane.drain() == 0
    plan = FaultPlan.from_spec("seed=7;shard_migrate:fail=1")
    with faults.injected(plan):
        with pytest.raises(MigrationError):
            migrate_session(plane, "s0", 1)
        assert plan.stats["shard_migrate"]["failed"] == 1
        migrate_session(plane, "s0", 1)  # budget spent; second succeeds
    assert sess[0].shard == 1
    dumps = [p for p in os.listdir(str(tmp_path)) if p.endswith(".json")]
    assert len(dumps) == 1, dumps
    snap = telemetry.snapshot()
    assert snap["counters"].get("elastic.rollbacks") == 1
    assert snap["counters"].get("elastic.migrations") == 1
    for i in range(2):
        sess[i].submit(streams[i][4:])
    assert plane.drain() == 0
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
    plane.close()


# ---------------------------------------------------------------------------
# Parking: in-flight submissions across the handoff
# ---------------------------------------------------------------------------


def test_parked_submission_resolves_after_replay():
    """A submit that lands mid-migration parks; the commit replay binds it
    to a real submission whose patches match direct ingest."""
    plane = _mk_plane(2)
    n = "pk"
    stream = author_stream(n, 6, seed=5)
    sess = plane.session("s0", replica=n, shard=0, record_stream=True)
    sess.submit(stream[:3])
    assert plane.drain() == 0
    sess._parked = []
    wrapper = sess.submit(stream[3:])
    assert not wrapper.done()
    assert sess._inner.pending() == 0
    elastic._replay_parked(sess, sess._inner, "s0", filter_chaos=False)
    assert sess._parked is None
    assert plane.drain() == 0
    patches = wrapper.result(timeout=5.0)
    _, want = direct_streams([n], [stream])
    assert sess.patch_log == want[n]
    assert patches and sess.patch_log[-len(patches):] == patches
    plane.close()


# ---------------------------------------------------------------------------
# Doc groups: cross-shard replication survives migration
# ---------------------------------------------------------------------------


def test_doc_group_migration_convergence():
    plane = _mk_plane(2)
    s1 = plane.session("d1", "da", doc="shared", shard=0, record_stream=True)
    plane.session("d2", "db", doc="shared", shard=1, record_stream=True)
    stream = author_stream("da", 8, seed=3)
    s1.submit(stream[:4])
    assert plane.drain() == 0
    migrate_session(plane, "d2", 0)
    s1.submit(stream[4:])
    assert plane.drain() == 0
    plane.anti_entropy()
    assert plane.drain() == 0
    assert plane.spans("da") == plane.spans("db")
    plane.close()


# ---------------------------------------------------------------------------
# export/import_replica (runtime/checkpoint.py)
# ---------------------------------------------------------------------------


def test_export_import_replica_roundtrip():
    full = author_stream("xa", 13, seed=21)
    src = TorchUniverse(["xa"], device="cpu")
    src.apply_changes({"xa": full[:11]})
    # Target with its OWN intern history first, so ids must remap.
    other = author_stream("zz", 3, seed=22)
    tgt = TorchUniverse(["zz", "xb"], device="cpu")
    tgt.apply_changes({"zz": other})
    payload = checkpoint.export_replica(src, "xa")
    checkpoint.import_replica(tgt, "xb", payload)
    assert tgt.spans("xb") == src.spans("xa")
    assert tgt.clock("xb") == src.clock("xa")
    src.apply_changes({"xa": full[11:]})
    tgt.apply_changes({"xb": full[11:]})
    assert tgt.spans("xb") == src.spans("xa")


def test_import_replica_guards():
    stream = author_stream("ga", 4, seed=31)
    src = TorchUniverse(["ga"], device="cpu")
    src.apply_changes({"ga": stream})
    payload = checkpoint.export_replica(src, "ga")
    tampered = dict(payload, digest="0" * 64)
    tgt = TorchUniverse(["gb"], device="cpu")
    with pytest.raises(ValueError, match="digest"):
        checkpoint.import_replica(tgt, "gb", tampered)
    busy = TorchUniverse(["gc"], device="cpu")
    busy.apply_changes({"gc": author_stream("gc", 2, seed=32)})
    with pytest.raises(ValueError, match="non-empty"):
        checkpoint.import_replica(busy, "gc", payload)


# ---------------------------------------------------------------------------
# Placement policies
# ---------------------------------------------------------------------------


def test_placement_load_prefers_empty_shard():
    plane = _mk_plane(2, placement="load")
    plane.session("p0", "pa", shard=0)
    s = plane.session("p1", "pb")
    assert s.shard == 1
    plane.close()


def test_placement_argument_and_validation(monkeypatch):
    """Placement is an argument; PERITEXT_SERVE_PLACEMENT is not read."""
    monkeypatch.setenv("PERITEXT_SERVE_PLACEMENT", "load")
    plane = _mk_plane(2)
    assert plane.placement == "rr"
    plane.close()
    plane = _mk_plane(2, placement="load")
    assert plane.placement == "load"
    plane.close()
    with pytest.raises(ValueError):
        _mk_plane(2, placement="bogus")


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


def test_controller_splits_hot_shard_and_merges_when_quiet():
    plane = _mk_plane(2)
    names = [f"c{i}" for i in range(4)]
    streams = [author_stream(n, 12, seed=70 + i) for i, n in enumerate(names)]
    sess = [
        plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
        for i in range(4)
    ]
    ctl = ElasticController(plane, interval=3600.0, spread=2.0, cooldown=0.0, start=False)
    for i in range(4):
        sess[i].submit(streams[i][:6])
    assert ctl.tick() == "split"
    assert ctl.last_action["ok"] and ctl.last_action["action"] == "split"
    assert plane.drain() == 0
    acts = [ctl.tick() for _ in range(ctl.merge_quiet + 4)]
    assert "split" not in acts
    assert "merge" in acts
    assert acts[-1] is None and acts[-2] is None
    for i in range(4):
        sess[i].submit(streams[i][6:])
    assert plane.drain() == 0
    _, want = direct_streams(names, streams)
    for i, n in enumerate(names):
        assert sess[i].patch_log == want[n], n
    assert ctl.stats["migrations"] >= 2
    assert ctl.stats["failures"] == 0
    ctl.close()
    plane.close()


def test_controller_status_surface(detached_telemetry):
    telemetry.enable()
    plane = _mk_plane(2, name="elastic_status")
    ctl = ElasticController(plane, interval=3600.0, cooldown=0.0, start=False)
    plane.session("s0", "sa", shard=0)
    ctl.tick()
    st = telemetry.status()
    blocks = [b for b in st.get("elastic", []) if b["plane"] == "elastic_status"]
    assert blocks, st.keys()
    blk = blocks[-1]
    assert blk["ticks"] >= 1
    assert {"loads", "in_flight", "migrations", "rollbacks"} <= set(blk)
    assert [e["shard"] for e in blk["loads"]] == [0, 1]
    ctl.close()
    plane.close()


def test_controller_burn_split_deterministic(detached_telemetry):
    """While an SLO breach is active, session imbalance >= 2 splits even
    with zero pending spread; ``watch_slo=False`` blinds the controller."""
    telemetry.enable()
    slo.install("e2e.admit_to_applied:p95=1,window=8,fast=4,min=4")
    try:
        for _ in range(8):
            telemetry.observe("e2e.admit_to_applied", 1.0)
        assert slo.active().breach_active()
        plane = _mk_plane(2)
        names = [f"b{i}" for i in range(3)]
        streams = [author_stream(n, 3, seed=80 + i) for i, n in enumerate(names)]
        sess = [
            plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True)
            for i in range(3)
        ]
        for i in range(3):
            sess[i].submit(streams[i])
        assert plane.drain() == 0
        blind = ElasticController(
            plane, interval=3600.0, spread=4.0, cooldown=0.0, watch_slo=False, start=False,
        )
        assert blind.tick() is None
        blind.close()
        ctl = ElasticController(plane, interval=3600.0, spread=4.0, cooldown=0.0, start=False)
        acts = [ctl.tick() for _ in range(4)]
        assert acts[0] == "split"
        assert [len(s.real) for s in plane.shards] == [2, 1]
        assert "merge" not in acts and acts[-1] is None
        ctl.close()
        plane.close()
    finally:
        slo.reset()


def test_controller_attaches_to_its_plane(monkeypatch):
    """Constructing a controller attaches it to the plane, whose close
    closes it; PERITEXT_ELASTIC attaches nothing."""
    monkeypatch.setenv("PERITEXT_ELASTIC", "1")
    plane = _mk_plane(2)
    assert plane.elastic is None
    ctl = ElasticController(plane, interval=3600.0, start=False)
    assert plane.elastic is ctl
    plane.close()
    assert ctl._closed


# ---------------------------------------------------------------------------
# Disabled-path contract
# ---------------------------------------------------------------------------


def test_unmigrated_submit_pays_one_attr_check():
    """With no migration in flight, the serving hot path's only elastic
    cost is the ``_parked is None`` check — bounded relative to an empty
    call, best-of-N mins."""

    class S:
        _parked = None

    s = S()

    def guarded_site():
        if s._parked is not None:
            raise AssertionError

    def empty_call():
        pass

    site_best = min(timeit_repeat(guarded_site, number=20000, repeat=7))
    base_best = min(timeit_repeat(empty_call, number=20000, repeat=7))
    assert site_best < base_best * 8 + 0.01, (site_best, base_best)


def test_serve_shard_differentials_still_green_with_elastic_import():
    """Importing elastic must not perturb an unmigrated sharded run."""
    names = [f"g{i}" for i in range(3)]
    streams = [author_stream(n, 8, seed=50 + i) for i, n in enumerate(names)]
    plane = _mk_plane(2)
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
