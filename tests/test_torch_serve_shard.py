"""The sharded serving tier of the PyTorch port (``peritext_tpu_torch.
runtime.serve_shard`` over ``TorchUniverse(device="cpu")``):
tests/test_serve_shard.py's scenarios.  Session partitioning across N
universe shards, shard widths held to their sessions (the JAX package's
``bucket="exact"``; the port keeps no pow2 pad rows), round-robin device
placement, per-session byte-identity against direct ingest (under seeded
chaos, breaker fast-fail and the oracle-degrade path too), cross-shard
doc-group fan-out and anti-entropy convergence under chaotic delivery,
and the per-shard trace attribution.

Parity: the same seeded traffic, pubsub chaos included, goes through the
JAX package's ShardedServePlane over TpuUniverse at exact widths, and
every per-submission patch list and session stream must be equal.  Each engine
has its own fault, health and telemetry planes, so a chaos leg arms both
with the same plan.
"""
import os
import random
import sys

import numpy as np
import pytest
import torch

from peritext_tpu.runtime import elastic as jax_elastic
from peritext_tpu.runtime import faults as jax_faults
from peritext_tpu.runtime import health as jax_health
from peritext_tpu.runtime.faults import FaultPlan as JaxFaultPlan
from peritext_tpu.runtime.serve_shard import ShardedServePlane as JaxShardedServePlane
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.oracle import Doc, accumulate_patches
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.runtime.elastic import migrate_session
from peritext_tpu_torch.runtime.faults import FaultPlan
from peritext_tpu_torch.runtime.serve_shard import ShardedServePlane, _GroupLog

from test_torch_serve import author_stream, detached_telemetry, direct_streams  # noqa: F401

CPU = ["cpu"]


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    for name in ("PERITEXT_FAULTS", "PERITEXT_BREAKER", "PERITEXT_SERVE_SHARDS",
                 "PERITEXT_SERVE_SHARD_BUCKET", "PERITEXT_SERVE_PLACEMENT",
                 "PERITEXT_ELASTIC", "PERITEXT_LIFECYCLE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PERITEXT_LAUNCH_BACKOFF", "0.001")
    for mod in (faults, health, jax_faults, jax_health):
        mod.reset()
    yield
    for mod in (faults, health, jax_faults, jax_health):
        mod.reset()


def port_plane(shards, **kw):
    kw.setdefault("devices", CPU)
    return ShardedServePlane(shards, start=False, **kw)


def jax_plane(shards, **kw):
    kw.setdefault("bucket", "exact")
    return JaxShardedServePlane(shards, start=False, **kw)


def sharded_streams(names, streams, rng, shards, make=port_plane, **plane_kw):
    """The per-session traffic through a manual-mode sharded plane with an
    rng-drawn interleaving of submissions and step points.  Returns the
    plane, each session's stream and each submission's patch list."""
    plane = make(shards, **plane_kw)
    sessions = [
        plane.session(
            f"s{i}",
            replica=names[i],
            weight=rng.choice([1, 3]),
            priority=rng.choice(["interactive", "bulk"]),
            record_stream=True,
        )
        for i in range(len(names))
    ]
    subs = []
    cursors = [0] * len(names)
    while any(cursors[i] < len(streams[i]) for i in range(len(names))):
        i = rng.randrange(len(names))
        if cursors[i] >= len(streams[i]):
            continue
        k = min(rng.choice([1, 1, 2, 3]), len(streams[i]) - cursors[i])
        subs.append(sessions[i].submit(streams[i][cursors[i] : cursors[i] + k]))
        cursors[i] += k
        if rng.random() < 0.3:
            plane.step()
    assert plane.drain() == 0
    served = {names[i]: list(sessions[i].patch_log) for i in range(len(names))}
    return plane, served, [s.result(timeout=5.0) for s in subs]


def both_engines(names, streams, seed, shards, **plane_kw):
    """The same seeded run through the port's plane and the JAX package's:
    their sessions' streams and per-submission patch lists must agree."""
    port = sharded_streams(names, streams, random.Random(seed), shards, **plane_kw)
    jax = sharded_streams(names, streams, random.Random(seed), shards, make=jax_plane, **plane_kw)
    assert jax[1] == port[1]
    assert jax[2] == port[2]
    return port


# ---------------------------------------------------------------------------
# The hard wall: byte-identity vs direct per-change ingest, and JAX parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shards", [(0, 2), (1, 3), (2, 4), (3, 8)])
def test_matrix_byte_identity_across_shards(seed, shards):
    rng = random.Random(seed)
    n = rng.choice([3, 4, 5])
    streams = [
        author_stream(f"sh{seed}_{i}", rng.choice([4, 7]), seed=seed * 10 + i)
        for i in range(n)
    ]
    names = [f"r{i}" for i in range(n)]
    plane_kw = dict(batch_target=rng.choice([4, 16]), deadline_ms=5.0)
    plane, served, _ = both_engines(names, streams, seed, shards, **plane_kw)
    uni_d, direct = direct_streams(names, streams)
    assert served == direct
    for name in names:
        assert plane.spans(name) == uni_d.spans(name)
    # Sessions actually spread over the shards (round-robin default).
    used = {plane.shard_of(name) for name in names}
    assert len(used) == min(shards, n)


def test_single_shard_degenerates_to_serve_plane():
    """shards=1 must behave exactly like one ServePlane."""
    rng = random.Random(7)
    streams = [author_stream("deg1_a", 5, seed=1), author_stream("deg1_b", 5, seed=2)]
    names = ["r0", "r1"]
    plane, served, _ = sharded_streams(
        names, streams, rng, 1, batch_target=8, deadline_ms=5.0
    )
    uni_d, direct = direct_streams(names, streams)
    assert served == direct
    assert len(plane.shards) == 1


def test_byte_identity_on_degrade_and_breaker_fastfail(monkeypatch):
    """Every launch fails past the budget, then a tripped breaker
    fast-fails: per-shard ingest completes on the oracle path and the
    served streams stay byte-identical."""
    monkeypatch.setenv("PERITEXT_DEGRADE", "1")
    rng = random.Random(4)
    streams = [author_stream(f"shd_{i}", 4, seed=5 + i) for i in range(3)]
    names = ["r0", "r1", "r2"]
    with faults.injected(FaultPlan().with_site("device_launch", fail=10_000)):
        with health.guarded("device_launch:threshold=1,cooldown=600"):
            plane, served, _ = sharded_streams(
                names, streams, rng, 2, batch_target=8, deadline_ms=5.0
            )
            degraded = sum(
                s.universe.stats["degraded_batches"]
                for s in plane.shards
                if s.universe is not None
            )
            assert degraded >= 2
            assert sum(s.universe.stats["fastfails"] for s in plane.shards) >= 1
    uni_d, direct = direct_streams(names, streams)
    assert served == direct


# ---------------------------------------------------------------------------
# Shape buckets + placement
# ---------------------------------------------------------------------------


def widths(plane):
    return [len(s.universe.replica_ids) for s in plane.shards]


def test_shard_width_tracks_its_sessions():
    """Round-robin: shard 0 fronts 3 sessions, shard 1 fronts 2, and each
    universe is exactly that wide, as the JAX plane's at exact widths."""
    planes = [port_plane(2), jax_plane(2)]
    for plane in planes:
        for i in range(5):
            plane.session(f"s{i}", replica=f"r{i}")
    assert widths(planes[0]) == widths(planes[1]) == [3, 2]
    assert sum(len(s.real) for s in planes[0].shards) == 5
    assert all(s.spare is None for s in planes[0].shards)


def test_width_equals_sessions_at_every_count():
    """A shard fronting n sessions runs an n-wide universe at every count;
    every replica is a row of it and serves."""
    plane = port_plane(1)
    seen = []
    for i in range(9):
        plane.session(f"s{i}", replica=f"r{i}")
        seen.append(widths(plane)[0])
    assert seen == list(range(1, 10))
    uni = plane.shards[0].universe
    assert uni.replica_ids == [f"r{i}" for i in range(9)]
    stream = author_stream("pw", 3)
    s = plane._sessions["s0"]
    s.submit(stream)
    assert plane.drain() == 0
    _, direct = direct_streams(["r0"], [stream])
    assert accumulate_patches(direct["r0"]) == plane.spans("r0")


def test_last_session_leaves_a_spare_the_next_takes_over():
    """A shard whose last session migrates away keeps one inert spare row;
    the next session to arrive takes it over by rename, and the widths
    follow the JAX plane's at every step."""
    stream = author_stream("spare", 4)
    planes = [port_plane(2), jax_plane(2)]
    moves = [migrate_session, jax_elastic.migrate_session]
    got = []
    for plane, move in zip(planes, moves):
        a = plane.session("a", replica="ra", shard=1, record_stream=True)
        plane.session("b", replica="rb", shard=0)
        a.submit(stream[:2])
        assert plane.drain() == 0
        move(plane, "a", 0)
        got.append([widths(plane)])
        c = plane.session("c", replica="rc", shard=1, record_stream=True)
        got[-1].append(widths(plane))
        a.submit(stream[2:])
        c.submit([dict(x) for x in stream])
        assert plane.drain() == 0
        assert plane.shards[1].universe.replica_ids == ["rc"]
        _, direct = direct_streams(["ra", "rc"], [stream, stream])
        assert a.patch_log == direct["ra"] and c.patch_log == direct["rc"]
    assert got[0] == got[1] == [[2, 1], [2, 1]]
    assert planes[0].shards[1].spare is None


def test_equal_width_shards_share_fleet_shapes():
    """Two equal-width shards flushing the same cohort shape count ONE
    fleet-wide shape, not two."""
    streams = [author_stream(f"fw_{i}", 3, seed=20 + i) for i in range(4)]
    names = [f"r{i}" for i in range(4)]
    plane = port_plane(2, batch_target=64)
    sessions = [plane.session(f"s{i}", replica=names[i]) for i in range(4)]
    for i in range(4):
        sessions[i].submit(streams[i])
    assert plane.drain() == 0
    st = plane.stats
    per_shard_shapes = [
        len(s.plane.shape_keys()) for s in plane.shards if s.plane is not None
    ]
    assert st["fleet_compiled_shapes"] <= sum(per_shard_shapes)
    assert st["fleet_compiled_shapes"] <= max(per_shard_shapes) + 1


def test_shards_place_round_robin_on_devices():
    """Shard i's universe lives on ``devices[i % len(devices)]``; with no
    ``devices`` and no CUDA device the first session raises instead of
    moving to the CPU, and nothing is left half-provisioned."""
    devices = ["cpu:0", "cpu:1"]
    plane = port_plane(5, devices=devices)
    for i in range(5):
        plane.session(f"s{i}", replica=f"r{i}")
    want = [torch.device(devices[i % 2]) for i in range(5)]
    assert [s.device for s in plane.shards] == want
    assert [s.universe.device for s in plane.shards] == want
    stream = author_stream("place", 3)
    s4 = plane._sessions["s4"]
    s4.submit(stream)
    assert plane.drain() == 0
    _, direct = direct_streams(["r4"], [stream])
    assert s4.patch_log is None and accumulate_patches(direct["r4"]) == plane.spans("r4")

    assert not torch.cuda.is_available()
    card = ShardedServePlane(2, start=False)  # devices=None: the GPU
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        card.session("a", replica="ra")
    assert card.shards[0].real == [] and card.shards[0].universe is None
    assert "a" not in card._sessions


def test_constructor_knobs(monkeypatch):
    """Shard count and placement are arguments; the JAX package's
    environment variables for them are not read, and there is no bucket
    policy to choose."""
    monkeypatch.setenv("PERITEXT_SERVE_SHARDS", "3")
    monkeypatch.setenv("PERITEXT_SERVE_PLACEMENT", "load")
    plane = ShardedServePlane(start=False)
    assert len(plane.shards) == 1 and plane.placement == "rr"
    assert len(ShardedServePlane(3, start=False).shards) == 3
    with pytest.raises(TypeError):
        ShardedServePlane(2, start=False, bucket="pow2")
    with pytest.raises(ValueError):
        ShardedServePlane(2, start=False, placement="bogus")
    with pytest.raises(ValueError):
        ShardedServePlane(0, start=False)


def test_default_plane_byte_identity():
    """A plane constructed with no shard count runs one shard and stays
    byte-identical."""
    streams = [author_stream(f"env_{i}", 4, seed=50 + i) for i in range(3)]
    names = [f"r{i}" for i in range(3)]
    plane = ShardedServePlane(start=False, batch_target=8, devices=CPU)
    sess = [
        plane.session(f"s{i}", replica=names[i], record_stream=True)
        for i in range(3)
    ]
    for i in range(3):
        sess[i].submit(streams[i])
    assert plane.drain() == 0
    uni_d, direct = direct_streams(names, streams)
    assert {n: list(sess[i].patch_log) for i, n in enumerate(names)} == direct
    assert len(plane.shards) == 1


def test_universe_factory_owns_placement():
    """A universe_factory plane never resolves a device (the factory owns
    placement entirely) and still serves."""
    made = []

    def factory(ids, shard):
        made.append(shard)
        return TorchUniverse(list(ids), device="cpu")

    plane = ShardedServePlane(2, start=False, universe_factory=factory)
    s0 = plane.session("a", replica="ra", record_stream=True)
    plane.session("b", replica="rb")
    assert made == [0, 1]
    assert all(s.device is None for s in plane.shards)
    stream = author_stream("fct", 3)
    s0.submit(stream)
    assert plane.drain() == 0
    _, direct = direct_streams(["ra"], [stream])
    assert list(s0.patch_log) == direct["ra"]


def test_threaded_session_add_during_live_traffic():
    """Threaded mode: opening a session on a shard whose scheduler is
    mid-flush must quiesce the launch first (ServePlane.run_quiesced) —
    replica add/drop rebuilds the state an in-flight launch reads."""
    streams = [author_stream(f"live_{i}", 6, seed=60 + i) for i in range(3)]
    names = [f"r{i}" for i in range(3)]
    plane = ShardedServePlane(1, start=True, batch_target=4, deadline_ms=1.0, devices=CPU)
    try:
        sessions = [plane.session("s0", replica=names[0], record_stream=True)]
        for j, change in enumerate(streams[0]):
            sessions[0].submit([change])
            if j == 1:
                sessions.append(plane.session("s1", replica=names[1], record_stream=True))
            if j == 3:
                sessions.append(plane.session("s2", replica=names[2], record_stream=True))
        for i in (1, 2):
            sessions[i].submit(streams[i])
        plane.flush_and_wait(timeout=60.0)
    finally:
        plane.close()
    uni_d, direct = direct_streams(names, streams)
    assert {n: list(sessions[i].patch_log) for i, n in enumerate(names)} == direct


def test_explicit_shard_pin_and_session_validation():
    plane = port_plane(2)
    a = plane.session("a", replica="ra", shard=1)
    assert a.shard == 1 and plane.shard_of("ra") == 1
    with pytest.raises(ValueError):
        plane.session("a", replica="rb")
    with pytest.raises(ValueError):
        plane.session("b", replica="ra")
    with pytest.raises(ValueError):
        plane.session("b", replica="rb", shard=5)


def _jax_fields(uni):
    import jax

    got = jax.device_get(uni.states)
    return {f: np.asarray(getattr(got, f)) for f in FIELDS}


@pytest.mark.parametrize("spare", [False, True])
def test_sorted_route_through_growth_and_the_spare_row(monkeypatch, spare):
    """A shard on PERITEXT_MERGE_PATH=sorted serves while sessions join:
    the width grows by add_replicas between flushes and, with ``spare``,
    the first session moves to the other shard after its first flush, so
    the next one takes the spare row over by rename.  The census mirror
    and the winner cache must follow the replica axis.  Streams equal
    direct ingest, and shard 0's universe equals the JAX plane's field
    for field."""
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")
    streams = [author_stream(f"srt_{i}", 6, text="sorted route pads " * 3, seed=70 + i) for i in range(5)]
    names = [f"r{i}" for i in range(5)]
    planes = [port_plane(2, batch_target=4), jax_plane(2, batch_target=4)]
    moves = [migrate_session, jax_elastic.migrate_session]
    sessions = [[], []]
    for i in range(5):
        # Session i joins shard 0, then every joined session sends its next two.
        for plane, sess, move in zip(planes, sessions, moves):
            sess.append(plane.session(f"s{i}", replica=names[i], shard=0, record_stream=True))
            for j in range(i + 1):
                sess[j].submit(streams[j][2 * (i - j) : 2 * (i - j) + 2])
            assert plane.drain() == 0
            if spare and i == 0:
                move(plane, "s0", 1)
    for plane, sess in zip(planes, sessions):
        for j in range(5):
            sess[j].submit(streams[j][2 * (5 - j) :])
        assert plane.drain() == 0
    _, direct = direct_streams(names, streams)
    for sess in sessions:
        assert {n: list(s.patch_log) for n, s in zip(names, sess)} == direct
    port_uni, jax_uni = planes[0].shards[0].universe, planes[1].shards[0].universe
    assert port_uni.replica_ids == jax_uni.replica_ids == names[spare:]
    want = _jax_fields(jax_uni)
    got = state_to_numpy(port_uni.states)
    for f, a in want.items():
        assert got[f].dtype == a.dtype and (got[f] == a).all(), f
    assert port_uni.stats["windowed_launches"] + port_uni.stats["launches"] >= 1


# ---------------------------------------------------------------------------
# Cross-shard anti-entropy (the doc replication group)
# ---------------------------------------------------------------------------


def _doc_group_plane(shards, members, make=port_plane, **plane_kw):
    plane = make(shards, **plane_kw)
    sessions = [
        plane.session(f"g{i}", replica=f"gr{i}", doc="essay", record_stream=True)
        for i in range(members)
    ]
    return plane, sessions


def test_doc_group_fans_out_across_shards():
    stream = author_stream("fan", 5)
    plane, sessions = _doc_group_plane(3, 3, batch_target=8, deadline_ms=5.0)
    assert {s.shard for s in sessions} == {0, 1, 2}
    sessions[0].submit(stream)
    assert plane.drain() == 0
    spans = [plane.spans(s.replica) for s in sessions]
    assert spans[0] == spans[1] == spans[2]
    for s in sessions:
        assert accumulate_patches(s.patch_log) == plane.spans(s.replica)


def _chaotic_doc_group(make, plan, stream):
    with (faults if make is port_plane else jax_faults).injected(plan):
        plane, sessions = _doc_group_plane(3, 3, make=make, batch_target=8, deadline_ms=5.0)
        subs = []
        for change in stream:
            subs.append(sessions[0].submit([change]))
            plane.step()
        plane.drain()
    redelivered = plane.anti_entropy()
    assert plane.drain() == 0
    return plane, sessions, [s.result(timeout=5.0) for s in subs], redelivered


@pytest.mark.parametrize("seed", [13, 21])
def test_doc_group_converges_under_chaotic_delivery(seed):
    """Seeded drop/dup/reorder on the cross-shard pubsub links: live
    fan-out leaves gaps, anti-entropy redelivery closes them, and every
    shard's replica converges byte-identically.  The JAX plane under the
    same seeded plan drops, duplicates and holds back the same deliveries
    (the per-subscriber stream keys match), so every session's stream and
    every submission's patches are equal."""
    stream = author_stream(f"chaosfan{seed}", 10, seed=seed)
    spec = dict(drop=0.4, dup=0.2, reorder=0.3)
    plan = FaultPlan(seed=seed).with_site("pubsub_deliver", **spec)
    plane, sessions, results, redelivered = _chaotic_doc_group(port_plane, plan, stream)
    assert plan.stats["pubsub_deliver"]["dropped"] >= 1
    spans = [plane.spans(s.replica) for s in sessions]
    assert spans[0] == spans[1] == spans[2]
    uni_d, _ = direct_streams(["ref"], [[dict(c) for c in stream]])
    assert spans[0] == uni_d.spans("ref")
    for s in sessions:
        assert accumulate_patches(s.patch_log) == plane.spans(s.replica)
    jplan = JaxFaultPlan(seed=seed).with_site("pubsub_deliver", **spec)
    jplane, jsessions, jresults, jredelivered = _chaotic_doc_group(jax_plane, jplan, stream)
    assert jplan.stats == plan.stats
    assert jredelivered == redelivered
    assert jresults == results
    assert [s.patch_log for s in jsessions] == [s.patch_log for s in sessions]


def test_doc_group_two_writers_converge():
    """Two sessions of the same doc on different shards both write
    concurrently; fan-out + anti-entropy merge them identically."""
    a, b = Doc("wa"), Doc("wb")
    genesis, _ = a.change(
        [
            {"path": [], "action": "makeList", "key": "text"},
            {"path": ["text"], "action": "insert", "index": 0, "values": list("base")},
        ]
    )
    b.apply_change(genesis)
    ca, _ = a.change([{"path": ["text"], "action": "insert", "index": 0, "values": list("A")}])
    cb, _ = b.change([{"path": ["text"], "action": "insert", "index": 4, "values": list("B")}])
    plane, sessions = _doc_group_plane(2, 2, batch_target=8)
    sessions[0].submit([genesis, ca])
    sessions[1].submit([cb])
    plane.drain()
    plane.anti_entropy()
    assert plane.drain() == 0
    assert plane.spans(sessions[0].replica) == plane.spans(sessions[1].replica)
    a.apply_change(cb)
    b.apply_change(ca)
    assert plane.spans(sessions[0].replica) == a.get_text_with_formatting(["text"])


def test_fanout_link_failure_never_voids_the_submission():
    """Live cross-shard fan-out is best-effort: a failing delivery link
    must not surface to the submitter or void its patches future."""
    stream = author_stream("ffail", 4)
    plan = FaultPlan(seed=2).with_site("pubsub_deliver", fail=2)
    with faults.injected(plan):
        plane, sessions = _doc_group_plane(2, 2, batch_target=8)
        sub = sessions[0].submit(stream)  # must NOT raise
        plane.drain()
    assert plan.stats["pubsub_deliver"]["failed"] >= 1
    assert sub.done() and sub.result()
    plane.anti_entropy()
    assert plane.drain() == 0
    assert plane.spans(sessions[0].replica) == plane.spans(sessions[1].replica)


def test_rename_replica_rebinds_only_empty_rows():
    """The spare-row takeover (TorchUniverse.rename_replica): pure
    bookkeeping for untouched rows, loud rejection otherwise."""
    stream = author_stream("ren", 2)
    uni = TorchUniverse(["live", "pad"], device="cpu")
    uni.apply_changes_with_patches({"live": stream})
    with pytest.raises(ValueError):
        uni.rename_replica("live", "fresh")
    with pytest.raises(KeyError):
        uni.rename_replica("ghost", "fresh")
    with pytest.raises(ValueError):
        uni.rename_replica("pad", "live")
    uni.rename_replica("pad", "fresh")
    assert "pad" not in uni.index_of and uni.index_of["fresh"] == 1
    out = uni.apply_changes_with_patches({"fresh": [dict(c) for c in stream]})
    assert out["fresh"]
    assert uni.spans("fresh") == uni.spans("live")


def test_group_log_rejects_forked_history():
    log = _GroupLog()
    log.record({"actor": "x", "seq": 1, "ops": [1]})
    log.record({"actor": "x", "seq": 1, "ops": [1]})  # idempotent
    with pytest.raises(ValueError):
        log.record({"actor": "x", "seq": 1, "ops": [2]})
    log.record({"actor": "x", "seq": 3, "ops": [3]})  # gap held back
    assert [c["seq"] for c in log.contiguous({})] == [1]
    log.record({"actor": "x", "seq": 2, "ops": [2.5]})
    assert [c["seq"] for c in log.contiguous({})] == [1, 2, 3]
    assert [c["seq"] for c in log.contiguous({"x": 2})] == [3]


def test_status_surface_registers_every_plane(detached_telemetry):
    """The fleet view and each shard's ServePlane register with
    telemetry.status() (weakly: a dropped plane leaves the surface)."""
    import gc

    telemetry.enable()
    plane = port_plane(2, name="status_probe")
    plane.session("a", replica="ra")
    plane.session("b", replica="rb")

    def ours(st, kind):
        return [p for p in st.get(kind, []) if p["plane"].startswith("status_probe")]

    st = telemetry.status()
    (fleet,) = ours(st, "serve_shards")
    assert fleet["doc_groups"] == 0
    assert [s["width"] for s in fleet["shards"]] == [1, 1]
    assert sorted(p["shard"] for p in ours(st, "serve")) == [0, 1]
    del plane, fleet, st
    gc.collect()
    st = telemetry.status()
    assert ours(st, "serve_shards") == [] and ours(st, "serve") == []


# ---------------------------------------------------------------------------
# Trace attribution
# ---------------------------------------------------------------------------


def test_sharded_trace_attributes_lanes_and_overlap(tmp_path, detached_telemetry):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import trace_report

    trace = str(tmp_path / "shard_trace.jsonl")
    telemetry.enable(trace=trace)
    rng = random.Random(6)
    streams = [author_stream(f"tr_{i}", 4, seed=40 + i) for i in range(4)]
    sharded_streams(
        [f"r{i}" for i in range(4)], streams, rng, 2,
        batch_target=8, deadline_ms=5.0,
    )
    telemetry.flush_trace()
    analysis = trace_report.analyze(trace_report.load_events(trace))
    assert analysis["problems"] == []
    ss = analysis["serve_shards"]
    assert ss is not None and ss["shards"] == 2
    assert sum(d["lanes"] for d in ss["per_shard"].values()) >= 4
    assert all(d["flushes"] >= 1 for d in ss["per_shard"].values())
    assert ss["flush_busy_us"] > 0
    assert ss["flush_overlap_us"] >= 0.0
    counters = telemetry.snapshot()["counters"]
    assert sum(counters.get(f"serve.shard.{i}.compile_cache_miss", 0) for i in (0, 1)) >= 2
    # An unsharded run reports no shard block.
    trace2 = str(tmp_path / "flat_trace.jsonl")
    telemetry.reset()
    telemetry.enable(trace=trace2)
    from test_torch_serve import serve_streams

    serve_streams(["r0"], [author_stream("flat", 3)], random.Random(1))
    telemetry.flush_trace()
    a2 = trace_report.analyze(trace_report.load_events(trace2))
    assert a2["serve_shards"] is None
