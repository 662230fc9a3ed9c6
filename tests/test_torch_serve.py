"""The serving plane of the PyTorch port (``peritext_tpu_torch.runtime.
serve`` over ``TorchUniverse(device="cpu")``): tests/test_serve.py's
scenarios.  Differential byte-identity against direct per-change ingest
(under seeded chaos, the breaker fast-fail path and the oracle-degrade
path too), DWRR fairness, the deadline/hold/shed policies under a sick
backend, per-session backpressure, shape tracking, and the trace and e2e
integration.  The matrix also serves the same seeded traffic through the
JAX package's ServePlane over TpuUniverse and through direct TpuUniverse
ingest: every per-submission patch list must be equal.

The port's fault, health and telemetry planes are its own; the autouse
fixture resets them around every test.
"""
import os
import random
import sys
import time

import pytest

from peritext_tpu.ops import TpuUniverse
from peritext_tpu.runtime.serve import ServePlane as JaxServePlane
from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.runtime.faults import FaultPlan
from peritext_tpu_torch.runtime.queue import QueueFullError
from peritext_tpu_torch.runtime.serve import (
    BULK,
    INTERACTIVE,
    ServeClosedError,
    ServePlane,
    ServeShedError,
)


def Universe(names):
    return TorchUniverse(names, device="cpu")


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    for name in ("PERITEXT_FAULTS", "PERITEXT_BREAKER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PERITEXT_LAUNCH_BACKOFF", "0.001")
    faults.reset()
    health.reset()
    yield
    faults.reset()
    health.reset()


@pytest.fixture()
def detached_telemetry():
    """Stash the ambient telemetry plane (a suite-wide PERITEXT_TRACE run
    must keep tracing after this file) and hand the test a pristine one."""
    saved = (
        telemetry.enabled,
        telemetry._tracer,
        telemetry._metrics_path,
        telemetry._registry,
        telemetry._recorder,
        telemetry._blackbox_dir,
    )
    telemetry.enabled = False
    telemetry._tracer = None
    telemetry._metrics_path = None
    telemetry._registry = telemetry.Registry()
    telemetry._recorder = None
    telemetry._blackbox_dir = None
    yield
    telemetry.reset()
    (
        telemetry.enabled,
        telemetry._tracer,
        telemetry._metrics_path,
        telemetry._registry,
        telemetry._recorder,
        telemetry._blackbox_dir,
    ) = saved


def author_stream(actor, n_changes, text="serving plane", seed=0):
    """Genesis + n causally-consecutive single-op changes by one editor."""
    rng = random.Random(seed)
    doc = Doc(actor)
    genesis, _ = doc.change(
        [
            {"path": [], "action": "makeList", "key": "text"},
            {"path": ["text"], "action": "insert", "index": 0, "values": list(text)},
        ]
    )
    changes = [genesis]
    for _ in range(n_changes):
        length = sum(len(s["text"]) for s in doc.get_text_with_formatting(["text"]))
        kind = rng.choice(["insert", "insert", "delete", "mark"])
        if kind == "insert" or length < 3:
            op = {
                "path": ["text"],
                "action": "insert",
                "index": rng.randrange(length + 1) if length else 0,
                "values": [rng.choice("abcxyz")],
            }
        elif kind == "delete":
            op = {
                "path": ["text"],
                "action": "delete",
                "index": rng.randrange(length),
                "count": 1,
            }
        else:
            start = rng.randrange(length)
            op = {
                "path": ["text"],
                "action": "addMark",
                "startIndex": start,
                "endIndex": start + rng.randrange(length - start) + 1,
                "markType": rng.choice(["strong", "em"]),
            }
        change, _ = doc.change([op])
        changes.append(change)
    return changes


def direct_streams(names, streams, make=Universe):
    """The reference: each replica ingests its session's changes ONE call
    per change.  Returns (universe, {replica: concatenated patch list})."""
    uni = make(names)
    out = {}
    for name, stream in zip(names, streams):
        acc = []
        for change in stream:
            acc.extend(uni.apply_changes_with_patches({name: [change]})[name])
        out[name] = acc
    return uni, out


def serve_streams(names, streams, rng, make=Universe, plane_cls=ServePlane, **plane_kw):
    """The same per-session traffic through a manual-mode plane with an
    rng-drawn interleaving of submissions and flush points."""
    uni = make(names)
    plane = plane_cls(uni, start=False, **plane_kw)
    sessions = [
        plane.session(
            f"s{i}",
            replica=names[i],
            weight=rng.choice([1, 3]),
            priority=rng.choice([INTERACTIVE, BULK]),
            record_stream=True,
        )
        for i in range(len(names))
    ]
    cursors = [0] * len(names)
    while any(cursors[i] < len(streams[i]) for i in range(len(names))):
        i = rng.randrange(len(names))
        if cursors[i] >= len(streams[i]):
            continue
        k = min(rng.choice([1, 1, 2, 3]), len(streams[i]) - cursors[i])
        sessions[i].submit(streams[i][cursors[i] : cursors[i] + k])
        cursors[i] += k
        if rng.random() < 0.3:
            plane.step()
    assert plane.drain() == 0
    return uni, plane, {names[i]: list(sessions[i].patch_log) for i in range(len(names))}


# ---------------------------------------------------------------------------
# The hard wall: differential byte-identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_matrix_byte_identity(seed):
    """Randomized (sessions x weights x priorities x batch/deadline x
    interleaving) matrix: served streams must equal direct per-change
    ingest exactly, and the final device states must match.  The same
    seed through the JAX package's plane over TpuUniverse, and direct
    TpuUniverse ingest, give the same per-submission patches."""
    rng = random.Random(seed)
    n = rng.choice([2, 3])
    streams = [
        author_stream(f"a{seed}_{i}", rng.choice([4, 7]), seed=seed * 10 + i)
        for i in range(n)
    ]
    names = [f"r{i}" for i in range(n)]
    plane_kw = dict(batch_target=rng.choice([4, 16, 64]), deadline_ms=5.0, quantum=rng.choice([1, 4]))
    state = rng.getstate()
    uni_s, plane, served = serve_streams(names, streams, rng, **plane_kw)
    uni_d, direct = direct_streams(names, streams)
    assert served == direct
    assert uni_s.texts() == uni_d.texts()
    assert (uni_s.digests() == uni_d.digests()).all()
    assert plane.stats["flushes"] <= sum(len(s) for s in streams)
    rng.setstate(state)
    uni_j, plane_j, served_j = serve_streams(
        names, streams, rng, make=TpuUniverse, plane_cls=JaxServePlane, **plane_kw
    )
    assert served_j == served
    assert without_deadline_misses(plane_j.stats) == without_deadline_misses(plane.stats)
    assert direct_streams(names, streams, make=TpuUniverse)[1] == direct
    assert (uni_j.digests() == uni_s.digests()).all()


def without_deadline_misses(stats):
    """A plane's stats less ``deadline_misses``: it counts submissions whose
    wall-clock wait outlived the deadline, so it is not a property of the
    traffic.  In manual mode nothing else reads the clock."""
    return {k: v for k, v in stats.items() if k != "deadline_misses"}


@pytest.mark.parametrize("deadline_ms, misses", [(1e9, "none"), (0.0, "all")])
def test_matrix_deadline_misses_match_jax(deadline_ms, misses):
    """``deadline_misses`` equal between the port's plane and the JAX
    package's on the same traffic, with no clock in the outcome: a deadline
    no run can miss counts none, and a zero deadline counts every
    submission (each waits from its submit to after its flush)."""
    rng = random.Random(1)
    streams = [author_stream(f"dl{i}", 5, seed=i) for i in range(2)]
    names = ["r0", "r1"]
    plane_kw = dict(batch_target=4, deadline_ms=deadline_ms, quantum=1)
    state = rng.getstate()
    _, plane, served = serve_streams(names, streams, rng, **plane_kw)
    rng.setstate(state)
    _, plane_j, served_j = serve_streams(
        names, streams, rng, make=TpuUniverse, plane_cls=JaxServePlane, **plane_kw
    )
    assert served_j == served
    want = 0 if misses == "none" else plane.stats["submits"]
    assert plane.stats["deadline_misses"] == plane_j.stats["deadline_misses"] == want
    assert plane_j.stats == plane.stats


def test_intra_submission_reorder_uses_gate_order():
    """A submission delivered out of causal order (per-actor grouped, like
    log.missing_changes) must apply in causal_order's arrangement — the
    same order one direct apply call with the same list would use."""
    stream = author_stream("reorder", 4)
    names = ["r0"]
    uni_s = Universe(names)
    plane = ServePlane(uni_s, start=False)
    s = plane.session("s0", replica="r0", record_stream=True)
    shuffled = [stream[0], stream[3], stream[1], stream[4], stream[2]]
    s.submit(shuffled)
    assert plane.drain() == 0
    uni_d = Universe(names)
    expect = uni_d.apply_changes_with_patches({"r0": shuffled})["r0"]
    assert s.patch_log == expect
    assert (uni_s.digests() == uni_d.digests()).all()


def test_byte_identity_with_telemetry_on(tmp_path, detached_telemetry):
    rng = random.Random(2)
    streams = [author_stream("tel_a", 5, seed=1), author_stream("tel_b", 5, seed=2)]
    names = ["r0", "r1"]
    uni_off, _, served_off = serve_streams(
        names, streams, random.Random(9), batch_target=8, deadline_ms=5.0
    )
    telemetry.enable(trace=str(tmp_path / "serve.jsonl"))
    uni_on, plane, served_on = serve_streams(
        names, streams, random.Random(9), batch_target=8, deadline_ms=5.0
    )
    telemetry.flush_trace()
    assert served_on == served_off
    assert uni_on.texts() == uni_off.texts()
    counters = telemetry.snapshot()["counters"]
    assert counters["serve.flushes"] == plane.stats["flushes"]
    assert counters["serve.submits"] == plane.stats["submits"]
    hists = telemetry.snapshot()["histograms"]
    assert hists["e2e.admit_to_applied"]["count"] >= plane.stats["submits"]
    assert "serve" in telemetry.summary()


# ---------------------------------------------------------------------------
# Chaos / breaker / degrade legs
# ---------------------------------------------------------------------------


def test_byte_identity_under_injected_launch_failures():
    """Seeded device_launch failures absorbed by the retry budget: the
    served streams stay byte-identical to a fault-free direct run."""
    rng = random.Random(3)
    streams = [author_stream("chaos_a", 5, seed=3), author_stream("chaos_b", 5, seed=4)]
    names = ["r0", "r1"]
    with faults.injected(FaultPlan(seed=7).with_site("device_launch", fail=2)):
        uni_s, plane, served = serve_streams(
            names, streams, rng, batch_target=16, deadline_ms=5.0
        )
    uni_d, direct = direct_streams(names, streams)
    assert served == direct
    assert (uni_s.digests() == uni_d.digests()).all()


def test_byte_identity_on_oracle_degrade_path():
    """Every launch fails past the budget: ingest completes on the oracle
    CPU path and the served streams are STILL byte-identical."""
    rng = random.Random(4)
    streams = [author_stream("deg_a", 4, seed=5), author_stream("deg_b", 4, seed=6)]
    names = ["r0", "r1"]
    with faults.injected(FaultPlan().with_site("device_launch", fail=10_000)):
        uni_s, plane, served = serve_streams(
            names, streams, rng, batch_target=16, deadline_ms=5.0
        )
        assert uni_s.stats["degraded_batches"] >= 1
    uni_d, direct = direct_streams(names, streams)
    assert served == direct
    assert uni_s.texts() == uni_d.texts()
    assert (uni_s.digests() == uni_d.digests()).all()


def test_byte_identity_with_breaker_fastfail():
    """A tripped breaker fast-fails flushes into the degrade path with no
    retry spend; the streams remain byte-identical."""
    rng = random.Random(5)
    streams = [author_stream("brk_a", 5, seed=7), author_stream("brk_b", 5, seed=8)]
    names = ["r0", "r1"]
    with faults.injected(FaultPlan().with_site("device_launch", fail=10_000)):
        with health.guarded("device_launch:threshold=1,cooldown=600"):
            uni_s, plane, served = serve_streams(
                names, streams, rng, batch_target=16, deadline_ms=5.0
            )
            assert uni_s.stats["fastfails"] >= 1
            assert uni_s.stats["degraded_batches"] >= 2
    uni_d, direct = direct_streams(names, streams)
    assert served == direct
    assert (uni_s.digests() == uni_d.digests()).all()


# ---------------------------------------------------------------------------
# Fairness + priority
# ---------------------------------------------------------------------------


def test_hot_session_cannot_starve_cold():
    """The fairness property: with a 100:1 hot/cold submission ratio, the
    cold session's submission rides the very next cohort after admission
    (DWRR guarantees inclusion — not behind the hot backlog)."""
    hot_stream = author_stream("hot", 100)
    cold_stream = author_stream("cold", 1)
    names = ["rh", "rc"]
    uni = Universe(names)
    plane = ServePlane(uni, start=False, batch_target=8, quantum=2)
    hot = plane.session("hot", replica="rh")
    cold = plane.session("cold", replica="rc")
    hot_subs = [hot.submit([c]) for c in hot_stream]
    plane.step()  # hot backlog starts draining, 8 changes per cohort
    cold_sub = cold.submit(cold_stream)
    plane.step()
    assert cold_sub.done(), "cold submission missed the next cohort"
    assert not hot_subs[-1].done(), "hot backlog should still be pending"
    assert plane.drain() == 0


def test_interactive_priority_beats_bulk():
    """Priority lane: with the batch budget saturated by a bulk backlog,
    an interactive submission still rides the next cohort."""
    bulk_stream = author_stream("bulk", 60)
    inter_stream = author_stream("inter", 1)
    names = ["rb", "ri"]
    uni = Universe(names)
    plane = ServePlane(uni, start=False, batch_target=4, quantum=4)
    bulk = plane.session("bulk", replica="rb", priority=BULK, weight=3)
    inter = plane.session("inter", replica="ri", priority=INTERACTIVE)
    for c in bulk_stream:
        bulk.submit([c])
    plane.step()
    sub = inter.submit(inter_stream)
    plane.step()
    assert sub.done(), "interactive submission must preempt the bulk backlog"
    assert plane.drain() == 0


def test_threaded_deadline_flush_and_wait():
    """Scheduler-thread mode: a lone submission flushes on the deadline
    (the batch target is never reached), and wait=True returns patches."""
    stream = author_stream("threaded", 2)
    uni = Universe(["r0"])
    plane = ServePlane(uni, batch_target=4096, deadline_ms=20.0)
    try:
        s = plane.session("s0", replica="r0", record_stream=True)
        t0 = time.perf_counter()
        patches = s.submit(stream, wait=True, timeout=60.0)
        elapsed = time.perf_counter() - t0
        assert patches and patches[0]["action"] == "makeList"
        # Generous for the loaded 1-core box; the deadline is 20ms.
        assert elapsed < 30.0
        plane.flush_and_wait(timeout=10.0)
        assert s.pending() == 0
    finally:
        plane.close()


def test_flush_and_wait_covers_in_flight_launch():
    """flush_and_wait must not return while the last cohort's launch is
    still in flight: admitted submissions leave their lanes at cohort
    FORMATION, so an empty lane alone proves nothing for un-waited
    submissions — the caller's next read would race the launch (found by
    the sharded serving plane's verify drive, where a late joiner's un-waited
    anti-entropy catch-up read back an empty replica)."""
    stream = author_stream("inflight", 3)
    uni = Universe(["r0"])
    plane = ServePlane(uni, batch_target=4096, deadline_ms=1.0)
    try:
        s = plane.session("s0", replica="r0")
        s.submit(stream)  # deliberately un-waited
        plane.flush_and_wait(timeout=60.0)
        assert uni.clock("r0"), "flush_and_wait returned before the launch landed"
        assert plane.stats["flushes"] >= 1
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# Wedged backend: deadline/hold/shed policies
# ---------------------------------------------------------------------------


def _trip_device_breaker(plane, session, stream):
    """Flush once under a failing backend so the guarded breaker trips."""
    session.submit([stream[0]])
    assert plane.step()  # degrades; breaker records the failures and trips
    br = health.breaker("device_launch")
    assert br is not None and br.state == health.OPEN
    return br


def test_breaker_open_degrade_policy_still_serves():
    """Default policy: an OPEN breaker routes cohorts straight into the
    oracle degrade path — submissions keep resolving at degrade cost."""
    stream = author_stream("wedge_d", 3)
    uni = Universe(["r0"])
    plane = ServePlane(uni, start=False, batch_target=8, deadline_ms=10.0)
    s = plane.session("s0", replica="r0", record_stream=True)
    with faults.injected(FaultPlan().with_site("device_launch", fail=10_000)):
        with health.guarded("device_launch:threshold=1,cooldown=600"):
            _trip_device_breaker(plane, s, stream)
            sub = s.submit(stream[1:])
            assert plane.step()
            assert sub.done() and sub.result()
            assert uni.stats["fastfails"] >= 1
    # Byte-identity held through the whole degraded run.
    uni_d, direct = direct_streams(["r0"], [stream])
    assert s.patch_log == direct["r0"]


def test_breaker_open_hold_policy_sheds_past_deadline():
    """hold policy: an OPEN breaker parks cohorts; once the oldest
    submission ages past the deadline the cohort sheds (ServeShedError)
    instead of burning the degrade path."""
    stream = author_stream("wedge_h", 3)
    uni = Universe(["r0"])
    plane = ServePlane(
        uni, start=False, batch_target=8, deadline_ms=20.0, on_open="hold"
    )
    s = plane.session("s0", replica="r0")
    with faults.injected(FaultPlan().with_site("device_launch", fail=10_000)):
        with health.guarded("device_launch:threshold=1,cooldown=600"):
            _trip_device_breaker(plane, s, stream)
            sub = s.submit(stream[1:])
            assert plane.step() is False  # held: inside the deadline
            assert plane.stats["held"] >= 1
            time.sleep(0.03)
            assert plane.step() is True  # past the deadline: shed
            with pytest.raises(ServeShedError):
                sub.result(timeout=1.0)
            assert plane.stats["shed"] == len(stream) - 1


# ---------------------------------------------------------------------------
# Per-session backpressure (the ChangeQueue policy vocabulary)
# ---------------------------------------------------------------------------


def test_block_policy_times_out_at_bound():
    stream = author_stream("blk", 4)
    uni = Universe(["r0"])
    plane = ServePlane(uni, start=False)
    s = plane.session(
        "s0", replica="r0", bound=2, policy="block", block_timeout=0.05
    )
    s.submit(stream[:2])
    with pytest.raises(QueueFullError):
        s.submit(stream[2:3])
    assert plane.drain() == 0  # the admitted prefix still applies


def test_coalesce_policy_merges_into_tail():
    stream = author_stream("coa", 4)
    uni = Universe(["r0"])
    plane = ServePlane(uni, start=False)
    s = plane.session(
        "s0", replica="r0", bound=1, policy="coalesce", record_stream=True
    )
    first = s.submit(stream[:2])
    merged = s.submit(stream[2:])  # at the entry bound: merges into tail
    assert merged is first
    assert s.pending() == len(stream)
    assert plane.stats["coalesced"] == len(stream) - 2
    assert plane.drain() == 0
    _, direct = direct_streams(["r0"], [stream])
    assert first.result() == direct["r0"]  # lossless, byte-identical


def test_shed_policy_drops_oldest_and_recovers_via_redelivery():
    stream = author_stream("shd", 3)
    uni = Universe(["r0"])
    plane = ServePlane(uni, start=False)
    s = plane.session("s0", replica="r0", bound=2, policy="shed")
    s.submit([stream[0]], wait=False)
    assert plane.drain() == 0  # genesis applied
    sub1 = s.submit([stream[1]])
    sub2 = s.submit([stream[2]])
    sub3 = s.submit([stream[3]])  # over the bound: sheds sub1 (oldest)
    with pytest.raises(ServeShedError):
        sub1.result(timeout=1.0)
    assert plane.stats["shed"] == 1
    # The shed change's successors are causally stranded until anti-entropy
    # redelivers it — exactly the queue.shed contract.
    assert plane.drain() == 2
    plane.close()  # the stranded submissions reject on close
    with pytest.raises(ServeClosedError):
        sub2.result(timeout=1.0)
    assert sub3.done()
    # Recovery: the session reconnects and anti-entropy redelivers the
    # full missing suffix (duplicates drop at the gate).
    plane2 = ServePlane(uni, start=False)
    s2 = plane2.session("s1", replica="r0")
    s2.submit(stream[1:])
    assert plane2.drain() == 0
    uni_d, _ = direct_streams(["r0"], [stream])
    assert uni.texts() == uni_d.texts()
    assert uni.spans_batch() == uni_d.spans_batch()


# ---------------------------------------------------------------------------
# Chaos grammar: the serve_admit site
# ---------------------------------------------------------------------------


def test_serve_admit_fault_site():
    stream = author_stream("adm", 2)
    uni = Universe(["r0"])
    plane = ServePlane(uni, start=False)
    s = plane.session("s0", replica="r0")
    plan = FaultPlan(seed=3).with_site("serve_admit", fail=1)
    with faults.injected(plan):
        with pytest.raises(faults.FaultError):
            s.submit([stream[0]])
        s.submit(stream)  # second admission passes
    assert plan.stats["serve_admit"]["failed"] == 1
    assert plan.stats["serve_admit"]["fired"] == 2
    assert plane.drain() == 0


def test_serve_admit_drop_is_recovered_by_redelivery():
    stream = author_stream("admdrop", 3)
    uni = Universe(["r0"])
    plane = ServePlane(uni, start=False)
    s = plane.session("s0", replica="r0", record_stream=True)
    plan = FaultPlan(seed=11).with_site("serve_admit", drop=0.5)
    with faults.injected(plan):
        for change in stream:
            s.submit([change])
        plane.drain()
    assert plan.stats["serve_admit"]["dropped"] >= 1
    # Anti-entropy: a fault-free redelivery of the full stream converges.
    s.submit(stream)
    assert plane.drain() == 0
    uni_d, _ = direct_streams(["r0"], [stream])
    assert uni.texts() == uni_d.texts()


# ---------------------------------------------------------------------------
# Shape bucketing + misc contracts
# ---------------------------------------------------------------------------


def test_compile_shape_tracking_hits_after_first_flush():
    stream = author_stream("shape", 6)
    uni = Universe(["r0"])
    plane = ServePlane(uni, start=False, batch_target=2)
    s = plane.session("s0", replica="r0")
    s.submit([stream[0]])
    s.submit([stream[1]])
    assert plane.drain() == 0
    for change in stream[2:]:
        s.submit([change])
        assert plane.drain() == 0
    assert plane.stats["compile_cache_hits"] >= 1
    assert (
        plane.stats["compile_cache_misses"] + plane.stats["compile_cache_hits"]
        == plane.stats["flushes"]
    )


def test_serve_trace_report_carries_admit_to_applied(tmp_path, detached_telemetry):
    """The flow lanes a served run emits must validate in trace_report and
    reproduce the admit-to-applied e2e quantiles from the trace alone."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import trace_report

    trace = str(tmp_path / "serve_trace.jsonl")
    telemetry.enable(trace=trace)
    rng = random.Random(6)
    streams = [author_stream("tr_a", 4, seed=1), author_stream("tr_b", 4, seed=2)]
    serve_streams(["r0", "r1"], streams, rng, batch_target=8, deadline_ms=5.0)
    telemetry.flush_trace()
    analysis = trace_report.analyze(trace_report.load_events(trace))
    assert analysis["problems"] == []
    assert analysis["e2e"]["admit_to_applied"]["count"] >= 2
    assert analysis["e2e"]["admit_to_applied"]["p95_us"] > 0


@pytest.mark.chaos
def test_serve_chaos_slice():
    """Seeded chaos through the plane: admission drops, duplicates and
    reorders plus transient launch failures; after a fault-free
    redelivery of every stream (anti-entropy), each replica equals direct
    ingest of its stream and the plane flushed every submission."""
    rng = random.Random(11)
    streams = [author_stream(f"chaos{i}", 6, seed=20 + i) for i in range(3)]
    names = [f"r{i}" for i in range(3)]
    uni = Universe(names)
    plane = ServePlane(uni, start=False, batch_target=8, deadline_ms=5.0)
    sessions = [plane.session(f"s{i}", replica=n) for i, n in enumerate(names)]
    plan = FaultPlan(seed=11).with_site("serve_admit", drop=0.2, dup=0.2, reorder=0.2)
    plan.with_site("device_launch", fail=2)
    with faults.injected(plan):
        for k in range(7):
            for s, stream in zip(sessions, streams):
                s.submit(stream[k : k + 1])
            if rng.random() < 0.5:
                plane.step()
        plane.drain()
    landed = plan.stats["serve_admit"]
    assert landed["dropped"] + landed["duplicated"] + landed["reordered"] >= 1
    for s, stream in zip(sessions, streams):
        s.submit(stream)
    assert plane.drain() == 0
    uni_d, _ = direct_streams(names, streams)
    assert uni.texts() == uni_d.texts()
    assert (uni.digests() == uni_d.digests()).all()
    assert plane.stats["submits"] >= 24 and plane.stats["flushes"] >= 1
