"""The port's copies of the JAX package's runtime modules give the
originals' results on the same inputs: fault schedules and their stats,
the ``retryable`` classification, breaker transitions under a fake clock,
queue backpressure policies, SLO verdicts, telemetry summaries and its
disabled contract, and the change log (its binary form is the same bytes,
and each package reads the other's).  Each scenario runs once per package
and the two transcripts must be equal."""
import json
import random

import pytest

import peritext_tpu.runtime.faults as jfaults
import peritext_tpu.runtime.health as jhealth
import peritext_tpu.runtime.log as jlog
import peritext_tpu.runtime.queue as jqueue
import peritext_tpu.runtime.slo as jslo
import peritext_tpu.runtime.telemetry as jtelemetry
from peritext_tpu.testing import generate_docs
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.runtime import faults, health, log, queue, slo, telemetry

PAIRS = {
    "faults": (jfaults, faults),
    "health": (jhealth, health),
    "queue": (jqueue, queue),
    "slo": (jslo, slo),
    "telemetry": (jtelemetry, telemetry),
    "log": (jlog, log),
}


def both(name, scenario):
    """Run ``scenario(module)`` on the JAX original and on the port's copy;
    the transcripts must be equal.  Returns the port's."""
    ref, port = PAIRS[name]
    want, got = scenario(ref), scenario(port)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _pristine_planes():
    for mod in (jfaults, faults, jhealth, health, jslo, slo, jtelemetry, telemetry):
        mod.reset()
    yield
    for mod in (jfaults, faults, jhealth, health, jslo, slo, jtelemetry, telemetry):
        mod.reset()


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "seed=7;device_launch:fail=2",
    "device_readback:wedge=0.001x2,fail=1",
    "seed=3;pubsub_deliver:drop=0.3,dup=0.2",
    "seed=5;serve_admit:reorder=0.4,drop=0.1",
    "checkpoint_write:corrupt=2;log_append:fail=1",
    "seed=11;queue_flush:fail=1,drop=0.5,dup=0.5,reorder=0.5",
])
def test_fault_schedules_match(spec):
    def scenario(mod):
        plan = mod.FaultPlan.from_spec(spec)
        out = []
        for site in mod.KNOWN_SITES:
            for _ in range(3):
                try:
                    plan.fire(site)
                    out.append((site, "ok"))
                except mod.FaultError as exc:
                    out.append((site, "fail", exc.site))
            out.append(("take", site, plan.take(site, "corrupt")))
            for k in range(4):
                out.append(("stream", site, plan.filter_stream(site, list(range(10 * k, 10 * k + 8)), "s")))
            out.append(("held", site, plan.pending(site), plan.drain(site, "s")))
        return out, plan.stats

    both("faults", scenario)


@pytest.mark.parametrize("spec", [
    "device_launch", "device_launch:explode=1", "nowhere:fail=1", "device_launch:fail",
])
def test_fault_spec_errors_match(spec):
    def scenario(mod):
        with pytest.raises(ValueError) as excinfo:
            mod.FaultPlan.from_spec(spec)
        return str(excinfo.value)

    both("faults", scenario)


def test_fault_env_plan_and_scoped_install_match(monkeypatch):
    monkeypatch.setenv("PERITEXT_FAULTS", "seed=2;device_launch:fail=1")

    def scenario(mod):
        out = []
        for _ in range(2):
            try:
                mod.fire("device_launch")
                out.append("ok")
            except RuntimeError:
                out.append("fail")
        with mod.injected("device_readback:fail=1") as plan:
            out.append(mod.active() is plan)
        out.append(mod.active().stats)
        mod.reset()
        return out

    both("faults", scenario)


def test_retryable_classification_matches():
    import torch

    errors = [ValueError("v"), TypeError("t"), KeyError("k"), NotImplementedError("n"),
              RuntimeError("r"), OSError("o"), TimeoutError("x"), torch.cuda.OutOfMemoryError("oom"),
              ZeroDivisionError("z")]
    got = both("faults", lambda mod: [mod.retryable(e) for e in errors] + [mod.retryable(mod.FaultError("s"))])
    assert got == [False, False, False, False, True, True, True, True, False, True]


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("spec", [
    "device_launch:threshold=2,cooldown=1,jitter=0",
    "seed=4;device_launch:threshold=1,cooldown=0.5,jitter=0.5",
    "device_launch:rate=0.5,window=4,threshold=2,cooldown=2",
])
def test_breaker_transitions_match(spec):
    rng = random.Random(7)
    events = [rng.choice(["fail", "ok", "admit", "tick", "abandon"]) for _ in range(80)]

    def scenario(mod):
        clock = FakeClock()
        br = mod.HealthPlan.from_spec(spec, clock=clock).breaker("device_launch")
        out = []
        for e in events:
            if e == "fail":
                br.record_failure()
            elif e == "ok":
                br.record_success()
            elif e == "admit":
                out.append(br.admit())
            elif e == "abandon":
                br.abandon()
            else:
                clock.t += 0.4
            out.append((br.state, round(br.cooldown_remaining(), 9)))
        return out, br.summary()

    both("health", scenario)


@pytest.mark.parametrize("spec", ["device_launch", "device_launch:explode=1", "device_lauch:threshold=1",
                                  "device_launch:rate=0"])
def test_breaker_spec_errors_match(spec):
    def scenario(mod):
        with pytest.raises(ValueError) as excinfo:
            mod.HealthPlan.from_spec(spec)
        return str(excinfo.value)

    both("health", scenario)


# ---------------------------------------------------------------------------
# queue
# ---------------------------------------------------------------------------


def _changes(n, actors=("a", "b")):
    seqs = {a: 0 for a in actors}
    out = []
    for i in range(n):
        a = actors[i % len(actors)]
        seqs[a] += 1
        out.append({"actor": a, "seq": seqs[a], "ops": [i]})
    return out


@pytest.mark.parametrize("policy,bound", [("block", 0), ("coalesce", 2), ("coalesce", 3), ("shed", 4)])
def test_queue_policies_match(policy, bound):
    changes = _changes(12)

    def scenario(mod):
        flushed = []
        q = mod.ChangeQueue(flushed.append, name="q", bound=bound, policy=policy)
        out = []
        for i in range(0, 12, 2):
            q.enqueue(*changes[i : i + 2])
            out.append((len(q), q.entries()))
            if i == 6:
                q.flush()
        q.flush()
        return out, flushed

    both("queue", scenario)


def test_queue_flush_failure_requeues_in_order():
    changes = _changes(5)

    def scenario(mod):
        flushed = []

        def handler(batch):
            if not flushed:
                flushed.append("failed")
                raise RuntimeError("handler down")
            flushed.append(list(batch))

        q = mod.ChangeQueue(handler, name="q")
        q.enqueue(*changes[:3])
        with pytest.raises(RuntimeError):
            q.flush()
        q.enqueue(*changes[3:])
        q.flush()
        return flushed

    both("queue", scenario)


def test_queue_block_timeout_matches():
    def scenario(mod):
        q = mod.ChangeQueue(lambda b: None, name="q", bound=2, policy="block", block_timeout=0.01)
        q.enqueue(*_changes(2))
        with pytest.raises(mod.QueueFullError) as excinfo:
            q.enqueue(*_changes(1))
        return len(q), type(excinfo.value).__name__, mod.POLICIES

    both("queue", scenario)


# ---------------------------------------------------------------------------
# slo and telemetry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,metric,values", [
    ("e2e.t:p95=50,window=16,fast=4,min=4,cooldown=60", "e2e.t",
     [0.01] * 8 + [0.2] * 8 + [0.001] * 24),
    ("e2e.t:p99=20,window=32,fast=4,min=4", "e2e.t", [0.001] * 28 + [10.0] + [0.05] * 6),
    ("ingest.launch:err_rate=0.1,window=16,fast=4,min=4", "ingest.launch", [1, 0, 0, 1, 1, 1, 0, 1] * 4),
])
def test_slo_verdicts_match(spec, metric, values):
    def scenario(mod):
        tel = jtelemetry if mod is jslo else telemetry
        tel.enable()
        mod.install(spec)
        out = []
        for v in values:
            if metric == "ingest.launch":
                tel.counter("ingest.launch_attempts")
                if v:
                    tel.counter("ingest.launch_failures")
            else:
                tel.observe(metric, v)
            s = mod.summary()[metric]
            out.append((s["breached"], round(s.get("burn", 0.0), 9)))
        snap = tel.snapshot()
        mod.reset()
        tel.reset()
        return out, snap["counters"], snap["gauges"]

    both("slo", scenario)


def test_slo_env_activation_matches(monkeypatch):
    """A PERITEXT_SLO spec in the environment wires its objectives and turns
    collection on, as in the JAX package."""
    monkeypatch.setenv("PERITEXT_SLO", "e2e.t:p95=50,window=16,fast=4,min=4")

    def scenario(mod):
        tel = jtelemetry if mod is jslo else telemetry
        mod._activate_from_env()
        out = [tel.enabled]
        for v in [0.01] * 6 + [0.2] * 10:
            tel.observe("e2e.t", v)
            out.append(mod.summary()["e2e.t"]["breached"])
        mod.reset()
        tel.reset()
        return out

    got = both("slo", scenario)
    assert got[0] and got[-1]


@pytest.mark.parametrize("spec", ["e2e.x:p95", "e2e.x:bogus=1,p95=50", "e2e.x:window=64",
                                  "e2e.x:p95=50,err_rate=0.1", "e2e.x:err_rate=1.5"])
def test_slo_spec_errors_match(spec):
    def scenario(mod):
        with pytest.raises(ValueError) as excinfo:
            mod.SloPlan.from_spec(spec)
        return str(excinfo.value)

    both("slo", scenario)


def test_telemetry_summaries_match():
    rng = random.Random(3)
    samples = [rng.lognormvariate(-6, 1.5) for _ in range(500)]

    def scenario(mod):
        mod.enable()
        for i, v in enumerate(samples):
            mod.observe("e2e.admit_to_applied", v)
            mod.counter("serve.flushes")
            mod.gauge_max("serve.depth_max", i % 17)
        snap, summary = mod.snapshot(), mod.summary()
        mod.reset()
        return snap, summary, mod.estimate_quantiles(snap["histograms"]["e2e.admit_to_applied"], (0.5, 0.95))

    both("telemetry", scenario)


def test_telemetry_env_activation_matches(monkeypatch, tmp_path):
    """PERITEXT_TRACE, PERITEXT_METRICS and PERITEXT_BLACKBOX arm the
    tracer, the exit snapshot and the black box as in the JAX package."""

    def scenario(mod):
        root = tmp_path / mod.__name__.split(".")[0]
        (root / "bb").mkdir(parents=True)
        monkeypatch.setenv("PERITEXT_TRACE", str(root / "trace.jsonl"))
        monkeypatch.setenv("PERITEXT_METRICS", str(root / "metrics.json"))
        monkeypatch.setenv("PERITEXT_BLACKBOX", str(root / "bb"))
        mod._activate_from_env()
        with mod.span("ingest.launch"):
            mod.counter("ingest.launches")
        mod.flush_trace()
        out = (
            mod.enabled,
            mod.trace_path() == str(root / "trace.jsonl"),
            mod.blackbox_dir() == str(root / "bb"),
            mod.dump_metrics() == str(root / "metrics.json"),
            mod.blackbox_dump("test") is not None,
            [json.loads(line)["name"] for line in (root / "trace.jsonl").read_text().splitlines()],
        )
        mod.reset()
        return out

    assert both("telemetry", scenario)[:5] == (True,) * 5


def test_disabled_telemetry_is_one_attribute_check_and_changes_nothing():
    """Off: sites allocate nothing (the null span is shared, no counter or
    span histogram registers), and a telemetry-on ingest, with and without
    patches, is byte-identical to an off one."""
    assert not telemetry.enabled
    assert telemetry.span("a") is telemetry.span("b")
    telemetry.counter("x")
    telemetry.observe("y", 1.0)
    assert telemetry.snapshot()["counters"] == {} and telemetry.snapshot()["histograms"] == {}
    assert telemetry.flow("k") is None

    docs, _, genesis = generate_docs("telemetry", count=2)
    c, _ = docs[0].change([{"path": ["text"], "action": "insert", "index": 3, "values": list("abc")},
                           {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 5,
                            "markType": "strong"}])
    outs = []
    for on in (False, True):
        if on:
            telemetry.enable()
        uni = TorchUniverse(["doc1", "doc2"], device="cpu")
        plain = TorchUniverse(["doc1", "doc2"], device="cpu")
        plain.apply_changes({"doc1": [genesis, c], "doc2": [genesis]})
        outs.append((uni.apply_changes_with_patches({"doc1": [genesis, c], "doc2": [genesis]}),
                     uni.spans_batch(), uni.digests().tolist(), plain.spans_batch(), plain.digests().tolist(),
                     {f: a.tobytes() for f, a in state_to_numpy(plain.states).items()}))
        if not on:
            assert telemetry.snapshot()["histograms"] == {}
    assert outs[0] == outs[1]
    snap = telemetry.snapshot()
    assert snap["counters"]["ingest.launches"] == 2
    assert all(f"span.ingest.{p}.seconds" in snap["histograms"]
               for p in ("group", "encode", "plan", "upload", "commit"))


# ---------------------------------------------------------------------------
# log
# ---------------------------------------------------------------------------


def _history():
    docs, _, genesis = generate_docs("change log", count=2)
    out = [genesis]
    for i, doc in enumerate(docs * 3):
        c, _ = doc.change([
            {"path": ["text"], "action": "insert", "index": 2, "values": list("xy")},
            {"path": ["text"], "action": "delete", "index": 0, "count": 1},
            {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 3, "markType": "link",
             "attrs": {"url": f"u{i}"}},
            {"path": [], "action": "makeMap", "key": f"m{i}"},
        ])
        out.append(c)
        for other in docs:
            if other is not doc:
                other.apply_change(c)
    return out


def test_change_log_matches_and_reads_the_other_packages_bytes():
    history = _history()

    def scenario(mod):
        lg = mod.ChangeLog()
        for c in history:
            lg.record(c)
        lg.record(history[0])  # already present: ignored
        with pytest.raises(ValueError) as gap:
            lg.append({**history[1], "seq": 9})
        return (lg.clock(), lg.missing_changes(lg.clock(), {"doc1": 1}), lg.all_changes(), lg.actors,
                str(gap.value), lg.to_bytes())

    got = both("log", scenario)
    data = got[-1]
    assert log.ChangeLog.from_bytes(data).all_changes() == got[2]
    assert sorted(map(str, got[2])) == sorted(map(str, history))
    assert jlog.ChangeLog.from_bytes(data).all_changes() == log.ChangeLog.from_bytes(data).all_changes()


def test_log_append_fault_site_fires_before_mutation():
    history = _history()

    def scenario(mod, fmod):
        lg = mod.ChangeLog()
        with fmod.injected("log_append:fail=1") as plan:
            with pytest.raises(fmod.FaultError):
                lg.record(history[0])
            lg.record(history[0])
        return lg.clock(), plan.stats

    assert scenario(log, faults) == scenario(jlog, jfaults)
