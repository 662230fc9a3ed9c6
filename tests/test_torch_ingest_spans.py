"""The ingest control plane's spans and its H2D counter.

One ``apply_changes`` records each of the five spans that split its host
time (``ingest.group``, ``ingest.encode``, ``ingest.plan``,
``ingest.upload``, ``ingest.commit``) once, inside
``stats["host_seconds"]``; under the torch profiler they land on its
timeline, in order and without overlap; ``ingest.h2d_bytes`` counts the
host bytes uploaded, which grow with the gate groups and, past them, by
the gather index's 8 B a replica."""
import pytest
import torch

from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.runtime import telemetry
from peritext_tpu_torch.testing import generate_docs

PHASES = ("group", "encode", "plan", "upload", "commit")


@pytest.fixture(autouse=True)
def _pristine_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _two_writer_batches(replicas):
    """Genesis plus one of two concurrent changes a replica, alternating:
    two gate groups however many replicas."""
    docs, _, genesis = generate_docs("spans", count=2)
    c1, _ = docs[0].change([{"path": ["text"], "action": "insert", "index": 2, "values": list("ab")},
                            {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 4,
                             "markType": "strong"}])
    c2, _ = docs[1].change([{"path": ["text"], "action": "delete", "index": 1, "count": 2}])
    return [[genesis, (c1, c2)[r % 2]] for r in range(replicas)]


def _ingest(replicas, patches=False):
    uni = TorchUniverse([f"r{i}" for i in range(replicas)], device="cpu")
    batches = _two_writer_batches(replicas)
    telemetry.enable()
    host0 = uni.stats["host_seconds"]
    if patches:
        uni.apply_changes_with_patches(batches)
    else:
        uni.apply_changes(batches)
    return uni, uni.stats["host_seconds"] - host0


def test_each_span_once_inside_host_seconds():
    _, host_s = _ingest(2)
    hists = telemetry.snapshot()["histograms"]
    spans = [hists[f"span.ingest.{p}.seconds"] for p in PHASES]
    assert [h["count"] for h in spans] == [1] * len(PHASES)
    assert 0 < sum(h["sum"] for h in spans) <= host_s


@pytest.mark.parametrize("patches,merge_path", [(False, None), (True, None), (True, "sorted")])
def test_h2d_bytes_grow_with_groups_not_replicas(monkeypatch, patches, merge_path):
    """On the kernels' route and both patch routes (the per-op loop, the
    sorted delta merge)."""
    if merge_path:
        monkeypatch.setenv("PERITEXT_MERGE_PATH", merge_path)
    sent = {}
    for replicas in (2, 6):
        telemetry.reset()
        _ingest(replicas, patches)
        sent[replicas] = telemetry.snapshot()["counters"]["ingest.h2d_bytes"]
    assert sent[6] - sent[2] == 8 * 4


def test_spans_land_on_the_profilers_timeline():
    uni = TorchUniverse(["r0", "r1"], device="cpu")
    batches = _two_writer_batches(2)
    telemetry.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.apply_changes"):
            uni.apply_changes(batches)
    events = prof.events()
    call = next(e.time_range for e in events if e.name == "test.apply_changes")
    ranges = []
    for p in PHASES:
        (tr,) = [e.time_range for e in events if e.name == f"ingest.{p}"]
        assert call.start <= tr.start <= tr.end <= call.end
        ranges.append(tr)
    assert all(a.end <= b.start for a, b in zip(ranges, ranges[1:]))
    upload = ranges[PHASES.index("upload")]
    assert any(e.name == "aten::index_select" and upload.start <= e.time_range.start
               and e.time_range.end <= upload.end for e in events)


def test_lanes_split_control_from_device(tmp_path):
    """A change's lane binds to the five spans, which the port's trace
    report reads as the ``control`` phase beside the launch's ``device``."""
    from peritext_tpu_torch.bench import trace_report as port_report

    trace_report = port_report.load()
    uni = TorchUniverse(["r0", "r1"], device="cpu")
    batches = _two_writer_batches(2)
    trace = tmp_path / "trace.jsonl"
    telemetry.enable(trace=str(trace))
    ctx = telemetry.flow("test.batch")
    with telemetry.span("test.batch"):
        telemetry.flow_point(ctx)
        with telemetry.flowing([ctx]):
            uni.apply_changes(batches)
        telemetry.flow_point(ctx, terminal=True)
    telemetry.flush_trace()
    events = trace_report.load_events(str(trace))
    assert trace_report.validate_flows(events) == []
    (lane,) = trace_report.build_lanes(events).values()
    bound = {p["slice"]["name"] for p in lane["points"] if p["slice"]}
    assert {f"ingest.{p}" for p in PHASES} <= bound
    phases = trace_report.lane_breakdown(lane)
    assert phases["control"] > 0 and phases["device"] > 0
    assert trace_report.phase_of("stream.wait") == "wait"
