"""The port's launch policy against the JAX package's (tests/test_faults.py's
resilience scenarios), on the CPU: retries absorb transient faults, budget
exhaustion degrades to the oracle CPU path byte-identically (all 13 state
fields and the patch streams against ``TpuUniverse`` under the same fault
plan and against a fault-free ``TorchUniverse``), rollback without
degradation raises ``DeviceLaunchError`` with the committed state untouched,
the strict barrier and the per-attempt deadline, degradation off by
default on the card, a kernel build failure neither retried nor degraded,
``TorchDoc``'s rollback,
and the retry contract itself: a failure injected after the merge ran
(``device_readback``) leaves every committed tensor byte-equal and its
version counter unmoved.

The two packages keep separate fault and health planes, so every
cross-engine case arms both plans; the autouse fixture resets both.
"""
import json

import numpy as np
import pytest
import torch

from peritext_tpu.ops import TpuUniverse
from peritext_tpu.ops.doc import TpuDoc
from peritext_tpu.runtime import faults as jfaults
from peritext_tpu.runtime import health as jhealth
from peritext_tpu.testing import generate_docs
from peritext_tpu_torch import TorchDoc, TorchUniverse, state_to_numpy
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.ops import universe as universe_module
from peritext_tpu_torch.ops._build import KernelBuildError
from peritext_tpu_torch.ops.universe import DeviceLaunchError, _degrade_enabled
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.runtime.faults import FaultError


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    for plane in (faults, health, jfaults, jhealth):
        plane.reset()
    for name in ("PERITEXT_FAULTS", "PERITEXT_BREAKER", "PERITEXT_MERGE_PATH", "PERITEXT_DEGRADE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PERITEXT_LAUNCH_BACKOFF", "0.001")
    telemetry.reset()
    yield
    for plane in (faults, health, jfaults, jhealth):
        plane.reset()


def arm(spec):
    """The same fault plan on both engines' planes; returns the port's."""
    jfaults.install(spec)
    return faults.install(spec)


def disarm():
    faults.reset()
    jfaults.reset()


def fields(uni):
    return state_to_numpy(uni.states) if isinstance(uni, TorchUniverse) else {
        f: np.asarray(getattr(uni.states, f)) for f in FIELDS
    }


def assert_fields_equal(a, b):
    fa, fb = fields(a), fields(b)
    for f in FIELDS:
        assert fa[f].dtype == fb[f].dtype and fa[f].shape == fb[f].shape, f
        assert (fa[f] == fb[f]).all(), f"state differs at {f}"


def control_plane(uni):
    return (
        [dict(c) for c in uni.clocks],
        list(uni.lengths),
        list(uni.mark_counts),
        [json.dumps(s.to_json(), sort_keys=True) for s in uni.stores],
        list(uni.text_objs),
    )


def versions(uni):
    """The universe's states version and every field tensor's version
    counter: an in-place write to a committed tensor moves one."""
    return (uni._states_version,) + tuple(getattr(uni.states, f)._version for f in FIELDS)


MIXED_OPS = [
    {"path": ["text"], "action": "insert", "index": 4, "values": list("+++")},
    {"path": ["text"], "action": "delete", "index": 1, "count": 2},
    {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 7,
     "markType": "comment", "attrs": {"id": "c-1"}},
    {"path": ["text"], "action": "addMark", "startIndex": 3, "endIndex": 9,
     "markType": "link", "attrs": {"url": "a.com"}},
    {"path": ["text"], "action": "removeMark", "startIndex": 5, "endIndex": 8,
     "markType": "strong"},
    {"path": [], "action": "makeMap", "key": "meta"},
    {"path": ["meta"], "action": "set", "key": "k", "value": 7},
]


def universes(text="resilient doc", count=2, capacity=256):
    """A TorchUniverse (CPU) and a TpuUniverse that took the same genesis,
    with the oracle docs that made it."""
    docs, _, genesis = generate_docs(text, count=count)
    names = [d.actor_id for d in docs]
    port = TorchUniverse(names, capacity=capacity, device="cpu")
    ref = TpuUniverse(names, capacity=capacity)
    for u in (port, ref):
        u.apply_changes({n: [genesis] for n in names})
    return docs, genesis, port, ref


def test_launch_retry_absorbs_transient_failures(monkeypatch):
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "3")
    docs, _, port, ref = universes()
    c, _ = docs[0].change(MIXED_OPS)
    docs[1].apply_change(c)
    plan = arm("device_launch:fail=2")
    port.apply_changes({"doc1": [c], "doc2": [c]})
    ref.apply_changes({"doc1": [c], "doc2": [c]})
    assert port.stats["launch_retries"] == ref.stats["launch_retries"] == 2
    assert port.stats["degraded_batches"] == 0
    assert plan.stats["device_launch"] == jfaults.active().stats["device_launch"]
    assert plan.stats["device_launch"]["failed"] == 2
    assert_fields_equal(port, ref)
    assert port.spans("doc1") == docs[0].get_text_with_formatting(["text"])


def test_retry_exhaustion_degrades_to_oracle_byte_identically(monkeypatch):
    """Exhaustion completes the batch on the oracle CPU path: the patches,
    all 13 fields, the host stores and digests equal TpuUniverse's under the
    same plan and a fault-free TorchUniverse's; a later fault-free ingest
    on the degraded states still agrees."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "1")
    docs, genesis, port, ref = universes()
    ctrl = TorchUniverse(["doc1", "doc2"], device="cpu")
    ctrl.apply_changes({"doc1": [genesis], "doc2": [genesis]})
    c, _ = docs[0].change(MIXED_OPS)
    oracle_patches = docs[1].apply_change(c)
    arm("device_launch:fail=99")
    degraded = port.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    ref_out = ref.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    assert port.stats["degraded_batches"] == ref.stats["degraded_batches"] == 1
    disarm()
    control = ctrl.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    assert degraded["doc2"] == oracle_patches
    assert degraded == control == ref_out
    assert_fields_equal(port, ctrl)
    assert_fields_equal(port, ref)
    assert control_plane(port) == control_plane(ctrl) == control_plane(ref)
    assert (port.digests() == ctrl.digests()).all() and (port.digests() == ref.digests()).all()

    c2, _ = docs[1].change(
        [{"path": ["text"], "action": "insert", "index": 2, "values": list("zz")},
         {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 6, "markType": "em"}]
    )
    docs[0].apply_change(c2)
    for u in (port, ref):
        u.apply_changes({"doc1": [c2], "doc2": [c2]})
    assert_fields_equal(port, ref)
    assert port.spans("doc1") == docs[0].get_text_with_formatting(["text"])


@pytest.mark.parametrize("route", ["scan", "sorted"])
def test_degradation_handles_genesis_batch(monkeypatch, route):
    """A failure on the very first batch (makeList + inserts): the degrade
    path creates the device binding itself, on either route."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    monkeypatch.setenv("PERITEXT_MERGE_PATH", route)
    docs, _, genesis = generate_docs("genesis under fire", count=2)
    port = TorchUniverse(["doc1", "doc2"], device="cpu")
    ref = TpuUniverse(["doc1", "doc2"])
    arm("device_launch:fail=99")
    for u in (port, ref):
        u.apply_changes({"doc1": [genesis], "doc2": [genesis]})
    disarm()
    assert port.stats["degraded_batches"] == 1
    assert port.text("doc1") == "genesis under fire" and port.text_objs[0] is not None
    assert_fields_equal(port, ref)
    c, _ = docs[0].change([{"path": ["text"], "action": "delete", "index": 0, "count": 8}])
    docs[1].apply_change(c)
    for u in (port, ref):
        u.apply_changes({"doc1": [c], "doc2": [c]})
    assert port.text("doc1") == "".join(docs[0].root["text"])
    assert_fields_equal(port, ref)


def test_degradation_under_scan_patch_path(monkeypatch):
    """The patch path (JAX: PERITEXT_PATCH_PATH=scan) degrades
    byte-identically to its fault-free control and to TpuUniverse."""
    monkeypatch.setenv("PERITEXT_PATCH_PATH", "scan")
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    docs, genesis, port, ref = universes()
    ctrl = TorchUniverse(["doc1", "doc2"], device="cpu")
    ctrl.apply_changes_with_patches({"doc1": [genesis], "doc2": [genesis]})
    c, _ = docs[0].change(MIXED_OPS)
    docs[1].apply_change(c)
    arm("device_launch:fail=99")
    degraded = port.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    ref_out = ref.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    disarm()
    control = ctrl.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    assert port.stats["degraded_batches"] == 1
    assert degraded == control == ref_out
    assert_fields_equal(port, ctrl)
    assert_fields_equal(port, ref)


def test_degradation_of_concurrent_multi_actor_batch(monkeypatch):
    """Concurrent inserts and marks from three actors degrade as one batch:
    placement past greater ids and the mark-table append order survive the
    oracle round trip."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    docs, _, genesis = generate_docs("concurrent base", count=3)
    names = [d.actor_id for d in docs]
    port = TorchUniverse(names, device="cpu")
    ctrl = TorchUniverse(names, device="cpu")
    ref = TpuUniverse(names)
    for u in (port, ctrl, ref):
        u.apply_changes({n: [genesis] for n in names})
    concurrent = []
    for i, doc in enumerate(docs):
        c, _ = doc.change(
            [{"path": ["text"], "action": "insert", "index": 4, "values": list(f"<{i}>")},
             {"path": ["text"], "action": "addMark", "startIndex": 2, "endIndex": 8,
              "markType": ["strong", "em", "comment"][i],
              **({"attrs": {"id": f"cc-{i}"}} if i == 2 else {})}]
        )
        concurrent.append(c)
    for i, doc in enumerate(docs):
        for j, c in enumerate(concurrent):
            if j != i:
                doc.apply_change(c)
    batch = {n: list(concurrent) for n in names}
    arm("device_launch:fail=99")
    port.apply_changes(batch)
    ref.apply_changes(batch)
    disarm()
    ctrl.apply_changes(batch)
    assert port.stats["degraded_batches"] == 1
    assert_fields_equal(port, ctrl)
    assert_fields_equal(port, ref)
    expected = docs[0].get_text_with_formatting(["text"])
    assert all(port.spans(n) == expected for n in names)
    assert (port.digests() == ctrl.digests()).all()


@pytest.mark.parametrize("route", ["scan", "sorted"])
def test_rollback_without_degradation(monkeypatch, route):
    """PERITEXT_DEGRADE=0: exhaustion raises DeviceLaunchError and nothing
    commits (control plane, all 13 fields, every version counter); with the
    faults cleared the same batch applies cleanly."""
    monkeypatch.setenv("PERITEXT_DEGRADE", "0")
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "1")
    monkeypatch.setenv("PERITEXT_MERGE_PATH", route)
    docs, _, port, ref = universes()
    before_cp, before_dev, before_ver = control_plane(port), fields(port), versions(port)
    c, _ = docs[0].change(MIXED_OPS)
    docs[1].apply_change(c)
    arm("device_launch:fail=99")
    with pytest.raises(DeviceLaunchError) as excinfo:
        port.apply_changes({"doc1": [c], "doc2": [c]})
    assert excinfo.value.attempts == 2
    assert isinstance(excinfo.value.cause, FaultError)
    assert control_plane(port) == before_cp and versions(port) == before_ver
    assert all((fields(port)[f] == before_dev[f]).all() for f in FIELDS)
    disarm()
    port.apply_changes({"doc1": [c], "doc2": [c]})
    ref.apply_changes({"doc1": [c], "doc2": [c]})
    assert_fields_equal(port, ref)
    assert port.spans("doc1") == docs[0].get_text_with_formatting(["text"])


@pytest.mark.parametrize(
    "device,setting,expected",
    [("cpu", None, True), ("cpu", "0", False), ("cuda", None, False), ("cuda", "1", True)],
)
def test_degrade_default_depends_on_the_device(monkeypatch, device, setting, expected):
    """Unset, PERITEXT_DEGRADE is on for a universe on the CPU (the JAX
    package's default) and off for one on the card, where a kernel that
    keeps failing must raise instead of serving from the oracle."""
    if setting is not None:
        monkeypatch.setenv("PERITEXT_DEGRADE", setting)
    assert _degrade_enabled(torch.device(device)) is expected


def test_kernel_build_failure_is_neither_retried_nor_degraded(monkeypatch):
    """A kernel that cannot build fails its first attempt for good: the
    error propagates as it is, with no retry, no degrade (even where
    degradation is on) and nothing committed."""
    monkeypatch.setenv("PERITEXT_DEGRADE", "1")
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "3")
    calls = []

    def unbuildable(*args, **kwargs):
        calls.append(1)
        raise KernelBuildError("nvcc failed for text_phase (exit 1)")

    docs, _, port, _ = universes()
    monkeypatch.setattr(universe_module, "merge_step_full", unbuildable)
    before_cp, before_dev, before_ver = control_plane(port), fields(port), versions(port)
    c, _ = docs[0].change(MIXED_OPS)
    with pytest.raises(KernelBuildError):
        port.apply_changes({"doc1": [c], "doc2": [c]})
    assert len(calls) == 1
    assert port.stats["launch_retries"] == port.stats["degraded_batches"] == 0
    assert control_plane(port) == before_cp and versions(port) == before_ver
    assert all((fields(port)[f] == before_dev[f]).all() for f in FIELDS)


def test_strict_commit_barrier_precedes_control_plane_commit(monkeypatch):
    """PERITEXT_STRICT_COMMIT=1: the barrier (a device_readback) runs before
    any commit, so a failure there leaves everything unchanged."""
    monkeypatch.setenv("PERITEXT_STRICT_COMMIT", "1")
    monkeypatch.setenv("PERITEXT_DEGRADE", "0")
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    docs, _, port, _ = universes()
    before_cp, before_ver = control_plane(port), versions(port)
    c, _ = docs[0].change(MIXED_OPS)
    docs[1].apply_change(c)
    plan = faults.install("device_readback:fail=1")
    with pytest.raises(DeviceLaunchError) as excinfo:
        port.apply_changes({"doc1": [c], "doc2": [c]})
    assert isinstance(excinfo.value.cause, FaultError)
    assert plan.stats["device_readback"]["failed"] == 1
    assert control_plane(port) == before_cp and versions(port) == before_ver
    port.apply_changes({"doc1": [c], "doc2": [c]})
    assert port.clock("doc1")["doc1"] == c["seq"]
    assert port.spans("doc1") == docs[0].get_text_with_formatting(["text"])


def test_per_attempt_deadline_retries_wedged_readback(monkeypatch):
    """A wedged readback trips the wall-clock deadline (judged after the
    barrier); the retry succeeds once the wedge is spent."""
    monkeypatch.setenv("PERITEXT_LAUNCH_TIMEOUT", "0.05")
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "2")
    docs, _, port, _ = universes()
    c, _ = docs[0].change([{"path": ["text"], "action": "insert", "index": 0, "values": ["w"]}])
    docs[1].apply_change(c)
    faults.install("device_readback:wedge=0.2x1")
    port.apply_changes({"doc1": [c], "doc2": [c]})
    assert port.stats["launch_retries"] >= 1 and port.stats["degraded_batches"] == 0
    assert port.spans("doc1") == docs[0].get_text_with_formatting(["text"])


def _window_batches():
    """Genesis and two rounds of hotspot edits on a doc long enough for the
    census window at PERITEXT_MERGE_WINDOW_MIN=64."""
    from peritext_tpu_torch.bench.workloads import make_writer_rounds

    wl = make_writer_rounds(200, 6, 2, 2, True, seed=11, locality=16)
    return [[[wl["genesis"]]] * 4] + [[rnd[r % 2] for r in range(4)] for rnd in wl["rounds"]]


@pytest.mark.parametrize("path", ["scan", "strict", "sorted", "windowed", "patched"])
def test_failure_after_the_merge_leaves_committed_tensors_untouched(monkeypatch, path):
    """The retry contract: an attempt reruns from the committed states, so
    no merge may write them in place.  A device_readback failure fires
    after the merge ran; every committed field must then be byte-equal and
    its version counter unmoved, and the retried batch must equal a
    fault-free twin's."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    monkeypatch.setenv("PERITEXT_DEGRADE", "0")
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")
    if path in ("sorted", "windowed"):
        monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    if path in ("scan", "sorted"):
        monkeypatch.setenv("PERITEXT_LAUNCH_TIMEOUT", "30")  # takes the barrier
    if path == "strict":
        monkeypatch.setenv("PERITEXT_STRICT_COMMIT", "1")
    if path != "windowed":
        monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "0")
    batches = _window_batches()
    names = [f"r{i}" for i in range(4)]
    port = TorchUniverse(names, capacity=512, device="cpu")
    twin = TorchUniverse(names, capacity=512, device="cpu")
    apply = (lambda u, b: u.apply_changes_with_patches(b)) if path == "patched" else (
        lambda u, b: u.apply_changes(b))
    for u in (port, twin):
        for b in batches[:2]:
            apply(u, b)
    before, before_ver, before_cp = fields(port), versions(port), control_plane(port)
    windowed0 = port.stats["windowed_launches"]
    plan = faults.install("device_readback:fail=1")
    with pytest.raises(DeviceLaunchError):
        apply(port, batches[2])
    assert plan.stats["device_readback"]["failed"] == 1
    assert versions(port) == before_ver and control_plane(port) == before_cp
    now = fields(port)
    assert all((now[f] == before[f]).all() for f in FIELDS)
    out = apply(port, batches[2])
    assert apply(twin, batches[2]) == out
    assert_fields_equal(port, twin)
    if path == "windowed":
        assert port.stats["windowed_launches"] > windowed0


def test_breaker_open_fastfails_and_degrades(monkeypatch):
    """An open device_launch breaker refuses the launch with no attempt
    (``fastfails``); the batch degrades byte-identically."""
    docs, genesis, port, _ = universes()
    ctrl = TorchUniverse(["doc1", "doc2"], device="cpu")
    ctrl.apply_changes({"doc1": [genesis], "doc2": [genesis]})
    health.install("device_launch:threshold=1,cooldown=60")
    health.breaker("device_launch").record_failure()
    assert health.breaker("device_launch").state == health.OPEN
    c, _ = docs[0].change(MIXED_OPS)
    docs[1].apply_change(c)
    plan = faults.install("device_launch:fail=0")
    out = port.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    assert port.stats["fastfails"] == 1 and port.stats["degraded_batches"] == 1
    assert plan.stats.get("device_launch", {}).get("fired", 0) == 0
    health.reset()
    assert out == ctrl.apply_changes_with_patches({"doc1": [c], "doc2": [c]})
    assert_fields_equal(port, ctrl)


def test_torch_doc_ingest_rides_the_resilience_policy(monkeypatch):
    """TorchDoc.apply_change goes through the universe's patch path, so a
    persistent launch failure degrades and the doc still converges with
    the oracle and with a TpuDoc under the same plan."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    oracle = Doc("doc1")
    genesis, _ = oracle.change(
        [{"path": [], "action": "makeList", "key": "text"},
         {"path": ["text"], "action": "insert", "index": 0, "values": list("tpu doc state")}]
    )
    c2, _ = oracle.change(MIXED_OPS)
    tdoc, jdoc = TorchDoc("mirror", device="cpu"), TpuDoc("mirror")
    p1 = tdoc.apply_change(genesis)
    jdoc.apply_change(genesis)
    arm("device_launch:fail=99")
    p2 = tdoc.apply_change(c2)
    assert jdoc.apply_change(c2) == p2
    disarm()
    assert tdoc._uni.stats["degraded_batches"] == 1
    assert tdoc.get_text_with_formatting(["text"]) == oracle.get_text_with_formatting(["text"])
    fresh = Doc("fresh")
    assert p1 + p2 == fresh.apply_change(genesis) + fresh.apply_change(c2)


def test_local_change_rolls_back_cleanly_on_launch_exhaustion(monkeypatch):
    """Local generation commits seq, clock and lengths before its launch;
    exhaustion restores all of it and the host store, and the stream stays
    contiguous.  TpuDoc under the same plan behaves the same."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    docs = (TorchDoc("author", device="cpu"), TpuDoc("author"))
    base = [{"path": [], "action": "makeList", "key": "text"},
            {"path": ["text"], "action": "insert", "index": 0, "values": list("base")}]
    failing = [{"path": [], "action": "makeMap", "key": "meta"},
               {"path": ["text"], "action": "insert", "index": 4, "values": ["!"]},
               {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 2,
                "markType": "comment", "attrs": {"id": "rb"}}]
    geneses = [d.change(base)[0] for d in docs]
    assert geneses[0] == geneses[1]
    befores = [(d.seq, d.max_op, dict(d.clock), d._uni.lengths[0]) for d in docs]
    arm("device_launch:fail=99")
    for d, err in zip(docs, (DeviceLaunchError, RuntimeError)):
        with pytest.raises(err):
            d.change(failing)
    assert faults.active().stats == jfaults.active().stats
    disarm()
    for d, before in zip(docs, befores):
        assert (d.seq, d.max_op, dict(d.clock), d._uni.lengths[0]) == before
        assert "meta" not in d.root
    changes = [d.change([{"path": ["text"], "action": "insert", "index": 4, "values": ["?"]}]) for d in docs]
    assert changes[0] == changes[1] and changes[0][0]["seq"] == geneses[0]["seq"] + 1
    peer = Doc("peer")
    peer.apply_change(geneses[0])
    peer.apply_change(changes[0][0])
    assert docs[0].get_text_with_formatting(["text"]) == peer.get_text_with_formatting(["text"])


def test_local_change_rollback_restores_capacity(monkeypatch):
    """A failing change that grew the capacity rolls the capacities back
    with the states, and a later growth resizes for real."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    tdoc = TorchDoc("author", capacity=32, max_mark_ops=32, device="cpu")
    genesis, _ = tdoc.change(
        [{"path": [], "action": "makeList", "key": "text"},
         {"path": ["text"], "action": "insert", "index": 0, "values": list("x" * 20)}]
    )
    faults.install("device_launch:fail=99")
    with pytest.raises(DeviceLaunchError):
        tdoc.change([{"path": ["text"], "action": "insert", "index": 0, "values": list("y" * 30)}])
    faults.reset()
    uni = tdoc._uni
    assert uni.capacity == 32 and uni.states.capacity == 32
    c, _ = tdoc.change([{"path": ["text"], "action": "insert", "index": 0, "values": list("z" * 40)}])
    assert uni.capacity >= 60 and uni.states.capacity == uni.capacity
    peer = Doc("peer")
    peer.apply_change(genesis)
    peer.apply_change(c)
    assert tdoc.get_text_with_formatting(["text"]) == peer.get_text_with_formatting(["text"])


def test_local_change_anchor_queries_fire_the_readback_site(monkeypatch):
    """TorchDoc's anchor queries fire device_readback exactly where
    TpuDoc's do (an insert's reference, a mark's start and end; not a
    delete's batched query), so one plan lands on the same query in both,
    and a fault there rolls the change back."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    docs = (TorchDoc("author", device="cpu"), TpuDoc("author"))
    for d in docs:
        d.change([{"path": [], "action": "makeList", "key": "text"},
                  {"path": ["text"], "action": "insert", "index": 0, "values": list("abcdef")}])
    ops = [{"path": ["text"], "action": "insert", "index": 2, "values": ["x"]},
           {"path": ["text"], "action": "delete", "index": 0, "count": 2},
           {"path": ["text"], "action": "addMark", "startIndex": 1, "endIndex": 3, "markType": "link",
            "attrs": {"url": "u"}}]
    arm("device_readback:fail=0")
    outs = [d.change(ops) for d in docs]
    assert outs[0] == outs[1]
    assert faults.active().stats["device_readback"]["fired"] == 3
    assert faults.active().stats == jfaults.active().stats
    arm("device_readback:fail=1")
    for d in docs:
        seq = d.seq
        with pytest.raises(FaultError if d is docs[0] else RuntimeError):
            d.change(ops)
        assert d.seq == seq
