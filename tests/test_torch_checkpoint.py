"""Checkpoints of the PyTorch port (``peritext_tpu_torch.runtime.checkpoint``)
on the CPU: tests/test_checkpoint.py's scenarios over ``TorchUniverse``,
and the cross-engine cases in both directions.  A ``TpuUniverse`` snapshot
and an exported row load into ``TorchUniverse``, and the reverse, with
equal ``_row_digest``s, digests, spans, clocks and all 13 state fields
(their dtypes included: the payload holds ``bnd_mask`` as uint32)."""
import json
import logging
import os

import numpy as np
import pytest

from peritext_tpu.ops import TpuUniverse
from peritext_tpu.runtime import checkpoint as jckpt
from peritext_tpu.runtime.log import ChangeLog as JaxChangeLog
from peritext_tpu.testing import generate_docs
from peritext_tpu_torch import TorchUniverse, schema, state_to_numpy
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.runtime import ChangeLog, faults
from peritext_tpu_torch.runtime.checkpoint import (
    CHECKPOINT_FORMAT,
    CheckpointManager,
    _row_digest,
    export_replica,
    import_replica,
    load_universe,
    resume_universe,
    save_universe,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def build_session(make=lambda names: TorchUniverse(names, device="cpu"), log_cls=ChangeLog):
    docs, _, genesis = generate_docs("checkpointed doc", count=2)
    log = log_cls()
    log.record(genesis)
    uni = make([d.actor_id for d in docs])
    uni.apply_changes({d.actor_id: [genesis] for d in docs})
    c1, _ = docs[0].change(
        [{"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 12, "markType": "strong"},
         {"path": ["text"], "action": "addMark", "startIndex": 3, "endIndex": 9, "markType": "comment",
          "attrs": {"id": "c1"}}]
    )
    log.record(c1)
    uni.apply_changes({"doc1": [c1], "doc2": [c1]})
    docs[1].apply_change(c1)
    return docs, log, uni


def fields(uni):
    if isinstance(uni, TorchUniverse):
        return state_to_numpy(uni.states)
    return {f: np.asarray(getattr(uni.states, f)) for f in FIELDS}


def assert_same(a, b):
    fa, fb = fields(a), fields(b)
    for f in FIELDS:
        assert fa[f].dtype == fb[f].dtype and fa[f].shape == fb[f].shape, f
        assert (fa[f] == fb[f]).all(), f
    assert a.replica_ids == b.replica_ids and a.clocks == b.clocks
    assert a.lengths == b.lengths and a.mark_counts == b.mark_counts and a.text_objs == b.text_objs
    assert (a.digests() == b.digests()).all()
    for name in a.replica_ids:
        assert a.spans(name) == b.spans(name)


def test_snapshot_round_trip(tmp_path):
    docs, log, uni = build_session()
    path = os.path.join(tmp_path, "snap")
    save_universe(uni, path)
    restored = load_universe(path, device="cpu")
    assert restored.device == uni.device
    assert_same(restored, uni)
    for name in ("doc1", "doc2"):
        assert restored.clock(name) == uni.clock(name)


def test_load_without_a_device_asks_for_the_gpu(tmp_path, monkeypatch):
    """Loading puts the state on the GPU unless device="cpu" is passed;
    without one that is an error, as for a new TorchUniverse."""
    _, _, uni = build_session()
    path = os.path.join(tmp_path, "snap")
    save_universe(uni, path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_universe(path)


def test_resume_replays_log_tail(tmp_path):
    docs, log, uni = build_session()
    path = os.path.join(tmp_path, "snap")
    save_universe(uni, path)
    c2, _ = docs[1].change([{"path": ["text"], "action": "insert", "index": 16, "values": list(" v2")}])
    log.record(c2)
    docs[0].apply_change(c2)
    restored = resume_universe(path, log, device="cpu")
    for name, doc in (("doc1", docs[0]), ("doc2", docs[1])):
        assert restored.spans(name) == doc.get_text_with_formatting(["text"]), name
    d = restored.digests()
    assert d[0] == d[1]
    assert restored.stats["launches"] == 1  # one merge replayed the tail


def test_checkpoint_manager_rotation_and_restore(tmp_path):
    docs, log, uni = build_session()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), interval=2, keep=2)
    assert mgr.maybe_save(uni) is None
    assert mgr.maybe_save(uni) is not None
    for _ in range(4):
        mgr.maybe_save(uni)
    assert len(mgr.generations()) == 2
    c2, _ = docs[0].change([{"path": ["text"], "action": "insert", "index": 0, "values": ["!"]}])
    log.record(c2)
    restored = mgr.restore_latest(log, device="cpu")
    assert restored is not None and restored.text("doc1").startswith("!")


def test_checkpoint_manager_skips_corrupt_generation(tmp_path):
    _, _, uni = build_session()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=3)
    mgr.save(uni)
    good_spans = uni.spans("doc1")
    path = mgr.save(uni)
    with open(path + ".npz", "wb") as f:
        f.write(b"corrupt")
    restored = mgr.restore_latest(device="cpu")
    assert restored is not None and restored.spans("doc1") == good_spans


def test_snapshot_digest_detects_truncation(tmp_path, caplog):
    _, _, uni = build_session()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=3)
    mgr.save(uni)
    good_spans = uni.spans("doc1")
    path = mgr.save(uni)
    with open(path + ".npz", "r+b") as f:
        f.truncate(f.seek(0, 2) // 2)
    with pytest.raises(ValueError, match="digest mismatch"):
        load_universe(path, device="cpu")
    with caplog.at_level(logging.WARNING, logger="peritext_tpu_torch.runtime.checkpoint"):
        restored = mgr.restore_latest(device="cpu")
    assert restored is not None and restored.spans("doc1") == good_spans
    assert any("falling back" in r.message for r in caplog.records)


def test_checkpoint_write_fault_sites(tmp_path):
    """checkpoint_write: ``fail`` raises before anything is written and
    ``corrupt`` truncates the written npz, which restore_latest skips."""
    _, _, uni = build_session()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=3)
    first = mgr.save(uni)
    with faults.injected("checkpoint_write:fail=1"):
        with pytest.raises(faults.FaultError):
            mgr.save(uni)
    assert mgr.generations() == [0]
    with faults.injected("checkpoint_write:corrupt=1") as plan:
        mgr.save(uni)
    assert plan.stats["checkpoint_write"]["corrupted"] == 1
    restored = mgr.restore_latest(device="cpu")
    assert_same(restored, load_universe(first, device="cpu"))


def test_log_only_cold_rebuild_matches_snapshot():
    _, log, uni = build_session()
    cold = TorchUniverse(["doc1", "doc2"], device="cpu")
    cold.apply_changes({n: log.all_changes() for n in ("doc1", "doc2")})
    assert_same(cold, uni)


def test_snapshot_persists_mark_schema(tmp_path):
    _, _, uni = build_session()
    path = os.path.join(tmp_path, "snap")
    save_universe(uni, path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    assert [e["name"] for e in sidecar["mark_schema"]][:4] == ["strong", "em", "comment", "link"]
    sidecar["mark_schema"][0]["inclusive"] = False
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(ValueError, match="mark schema mismatch"):
        load_universe(path, device="cpu")


def test_snapshot_format_versioned(tmp_path):
    _, _, uni = build_session()
    path = os.path.join(tmp_path, "snap")
    save_universe(uni, path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    assert sidecar["format"] == CHECKPOINT_FORMAT == jckpt.CHECKPOINT_FORMAT
    sidecar["format"] = CHECKPOINT_FORMAT + 1
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(ValueError, match="format"):
        load_universe(path, device="cpu")
    del sidecar["format"]
    sidecar["roots"] = sidecar.pop("stores")
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(ValueError, match="roots"):
        load_universe(path, device="cpu")


def test_snapshot_round_trips_excludes(tmp_path):
    _, _, uni = build_session()
    path = os.path.join(tmp_path, "snap")
    save_universe(uni, path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    assert next(e for e in sidecar["mark_schema"] if e["name"] == "comment")["excludes"] == ""
    sidecar["mark_schema"].append({"name": "ckpt_excl_mark", "inclusive": False, "allow_multiple": True,
                                   "attr_keys": ["id"], "excludes": ""})
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    try:
        load_universe(path, device="cpu")
        assert schema.MARK_SPEC["ckpt_excl_mark"].excludes == ""
        schema.register_mark_type("ckpt_excl_mark", inclusive=False, allow_multiple=True,
                                  attr_keys=("id",), excludes="")
    finally:
        schema.MARK_SPEC.pop("ckpt_excl_mark", None)
        schema._rebuild_views()


def test_snapshot_restores_registered_mark_types(tmp_path):
    _, _, uni = build_session()
    path = os.path.join(tmp_path, "snap")
    save_universe(uni, path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    sidecar["mark_schema"].append({"name": "ckpt_only_mark", "inclusive": True,
                                   "allow_multiple": False, "attr_keys": []})
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    assert "ckpt_only_mark" not in schema.MARK_SPEC
    try:
        restored = load_universe(path, device="cpu")
        assert schema.MARK_SPEC["ckpt_only_mark"].inclusive is True
        assert restored.spans("doc1") == uni.spans("doc1")
    finally:
        schema.MARK_SPEC.pop("ckpt_only_mark", None)
        schema._rebuild_views()


# ---------------------------------------------------------------------------
# Across the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_loads_in_the_other_engine(tmp_path, direction):
    """Either engine's snapshot loads in the other: the npz holds the same
    dtypes, so all fields, digests, spans and clocks are equal, and both
    keep ingesting in step."""
    docs, log, port = build_session()
    _, _, ref = build_session(make=TpuUniverse, log_cls=JaxChangeLog)
    assert_same(port, ref)
    path = os.path.join(tmp_path, "snap")
    if direction == "jax_to_torch":
        jckpt.save_universe(ref, path)
        loaded, other = load_universe(path, device="cpu"), ref
    else:
        save_universe(port, path)
        loaded, other = jckpt.load_universe(path), port
    assert_same(loaded, other)
    c2, _ = docs[0].change([{"path": ["text"], "action": "insert", "index": 2, "values": list("xy")}])
    for u in (loaded, other):
        u.apply_changes({"doc1": [c2], "doc2": [c2]})
    assert_same(loaded, other)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_exported_row_imports_into_the_other_engine(direction):
    """A row exported by either engine imports into a fresh universe of
    the other; the two engines' ``_row_digest`` agree on every row, and
    the imported replica's digest and spans equal the source's."""
    _, _, port = build_session()
    _, _, ref = build_session(make=TpuUniverse, log_cls=JaxChangeLog)
    for name in port.replica_ids:
        a, b = export_replica(port, name), jckpt.export_replica(ref, name)
        assert a["digest"] == b["digest"] == jckpt._row_digest(a["arrays"]) == _row_digest(b["arrays"])
    src, export, make, imp = (
        (ref, jckpt.export_replica, lambda n: TorchUniverse(n, device="cpu"), import_replica)
        if direction == "jax_to_torch"
        else (port, export_replica, TpuUniverse, jckpt.import_replica)
    )
    payload = export(src, "doc1")
    target = make(["fresh", "other"])
    target.actors.intern("someone-else")  # the target's ids differ: remapped
    imp(target, "fresh", payload)
    r = target.index_of["fresh"]
    assert target.digests()[r] == src.digests()[src.index_of["doc1"]]
    assert target.spans("fresh") == src.spans("doc1")
    assert target.clock("fresh") == src.clock("doc1")


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_census_folds_alike_on_load_and_import(tmp_path, monkeypatch, direction):
    """A snapshot saved by one engine loads in the other with the
    allowMultiple group census folded from its mark tables as the live
    universes folded it; an imported row joins the census and drops the
    winner cache; and the next patched ingest on the sorted route is the
    same in both."""
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    docs, _, port = build_session()
    _, _, ref = build_session(make=TpuUniverse, log_cls=JaxChangeLog)
    assert port._multi_groups == ref._multi_groups and port._multi_groups
    path = os.path.join(tmp_path, "snap")
    if direction == "jax_to_torch":
        jckpt.save_universe(ref, path)
        loaded, other = load_universe(path, device="cpu"), ref
    else:
        save_universe(port, path)
        loaded, other = jckpt.load_universe(path), port
    assert loaded._multi_groups == other._multi_groups
    fresh_port, fresh_ref = TorchUniverse(["fresh"], device="cpu"), TpuUniverse(["fresh"])
    import_replica(fresh_port, "fresh", export_replica(port, "doc1"))
    jckpt.import_replica(fresh_ref, "fresh", jckpt.export_replica(ref, "doc1"))
    assert fresh_port._multi_groups == fresh_ref._multi_groups == port._multi_groups
    assert fresh_port._wcaches is None
    c2, _ = docs[0].change([{"path": ["text"], "action": "addMark", "startIndex": 1, "endIndex": 6,
                             "markType": "comment", "attrs": {"id": "c1"}}])
    batch = {"doc1": [c2], "doc2": [c2]}
    assert loaded.apply_changes_with_patches(batch) == other.apply_changes_with_patches(batch)
    assert_same(loaded, other)
    assert loaded._multi_groups == other._multi_groups


def test_import_refuses_a_torn_payload_and_a_busy_row():
    _, _, uni = build_session()
    payload = export_replica(uni, "doc1")
    target = TorchUniverse(["fresh"], device="cpu")
    payload["arrays"]["chars"][0] += 1
    with pytest.raises(ValueError, match="digest mismatch"):
        import_replica(target, "fresh", payload)
    with pytest.raises(ValueError, match="non-empty"):
        import_replica(uni, "doc2", export_replica(uni, "doc1"))


def test_import_leaves_committed_tensors_untouched():
    """import_replica writes the row into copies: the tensors of the
    states it replaced keep their bytes and version counters."""
    _, _, uni = build_session()
    target = TorchUniverse(["a", "b"], device="cpu")
    old = target.states
    before = {f: getattr(old, f).clone() for f in FIELDS}
    counters = [getattr(old, f)._version for f in FIELDS]
    import_replica(target, "b", export_replica(uni, "doc2"))
    assert [getattr(old, f)._version for f in FIELDS] == counters
    assert all(bool((getattr(old, f) == before[f]).all()) for f in FIELDS)
    assert target.spans("b") == uni.spans("doc2") and target.spans("a") == []
