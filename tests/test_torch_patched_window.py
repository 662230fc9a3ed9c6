"""The port's patched windowed merge (``sorted_patched.
merge_step_sorted_patched_windowed_batch`` under ``TorchUniverse.
_patched_sorted``) against the full-table patched merge and against
``TpuUniverse``'s windowed route, byte for byte (tests/test_window_merge.py's
patched cases).

Every case runs the same delivery through the port windowed
(``PERITEXT_MERGE_WINDOW=1`` with the engagement floor at 64), the port
on the full table (``=0``) and ``TpuUniverse`` windowed, all on the sorted
route, and compares patch streams, every state field, digests, spans and
the winner cache (``wcache_to_numpy``), asserting the window engaged on
both engines alike.  Tolerance 0.
"""
import dataclasses
import random

import numpy as np
import pytest

from peritext_tpu.fuzz import _random_add_mark, _random_delete, _random_insert, _random_remove_mark
from peritext_tpu.ops import TpuUniverse
from peritext_tpu_torch import TorchUniverse, state_to_numpy, wcache_to_numpy
from peritext_tpu_torch.ops import sorted_patched as SP
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime.serve import ServePlane

_KNOBS = ("PERITEXT_PATCH_PATH", "PERITEXT_PATCH_READBACK", "PERITEXT_PATCH_SPAN_CAP",
          "PERITEXT_PATCH_CHUNK", "PERITEXT_SORTED_CHUNK", "PERITEXT_SORTED_MAX_ROUNDS",
          "PERITEXT_WINDOW_CHECK", "PERITEXT_FAULTS", "PERITEXT_DEGRADE")
WINDOW_STATS = ("launches", "windowed_launches", "window_fallbacks", "window_census_skips",
                "readback_overflows", "scan_fallbacks")


@pytest.fixture(autouse=True)
def _sorted_route(monkeypatch):
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")
    monkeypatch.setattr(TorchUniverse, "_span_cap_floor", 1)
    monkeypatch.setattr(TpuUniverse, "_span_cap_floor", 1)


def _drive(make, batches, windowed, monkeypatch, replicas=("r1", "r2"), **kw):
    kw.setdefault("capacity", 1024)
    kw.setdefault("max_mark_ops", 64)
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "1" if windowed else "0")
    uni = make(list(replicas), **kw)
    outs = [uni.apply_changes_with_patches({r: b for r in replicas}, with_positions=True)
            for b in batches]
    return uni, outs


def _port(names, **kw):
    return TorchUniverse(names, device="cpu", **kw)


def _fields(uni):
    if isinstance(uni, TorchUniverse):
        return state_to_numpy(uni.states)
    return {f: np.asarray(getattr(uni.states, f)) for f in FIELDS}


def _assert_same(a, b, context, same_cache_presence=True):
    """States, digests, spans and the winner cache.  A cold windowed
    ingest leaves no cache where a full-table one builds it, so windowed
    against full compares caches only where both exist (as JAX's test
    does); port against TpuUniverse on one route must agree on both."""
    fa, fb = _fields(a), _fields(b)
    for f in FIELDS:
        assert (fa[f] == fb[f]).all(), f"{context}: state field {f} diverged"
    assert (np.asarray(a.digests()) == np.asarray(b.digests())).all(), context
    assert a.spans_batch() == b.spans_batch(), context
    wa = None if a._wcaches is None else (
        wcache_to_numpy(a._wcaches) if isinstance(a, TorchUniverse) else np.asarray(a._wcaches))
    wb = None if b._wcaches is None else (
        wcache_to_numpy(b._wcaches) if isinstance(b, TorchUniverse) else np.asarray(b._wcaches))
    if same_cache_presence:
        assert (wa is None) == (wb is None), context
    if wa is not None and wb is not None:
        assert (wa == wb).all(), f"{context}: winner cache diverged"


def _assert_identical(batches, monkeypatch, expect_windowed=True, **kw):
    pw, ow = _drive(_port, batches, True, monkeypatch, **kw)
    pf, of = _drive(_port, batches, False, monkeypatch, **kw)
    jw, oj = _drive(TpuUniverse, batches, True, monkeypatch, **kw)
    if expect_windowed:
        assert pw.stats["windowed_launches"] >= 1, pw.stats
    assert pf.stats["windowed_launches"] == 0
    assert ow == of == oj, "patch streams diverged"
    _assert_same(pw, pf, "windowed vs full", same_cache_presence=False)
    _assert_same(pw, jw, "port vs TpuUniverse")
    for k in WINDOW_STATS:
        assert pw.stats[k] == jw.stats.get(k, 0), (k, pw.stats[k], jw.stats.get(k, 0))
    return pw, pf


def _genesis(n_chars=420, text="windowed merge! "):
    d = Doc("alice")
    body = (text * (n_chars // len(text) + 1))[:n_chars]
    genesis, _ = d.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list(body)},
    ])
    return d, genesis


def _random_stream(seed, steps=10, writers=3, n_chars=420):
    rng = random.Random(seed)
    base, genesis = _genesis(n_chars)
    docs = [base] + [Doc(f"w{i}") for i in range(1, writers)]
    for d in docs[1:]:
        d.apply_change(genesis)
    batches = [[genesis]]
    comments = []
    for _ in range(steps):
        batch = []
        for _ in range(rng.randrange(1, writers + 1)):
            doc = docs[rng.randrange(len(docs))]
            kind = rng.choice(["insert", "insert", "insert", "delete", "addMark", "removeMark"])
            if kind == "insert":
                op = _random_insert(rng, doc, 6)
            elif kind == "delete":
                op = _random_delete(rng, doc)
            elif kind == "addMark":
                op = _random_add_mark(rng, doc, comments)
            else:
                op = _random_remove_mark(rng, doc, comments, False)
            if op is not None:
                change, _ = doc.change([op])
                batch.append(change)
        for change in batch:
            for d in docs:
                if d.actor_id != change["actor"]:
                    d.apply_change(change)
        if batch:
            batches.append(batch)
    return batches


@pytest.mark.parametrize("seed", [0])
def test_windowed_matches_full_and_tpu_universe(seed, monkeypatch):
    """Random multi-writer steps: windowed = full table = TpuUniverse (seed
    0, as tests/test_window_merge.py runs it in tier 1)."""
    _assert_identical(_random_stream(seed), monkeypatch)


def test_tombstone_run_straddling_window_edge(monkeypatch):
    """A long tombstone run next to the edits: the hull carries the
    skip-run slack over the tombstones, and a mark spans the run."""
    d, genesis = _genesis(500)
    batches = [[genesis]]
    c, _ = d.change([{"path": ["text"], "action": "delete", "index": 150, "count": 80}])
    batches.append([c])
    for idx in (150, 151, 149):
        c, _ = d.change([{"path": ["text"], "action": "insert", "index": idx, "values": list("ab")}])
        batches.append([c])
    c, _ = d.change([{"path": ["text"], "action": "addMark", "startIndex": 140, "endIndex": 160,
                      "markType": "strong"}])
    batches.append([c])
    pw, _ = _assert_identical(batches, monkeypatch)
    # One replica per slice through the window's gather, merge and scatter.
    monkeypatch.setattr(SP, "_CHUNK_ELEMS", 1)
    ps, _ = _drive(_port, batches, True, monkeypatch)
    assert ps.stats["windowed_launches"] == pw.stats["windowed_launches"]
    _assert_same(ps, pw, "sliced vs unsliced")


def test_census_rejection_relaunches_full_path(monkeypatch):
    """A corrupted mirror windows the wrong region: the device check
    rejects it, the rejection is counted, and the full-table relaunch
    gives the full path's exact results."""
    d, genesis = _genesis(800)
    warm, _ = d.change([{"path": ["text"], "action": "insert", "index": 10, "values": ["w"]}])
    edit, _ = d.change([{"path": ["text"], "action": "insert", "index": 700, "values": list("xy")}])
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "1")
    uni = _port(["r1"], capacity=2048, max_mark_ops=64)
    uni.apply_changes_with_patches({"r1": [genesis]})
    uni.apply_changes_with_patches({"r1": [warm]})
    assert uni.stats["windowed_launches"] == 1
    m = uni._mirror[0]
    for f in ("ctr", "act", "deleted"):
        m[f][5], m[f][699] = m[f][699].copy(), m[f][5].copy()
    out = uni.apply_changes_with_patches({"r1": [edit]})
    assert uni.stats["window_fallbacks"] == 1
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "0")
    ctrl = TpuUniverse(["r1"], capacity=2048, max_mark_ops=64)
    ctrl.apply_changes_with_patches({"r1": [genesis]})
    ctrl.apply_changes_with_patches({"r1": [warm]})
    assert out == ctrl.apply_changes_with_patches({"r1": [edit]})
    _assert_same(uni, ctrl, "after the rejection")


def test_warm_winner_cache_through_windowed_ingests(monkeypatch):
    """A cache built by a full-table marked ingest survives windowed
    ingests: its window rows ride the gather and scatter, the rest stay."""
    d, genesis = _genesis(420)
    mark, _ = d.change([{"path": ["text"], "action": "addMark", "startIndex": 50, "endIndex": 90,
                         "markType": "strong"}])
    edits = [
        d.change([{"path": ["text"], "action": "insert", "index": 70, "values": list("mid")}])[0],
        d.change([{"path": ["text"], "action": "addMark", "startIndex": 60, "endIndex": 80,
                   "markType": "em"}])[0],
    ]

    def run(make, windowed_later):
        monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "0")
        uni = make(["r1"], capacity=1024, max_mark_ops=64)
        uni.apply_changes_with_patches({"r1": [genesis]})
        uni.apply_changes_with_patches({"r1": [mark]})
        assert uni._wcaches is not None
        monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "1" if windowed_later else "0")
        outs = [uni.apply_changes_with_patches({"r1": [c]}) for c in edits]
        return uni, outs

    pw, ow = run(_port, True)
    pf, of = run(_port, False)
    jw, oj = run(TpuUniverse, True)
    assert pw.stats["windowed_launches"] == jw.stats["windowed_launches"] >= 1
    assert ow == of == oj
    _assert_same(pw, pf, "warm windowed vs full")
    _assert_same(pw, jw, "warm port vs TpuUniverse")


def test_window_check_drill_and_served_windowed_flushes(monkeypatch):
    """``PERITEXT_WINDOW_CHECK=1`` recomputes each windowed batch on the
    full table and finds no difference; a ServePlane flush that took the
    window is counted in ``stats["windowed_flushes"]``."""
    d, genesis = _genesis(420)
    edit, _ = d.change([{"path": ["text"], "action": "insert", "index": 200, "values": list("hi")}])
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "1")
    monkeypatch.setenv("PERITEXT_WINDOW_CHECK", "1")
    uni = _port(["r1"], capacity=1024, max_mark_ops=64)
    plane = ServePlane(uni, start=False)
    s = plane.session("s0", replica="r1", record_stream=True)
    s.submit([genesis])
    assert plane.drain() == 0
    s.submit([edit])
    assert plane.drain() == 0
    assert uni.stats["windowed_launches"] == 1
    assert plane.stats["windowed_flushes"] == 1
    ref = TpuUniverse(["r1"], capacity=1024, max_mark_ops=64)
    expect = ref.apply_changes_with_patches({"r1": [genesis]})["r1"]
    expect += ref.apply_changes_with_patches({"r1": [edit]})["r1"]
    assert s.patch_log == expect


def test_window_check_drill_catches_a_diverging_window(monkeypatch):
    """Under ``PERITEXT_WINDOW_CHECK=1`` a windowed result that differs
    from the full-table recompute raises, naming the plane, and nothing
    commits."""
    d, genesis = _genesis(420)
    edit, _ = d.change([{"path": ["text"], "action": "insert", "index": 200, "values": list("hi")}])
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "1")
    monkeypatch.setenv("PERITEXT_WINDOW_CHECK", "1")
    uni = _port(["r1"], capacity=1024, max_mark_ops=64)
    uni.apply_changes_with_patches({"r1": [genesis]})
    real = SP.merge_step_sorted_patched_windowed_batch

    def diverging(*args, **kw):
        st, rec = real(*args, **kw)
        return dataclasses.replace(st, chars=st.chars + 1), rec

    monkeypatch.setattr(SP, "merge_step_sorted_patched_windowed_batch", diverging)
    before = state_to_numpy(uni.states)
    with pytest.raises(RuntimeError, match="diverged from full-table on plane chars"):
        uni.apply_changes_with_patches({"r1": [edit]})
    assert uni.clock("r1") == {"alice": 1}
    after = state_to_numpy(uni.states)
    assert all((before[f] == after[f]).all() for f in FIELDS)
