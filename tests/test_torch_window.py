"""The port's frontier-bounded window merge against the JAX package's.

The census (``ops/window.py``), the windowed device merge
(``sorted_merge.merge_step_sorted_windowed_batch``) and the universe's
window plane must give exactly what the JAX package gives: the same plans,
the same states, stats and readbacks.  Each universe scenario runs three
legs on the same deliveries — the port windowed, the port pinned to the
full table (``PERITEXT_MERGE_WINDOW=0``) and ``TpuUniverse`` windowed —
with ``PERITEXT_MERGE_WINDOW_MIN=64`` so small documents engage, and
asserts that the window engaged where it should.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from peritext_tpu.fuzz import _random_add_mark, _random_delete, _random_insert, _random_remove_mark
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops import window as JW
from peritext_tpu.ops.encode import bucket_length, pad_rows, prepare_sorted_batch, split_rows
from peritext_tpu.ops.universe import TpuUniverse
from peritext_tpu.oracle import Doc
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import make_writer_rounds
from peritext_tpu_torch.ops import sorted_merge
from peritext_tpu_torch.ops import window as PW
from peritext_tpu_torch.ops.state import DocState, state_from_numpy

FIELDS = [f.name for f in dataclasses.fields(DocState)]
STATS = ("launches", "ops_applied", "rows_padded", "capacity_growths", "changes_ingested",
         "scan_fallbacks", "windowed_launches", "window_fallbacks", "window_rebuilds",
         "window_census_skips")


@pytest.fixture
def window_env(monkeypatch):
    """Selects the sorted route in both engines and pins the window knobs;
    returns a setter for PERITEXT_MERGE_WINDOW."""
    for var in ("PERITEXT_SORTED_CHUNK", "PERITEXT_PATCH_CHUNK", "PERITEXT_WINDOW_BACKOFF"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")

    def set_window(on: bool) -> None:
        monkeypatch.setenv("PERITEXT_MERGE_WINDOW", "1" if on else "0")

    return set_window


def _states_np(uni):
    if isinstance(uni, TorchUniverse):
        return state_to_numpy(uni.states)
    st = jax.device_get(uni.states)
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def _assert_same(a, b, context):
    sa, sb = _states_np(a), _states_np(b)
    for f in FIELDS:
        assert sa[f].dtype == sb[f].dtype and (sa[f] == sb[f]).all(), f"{context}: plane {f} diverged"
    assert a.texts() == b.texts(), context
    assert a.spans_batch() == b.spans_batch(), context
    assert (a.digests() == b.digests()).all(), context


def _drive(set_window, batches, windowed, engine, replicas=("r1", "r2"), capacity=1024):
    set_window(windowed)
    uni = engine(list(replicas), capacity=capacity, max_mark_ops=64,
                 **({"device": "cpu"} if engine is TorchUniverse else {}))
    for batch in batches:
        uni.apply_changes({r: batch for r in replicas})
    return uni


def _three_legs(set_window, batches, expect_windowed=True, **kw):
    port = _drive(set_window, batches, True, TorchUniverse, **kw)
    full = _drive(set_window, batches, False, TorchUniverse, **kw)
    tpu = _drive(set_window, batches, True, TpuUniverse, **kw)
    if expect_windowed:
        assert port.stats["windowed_launches"] >= 1, f"the window never engaged: {port.stats}"
    assert full.stats["windowed_launches"] == 0
    _assert_same(port, full, "windowed vs full table")
    _assert_same(port, tpu, "port vs TpuUniverse")
    for k in STATS:
        assert port.stats[k] == tpu.stats.get(k, 0), f"stats[{k}]"
    return port, full, tpu


def _genesis(n_chars=420, text="windowed merge! "):
    d = Doc("alice")
    body = (text * (n_chars // len(text) + 1))[:n_chars]
    genesis, _ = d.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list(body)},
    ])
    return d, genesis


def _random_stream(seed, steps=8, writers=3, n_chars=420):
    """Per-step batches of concurrent edits by up to ``writers`` actors at
    random positions, synced between steps (tests/test_window_merge.py's
    generator)."""
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
                batch.append(doc.change([op])[0])
        for change in batch:
            for d in docs:
                if d.actor_id != change["actor"]:
                    d.apply_change(change)
        if batch:
            batches.append(batch)
    return batches


def test_plan_windows_matches_jax(window_env):
    """On the JAX universe's own mirrors and gated rows, before every batch
    of a random stream: the port's census gives JAX's plan (starts, hulls,
    w_cap, vis_base, vis_after, or None) and each replica's hull."""
    window_env(True)
    batches = _random_stream(1, steps=10)
    tpu = TpuUniverse(["r1", "r2"], capacity=1024, max_mark_ops=64)
    tpu.apply_changes({r: batches[0] for r in ("r1", "r2")})
    planned = 0
    lagging = []  # r2 takes each batch one step after r1, so the mirrors differ
    for batch in batches[1:]:
        prep = tpu._prepare([batch, lagging])
        rows_of = [prep["groups"][g]["rows"] for g in prep["group_of"]]
        ins_of = [int(prep["groups"][g]["inserts"]) for g in prep["group_of"]]
        mirrors = tpu._mirrors()
        ranks = tpu._ranks_host()
        for m, rows in zip(mirrors, rows_of):
            assert PW.replica_window(m, rows, ranks) == JW.replica_window(m, rows, ranks)
        for min_cap in (64, 2048):
            want = JW.plan_windows(mirrors, rows_of, ins_of, ranks, tpu.capacity, min_cap)
            got = PW.plan_windows(mirrors, rows_of, ins_of, ranks, tpu.capacity, min_cap)
            assert (got is None) == (want is None)
            if want is not None:
                assert sorted(got) == sorted(want) and got["w_cap"] == want["w_cap"]
                for k in ("starts", "hulls", "vis_base", "vis_after"):
                    assert got[k].dtype == want[k].dtype and (got[k] == want[k]).all(), k
        planned += JW.plan_windows(mirrors, rows_of, ins_of, ranks, tpu.capacity, 64) is not None
        tpu.apply_changes([batch, lagging])
        lagging = batch
    assert planned


def test_windowed_merge_matches_jax():
    """``merge_step_sorted_windowed_batch`` against JAX's on the same state,
    plan and rows: new states, the device verdict and the window planes;
    then with one replica's window moved off its edit, where both verdicts
    are False for that replica."""
    batches = _random_stream(2, steps=4)
    tpu = TpuUniverse(["r1", "r2"], capacity=1024, max_mark_ops=64)
    tpu.apply_changes({r: batches[0] for r in ("r1", "r2")})
    local = Doc("bob")
    local.apply_change(batches[0][0])
    edit, _ = local.change([
        {"path": ["text"], "action": "insert", "index": 300, "values": list("xyz")},
        {"path": ["text"], "action": "addMark", "startIndex": 298, "endIndex": 305, "markType": "em"},
        {"path": ["text"], "action": "delete", "index": 296, "count": 2},
    ])
    prep = tpu._prepare([[edit], [edit]])
    g = prep["groups"][0]
    text_rows, mark_rows = split_rows(g["rows"])
    plan = JW.plan_windows(tpu._mirrors(), [g["rows"]] * 2, [g["inserts"]] * 2, tpu._ranks_host(),
                           tpu.capacity, 64)
    assert plan is not None
    sp = prepare_sorted_batch([text_rows] * 2, max_run=0)
    marks = np.stack([mark_rows] * 2)
    ranks = tpu._ranks_host()
    st = tpu.states
    verdicts = []
    # The plan; one replica's window moved off its edit; starts past
    # C - w_cap, which the gather clamps as lax.dynamic_slice does.
    past = np.asarray([tpu.capacity - 1, tpu.capacity - plan["w_cap"] + 7], np.int32)
    for starts in (plan["starts"], np.asarray([plan["starts"][0], 0], np.int32), past):
        ref, ref_rec = JK.merge_step_sorted_windowed_batch(
            st, jnp.asarray(starts), jnp.asarray(plan["hulls"]), jnp.asarray(sp["text"]),
            jnp.asarray(sp["rounds"]), sp["num_rounds"], jnp.asarray(marks), jnp.asarray(ranks),
            jnp.asarray(sp["bufs"]), sp["maxk"], plan["w_cap"],
        )
        got, rec = sorted_merge.merge_step_sorted_windowed_batch(
            state_from_numpy({f: np.array(getattr(st, f)) for f in FIELDS}), torch.from_numpy(starts),
            torch.from_numpy(plan["hulls"]), torch.from_numpy(sp["text"]), torch.from_numpy(sp["rounds"]),
            sp["num_rounds"], torch.from_numpy(marks), torch.from_numpy(ranks), torch.from_numpy(sp["bufs"]),
            sp["maxk"], plan["w_cap"],
        )
        assert sorted(rec) == sorted(ref_rec)
        for k, v in rec.items():
            want = np.asarray(ref_rec[k])
            assert v.numpy().dtype == want.dtype and (v.numpy() == want).all(), k
        wok = np.asarray(ref_rec["wok"])
        got_np = state_to_numpy(got)
        for f in FIELDS:
            want = np.asarray(getattr(ref, f))
            assert got_np[f].dtype == want.dtype, f
            # A rejected window's state is meaningless: compare accepted rows.
            assert (got_np[f][wok] == want[wok]).all(), f
        verdicts.append(wok.tolist())
    assert verdicts[:2] == [[True, True], [True, False]]


class _PeakStorage(TorchDispatchMode):
    """Largest storage, in elements, of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.peak = max(self.peak, t.untyped_storage().nbytes() // t.element_size())
        return out


def test_windowed_merge_in_slices_bounds_its_transients(monkeypatch):
    """Four replicas take two writers' hotspot batches of about 60 text
    rows each.  With ``_CHUNK_ELEMS`` cut to 4096 the windowed merge runs
    each replica alone and its window check in op chunks: no tensor it
    makes is as large as one replica's [L, w_cap] predicate, and states,
    verdicts and window planes still equal JAX's and the unsliced run's."""
    wl = make_writer_rounds(doc_len=700, ops_per_round=160, num_writers=2, rounds=1, seed=6, locality=96)
    names = [f"r{i}" for i in range(4)]
    tpu = TpuUniverse(names, capacity=1024, max_mark_ops=64)
    tpu.apply_changes([[wl["genesis"]]] * 4)
    batch = [wl["rounds"][0][r % 2] for r in range(4)]
    prep = tpu._prepare(batch)
    rows_of = [prep["groups"][g]["rows"] for g in prep["group_of"]]
    ins_of = [int(prep["groups"][g]["inserts"]) for g in prep["group_of"]]
    plan = JW.plan_windows(tpu._mirrors(), rows_of, ins_of, tpu._ranks_host(), tpu.capacity, 64)
    assert plan is not None
    split = [split_rows(rows) for rows in rows_of]
    sp = prepare_sorted_batch([t for t, _ in split], max_run=0)
    mark_pad = bucket_length(max(m.shape[0] for _, m in split))
    marks = np.stack([pad_rows(m, mark_pad) for _, m in split])
    ranks = tpu._ranks_host()
    n_text, w_cap = sp["text"].shape[1], plan["w_cap"]
    assert n_text >= 32 and (marks[:, :, JK.K_KIND] == JK.KIND_MARK).any()
    args = (plan["starts"], plan["hulls"], sp["text"], sp["rounds"], sp["num_rounds"], marks, ranks,
            sp["bufs"], sp["maxk"], w_cap)
    ref, ref_rec = JK.merge_step_sorted_windowed_batch(
        tpu.states, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    port_states = state_from_numpy({f: np.array(getattr(tpu.states, f)) for f in FIELDS})
    port_args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    runs = {}
    for chunk in (sorted_merge._CHUNK_ELEMS, 4096):
        monkeypatch.setattr(sorted_merge, "_CHUNK_ELEMS", chunk)
        with _PeakStorage() as peak:
            got, rec = sorted_merge.merge_step_sorted_windowed_batch(port_states, *port_args)
        runs[chunk] = peak.peak
        assert np.asarray(ref_rec["wok"]).all()
        for k, v in rec.items():
            assert (v.numpy() == np.asarray(ref_rec[k])).all(), (chunk, k)
        got_np = state_to_numpy(got)
        for f in FIELDS:
            want = np.asarray(getattr(ref, f))
            assert got_np[f].dtype == want.dtype and (got_np[f] == want).all(), (chunk, f)
    unsliced, sliced = runs.values()
    assert unsliced >= 4 * n_text * w_cap and sliced < n_text * w_cap, runs


def test_windowed_matches_full_table_and_tpu_universe(window_env):
    """Random multi-writer streams through apply_changes: the three legs
    agree on every plane, text, span, digest and shared stat."""
    _three_legs(window_env, _random_stream(10, steps=8))


def _zero_width_and_edge_marks():
    d, genesis = _genesis(400)
    batches = [[genesis]]
    for ops in (
        [{"path": ["text"], "action": "addMark", "startIndex": 100, "endIndex": 110, "markType": "strong"}],
        [{"path": ["text"], "action": "delete", "index": 100, "count": 10}],  # zero-width survivor
        [{"path": ["text"], "action": "insert", "index": 100, "values": list("in")}],
        [{"path": ["text"], "action": "addMark", "startIndex": 200, "endIndex": 200, "markType": "em"}],
        [{"path": ["text"], "action": "insert", "index": 200, "values": list("zz")}],
    ):
        batches.append([d.change(ops)[0]])
    return batches


def _mark_at_earlier_mark_boundary():
    d, genesis = _genesis(600)
    batches = [[genesis]]
    batches.append([d.change([{"path": ["text"], "action": "addMark", "startIndex": 200,
                               "endIndex": 210, "markType": "strong"}])[0]])
    for start, end, mt, action in ((209, 215, "em", "addMark"), (210, 220, "em", "addMark"),
                                   (209, 214, "strong", "removeMark"), (208, 213, "comment", "addMark")):
        op = {"path": ["text"], "action": action, "startIndex": start, "endIndex": end, "markType": mt}
        if mt == "comment":
            op["attrs"] = {"id": "c-1"}
        batches.append([d.change([op])[0]])
    return batches


def _tombstone_run_straddling_the_window():
    d, genesis = _genesis(500)
    batches = [[genesis], [d.change([{"path": ["text"], "action": "delete", "index": 150, "count": 80}])[0]]]
    for idx in (150, 151, 149):
        batches.append([d.change([{"path": ["text"], "action": "insert", "index": idx,
                                   "values": list("ab")}])[0]])
    batches.append([d.change([{"path": ["text"], "action": "addMark", "startIndex": 140,
                               "endIndex": 160, "markType": "strong"}])[0]])
    return batches


@pytest.mark.parametrize("scenario", [
    _zero_width_and_edge_marks, _mark_at_earlier_mark_boundary, _tombstone_run_straddling_the_window,
])
def test_window_edge_scenarios(window_env, scenario):
    """Zero-width and same-element (caret) marks at the window's edges, a
    mark starting on an earlier mark's end boundary (its carry source lies
    left of the anchor), and a tombstone run across the window edge."""
    _three_legs(window_env, scenario())


def test_window_engages_only_past_min_capacity(window_env, monkeypatch):
    d, genesis = _genesis(100)
    c, _ = d.change([{"path": ["text"], "action": "insert", "index": 50, "values": ["x"]}])
    window_env(True)
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "4096")
    uni = TorchUniverse(["r1"], capacity=1024, max_mark_ops=64, device="cpu")
    uni.apply_changes({"r1": [genesis]})
    uni.apply_changes({"r1": [c]})
    assert uni.stats["windowed_launches"] == 0 and uni.stats["window_rebuilds"] == 0
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "1024")
    uni.apply_changes({"r1": [d.change([{"path": ["text"], "action": "delete", "index": 3, "count": 1}])[0]]})
    assert uni.stats["windowed_launches"] == 1
    later, _ = d.change([{"path": ["text"], "action": "insert", "index": 1, "values": ["y"]}])
    for value, msg in (("x", "must be an integer"), ("0", "must be >= 1")):
        monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", value)
        with pytest.raises(ValueError, match=f"PERITEXT_MERGE_WINDOW_MIN {msg}"):
            uni.apply_changes({"r1": [later]})
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")
    uni.apply_changes({"r1": [later]})  # nothing was committed by the failed calls
    assert uni.text("r1") == "".join(s["text"] for s in d.get_text_with_formatting(["text"]))


def test_census_rejection_backoff(window_env):
    """Twelve batches whose hulls span the table: the first four pay a
    census and a mirror rebuild and are rejected, the next eight skip the
    census, and a caret-local edit after that engages the window again."""
    d, genesis = _genesis(900)
    batches = [[genesis]]
    for i in range(12):
        batches.append([d.change([
            {"path": ["text"], "action": "insert", "index": 1, "values": ["a"]},
            {"path": ["text"], "action": "insert", "index": 899 + 2 * i, "values": ["b"]},
        ])[0]])
    batches.append([d.change([{"path": ["text"], "action": "insert", "index": 450, "values": ["e"]}])[0]])
    port, _, _ = _three_legs(window_env, batches)
    assert port.stats["window_census_skips"] == 8
    assert port.stats["windowed_launches"] == 1
    assert port.stats["window_rebuilds"] == 5


def test_stale_mirror_is_rejected_on_device_and_relaunched(window_env):
    """A corrupted mirror windows the wrong region; the device check
    rejects it, the merge relaunches on the full table (counted), and the
    result equals a full-table run and TpuUniverse given the same mirror."""
    d, genesis = _genesis(800)
    warm, _ = d.change([{"path": ["text"], "action": "insert", "index": 10, "values": ["w"]}])
    edit, _ = d.change([{"path": ["text"], "action": "insert", "index": 700, "values": list("xy")}])
    window_env(True)
    legs = []
    for uni in (TorchUniverse(["r1"], capacity=2048, max_mark_ops=64, device="cpu"),
                TpuUniverse(["r1"], capacity=2048, max_mark_ops=64)):
        uni.apply_changes({"r1": [genesis]})
        uni.apply_changes({"r1": [warm]})
        assert uni.stats["windowed_launches"] == 1
        m = uni._mirror[0]
        for f in ("ctr", "act", "deleted"):
            m[f][5], m[f][699] = m[f][699].copy(), m[f][5].copy()
        uni.apply_changes({"r1": [edit]})
        assert uni.stats["window_fallbacks"] == 1 and uni.stats["launches"] == 4
        legs.append(uni)
    port, tpu = legs
    full = _drive(window_env, [[genesis], [warm], [edit]], False, TorchUniverse, replicas=("r1",),
                  capacity=2048)
    _assert_same(port, full, "relaunch vs full table")
    _assert_same(port, tpu, "relaunch vs TpuUniverse")


def test_mirror_is_rebuilt_after_the_states_change_elsewhere(window_env, monkeypatch):
    """The mirror is keyed to the states' version: windowed commits splice
    it (no rebuild), the windowed patched merge included; an ingest on the
    per-op loop (PERITEXT_PATCH_PATH=scan) reassigns the states, and an
    in-place write to a state tensor changes its version, so the next
    windowed merge rebuilds the mirror.  The result equals TpuUniverse's."""
    window_env(True)
    monkeypatch.delenv("PERITEXT_PATCH_PATH", raising=False)
    d, genesis = _genesis(600)
    edits = [d.change([{"path": ["text"], "action": "insert", "index": 100 + 20 * i,
                        "values": list("ok")}])[0] for i in range(6)]
    port = TorchUniverse(["r1", "r2"], capacity=1024, max_mark_ops=64, device="cpu")
    tpu = TpuUniverse(["r1", "r2"], capacity=1024, max_mark_ops=64)
    for uni in (port, tpu):
        uni.apply_changes([[genesis]] * 2)
        uni.apply_changes([[edits[0]]] * 2)
        uni.apply_changes([[edits[1]]] * 2)
        assert uni.stats["windowed_launches"] == 2 and uni.stats["window_rebuilds"] == 1
        # The patched route windows and splices in both engines.
        uni.apply_changes_with_patches([[edits[2]]] * 2)
        assert uni.stats["windowed_launches"] == 3 and uni.stats["window_rebuilds"] == 1
        monkeypatch.setenv("PERITEXT_PATCH_PATH", "scan")
        uni.apply_changes_with_patches([[edits[3]]] * 2)
        monkeypatch.delenv("PERITEXT_PATCH_PATH")
        uni.apply_changes([[edits[4]]] * 2)
    assert port.stats["windowed_launches"] == 4 and port.stats["window_rebuilds"] == 2
    _assert_same(port, tpu, "after a per-op patched ingest")
    port.states.deleted[0, 0] = port.states.deleted[0, 0].clone()  # same bytes, new version
    port.apply_changes([[edits[5]]] * 2)
    assert port.stats["windowed_launches"] == 5 and port.stats["window_rebuilds"] == 3
    tpu.apply_changes([[edits[5]]] * 2)
    _assert_same(port, tpu, "after an in-place write")


def test_mirror_under_inference_mode_is_rebuilt_every_time(window_env):
    """Inference tensors keep no version counter: the mirror can never be
    shown current, so every census rebuilds it, with the same result."""
    window_env(True)
    d, genesis = _genesis(600)
    edits = [d.change([{"path": ["text"], "action": "insert", "index": 50 + 30 * i,
                        "values": list("ab")}])[0] for i in range(2)]
    with torch.inference_mode():
        port = TorchUniverse(["r1"], capacity=1024, max_mark_ops=64, device="cpu")
        for batch in [[genesis]] + [[e] for e in edits]:
            port.apply_changes({"r1": batch})
        assert port.stats["windowed_launches"] == 2 and port.stats["window_rebuilds"] == 2
    full = _drive(window_env, [[genesis]] + [[e] for e in edits], False, TorchUniverse, replicas=("r1",))
    _assert_same(port, full, "inference mode")
