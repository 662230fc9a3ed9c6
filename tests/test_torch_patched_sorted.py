"""The port's patched sorted route (``ops/sorted_patched.py`` and
``TorchUniverse._patched_sorted``) against the JAX package's default patch
route, byte for byte.

Universe level: ``TorchUniverse(device="cpu")`` under
``PERITEXT_MERGE_PATH=sorted`` (the compact-delta scan, and the per-op loop
via ``PERITEXT_PATCH_PATH=scan``) against ``TpuUniverse`` on its default
route, over the same change streams: every
patch stream (with and without positions), every state field, the winner
cache (through ``wcache_to_numpy``), digests, spans and the route
counters, and the oracle's stream on the observer.  Kernel level:
``merge_step_sorted_patched_batch`` against JAX's (its delta and its dense
scan) on the same numpy inputs, cold and warm.  ``TorchDoc`` on the sorted route: the census fed
by local marks, and a rollback that keeps it.  Tolerance is 0
throughout: every record, patch and state field is an integer, bool or
string.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.fuzz import _random_add_mark, _random_delete, _random_insert, _random_remove_mark
from peritext_tpu.ops import TpuUniverse
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops.doc import TpuDoc
from peritext_tpu.ops.encode import prepare_sorted_batch
from peritext_tpu.runtime import faults as jfaults
from peritext_tpu.runtime import health as jhealth
from peritext_tpu.schema import allow_multiple_array
from peritext_tpu.testing import generate_docs
from peritext_tpu_torch import TorchDoc, TorchUniverse, state_to_numpy, wcache_from_numpy, wcache_to_numpy
from peritext_tpu_torch.ops import sorted_patched as SP
from peritext_tpu_torch.ops.state import FIELDS, state_from_numpy
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import faults, health
from peritext_tpu_torch.testing import patch_path_env, patch_readback_env

ROUTE_STATS = ("launches", "scan_fallbacks", "multi_group_fallbacks", "readback_overflows",
               "degraded_batches", "ops_applied", "rows_padded", "changes_ingested")
_KNOBS = ("PERITEXT_PATCH_PATH", "PERITEXT_PATCH_READBACK", "PERITEXT_PATCH_SPAN_CAP",
          "PERITEXT_PATCH_CHUNK", "PERITEXT_SORTED_CHUNK", "PERITEXT_MERGE_WINDOW",
          "PERITEXT_MERGE_WINDOW_MIN", "PERITEXT_SORTED_MAX_ROUNDS", "PERITEXT_WINDOW_CHECK",
          "PERITEXT_FAULTS", "PERITEXT_DEGRADE", "PERITEXT_BREAKER")


@pytest.fixture(autouse=True)
def _sorted_route(monkeypatch):
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    monkeypatch.setenv("PERITEXT_LAUNCH_BACKOFF", "0.001")
    monkeypatch.setattr(TorchUniverse, "_span_cap_floor", 1)
    monkeypatch.setattr(TpuUniverse, "_span_cap_floor", 1)
    for plane in (faults, health, jfaults, jhealth):
        plane.reset()
    yield
    for plane in (faults, health, jfaults, jhealth):
        plane.reset()


def _drive(uni, steps, with_positions=False):
    return [uni.apply_changes_with_patches(step, with_positions=with_positions) for step in steps]


def _assert_same_universe(port, ref, context=""):
    got = state_to_numpy(port.states)
    for f in FIELDS:
        want = np.asarray(getattr(ref.states, f))
        assert got[f].dtype == want.dtype and got[f].shape == want.shape, f"{context}: {f}"
        assert (got[f] == want).all(), f"{context}: state field {f} diverged"
    assert (port.digests() == np.asarray(ref.digests())).all(), context
    assert port.spans_batch() == ref.spans_batch(), context


def _assert_same_cache(port, ref, context=""):
    if ref._wcaches is None:
        assert port._wcaches is None, f"{context}: the port kept a winner cache JAX dropped"
        return
    assert port._wcaches is not None, f"{context}: the port dropped the winner cache"
    assert port._wcaches_actors == ref._wcaches_actors, context
    assert (wcache_to_numpy(port._wcaches) == np.asarray(ref._wcaches)).all(), (
        f"{context}: winner cache diverged"
    )


def _assert_stats(port, ref, keys=ROUTE_STATS):
    for k in keys:
        assert port.stats.get(k, 0) == ref.stats.get(k, 0), (k, port.stats.get(k), ref.stats.get(k))


def _random_stream(seed, rounds=12, text="Delta scan!"):
    rng = random.Random(seed + 4242)
    docs, _, genesis = generate_docs(text, 3)
    stream = [genesis]
    comments = []
    for _ in range(rounds):
        doc = docs[rng.randrange(3)]
        for _ in range(rng.randrange(1, 4)):
            kind = rng.choice(["insert", "insert", "remove", "addMark", "removeMark"])
            if kind == "insert":
                op = _random_insert(rng, doc, 4)
            elif kind == "remove":
                op = _random_delete(rng, doc)
            elif kind == "addMark":
                op = _random_add_mark(rng, doc, comments)
            else:
                op = _random_remove_mark(rng, doc, comments, False)
            if op is not None:
                change, _ = doc.change([op])
                stream.append(change)
                for other in docs:
                    if other is not doc:
                        other.apply_change(change)
    return stream


def _oracle(stream):
    obs = Doc("oracle-observer")
    patches = []
    for change in stream:
        patches.extend(obs.apply_change(change))
    return obs, patches


# ---------------------------------------------------------------------------
# Universe level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_delta_dense_and_scan_match_tpu_universe(seed):
    """Random multi-writer streams in three batches to two replicas (one a
    lagging prefix): the port's delta scan and per-op loop each equal
    TpuUniverse's default route (whose dense scan gives the same bytes,
    ``test_merge_step_sorted_patched_matches_jax``) step by step, streams
    with positions."""
    stream = _random_stream(seed)
    half = len(stream) // 2
    steps = [
        {"observer": stream[:3], "late": stream[:2]},
        {"observer": stream[3:half], "late": stream[2:half]},
        {"observer": stream[half:], "late": []},
    ]
    ref = TpuUniverse(["observer", "late"])
    want = _drive(ref, steps, with_positions=True)
    for mode in ("delta", "scan"):
        with patch_path_env("scan" if mode == "scan" else None):
            port = TorchUniverse(["observer", "late"], device="cpu")
            for i, step in enumerate(steps):
                assert port.apply_changes_with_patches(step, with_positions=True) == want[i], (mode, i)
        _assert_same_universe(port, ref, mode)
        if mode == "scan":
            assert port._wcaches is None
        else:
            _assert_same_cache(port, ref, mode)
            _assert_stats(port, ref)
    obs, patches = _oracle(stream)
    assert [p for step in want for _, p in step["observer"]] == patches
    assert ref.spans("observer") == obs.get_text_with_formatting(["text"])


def test_zero_width_marks(monkeypatch):
    """Same-slot anchors (the endOfText walk-order edge) and a
    non-inclusive zero-width mark that lands nowhere, then text growth
    through both boundary states."""
    docs, _, genesis = generate_docs("ABCDE")
    doc = docs[0]
    stream = [genesis]
    for op in (
        {"path": ["text"], "action": "addMark", "startIndex": 2, "endIndex": 2, "markType": "strong"},
        {"path": ["text"], "action": "addMark", "startIndex": 3, "endIndex": 3, "markType": "link",
         "attrs": {"url": "x.example"}},
        {"path": ["text"], "action": "insert", "index": 3, "values": list("xy")},
        {"path": ["text"], "action": "removeMark", "startIndex": 1, "endIndex": 4, "markType": "strong"},
    ):
        change, _ = doc.change([op])
        stream.append(change)
    steps = [{"s": stream[:2]}, {"s": stream[2:]}]
    ref = TpuUniverse(["s"])
    want = _drive(ref, steps)
    port = TorchUniverse(["s"], device="cpu")
    assert _drive(port, steps) == want
    _assert_same_universe(port, ref)
    _assert_same_cache(port, ref)
    assert [p for step in want for p in step["s"]] == _oracle(stream)[1]


def _group_stream(n_ops, doc_text="commented delta text"):
    docs, _, genesis = generate_docs(doc_text, 2)
    a, b = docs
    stream = [genesis]
    for i in range(n_ops):
        action = "addMark" if i % 2 == 0 else "removeMark"
        change, _ = a.change([{
            "path": ["text"], "action": action, "startIndex": i % 5, "endIndex": 6 + (i % 4),
            "markType": "comment", "attrs": {"id": "hot"},
        }])
        b.apply_change(change)
        stream.append(change)
        if i % 3 == 1:
            change, _ = b.change([{"path": ["text"], "action": "addMark", "startIndex": i % 4,
                                   "endIndex": 12, "markType": "strong"}])
            a.apply_change(change)
            stream.append(change)
    return stream


def test_multi_group_under_cap_resolves_exactly(monkeypatch):
    """An allowMultiple group under the cap, in one batch (resolved in one
    launch) and delivered change by change (through the threaded cache)."""
    stream = _group_stream(5)
    patches = _oracle(stream)[1]
    for steps in ([{"s": stream}], [{"s": [c]} for c in stream]):
        ref = TpuUniverse(["s"])
        want = _drive(ref, steps)
        port = TorchUniverse(["s"], device="cpu")
        assert _drive(port, steps) == want
        _assert_same_universe(port, ref)
        _assert_same_cache(port, ref)
        _assert_stats(port, ref)
        assert port.stats["multi_group_fallbacks"] == 0
        assert [p for step in want for p in step["s"]] == patches


def test_multi_group_over_cap_falls_back_and_is_counted():
    """A group past PATCH_GROUP_K takes the per-op loop, counted as JAX
    counts it, and the stream stays the oracle's."""
    stream = _group_stream(SP.PATCH_GROUP_K + 1)
    steps = [{"s": stream[:6]}, {"s": stream[6:]}]
    ref = TpuUniverse(["s"])
    want = _drive(ref, steps)
    port = TorchUniverse(["s"], device="cpu")
    assert _drive(port, steps) == want
    assert port.stats["multi_group_fallbacks"] == ref.stats["multi_group_fallbacks"] == 1
    _assert_stats(port, ref)
    _assert_same_universe(port, ref)
    _assert_same_cache(port, ref)
    assert [p for step in want for p in step["s"]] == _oracle(stream)[1]


@pytest.mark.parametrize("span_cap", ["1", "8"])
def test_compact_and_planes_readbacks_and_span_overflow(span_cap, monkeypatch):
    """Compact equals planes; with a span cap of 1 the wide mark rows
    overflow and the batch is run again reading planes, counted as JAX
    counts it."""
    stream = _random_stream(7, rounds=10)
    steps = [{"a": stream[:5], "b": stream[:3]}, {"a": stream[5:], "b": stream[3:]}]
    monkeypatch.setenv("PERITEXT_PATCH_SPAN_CAP", span_cap)
    ref = TpuUniverse(["a", "b"])
    want = _drive(ref, steps, with_positions=True)
    for readback in ("compact", "planes"):
        with patch_readback_env(readback):
            port = TorchUniverse(["a", "b"], device="cpu")
            assert _drive(port, steps, with_positions=True) == want, readback
        _assert_same_universe(port, ref, readback)
        _assert_same_cache(port, ref, readback)
        if readback == "compact":
            _assert_stats(port, ref)
    if span_cap == "1":
        assert ref.stats["readback_overflows"] > 0


def test_lone_surrogates_assemble_through_both_readbacks():
    """Lone surrogate code points decode in the vectorized assembler as
    ``chr()`` decodes them."""
    docs, _, genesis = generate_docs("ab", 1)
    change, _ = docs[0].change(
        [{"path": ["text"], "action": "insert", "index": 1, "values": ["\ud800", "x", "\udfff"]}]
    )
    steps = [{"s": [genesis, change]}]
    want = _drive(TpuUniverse(["s"]), steps)
    for readback in ("compact", "planes"):
        with patch_readback_env(readback):
            port = TorchUniverse(["s"], device="cpu")
            assert _drive(port, steps) == want
        assert port.texts()[0] == "a\ud800x\udfffb"


def test_winner_cache_persists_and_interning_drops_it():
    """The winner cache rides every patched ingest (mark-free batches keep
    it, permuted), equals TpuUniverse's after each step, is dropped by a
    no-patch merge, by capacity growth and by a new actor's interning, and
    recovers after each."""
    m, z, a = Doc("m"), Doc("z"), Doc("a")
    genesis, _ = m.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("rank shift here")},
    ])
    for d in (z, a):
        d.apply_change(genesis)

    def authored(doc, ops):
        change, _ = doc.change(ops)
        for d in (m, z, a):
            if d is not doc:
                d.apply_change(change)
        return change

    ref = TpuUniverse(["obs"], capacity=64)
    port = TorchUniverse(["obs"], capacity=64, device="cpu")
    obs = Doc("obs")

    def step(change, patched=True):
        if patched:
            got = port.apply_changes_with_patches({"obs": [change]})
            assert got == ref.apply_changes_with_patches({"obs": [change]})
            assert got["obs"] == obs.apply_change(change)
        else:
            port.apply_changes({"obs": [change]})
            ref.apply_changes({"obs": [change]})
            obs.apply_change(change)
        _assert_same_cache(port, ref)

    step(genesis)
    step(authored(z, [{"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 4,
                       "markType": "strong"}]))
    assert port._wcaches is not None
    step(authored(z, [{"path": ["text"], "action": "insert", "index": 3, "values": list("xyz")}]))
    assert port._wcaches is not None  # the mark-free batch kept it
    step(authored(z, [{"path": ["text"], "action": "addMark", "startIndex": 2, "endIndex": 10,
                       "markType": "em"},
                      {"path": ["text"], "action": "removeMark", "startIndex": 0, "endIndex": 4,
                       "markType": "strong"}]))
    step(authored(m, [{"path": ["text"], "action": "addMark", "startIndex": 1, "endIndex": 6,
                       "markType": "comment", "attrs": {"id": "w1"}}]), patched=False)
    assert port._wcaches is None
    step(authored(m, [{"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 8,
                       "markType": "strong"}]))
    actors_before = port._wcaches_actors
    # A new actor sorts before both and renumbers every rank.
    step(authored(a, [{"path": ["text"], "action": "addMark", "startIndex": 2, "endIndex": 9,
                       "markType": "em"}]))
    assert port._wcaches_actors > actors_before
    step(authored(z, [{"path": ["text"], "action": "insert", "index": 0, "values": list("x" * 80)}]))
    assert port.capacity > 64
    step(authored(a, [{"path": ["text"], "action": "addMark", "startIndex": 10, "endIndex": 40,
                       "markType": "em"}]))
    _assert_same_universe(port, ref)
    assert port.spans("obs") == obs.get_text_with_formatting(["text"])
    # The bridge round-trips the cache.
    again = wcache_from_numpy(wcache_to_numpy(port._wcaches), device="cpu")
    assert again.dtype == torch.int32 and torch.equal(again, port._wcaches)


def test_degrade_under_faults_is_byte_identical(monkeypatch):
    """A transient launch failure is retried and the persistent one
    degrades to the oracle path; both end byte-equal to a fault-free
    TpuUniverse, the winner cache dropped by the degrade as JAX drops it."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "1")
    docs, _, genesis = generate_docs("delta under fire", count=2)
    a, b = docs
    c1, _ = a.change([
        {"path": ["text"], "action": "insert", "index": 3, "values": list("!!")},
        {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 8, "markType": "strong"},
        {"path": ["text"], "action": "addMark", "startIndex": 2, "endIndex": 10, "markType": "comment",
         "attrs": {"id": "chaos"}},
    ])
    steps = [{"d1": [genesis], "d2": [genesis]}, {"d1": [c1], "d2": [c1]}]
    ctrl = TpuUniverse(["d1", "d2"])
    want = _drive(ctrl, steps)
    for spec, degraded in (("seed=3;device_launch:fail=1", 0), ("seed=3;device_launch:fail=99", 1)):
        jref = TpuUniverse(["d1", "d2"])
        port = TorchUniverse(["d1", "d2"], device="cpu")
        assert port.apply_changes_with_patches(steps[0]) == jref.apply_changes_with_patches(steps[0])
        jfaults.install(spec)
        faults.install(spec)
        got = port.apply_changes_with_patches(steps[1])
        assert got == jref.apply_changes_with_patches(steps[1]) == want[1]
        faults.reset()
        jfaults.reset()
        assert port.stats["degraded_batches"] == jref.stats["degraded_batches"] == degraded
        assert port.stats["launch_retries"] >= 1
        _assert_same_universe(port, ctrl, spec)
        _assert_same_cache(port, jref, spec)


def test_replica_slices_and_patch_chunks_change_no_result(monkeypatch):
    """The patched merge's memory valve at its tightest (one replica per
    slice, the cold cache init sliced too) and ``PERITEXT_PATCH_CHUNK``
    give the unsliced streams, states and winner cache, windowed and not."""
    stream = _random_stream(11, rounds=8)
    steps = [{"a": stream[:4], "b": stream[:2], "c": stream[:4]},
             {"a": stream[4:], "b": stream[2:], "c": stream[4:]}]

    def run():
        port = TorchUniverse(["a", "b", "c"], device="cpu")
        return port, _drive(port, steps, with_positions=True)

    ref, want = run()
    for knob in ("slices", "chunks"):
        with monkeypatch.context() as mp:
            if knob == "slices":
                mp.setattr(SP, "_CHUNK_ELEMS", 1)
            else:
                mp.setenv("PERITEXT_PATCH_CHUNK", "2")
            port, got = run()
        assert got == want, knob
        a, b = state_to_numpy(port.states), state_to_numpy(ref.states)
        assert all((a[f] == b[f]).all() for f in FIELDS), knob
        assert torch.equal(port._wcaches, ref._wcaches), knob


def test_patch_group_k_and_route_knobs():
    """PATCH_GROUP_K is the JAX module's value; an unknown patch route
    (JAX's dense scan is not ported) raises before anything commits."""
    assert SP.PATCH_GROUP_K == JK.PATCH_GROUP_K
    docs, _, genesis = generate_docs("knobs", 1)
    port = TorchUniverse(["s"], device="cpu")
    for value in ("fast", "dense"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PERITEXT_PATCH_PATH", value)
            with pytest.raises(ValueError, match="PERITEXT_PATCH_PATH"):
                port.apply_changes_with_patches({"s": [genesis]})
    assert port.clock("s") == {}


# ---------------------------------------------------------------------------
# Kernel level
# ---------------------------------------------------------------------------


def _kernel_inputs(seed):
    """A JAX workload batch with a delivery order interleaving text and
    mark rows (any consistent order is a valid input to both engines)."""
    wl = make_merge_workload(doc_len=80, ops_per_merge=24, num_streams=4, with_marks=True, seed=seed)
    b = build_device_batch(wl, num_replicas=4, capacity=256, max_mark_ops=64)
    text_rows = [np.asarray(b["text_ops"][r]) for r in range(4)]
    mark_ops = np.asarray(b["mark_ops"])
    pos = [2 * np.arange(t.shape[0], dtype=np.int64) for t in text_rows]
    sp = prepare_sorted_batch(text_rows, max_run=0, pos_list=pos)
    n_valid = (mark_ops[..., JK.K_KIND] == JK.KIND_MARK).sum(axis=1)
    mark_time = np.where(np.arange(mark_ops.shape[1])[None, :] < n_valid[:, None],
                         2 * np.arange(mark_ops.shape[1])[None, :] + 1, 1 << 30).astype(np.int32)
    return b, sp, mark_ops, mark_time


def _kernel_pair(states_j, sp, mark_ops, mark_time, ranks, wcache=None, jax_mode="delta", **kw):
    """JAX's patched merge with its ``jax_mode`` scan against the port's
    (delta) scan on the same inputs."""
    multi = allow_multiple_array()
    args = (sp["text"], sp["rounds"], sp["num_rounds"], mark_ops, ranks, sp["bufs"], multi,
            sp["text_pos"], mark_time, sp["maxk"])
    ref_st, ref = JK.merge_step_sorted_patched_batch(
        states_j, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
        wcache_in=None if wcache is None else jnp.asarray(wcache), mode=jax_mode, **kw,
    )
    port_st = state_from_numpy({f: np.asarray(getattr(states_j, f)) for f in FIELDS}, device="cpu")
    st, rec = SP.merge_step_sorted_patched_batch(
        port_st, *(torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                   for a in args),
        wcache_in=None if wcache is None else wcache_from_numpy(wcache, device="cpu"), **kw,
    )
    got = state_to_numpy(st)
    for f in FIELDS:
        assert (got[f] == np.asarray(getattr(ref_st, f))).all(), f"state field {f}"
    assert sorted(rec) == sorted(ref)
    for k, v in ref.items():
        want = np.asarray(jax.device_get(v))
        g = rec[k].numpy()
        if want.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == want.shape and (g == want.astype(g.dtype)).all(), f"record {k}"
    return ref_st, np.asarray(ref["wcache"])


@pytest.mark.parametrize("mode,readback", [("delta", "compact"), ("dense", "planes")])
def test_merge_step_sorted_patched_matches_jax(mode, readback):
    """The patched merge itself, cold (winner cache init) then warm (the
    cold call's cache threaded into a second merge of the same batch),
    against JAX's delta scan and its dense scan."""
    b, sp, mark_ops, mark_time = _kernel_inputs(5)
    ranks = np.asarray(b["ranks"])
    kw = dict(jax_mode=mode, readback=readback, span_cap=8, cand_cap=64)
    st1, wc = _kernel_pair(b["states"], sp, mark_ops, mark_time, ranks, **kw)
    _kernel_pair(st1, sp, mark_ops, mark_time, ranks, wcache=wc, **kw)


# ---------------------------------------------------------------------------
# TorchDoc on the sorted route
# ---------------------------------------------------------------------------


def test_local_marks_count_toward_multi_group_gate():
    """K+1 local ops on one comment id, then one remote op on it: only the
    census fed by the local path can trip the gate, and the patches stay
    the oracle's (and TpuDoc's)."""
    src = Doc("src")
    genesis, _ = src.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("commented text here")},
    ])
    port, jdoc = TorchDoc("tpu", device="cpu"), TpuDoc("tpu")
    remote, observer = Doc("remote"), Doc("observer")
    for d in (port, jdoc, remote, observer):
        d.apply_change(genesis)
    for i in range(SP.PATCH_GROUP_K + 1):
        op = {"path": ["text"], "action": "addMark" if i % 2 == 0 else "removeMark",
              "startIndex": i % 5, "endIndex": 6 + (i % 4), "markType": "comment",
              "attrs": {"id": "hot"}}
        change, patches = port.change([op])
        assert jdoc.change([op])[1] == patches
        remote.apply_change(change)
        observer.apply_change(change)
    assert port._uni._multi_groups == jdoc._uni._multi_groups
    remote_change, _ = remote.change([{"path": ["text"], "action": "addMark", "startIndex": 2,
                                       "endIndex": 9, "markType": "comment", "attrs": {"id": "hot"}}])
    expected = observer.apply_change(remote_change)
    assert port.apply_change(remote_change) == jdoc.apply_change(remote_change) == expected
    assert port._uni.stats["multi_group_fallbacks"] == 1
    assert port.get_text_with_formatting(["text"]) == observer.get_text_with_formatting(["text"])


def test_doc_rollback_keeps_census_and_cache(monkeypatch):
    """A local change whose launch budget runs out rolls back with the
    census and the winner cache as they were; the next remote change on
    the sorted route threads the same cache TpuDoc does."""
    monkeypatch.setenv("PERITEXT_LAUNCH_RETRIES", "0")
    docs, _, genesis = generate_docs("rollback census", 2)
    a = docs[0]
    port, jdoc = TorchDoc("me", device="cpu"), TpuDoc("me")
    mark, _ = a.change([{"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 8,
                         "markType": "comment", "attrs": {"id": "c1"}}])
    for d in (port, jdoc):
        d.apply_change(genesis)
        d.apply_change(mark)
    census = {k: set(v) for k, v in port._uni._multi_groups.items()}
    cache = port._uni._wcaches
    assert census and cache is not None
    faults.install("device_launch:fail=99")
    with pytest.raises(Exception):
        port.change([{"path": ["text"], "action": "addMark", "startIndex": 1, "endIndex": 5,
                      "markType": "comment", "attrs": {"id": "c2"}}])
    faults.reset()
    assert port._uni._multi_groups == census
    assert port._uni._wcaches is cache
    follow, _ = a.change([{"path": ["text"], "action": "addMark", "startIndex": 3, "endIndex": 12,
                           "markType": "strong"}])
    assert port.apply_change(follow) == jdoc.apply_change(follow)
    _assert_same_cache(port._uni, jdoc._uni)
