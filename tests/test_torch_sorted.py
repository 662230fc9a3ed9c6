"""The port's sorted merge (sort-based placement + batched mark phase)
against the JAX package's, byte for byte, and the default
``TorchUniverse.apply_changes`` against the default ``TpuUniverse``.

Inputs are the JAX package's benchmark workloads and hand-built edge
cases (numpy seeds); both engines get the same numpy op rows.  Every
state field must agree exactly (tolerance 0) and keep its JAX dtype.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ids import ActorRegistry
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops.encode import AttrRegistry, encode_changes, prepare_sorted_batch, split_rows
from peritext_tpu.ops.state import make_empty_state, stack_states
from peritext_tpu.ops.universe import TpuUniverse
from peritext_tpu.oracle import Doc
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import insert_heavy_text_ops, make_writer_rounds
from peritext_tpu_torch.ops import cuda_kernels, sorted_merge
from peritext_tpu_torch.ops import universe as port_universe
from peritext_tpu_torch.ops.state import DocState, state_from_numpy

FIELDS = [f.name for f in dataclasses.fields(DocState)]
SHARED_STATS = ("launches", "ops_applied", "rows_padded", "capacity_growths", "changes_ingested",
                "duplicates_dropped", "scan_fallbacks", "windowed_launches", "window_fallbacks",
                "window_rebuilds", "window_census_skips")


def _np(x):
    return np.array(jax.device_get(x))


def _port_state(jax_state):
    return state_from_numpy({f: _np(getattr(jax_state, f)) for f in FIELDS})


def _assert_state_equal(jax_state, port_state, context=""):
    got = state_to_numpy(port_state)
    for f in FIELDS:
        ref = _np(getattr(jax_state, f))
        assert got[f].dtype == ref.dtype, f"{context}: {f} dtype"
        assert got[f].shape == ref.shape, f"{context}: {f} shape"
        assert (got[f] == ref).all(), f"{context}: field {f} diverged"


def _both_sorted(states, text_rows, mark_ops, ranks, chunk=None):
    """The same numpy inputs through JAX's and the port's sorted merge."""
    sp = prepare_sorted_batch(text_rows, max_run=0)
    args = (sp["text"], sp["rounds"], sp["num_rounds"], mark_ops, ranks, sp["bufs"], sp["maxk"])
    ref = JK.merge_step_sorted_batch(
        states, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    out = sorted_merge.merge_step_sorted_batch(
        _port_state(states), *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args),
        chunk=chunk,
    )
    return ref, out, sp


def _workload_batch(seed, with_marks, replicas=4, doc_len=120, ops=48, capacity=512):
    wl = make_merge_workload(doc_len=doc_len, ops_per_merge=ops, num_streams=4, with_marks=with_marks, seed=seed)
    return build_device_batch(wl, num_replicas=replicas, capacity=capacity, max_mark_ops=64)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("with_marks", [True, False])
def test_sorted_merge_matches_jax(seed, with_marks):
    b = _workload_batch(seed, with_marks)
    ref, out, _ = _both_sorted(
        b["states"], [np.asarray(b["text_ops"][r]) for r in range(4)], np.asarray(b["mark_ops"]),
        np.asarray(b["ranks"]),
    )
    _assert_state_equal(ref, out, f"seed={seed}")
    # The sorted path equals the exact per-op merge (JAX's own invariant).
    scan = JK.merge_step_batch(
        b["states"], jnp.asarray(b["text_ops"]), jnp.asarray(b["mark_ops"]), jnp.asarray(b["ranks"])
    )
    _assert_state_equal(scan, out, f"seed={seed} vs scan")


def _encode(changes_list, genesis):
    actors, attrs = ActorRegistry(), AttrRegistry()
    g_rows, _, _ = encode_changes([genesis], actors, attrs)
    text_obj = genesis["ops"][0]["opId"]
    rows = [encode_changes(c, actors, attrs, text_obj=text_obj)[0] for c in changes_list]
    ranks = np.zeros(64, np.int32)
    ranks[: len(actors.ranks())] = actors.ranks()
    return g_rows, rows, ranks


def _genesis_state(g_rows, ranks, capacity, max_marks):
    base = JK.apply_ops_jit(make_empty_state(capacity, max_marks), jnp.asarray(g_rows), jnp.asarray(ranks))
    return stack_states([base])


def test_deep_chains_and_same_position_races():
    """Three actors insert at one position, chain inserts on their own
    earlier batch elements and delete one of them: several rounds."""
    base = Doc("base")
    genesis, _ = base.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("wxyz")},
    ])
    changes = []
    for name in ("alice", "bob", "carol"):
        w = Doc(name)
        w.apply_change(genesis)
        c1, _ = w.change([{"path": ["text"], "action": "insert", "index": 2, "values": list(name[:2])}])
        c2, _ = w.change([
            {"path": ["text"], "action": "insert", "index": 3, "values": list(name[2:].upper() or "Q")},
            {"path": ["text"], "action": "delete", "index": 2, "count": 1},
        ])
        changes += [c1, c2]
    g_rows, (rows,), ranks = _encode([changes], genesis)
    text_rows, mark_rows = split_rows(rows)
    assert mark_rows.shape[0] == 0
    states = _genesis_state(g_rows, ranks, 128, 64)
    no_marks = np.zeros((1, 1, JK.OP_FIELDS), np.int32)
    ref, out, sp = _both_sorted(states, [text_rows], no_marks, ranks)
    assert sp["num_rounds"] >= 2
    _assert_state_equal(ref, out, "deep chains")


def test_unbounded_run_places_in_one_round():
    """A pasted 300-char run fuses to one row and places in one round, a
    block wider than MAX_RUN_LEN."""
    doc = Doc("paster")
    genesis, _ = doc.change([{"path": [], "action": "makeList", "key": "text"}])
    change, _ = doc.change([{"path": ["text"], "action": "insert", "index": 0, "values": list("ab" * 150)}])
    g_rows, (rows,), ranks = _encode([[change]], genesis)
    states = stack_states([make_empty_state(512, 32)])
    ref, out, sp = _both_sorted(states, [rows], np.zeros((1, 1, JK.OP_FIELDS), np.int32), ranks)
    assert sp["num_rounds"] == 1 and sp["maxk"] >= 300
    _assert_state_equal(ref, out, "unbounded run")
    assert int(out.length[0]) == 300


def test_chunked_matches_unchunked_with_uneven_tail(monkeypatch):
    b = _workload_batch(9, True, replicas=6, doc_len=80, ops=32, capacity=256)
    args = (b["states"], [np.asarray(b["text_ops"][r]) for r in range(6)], np.asarray(b["mark_ops"]),
            np.asarray(b["ranks"]))
    ref, whole, _ = _both_sorted(*args, chunk=0)
    _, chunked, _ = _both_sorted(*args, chunk=4)  # slices of 4 and 2
    _assert_state_equal(ref, whole, "unchunked")
    _assert_state_equal(ref, chunked, "chunk 4")
    monkeypatch.setenv("PERITEXT_SORTED_CHUNK", "5")
    _, env_chunked, _ = _both_sorted(*args)
    _assert_state_equal(ref, env_chunked, "PERITEXT_SORTED_CHUNK=5")
    # The memory bound alone: one replica per slice.
    monkeypatch.setattr(sorted_merge, "_CHUNK_ELEMS", 1)
    _, tiny, _ = _both_sorted(*args, chunk=0)
    _assert_state_equal(ref, tiny, "one replica per slice")
    monkeypatch.setenv("PERITEXT_SORTED_CHUNK", "x")
    with pytest.raises(ValueError):  # JAX's int() raises too
        _both_sorted(*args)
    port_only = (torch.from_numpy(np.asarray(b["text_ops"])), torch.zeros((6, 64), dtype=torch.int32), 1,
                 torch.from_numpy(np.asarray(b["mark_ops"])), torch.from_numpy(np.asarray(b["ranks"])),
                 torch.zeros((6, 64), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="PERITEXT_SORTED_CHUNK must be an integer"):
        sorted_merge.merge_step_sorted_batch(_port_state(args[0]), *port_only)
    monkeypatch.setenv("PERITEXT_SORTED_CHUNK", "-1")
    with pytest.raises(ValueError, match="PERITEXT_SORTED_CHUNK must be >= 0"):
        sorted_merge.merge_step_sorted_batch(_port_state(args[0]), *port_only)


def _mark_changes(rng, w, n):
    out = []
    for i in range(n):
        a = rng.randrange(0, 150)
        add = bool(i % 4)
        mt = rng.choice(["strong", "em", "link"] if add else ["strong", "em"])
        op = {"path": ["text"], "action": "addMark" if add else "removeMark",
              "startIndex": a, "endIndex": a + 1 + rng.randrange(40), "markType": mt}
        if mt == "link":
            op["attrs"] = {"url": "u.com"}
        out.append(w.change([op])[0])
    return out


@pytest.mark.parametrize("fill,batch,max_marks", [
    (100, 10, 128),  # the word window clamps at the table's last words
    (24, 12, 64),    # the batch's bits cross bit 31 of word 0 into word 1
    (0, 70, 128),    # 140 write nodes: JAX's gather branch, not its OR chain
])
def test_mark_window_at_table_end_and_bit_31(fill, batch, max_marks):
    """Marks whose table index lands in the last words of the table (w0 =
    clip(count // 32, 0, W - w_act)) and marks whose bit is bit 31 of a
    word (an int32 bitcast's sign bit): sorted equals JAX and the scan."""
    base = Doc("base")
    genesis, _ = base.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("y" * 200)},
    ])
    w = Doc("w")
    w.apply_change(genesis)
    rng = random.Random(13)
    fills = _mark_changes(rng, w, fill)
    last = _mark_changes(rng, w, batch)
    g_rows, (fill_rows, last_rows), ranks = _encode([fills, last], genesis)
    states = _genesis_state(g_rows, ranks, 512, max_marks)
    _, fm = split_rows(fill_rows)
    states = JK.merge_step_batch(states, jnp.zeros((1, 1, JK.OP_FIELDS), jnp.int32), jnp.asarray(fm[None]),
                                 jnp.asarray(ranks))
    assert int(_np(states.mark_count)[0]) == fill
    t, m = split_rows(last_rows)
    ref, out, _ = _both_sorted(states, [t], m[None], ranks)
    _assert_state_equal(ref, out, "window")
    scan = JK.merge_step_batch(states, jnp.asarray(t[None]), jnp.asarray(m[None]), jnp.asarray(ranks))
    _assert_state_equal(scan, out, "window vs scan")
    words = state_to_numpy(out)["bnd_mask"]
    if fill <= 31 < fill + batch:
        assert (words[..., 0] & np.uint32(1 << 31)).any()  # bit 31 was set somewhere


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_splice_on_insert_heavy_rows_matches_jax(seed):
    """Random rows, a quarter each of pads, inserts, deletes and runs of up
    to 64 chars, with HEAD, absent and live references, in three rounds:
    the splice sorts many equal sentinel keys (dead slots, inactive lanes),
    absent references resolve to element 0, and some replicas grow past C.
    Every field keeps its JAX dtype."""
    b = _workload_batch(seed, True, replicas=6, doc_len=100, ops=24, capacity=256)
    st = b["states"]
    ops, char_buf = insert_heavy_text_ops(np.random.default_rng(seed), _port_state(st), 24, 128)
    ops = ops.numpy()
    # Round labels drawn at random: each round places its own rows.
    rounds = np.random.default_rng(seed + 7).integers(0, 3, size=ops.shape[:2]).astype(np.int32)
    num_rounds = 3
    marks = np.asarray(b["mark_ops"])
    ranks = np.asarray(b["ranks"])
    ref = JK.merge_step_sorted_batch(st, jnp.asarray(ops), jnp.asarray(rounds), num_rounds, jnp.asarray(marks),
                                     jnp.asarray(ranks), jnp.asarray(char_buf.numpy()), 64)
    out = sorted_merge.merge_step_sorted_batch(
        _port_state(st), torch.from_numpy(ops), torch.from_numpy(rounds), num_rounds, torch.from_numpy(marks),
        torch.from_numpy(ranks), char_buf, 64,
    )
    _assert_state_equal(ref, out, "insert-heavy")
    assert (out.length > 256).any()  # grew past C


def test_apply_marks_batch_with_perm_matches_jax():
    """The mark phase with the splice permutation composed into its reads,
    on a batch whose text phase inserts and deletes."""
    b = _workload_batch(5, True)
    sp = prepare_sorted_batch([np.asarray(b["text_ops"][r]) for r in range(4)], max_run=0)
    st = b["states"]
    ranks = jnp.asarray(b["ranks"])
    ec, ea, _, _, oi, ln = jax.vmap(
        lambda *a: JK.place_text_batch(*a[:7], sp["num_rounds"], ranks, a[7], sp["maxk"])
    )(st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, jnp.asarray(sp["text"]),
      jnp.asarray(sp["rounds"]), jnp.asarray(sp["bufs"]))
    ref_def, ref_mask = jax.vmap(
        lambda d, m, mo, e, a, n, mc, p: JK._apply_marks_batch(d, m, mo, e, a, n, mc, st.bnd_mask.shape[-1], perm=p)
    )(st.bnd_def, st.bnd_mask, jnp.asarray(b["mark_ops"]), ec, ea, ln, st.mark_count, oi)
    p = _port_state(st)
    got_def, got_mask = sorted_merge._apply_marks_batch(
        p.bnd_def, p.bnd_mask, torch.from_numpy(np.asarray(b["mark_ops"])), torch.from_numpy(_np(ec)),
        torch.from_numpy(_np(ea)), torch.from_numpy(_np(ln)), p.mark_count, perm=torch.from_numpy(_np(oi)),
    )
    assert (_np(oi) < 0).any()  # the splice inserted something
    assert got_def.dtype == torch.bool and got_mask.dtype == torch.int32
    assert (got_def.numpy() == _np(ref_def)).all()
    assert (got_mask.numpy().view(np.uint32) == _np(ref_mask)).all()
    assert not (_np(ref_mask) == _np(st.bnd_mask)).all()


def test_or_accumulate_is_exact_on_high_bits():
    """Distinct bits up to bit 31 in every word sum exactly (the float64
    matmul), independent of the TF32 flag."""
    sel = torch.ones((1, 3, 64), dtype=torch.bool)
    bits = torch.zeros((1, 64, 2), dtype=torch.int64)
    for m in range(64):
        bits[0, m, m // 32] = 1 << (m % 32)
    out = sorted_merge._or_accumulate(sel, bits)
    assert (out == 0xFFFFFFFF).all()
    assert (sorted_merge._to_int32_bits(out) == -1).all()


def test_first_match_sentinel_is_element_0():
    """An anchor that matches nothing resolves to slot 0 (+ kind), as JAX's
    argmax over all-False does; endOfText and same-slot ends take the
    sentinel 2C + 2."""
    c = 8
    ec = torch.arange(1, c + 1, dtype=torch.int32)[None]
    ea = torch.zeros((1, c), dtype=torch.int32)
    ops = torch.zeros((1, 3, 15), dtype=torch.int32)
    ops[0, :, 0] = 3
    ops[0, 0, [10, 11, 9, 13, 14, 12]] = torch.tensor([999, 0, 1, 3, 0, 0], dtype=torch.int32)  # absent start
    ops[0, 1, [10, 11, 9, 12]] = torch.tensor([2, 0, 0, 2], dtype=torch.int32)  # endOfText
    ops[0, 2, [10, 11, 9, 13, 14, 12]] = torch.tensor([4, 0, 1, 4, 0, 1], dtype=torch.int32)  # same slot
    valid, s, e = sorted_merge._batched_anchor_slots(ops, ec, ea, torch.tensor([c], dtype=torch.int32))
    assert valid.all()
    assert s.tolist() == [[1, 2, 7]]
    assert e.tolist() == [[4, 2 * c + 2, 2 * c + 2]]


def _assert_universes_equal(tpu, port, context=""):
    ref = jax.device_get(tpu.states)
    got = state_to_numpy(port.states)
    for f in FIELDS:
        a = np.asarray(getattr(ref, f))
        assert got[f].dtype == a.dtype and (got[f] == a).all(), f"{context}: field {f} diverged"
    assert port.texts() == tpu.texts()
    assert port.spans_batch() == tpu.spans_batch()
    assert (port.digests() == tpu.digests()).all()
    assert port.clocks == tpu.clocks and port.lengths == tpu.lengths
    for k in SHARED_STATS:
        assert port.stats[k] == tpu.stats.get(k, 0), f"{context}: stats[{k}]"


@pytest.mark.parametrize("seed,locality", [(0, 48), (3, 0)])
def test_sorted_universe_matches_tpu_universe(monkeypatch, seed, locality):
    """Under PERITEXT_MERGE_PATH=sorted (TpuUniverse's default route), six
    replicas follow three writers over three chained rounds, then merge all
    to all, from C = 32 (growing to 512): states, texts, spans, digests and
    every shared stat agree.  With hotspot edits the window engages; with
    edits anywhere the census mostly rejects."""
    for var in ("PERITEXT_SORTED_CHUNK", "PERITEXT_PATCH_CHUNK", "PERITEXT_MERGE_WINDOW"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")
    wl = make_writer_rounds(doc_len=300, ops_per_round=10, num_writers=3, rounds=3, seed=seed,
                            locality=locality)
    names = [f"r{i}" for i in range(6)]
    tpu = TpuUniverse(names, capacity=32, max_mark_ops=32)
    port = TorchUniverse(names, capacity=32, max_mark_ops=32, device="cpu")
    cuda_kernels.reset_launch_counts()
    batches = [[[wl["genesis"]]] * 6] + [[rnd[i % 3] for i in range(6)] for rnd in wl["rounds"]]
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(3)]
    batches.append([history[(i + 1) % 3] + history[(i + 2) % 3] for i in range(6)])
    for k, batch in enumerate(batches):
        tpu.apply_changes(batch)
        port.apply_changes(batch)
        _assert_universes_equal(tpu, port, f"batch {k}")
    assert port.stats["capacity_growths"] >= 1 and port.stats["scan_fallbacks"] == 0
    assert port.stats["windowed_launches"] >= (1 if locality else 0)
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0}
    oracle = Doc("oracle")
    oracle.apply_change(wl["genesis"])
    for w in range(3):
        for c in history[w]:
            oracle.apply_change(c)
    assert port.spans_batch() == [oracle.get_text_with_formatting(["text"])] * 6


def _deep_history():
    doc = Doc("deep")
    genesis, _ = doc.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("deep")},
    ])
    changes = [genesis]
    for i in range(40):
        idx = len(doc.root["text"]) if i % 2 == 0 else 0  # chained, and unfusable
        changes.append(doc.change([{"path": ["text"], "action": "insert", "index": idx,
                                    "values": [chr(97 + i % 26)]}])[0])
    return doc, changes


def test_deep_history_falls_back_to_the_scan_path(monkeypatch):
    """On the sorted route, a history deeper than
    PERITEXT_SORTED_MAX_ROUNDS runs the exact per-op merge (the kernels'
    plain versions here), counted once, with the oracle's spans, as
    TpuUniverse does; the variable is checked as an integer knob."""
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    doc, changes = _deep_history()
    calls = []
    real = port_universe.merge_step_full
    monkeypatch.setattr(port_universe, "merge_step_full", lambda *a: calls.append(1) or real(*a))
    port = TorchUniverse(["r"], capacity=256, device="cpu")
    tpu = TpuUniverse(["r"], capacity=256)
    port.apply_changes({"r": changes})
    tpu.apply_changes({"r": changes})
    assert port.stats["scan_fallbacks"] == 1 == tpu.stats["scan_fallbacks"]
    assert calls == [1]
    assert port.spans("r") == doc.get_text_with_formatting(["text"])
    _assert_universes_equal(tpu, port, "deep history")
    monkeypatch.setenv("PERITEXT_SORTED_MAX_ROUNDS", "64")
    deep = TorchUniverse(["r"], capacity=256, device="cpu")
    deep.apply_changes({"r": changes})
    assert deep.stats["scan_fallbacks"] == 0 and calls == [1]
    assert deep.spans("r") == doc.get_text_with_formatting(["text"])
    for value, msg in (("eight", "must be an integer"), ("-1", "must be >= 0")):
        monkeypatch.setenv("PERITEXT_SORTED_MAX_ROUNDS", value)
        with pytest.raises(ValueError, match=f"PERITEXT_SORTED_MAX_ROUNDS {msg}"):
            TorchUniverse(["r"], capacity=256, device="cpu").apply_changes({"r": changes})


@pytest.mark.parametrize("path", [None, "", "scan"])
def test_scan_pin_takes_merge_step_full(monkeypatch, path):
    """The kernels' merge is the default route (unset or empty) and the
    ``scan`` pin; neither reaches the sorted or windowed merge."""
    if path is None:
        monkeypatch.delenv("PERITEXT_MERGE_PATH", raising=False)
    else:
        monkeypatch.setenv("PERITEXT_MERGE_PATH", path)
    calls = []
    real = port_universe.merge_step_full
    monkeypatch.setattr(port_universe, "merge_step_full", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(port_universe, "merge_step_sorted_batch", None)  # must not be called
    monkeypatch.setattr(port_universe, "merge_step_sorted_windowed_batch", None)
    wl = make_writer_rounds(doc_len=600, ops_per_round=6, num_writers=2, rounds=2, seed=4)
    port = TorchUniverse(["a", "b"], capacity=1024, device="cpu")
    port.apply_changes([[wl["genesis"]]] * 2)
    for rnd in wl["rounds"]:
        port.apply_changes(rnd)
    assert calls == [1, 1, 1] and port.stats["launches"] == 3
    assert port.stats["windowed_launches"] == 0 and port.stats["window_rebuilds"] == 0


def test_unknown_merge_path_raises(monkeypatch):
    """A misspelt route names the variable and commits nothing."""
    wl = make_writer_rounds(doc_len=40, ops_per_round=4, num_writers=1, rounds=0, seed=5)
    port = TorchUniverse(["a"], capacity=256, device="cpu")
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sort")
    with pytest.raises(ValueError, match="PERITEXT_MERGE_PATH must be 'scan' or 'sorted', got 'sort'"):
        port.apply_changes([[wl["genesis"]]])
    assert port.stats["changes_ingested"] == 0 and port.clocks == [{}]
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "sorted")
    port.apply_changes([[wl["genesis"]]])
    assert port.text("a") == "".join(s["text"] for s in wl["writers"][0].get_text_with_formatting(["text"]))
