"""The port's patch path against the JAX package and the oracle.

Kernel level: ``apply_ops_patched`` (both readbacks) against JAX's
``apply_ops_patched_batch`` on the same numpy states and unfused op rows,
every record field and the state byte-equal.  Universe level:
``TorchUniverse(device="cpu").apply_changes_with_patches`` against
``TpuUniverse`` on its scan path (streams, states, stats) and its default
path (streams, spans), and against an incremental oracle Doc.  Cursors
against ``TpuUniverse``'s.  Tolerance is 0 throughout: every record,
patch and state field is an integer, bool or string.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.fuzz import _random_add_mark, _random_delete, _random_insert, _random_remove_mark
from peritext_tpu.ids import ActorRegistry
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops.encode import AttrRegistry, encode_changes, pad_rows
from peritext_tpu.ops.state import index_state, make_empty_state as jax_empty_state, stack_states
from peritext_tpu.ops.universe import TpuUniverse
from peritext_tpu.schema import allow_multiple_array
from peritext_tpu.testing import generate_docs, patch_path_env
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import make_merge_workload
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import DocState, state_from_numpy
from peritext_tpu_torch.oracle import Doc, accumulate_patches

from tests.test_engine import SCENARIOS

FIELDS = [f.name for f in dataclasses.fields(DocState)]
STATS = ("launches", "ops_applied", "rows_padded", "capacity_growths",
         "changes_ingested", "duplicates_dropped")


def _np(x):
    return np.array(jax.device_get(x))


# ---------------------------------------------------------------------------
# Kernel level
# ---------------------------------------------------------------------------


def _patched_inputs(seed, replicas=6, doc_len=60, ops=20, capacity=256, max_marks=64):
    """Replica r holds the genesis plus writer (r + 1) % 4's stream (applied
    by JAX's per-op path), and takes writer r % 4's stream as unfused op
    rows: concurrent inserts, deletes and marks over existing marks."""
    wl = make_merge_workload(doc_len, ops, 4, True, seed=seed)
    actors, attrs = ActorRegistry(), AttrRegistry()
    text_obj = wl["genesis"]["ops"][0]["opId"]
    g_rows, _, _ = encode_changes([wl["genesis"]], actors, attrs)
    streams = [encode_changes(s, actors, attrs, text_obj=text_obj)[0] for s in wl["streams"]]
    ranks = np.zeros(64, np.int32)
    ranks[: len(actors.ranks())] = actors.ranks()
    pad = max(s.shape[0] for s in streams)
    first = np.stack([
        np.concatenate([g_rows, pad_rows(streams[(r + 1) % 4], pad)]) for r in range(replicas)
    ])
    base = stack_states([jax_empty_state(capacity, max_marks) for _ in range(replicas)])
    base = JK.apply_ops_batch(base, jnp.asarray(first), jnp.asarray(ranks))
    ops_rows = np.stack([pad_rows(streams[r % 4], pad + 3) for r in range(replicas)])
    return base, ops_rows, ranks


@pytest.mark.parametrize("readback", ["compact", "planes"])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_ops_patched_matches_jax(seed, readback):
    base, ops_rows, ranks = _patched_inputs(seed)
    multi = allow_multiple_array()
    want_state, want = JK.apply_ops_patched_batch(
        base, jnp.asarray(ops_rows), jnp.asarray(ranks), jnp.asarray(multi),
        readback=readback, span_cap=8,
    )
    port = state_from_numpy({f: _np(getattr(base, f)) for f in FIELDS}, device="cpu")
    got_state, got = K.apply_ops_patched(
        port, torch.from_numpy(ops_rows), torch.from_numpy(ranks), torch.from_numpy(multi),
        readback=readback, span_cap=8,
    )
    assert (ops_rows[..., K.K_KIND] == K.KIND_MARK).any()
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = _np(ref)
        g = got[name].numpy()
        if ref.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.dtype == ref.dtype and g.shape == ref.shape, name
        assert (g == ref).all(), f"record field {name} diverged"
    if readback == "compact":
        assert _np(want["mcount"]).max() > 0
    else:
        assert _np(want["changed"]).any()
    got_np = state_to_numpy(got_state)
    for f in FIELDS:
        assert (got_np[f] == _np(getattr(want_state, f))).all(), f"state field {f} diverged"


@pytest.mark.parametrize("seed", [2, 3])
def test_apply_ops_matches_jax(seed):
    base, ops_rows, ranks = _patched_inputs(seed, replicas=4)
    want = JK.apply_ops_batch(base, jnp.asarray(ops_rows), jnp.asarray(ranks))
    port = state_from_numpy({f: _np(getattr(base, f)) for f in FIELDS}, device="cpu")
    got = state_to_numpy(K.apply_ops(port, torch.from_numpy(ops_rows), torch.from_numpy(ranks)))
    for f in FIELDS:
        assert (got[f] == _np(getattr(want, f))).all(), f"state field {f} diverged"


def test_views_match_jax():
    """Anchors with and without the tombstone peek, cursors and visible
    lengths on states with tombstones and defined boundaries."""
    base, ops_rows, ranks = _patched_inputs(4)
    multi = allow_multiple_array()
    base, _ = JK.apply_ops_patched_batch(
        base, jnp.asarray(ops_rows), jnp.asarray(ranks), jnp.asarray(multi)
    )
    port = state_from_numpy({f: _np(getattr(base, f)) for f in FIELDS}, device="cpu")
    r = port.elem_ctr.shape[0]
    idx = np.tile(np.arange(-1, 90, dtype=np.int32), (r, 1))
    peeked = 0
    for peek in (False, True):
        ctr, act, found = (x.numpy() for x in K.visible_elem_ids(port, torch.from_numpy(idx), peek))
        want = [JK.visible_elem_ids_batch(index_state(base, i), jnp.asarray(idx[i]), jnp.bool_(peek))
                for i in range(r)]
        for i, (wc, wa, wf) in enumerate(want):
            assert (found[i] == _np(wf)).all()
            assert (ctr[i] == _np(wc)).all() and (act[i] == _np(wa)).all()
        peeked += int((ctr != K.visible_elem_ids(port, torch.from_numpy(idx))[0].numpy()).sum())
    assert peeked > 0, "no anchor moved under the peek: the check proves nothing"
    assert found.any() and not found.all()
    pick = torch.from_numpy(idx[:, 5].copy())
    c, a, f = K.cursor_elems(port, pick)
    wc, wa, wf = JK.cursor_elems_batch(base, jnp.asarray(idx[:, 5]))
    assert (c.numpy() == _np(wc)).all() and (a.numpy() == _np(wa)).all() and (f.numpy() == _np(wf)).all()
    tgt_c = port.elem_ctr[:, 3].clone()
    tgt_c[0] = 9999  # an id replica 0 does not hold
    tgt_a = port.elem_act[:, 3]
    got_i, got_f = K.resolve_cursor_indices(port, tgt_c, tgt_a)
    want_i, want_f = JK.resolve_cursor_indices_batch(base, jnp.asarray(tgt_c.numpy()), jnp.asarray(tgt_a.numpy()))
    assert (got_i.numpy() == _np(want_i)).all() and (got_f.numpy() == _np(want_f)).all()
    assert not got_f[0] and got_f[1:].all()
    lengths = K.visible_length(port)
    assert lengths.dtype == torch.int32
    assert [int(x) for x in lengths] == [int(JK.visible_length(index_state(base, i))) for i in range(r)]


# ---------------------------------------------------------------------------
# Universe level
# ---------------------------------------------------------------------------


@pytest.fixture
def pinned_cap(monkeypatch):
    """Pin the span cap: a pinned cap ignores both engines' process-wide
    floors, so their launch counts compare whatever ran before."""
    monkeypatch.setenv("PERITEXT_PATCH_SPAN_CAP", "8")
    monkeypatch.delenv("PERITEXT_PATCH_CHUNK", raising=False)
    monkeypatch.delenv("PERITEXT_PATCH_READBACK", raising=False)


def _oracle_stream(stream, actor="observer"):
    oracle = Doc(actor)
    patches = [p for change in stream for p in oracle.apply_change(change)]
    return patches, oracle


def _three_engines(batches, names=("observer",), with_positions=False, **sizes):
    """Run ``batches`` (a list of per-replica dicts, ingested in order)
    through TpuUniverse's scan and default patch paths and through the
    port; the port must equal the scan path in streams, states and stats,
    and the default path in streams and spans.  Returns the port's
    streams, one list per batch, and the port universe."""
    outs = []
    unis = []
    for mode in ("scan", None):
        with patch_path_env(mode):
            tpu = TpuUniverse(list(names), **sizes)
            outs.append([tpu.apply_changes_with_patches(b, with_positions=with_positions)
                         for b in batches])
            unis.append(tpu)
    port = TorchUniverse(list(names), device="cpu", **sizes)
    got = [port.apply_changes_with_patches(b, with_positions=with_positions) for b in batches]
    assert got == outs[0], "stream differs from TpuUniverse's scan path"
    assert got == outs[1], "stream differs from TpuUniverse's default path"
    scan, default = unis
    ref = jax.device_get(scan.states)
    now = state_to_numpy(port.states)
    for f in FIELDS:
        assert (now[f] == np.asarray(getattr(ref, f))).all(), f"state field {f} diverged"
    for k in STATS:
        assert port.stats[k] == scan.stats[k], k
    assert port.stats["readback_overflows"] == scan.stats.get("readback_overflows", 0)
    assert port.spans_batch() == scan.spans_batch() == default.spans_batch()
    assert port.clocks == scan.clocks
    return got, port


def _check_against_oracle(stream, **sizes):
    want, oracle = _oracle_stream(stream)
    (got,), port = _three_engines([{"observer": stream}], **sizes)
    assert got["observer"] == want
    spans = oracle.get_text_with_formatting(["text"])
    assert accumulate_patches(got["observer"]) == spans
    assert port.spans("observer") == spans


def _scenario_stream(initial_text="The Peritext editor", pre_ops=None, input_ops1=(), input_ops2=()):
    """The concurrent-write harness of tests/test_engine_patches.py: the
    full stream a fresh observer ingests."""
    docs, _, initial_change = generate_docs(initial_text)
    doc1, doc2 = docs

    def with_path(ops):
        return [{**op, "path": ["text"]} for op in ops]

    stream = [initial_change]
    if pre_ops:
        change0, _ = doc1.change(with_path(pre_ops))
        doc2.apply_change(change0)
        stream.append(change0)
    change1, _ = doc1.change(with_path(input_ops1))
    change2, _ = doc2.change(with_path(input_ops2))
    doc2.apply_change(change1)
    doc1.apply_change(change2)
    return stream + [change1, change2]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_patches_match_tpu_universe_and_oracle(pinned_cap, name):
    _check_against_oracle(_scenario_stream(**SCENARIOS[name]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_unsynced_writers_patches(pinned_cap, seed):
    """Writers that never sync: the observer's delivery interleaves
    causally independent changes (tests/test_engine_patches.py)."""
    rng = random.Random(seed + 100)
    docs, _, initial_change = generate_docs("ABCDEFG", 3)
    stream = [initial_change]
    for _ in range(15):
        doc = docs[rng.randrange(3)]
        kind = rng.choice(["insert", "remove", "addMark"])
        if kind == "insert":
            op = _random_insert(rng, doc, 3)
        elif kind == "remove":
            op = _random_delete(rng, doc)
        else:
            op = _random_add_mark(rng, doc, [])
        if op is not None:
            stream.append(doc.change([op])[0])
    _check_against_oracle(stream)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_differential_patches(pinned_cap, seed):
    rng = random.Random(seed)
    docs, _, initial_change = generate_docs("ABCDE", 2)
    stream = [initial_change]
    comments = []
    for _ in range(30):
        doc = docs[rng.randrange(2)]
        kind = rng.choice(["insert", "remove", "addMark", "removeMark"])
        if kind == "insert":
            op = _random_insert(rng, doc, 3)
        elif kind == "remove":
            op = _random_delete(rng, doc)
        elif kind == "addMark":
            op = _random_add_mark(rng, doc, comments)
        else:
            op = _random_remove_mark(rng, doc, comments, False)
        if op is None:
            continue
        change, _ = doc.change([op])
        stream.append(change)
        docs[1 - docs.index(doc)].apply_change(change)
    _check_against_oracle(stream)


def test_multichar_delete_splits_into_single_char_patches(pinned_cap):
    docs, _, initial_change = generate_docs()
    change, _ = docs[0].change([{"path": ["text"], "action": "delete", "index": 5, "count": 2}])
    (got,), _ = _three_engines([{"observer": [initial_change, change]}])
    assert got["observer"][-2:] == [
        {"path": ["text"], "action": "delete", "index": 5, "count": 1},
    ] * 2
    _check_against_oracle([initial_change, change])


def _mixed_stream():
    """Host-object ops (a root list and a map key) between text ops inside
    one change, so host and device patches interleave by position."""
    author = Doc("a")
    genesis, _ = author.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("hi there")},
    ])
    mixed, _ = author.change([
        {"path": ["text"], "action": "insert", "index": 2, "values": ["?"]},
        {"path": [], "action": "makeList", "key": "z"},
        {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 4, "markType": "em"},
        {"path": [], "action": "set", "key": "title", "value": "T"},
        {"path": ["z"], "action": "insert", "index": 0, "values": ["q"]},
        {"path": ["text"], "action": "delete", "index": 0, "count": 1},
    ])
    return [genesis, mixed]


def test_host_and_device_patches_interleave_by_position(pinned_cap):
    stream = _mixed_stream()
    want, _ = _oracle_stream(stream)
    got, port = _three_engines([{"observer": [c]} for c in stream])
    assert [p for batch in got for p in batch["observer"]] == want
    assert any("key" in p for p in want[len(want) // 2:])


def test_positions_pair_every_patch_with_its_op(pinned_cap):
    stream = _mixed_stream()
    (pairs,), _ = _three_engines([{"observer": stream}], with_positions=True)
    pairs = pairs["observer"]
    want, _ = _oracle_stream(stream)
    assert [p for _, p in pairs] == want
    positions = [pos for pos, _ in pairs]
    assert positions == sorted(positions)
    n_ops = sum(len(c["ops"]) for c in stream)
    assert set(positions) <= set(range(n_ops)) and len(set(positions)) > n_ops // 2


def _wide_mark_stream():
    """Marks whose patch count exceeds a span cap of 1: alternating bold
    chars, then one em op over all of them."""
    docs, _, genesis = generate_docs("abcdefghijkl", 1)
    doc = docs[0]
    stream = [genesis]
    for i in range(0, 12, 2):
        stream.append(doc.change([{"path": ["text"], "action": "addMark", "startIndex": i,
                                   "endIndex": i + 1, "markType": "strong"}])[0])
    stream.append(doc.change([{"path": ["text"], "action": "removeMark", "startIndex": 0,
                               "endIndex": 12, "markType": "strong"}])[0])
    return stream


def test_span_cap_overflow_reads_planes(monkeypatch):
    monkeypatch.setenv("PERITEXT_PATCH_SPAN_CAP", "1")
    stream = _wide_mark_stream()
    want, _ = _oracle_stream(stream)
    (got,), port = _three_engines([{"observer": stream}])
    assert got["observer"] == want
    assert port.stats["readback_overflows"] >= 1
    assert port._span_cap > 1
    monkeypatch.setenv("PERITEXT_PATCH_READBACK", "planes")
    (planes,), _ = _three_engines([{"observer": stream}])
    assert planes == got


def test_chunked_patch_path_matches_unchunked(monkeypatch):
    """PERITEXT_PATCH_CHUNK=3 over 7 replicas: chunks of 3, 3 and an
    uneven tail of 1; streams and states equal the unchunked run's."""
    monkeypatch.setenv("PERITEXT_PATCH_SPAN_CAP", "8")
    docs, _, genesis = generate_docs("chunked patches", count=3)
    d1, d2, _ = docs
    c1, _ = d1.change([
        {"path": ["text"], "action": "insert", "index": 0, "values": list("xy")},
        {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 6, "markType": "strong"},
    ])
    c2, _ = d2.change([{"path": ["text"], "action": "delete", "index": 3, "count": 2}])
    names = list("abcdefg")
    batches = [
        {n: [genesis] for n in names},
        {"a": [c1, c2], "b": [c2, c1], "c": [c1], "d": [c2], "e": [], "f": [c1, c2], "g": [c2]},
    ]
    monkeypatch.delenv("PERITEXT_PATCH_CHUNK", raising=False)
    whole, port_whole = _three_engines(batches, names=names)
    monkeypatch.setenv("PERITEXT_PATCH_CHUNK", "3")
    assert TorchUniverse._patch_chunk(7) == 3
    chunked, port_chunked = _three_engines(batches, names=names)
    assert chunked == whole
    assert port_chunked.stats["launches"] == 2 * 3 and port_whole.stats["launches"] == 2
    a, b = state_to_numpy(port_whole.states), state_to_numpy(port_chunked.states)
    assert all((a[f] == b[f]).all() for f in FIELDS)


def test_cursors_match_tpu_universe(pinned_cap):
    docs, _, genesis = generate_docs("cursor text", count=2)
    d1, d2 = docs
    c1, _ = d1.change([{"path": ["text"], "action": "insert", "index": 3, "values": list("AB")}])
    c2, _ = d2.change([{"path": ["text"], "action": "delete", "index": 0, "count": 2}])
    names = ["a", "b", "c"]
    batches = [{n: [genesis] for n in names}]
    tpu = TpuUniverse(names)
    port = TorchUniverse(names, device="cpu")
    for uni in (tpu, port):
        uni.apply_changes_with_patches(batches[0])
    indices = [0, 5, 10]
    curs = port.get_cursors(indices)
    assert curs == tpu.get_cursors(indices)
    assert [port.get_cursor(r, i) for r, i in enumerate(indices)] == curs
    later = {"a": [c1], "b": [c2], "c": [c1, c2]}
    for uni in (tpu, port):
        uni.apply_changes_with_patches(later)
    # The deleted target of replica b resolves to where it was.
    assert port.resolve_cursors(curs) == tpu.resolve_cursors(curs)
    assert [port.resolve_cursor(r, c) for r, c in enumerate(curs)] == port.resolve_cursors(curs)
    assert port.clock("c") == tpu.clock("c")
    with pytest.raises(IndexError):
        port.get_cursor("a", 99)
    with pytest.raises(IndexError):
        port.get_cursors([0, 0, 99])
    with pytest.raises(KeyError):
        port.resolve_cursor("a", {"objectId": curs[0]["objectId"], "elemId": "5@nobody"})
    with pytest.raises(KeyError):
        port.resolve_cursors([{"objectId": curs[0]["objectId"], "elemId": "999@doc1"}] * 3)
