"""Merge workloads for the port, generated with the port's own oracle.

``make_merge_workload`` is a copy of the JAX package's
(``peritext_tpu/bench/workloads.py``) over the op generators of the port's
``fuzz`` module: the same seed gives the same changes.  ``make_writer_rounds`` extends the
same generator to chained rounds, ``build_device_batch`` encodes a
workload into the stacked device batch the merge kernels take, and
``doc_session`` drives live document replicas through random edits, each
held against an oracle twin.  ``slice_edge_batch`` makes random states and
op rows aimed at the slice edges of the kernels' cluster form, and
``resident_text_batch`` the text batches of a resident 10,000-char fleet's
merges (genesis, a round, the all-to-all) at their row counts.  ``WireAuthor`` and ``wire_rounds`` write
changes out in wire format with named element ids, for documents too long
for the oracle's O(n) index walks to author quickly (past 16k chars).
"""
from __future__ import annotations

import copy
import random
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from peritext_tpu_torch.fuzz import _random_add_mark, _random_delete, _random_insert, _text_len
from peritext_tpu_torch.ids import ActorRegistry
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.encode import (
    AttrRegistry,
    bucket_length,
    encode_changes,
    fuse_insert_runs,
    pad_buffer,
    pad_rows,
    split_rows,
)
from peritext_tpu_torch.ops.state import make_empty_state, map_state, state_from_numpy
from peritext_tpu_torch.oracle import Doc, accumulate_patches

def _writer_changes(
    rng: random.Random, writer: Doc, op_budget: int, with_marks: bool
) -> List[Dict[str, Any]]:
    """One writer's concurrent changes worth ``op_budget`` internal ops."""
    changes: List[Dict[str, Any]] = []
    while op_budget > 0:
        kinds = ["insert", "remove"] + (["addMark"] if with_marks else [])
        kind = rng.choice(kinds)
        if kind == "insert":
            op = _random_insert(rng, writer, 4)
        elif kind == "remove":
            op = _random_delete(rng, writer)
        else:
            op = _random_add_mark(rng, writer, [])
        if op is None:
            continue
        if op["action"] == "insert":
            cost = len(op["values"])
            if cost == 0:
                continue
        elif op["action"] == "delete":
            cost = op["count"]
        else:
            cost = 1
        cost = min(cost, op_budget)
        if op["action"] == "insert":
            op["values"] = op["values"][:cost]
        elif op["action"] == "delete":
            op["count"] = cost
        change, _ = writer.change([op])
        changes.append(change)
        op_budget -= cost
    return changes


def _local_op(rng: random.Random, writer: Doc, kind: str, hot: int, width: int) -> Optional[Dict[str, Any]]:
    """One op with every index confined to the [hot, hot+width) hotspot —
    the editor-caret locality pattern (a copy of the JAX package's
    ``bench/workloads._local_op``)."""
    length = _text_len(writer)
    if length == 0:
        return None
    lo = min(hot, length - 1)
    hi = min(hot + width, length)
    if kind == "insert":
        idx = lo + rng.randrange(max(1, hi - lo))
        values = [rng.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(rng.randrange(1, 7))]
        return {"path": ["text"], "action": "insert", "index": min(idx, length), "values": values}
    if kind == "remove":
        if hi <= lo:
            return None
        return {"path": ["text"], "action": "delete", "index": lo + rng.randrange(hi - lo), "count": 1}
    start = lo + rng.randrange(max(1, hi - lo))
    end = min(start + rng.randrange(1, max(2, width // 4)), length)
    if end <= start:
        return None
    return {"path": ["text"], "action": "addMark", "startIndex": start, "endIndex": end,
            "markType": rng.choice(["strong", "em"])}


def _local_writer_changes(
    rng: random.Random, writer: Doc, op_budget: int, with_marks: bool, locality: int
) -> List[Dict[str, Any]]:
    """One writer's changes worth at least ``op_budget`` internal ops, every
    index inside one ``locality``-char hotspot drawn for the stream (the
    op mix and hotspot rule of the JAX package's ``_make_patched_stream``
    with ``locality``)."""
    kinds = ["insert", "insert", "remove"] + (["addMark"] if with_marks else [])
    hot = rng.randrange(max(1, _text_len(writer) - locality))
    changes: List[Dict[str, Any]] = []
    n_ops = 0
    while n_ops < op_budget:
        op = _local_op(rng, writer, rng.choice(kinds), hot, locality)
        if op is None:
            continue
        change, _ = writer.change([op])
        n_ops += len(change["ops"])
        changes.append(change)
    return changes


def _genesis(rng: random.Random, doc_len: int) -> Dict[str, Any]:
    base = Doc("base")
    text = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(doc_len))
    genesis, _ = base.change(
        [
            {"path": [], "action": "makeList", "key": "text"},
            {"path": ["text"], "action": "insert", "index": 0, "values": list(text)},
        ]
    )
    return genesis


def make_merge_workload(
    doc_len: int = 1000,
    ops_per_merge: int = 64,
    num_streams: int = 4,
    with_marks: bool = True,
    seed: int = 0,
) -> Dict[str, Any]:
    """A genesis change building a ``doc_len``-char doc, plus
    ``num_streams`` concurrent change streams of ``ops_per_merge`` internal
    ops each, written by oracle replicas (the JAX package's benchmark
    workload, change for change)."""
    rng = random.Random(seed)
    genesis = _genesis(rng, doc_len)
    streams: List[List[Dict[str, Any]]] = []
    for s in range(num_streams):
        writer = Doc(f"writer{s}")
        writer.apply_change(genesis)
        streams.append(_writer_changes(rng, writer, ops_per_merge, with_marks))
    return {"genesis": genesis, "streams": streams}


def make_writer_rounds(
    doc_len: int = 1000,
    ops_per_round: int = 64,
    num_writers: int = 4,
    rounds: int = 8,
    with_marks: bool = True,
    seed: int = 0,
    locality: int = 0,
) -> Dict[str, Any]:
    """Chained rounds: each round, each writer makes ``ops_per_round``
    concurrent ops on its own copy (writers never see each other).
    ``locality`` > 0 keeps each writer's indices in one hotspot of that
    many chars per round (``_local_writer_changes``), where the
    frontier-bounded window engages.  Returns ``genesis``, ``rounds``
    ([round][writer] -> changes) and the ``writers``' oracle docs."""
    rng = random.Random(seed)
    genesis = _genesis(rng, doc_len)
    # Only the actor id tells writers apart after the genesis, so one doc
    # applies it (an O(n^2) integration in the oracle) and the rest copy it.
    first = Doc("writer0")
    first.apply_change(genesis)
    writers = [first]
    for s in range(1, num_writers):
        w = copy.deepcopy(first)
        w.actor_id = f"writer{s}"
        writers.append(w)

    def stream(w: Doc) -> List[Dict[str, Any]]:
        if locality:
            return _local_writer_changes(rng, w, ops_per_round, with_marks, locality)
        return _writer_changes(rng, w, ops_per_round, with_marks)

    per_round = [[stream(w) for w in writers] for _ in range(rounds)]
    return {"genesis": genesis, "rounds": per_round, "writers": writers}


class WireAuthor:
    """One actor's changes written out in wire format: each op names the
    element ids it references, so no document is consulted.  ``saw``
    records a peer's change (its clock and counter advance)."""

    def __init__(self, actor: str):
        self.actor, self.seq, self.max_op, self.clock = actor, 0, 0, {}

    def change(self, build) -> Dict[str, Any]:
        """A change whose ops ``build(new_id)`` returns, ``new_id()`` giving
        each op its id in turn."""
        self.seq += 1
        start = self.max_op + 1
        ops = build(self._new_id)
        change = {"actor": self.actor, "seq": self.seq, "deps": dict(self.clock),
                  "startOp": start, "ops": ops}
        self.clock[self.actor] = self.seq
        return change

    def _new_id(self) -> str:
        self.max_op += 1
        return f"{self.max_op}@{self.actor}"

    def saw(self, change: Dict[str, Any]) -> None:
        self.clock[change["actor"]] = change["seq"]
        self.max_op = max(self.max_op, change["startOp"] + len(change["ops"]) - 1)


def wire_insert(text_obj: str, after: Optional[str], chars: str):
    """Ops inserting ``chars`` as a chain after element ``after`` (None:
    the head)."""
    def build(new_id):
        out, prev = [], after
        for ch in chars:
            op = {"opId": new_id(), "action": "set", "obj": text_obj, "insert": True, "value": ch}
            if prev is not None:
                op["elemId"] = prev
            out.append(op)
            prev = op["opId"]
        return out
    return build


def wire_rounds(doc_len: int, writers: int, rounds: int, run_chars: int, seed: int) -> Dict[str, Any]:
    """A ``doc_len``-character genesis by actor "genesis" and ``rounds``
    rounds of concurrent changes: in each, writer w inserts a run of
    ``run_chars`` characters after a random genesis character and adds a
    mark (strong, em or a comment) over a random genesis range.  A
    writer's changes depend on the genesis and its own earlier ones only.
    Returns ``genesis``, ``rounds`` ([round][writer] -> [change]) and
    ``text_obj``."""
    rng = random.Random(seed)
    text = "1@genesis"
    base = WireAuthor("genesis")
    body = "".join(rng.choice("abcdefghij klmnop") for _ in range(doc_len))
    genesis = base.change(lambda new_id: [{"opId": new_id(), "action": "makeList", "obj": None,
                                            "key": "text"}] + wire_insert(text, None, body)(new_id))
    authors = [WireAuthor(f"writer{w}") for w in range(writers)]
    for a in authors:
        a.saw(genesis)
    out = []
    for k in range(rounds):
        rnd = []
        for w, a in enumerate(authors):
            at = rng.randrange(doc_len)
            lo = rng.randrange(doc_len - 1)
            hi = rng.randrange(lo + 1, min(doc_len, lo + 400))
            mark_type = rng.choice(["strong", "em", "comment"])

            def build(new_id, at=at, lo=lo, hi=hi, mark_type=mark_type, w=w, k=k):
                ops = wire_insert(text, f"{at + 2}@genesis", "".join(
                    rng.choice("XYZ") for _ in range(run_chars)))(new_id)
                mark = {"opId": new_id(), "action": "addMark", "obj": text, "markType": mark_type,
                        "start": {"type": "before", "elemId": f"{lo + 2}@genesis"},
                        "end": {"type": "after", "elemId": f"{hi + 2}@genesis"}}
                if mark_type == "comment":
                    mark["attrs"] = {"id": f"c{w}-{k}"}
                return ops + [mark]

            rnd.append([a.change(build)])
        out.append(rnd)
    return {"genesis": genesis, "rounds": out, "text_obj": text}


def split_rounds(rounds: List[List[List[Dict[str, Any]]]], ops_per_change: int) -> List[List[List[Dict[str, Any]]]]:
    """``make_writer_rounds``' rounds with each writer's ops re-cut into
    changes of ``ops_per_change`` internal ops (the last of a round may be
    shorter), numbered on from one round to the next.  A writer sees only
    the genesis and its own changes, so each new change depends on the
    first change's other actors and on its writer's previous change; the
    ops, their ids and their order are unchanged, so an observer emits the
    same patches op for op."""
    out: List[List[List[Dict[str, Any]]]] = [[[] for _ in rnd] for rnd in rounds]
    for w in range(len(rounds[0])):
        seq = 0
        for k, rnd in enumerate(rounds):
            actor = rnd[w][0]["actor"]
            others = {a: s for a, s in rnd[w][0]["deps"].items() if a != actor}
            ops = [op for c in rnd[w] for op in c["ops"]]
            for i in range(0, len(ops), ops_per_change):
                chunk = ops[i : i + ops_per_change]
                deps = dict(others, **({actor: seq} if seq else {}))
                seq += 1
                start = int(chunk[0]["opId"].split("@", 1)[0])
                out[k][w].append({"actor": actor, "seq": seq, "deps": deps, "startOp": start, "ops": chunk})
    return out


def doc_session(
    docs: Sequence[Any],
    genesis: Dict[str, Any],
    edits: int,
    sync_every: int,
    seed: int,
    max_chars: int = 4,
) -> Dict[str, Any]:
    """Drive document replicas (``TorchDoc``, oracle ``Doc`` or any peer)
    through ``edits`` random single-op changes with marks, each by a random
    replica, syncing every replica to the full change log every
    ``sync_every`` edits and at the end.

    Each replica has an oracle twin with its actor id that sees the same
    operations: every ``change()`` must return the twin's change and
    patches, and every ``apply_change()`` the twin's patches.  At the end
    each replica's accumulated patch stream must equal its spans, and all
    replicas must agree.  Raises AssertionError on the first difference.
    Returns the wall milliseconds of each ``change()`` and
    ``apply_change()`` call (``change_ms``, ``apply_ms``), the index of the
    replica that made each (``change_by``, ``apply_by``) and the final
    spans."""
    rng = random.Random(seed)
    twins = [Doc(d.actor_id) for d in docs]
    streams: List[List[Dict[str, Any]]] = []
    for d, twin in zip(docs, twins):
        got = d.apply_change(genesis)
        if got != twin.apply_change(genesis):
            raise AssertionError(f"{d.actor_id}: genesis patches differ from the oracle's")
        streams.append(list(got))
    log = [genesis]
    change_ms: List[float] = []
    apply_ms: List[float] = []
    change_by: List[int] = []
    apply_by: List[int] = []

    def sync() -> None:
        for i, (d, twin) in enumerate(zip(docs, twins)):
            for c in log:
                if c["seq"] <= d.clock.get(c["actor"], 0):
                    continue
                t = time.perf_counter()
                got = d.apply_change(c)
                apply_ms.append(1e3 * (time.perf_counter() - t))
                apply_by.append(i)
                if got != twin.apply_change(c):
                    raise AssertionError(
                        f"{d.actor_id}: apply_change of {c['actor']}#{c['seq']} differs from the oracle's"
                    )
                streams[i] += got

    made = 0
    while made < edits:
        i = rng.randrange(len(docs))
        d = docs[i]
        kind = rng.choice(["insert", "delete", "mark"]) if _text_len(d) > 1 else "insert"
        if kind == "insert":
            op = _random_insert(rng, d, max_chars)
        elif kind == "delete":
            op = _random_delete(rng, d)
        else:
            op = _random_add_mark(rng, d, [])
        if op is None or (op["action"] == "insert" and not op["values"]):
            continue
        t = time.perf_counter()
        change, patches = d.change([op])
        change_ms.append(1e3 * (time.perf_counter() - t))
        change_by.append(i)
        if (change, patches) != twins[i].change([op]):
            raise AssertionError(f"{d.actor_id}: change {op['action']} differs from the oracle's")
        streams[i] += patches
        log.append(change)
        made += 1
        if made % sync_every == 0:
            sync()
    sync()
    spans = [d.get_text_with_formatting(["text"]) for d in docs]
    for d, stream, sp in zip(docs, streams, spans):
        if accumulate_patches(stream) != sp:
            raise AssertionError(f"{d.actor_id}: accumulated patches differ from its spans")
    if any(sp != spans[0] for sp in spans):
        raise AssertionError("the replicas did not converge")
    return {"change_ms": change_ms, "apply_ms": apply_ms, "change_by": change_by,
            "apply_by": apply_by, "spans": spans[0], "changes": len(log)}


def build_device_batch(
    workload: Dict[str, Any],
    num_replicas: int,
    capacity: int,
    max_mark_ops: int = 64,
    device: str | torch.device = "cpu",
) -> Dict[str, Any]:
    """Encode a ``make_merge_workload`` workload into a stacked batch:
    replica r holds the genesis document and gets stream r % S.  Text rows
    are fused into insert runs (at most MAX_RUN_LEN) with their char
    buffers, as the universe's exact path feeds the kernels.

    Returns ``states`` [R, ...], ``text_ops`` [R, L, F], ``char_buf``
    [R, B], ``mark_ops`` [R, Lm, F] and ``ranks`` [A] on ``device``, and
    ``stream_rows``, each stream's unfused text rows (numpy), as the sorted
    merge's ``prepare_sorted_batch`` takes them."""
    actors = ActorRegistry()
    attrs = AttrRegistry()
    genesis_rows, _, _ = encode_changes([workload["genesis"]], actors, attrs)
    text_obj = workload["genesis"]["ops"][0]["opId"]  # the makeList op
    stream_rows, text_streams, mark_streams = [], [], []
    for stream in workload["streams"]:
        rows, _, _ = encode_changes(stream, actors, attrs, text_obj=text_obj)
        t, m = split_rows(rows)
        stream_rows.append(t)
        text_streams.append(fuse_insert_runs(t)[:2])
        mark_streams.append(m)
    ranks_np = np.zeros(64, np.int32)
    rk = actors.ranks()
    ranks_np[: len(rk)] = rk
    ranks = torch.from_numpy(ranks_np).to(device)

    # The genesis document: one fused merge on a single replica, then tiled.
    g_text, g_marks = split_rows(genesis_rows)
    fr, fb, _ = fuse_insert_runs(g_text)
    single = map_state(lambda x: x.unsqueeze(0), make_empty_state(capacity, max_mark_ops, device))
    base = K.merge_step_plain(
        single,
        torch.from_numpy(fr[None]).to(device),
        torch.from_numpy(pad_rows(g_marks, max(g_marks.shape[0], 1))[None]).to(device),
        ranks,
        torch.from_numpy(pad_buffer(fb, max(fb.shape[0], K.MAX_RUN_LEN))[None]).to(device),
    )
    states = map_state(lambda x: x.expand(num_replicas, *x.shape[1:]).contiguous(), base)

    text_pad = max(max(t.shape[0] for t, _ in text_streams), 1)
    buf_pad = bucket_length(max(max(b.shape[0] for _, b in text_streams), K.MAX_RUN_LEN))
    mark_pad = max(max(m.shape[0] for m in mark_streams), 1)
    s = len(text_streams)
    pick = [r % s for r in range(num_replicas)]
    text_ops = np.stack([pad_rows(text_streams[i][0], text_pad) for i in pick])
    char_buf = np.stack([pad_buffer(text_streams[i][1], buf_pad) for i in pick])
    mark_ops = np.stack([pad_rows(mark_streams[i], mark_pad) for i in pick])
    return {
        "states": states,
        "text_ops": torch.from_numpy(text_ops).to(device),
        "char_buf": torch.from_numpy(char_buf).to(device),
        "mark_ops": torch.from_numpy(mark_ops).to(device),
        "ranks": ranks,
        "stream_rows": stream_rows,
    }


def insert_heavy_text_ops(rng: np.random.Generator, st, num_ops: int, buf_len: int):
    """Random text rows for the states ``st`` [R, C], mixed as
    ``tests/test_torch_cuda.py::_text_ops`` mixes them but drawn with numpy
    over all replicas at once: a quarter each of pads, inserts, deletes and
    runs of 1..MAX_RUN_LEN chars; the reference (or delete target) is HEAD
    (15%), an absent id (10%) or a live element.  Returns ``(text_ops [R,
    num_ops, OP_FIELDS], char_buf [R, buf_len])`` as CPU int32 tensors."""
    ec = st.elem_ctr.cpu().numpy()
    ea = st.elem_act.cpu().numpy()
    length = st.length.cpu().numpy()
    r, c = ec.shape
    ops = np.zeros((r, num_ops, K.OP_FIELDS), np.int32)
    kind = rng.choice([K.KIND_PAD, K.KIND_INSERT, K.KIND_DELETE, K.KIND_INSERT_RUN], size=(r, num_ops))
    ops[..., K.K_KIND] = kind
    ops[..., K.K_CTR] = rng.integers(1, 8 * c, size=(r, num_ops))
    ops[..., K.K_ACT] = rng.integers(0, 5, size=(r, num_ops))
    pick = (rng.random((r, num_ops)) * np.maximum(length, 1)[:, None]).astype(np.int64)
    ref_ctr = np.take_along_axis(ec, pick, 1)
    ref_act = np.take_along_axis(ea, pick, 1)
    u = rng.random((r, num_ops))
    head = (u < 0.15) | (length[:, None] == 0)
    absent = ~head & (u < 0.25)
    ops[..., K.K_REF_CTR] = np.where(head, 0, np.where(absent, 999999, ref_ctr))
    ops[..., K.K_REF_ACT] = np.where(head, 0, np.where(absent, 3, ref_act))
    run = kind == K.KIND_INSERT_RUN
    ops[..., K.K_RUN_LEN] = np.where(run, rng.integers(1, K.MAX_RUN_LEN + 1, size=(r, num_ops)), 0)
    ops[..., K.K_PAYLOAD] = np.where(
        run, rng.integers(0, buf_len + 20, size=(r, num_ops)), rng.integers(32, 127, size=(r, num_ops))
    )
    char_buf = rng.integers(32, 0x10FFFF, size=(r, buf_len)).astype(np.int32)
    return torch.from_numpy(ops), torch.from_numpy(char_buf)


def _near_edges(rng: np.random.Generator, length: np.ndarray, blocks: int, edge: int, shape) -> np.ndarray:
    """Positions [R, N]: 80% within MAX_RUN_LEN + 8 slots of a slice edge
    (70%) or of the document's end, the rest anywhere in it; -1 where the
    draw is not a live element."""
    r, n = shape
    near_edge = edge * rng.integers(1, max(blocks, 2), size=shape) if blocks > 1 else np.zeros(shape, np.int64)
    centre = np.where((rng.random(shape) < 0.7) & (blocks > 1), near_edge, length[:, None])
    near = centre + rng.integers(-(K.MAX_RUN_LEN + 8), 8, size=shape)
    anywhere = (rng.random(shape) * length[:, None]).astype(np.int64)
    pos = np.where(rng.random(shape) < 0.8, near, anywhere)
    return np.where((pos >= 0) & (pos < length[:, None]), pos, -1)


def slice_edge_batch(
    rng: np.random.Generator,
    replicas: int,
    capacity: int,
    max_mark_ops: int,
    blocks: int,
    text_rows: int = 64,
    mark_rows: int = 16,
    buf_len: int = 128,
    device: str | torch.device = "cpu",
) -> Dict[str, Any]:
    """Random replica states and op rows aimed at the slice edges of the
    kernels' cluster form (``blocks`` equal slices of ``capacity``).  Each
    document ends near an edge or near C; references, delete targets and
    mark anchors lie near an edge or the document's end (``_near_edges``),
    5% of references are absent; a quarter of the inserts carry small
    counters, so their skip runs cross edges; a third of the runs are
    MAX_RUN_LEN long; a quarter of the replicas start with M - 3 marks, so
    their tables overflow.  Returns what ``build_device_batch`` returns."""
    r, c = replicas, capacity
    edge = c // blocks
    ends = np.array([edge * k + d for k in range(1, blocks) for d in (-40, 0, 30)] + [c - 200, c - 20])
    length = ends[rng.integers(0, len(ends), size=r)].astype(np.int32)
    live = np.arange(c)[None, :] < length[:, None]
    ec = np.zeros((r, c), np.int32)
    for i in range(r):
        ec[i, : length[i]] = rng.permutation(4 * c)[: length[i]] + 1
    ea = np.where(live, rng.integers(0, 5, size=(r, c)), 0).astype(np.int32)
    words = max_mark_ops // 32
    table = np.zeros((r, max_mark_ops), np.int32)
    fields = {
        "elem_ctr": ec,
        "elem_act": ea,
        "deleted": (rng.random((r, c)) < 0.3) & live,
        "chars": np.where(live, rng.integers(32, 0x10FFFF, size=(r, c)), 0).astype(np.int32),
        "bnd_def": rng.random((r, 2 * c)) < 0.2,
        "bnd_mask": rng.integers(0, 2**32, size=(r, 2 * c, words), dtype=np.uint32),
        "mark_ctr": table, "mark_act": table, "mark_action": table, "mark_type": table, "mark_attr": table,
        "length": length,
        "mark_count": np.where(rng.random(r) < 0.25, max_mark_ops - 3, 0).astype(np.int32),
    }

    def refs(shape):
        pos = _near_edges(rng, length, blocks, edge, shape)
        at = np.clip(pos, 0, c - 1)
        ctr = np.where(pos >= 0, np.take_along_axis(ec, at, 1), 0)
        act = np.where(pos >= 0, np.take_along_axis(ea, at, 1), 0)
        absent = rng.random(shape) < 0.05
        return np.where(absent, 999_999, ctr), np.where(absent, 3, act)

    shape = (r, text_rows)
    text = np.zeros((r, text_rows, K.OP_FIELDS), np.int32)
    kind = rng.choice([K.KIND_PAD, K.KIND_INSERT, K.KIND_INSERT_RUN, K.KIND_DELETE, K.KIND_DELETE], size=shape)
    run = kind == K.KIND_INSERT_RUN
    text[..., K.K_KIND] = kind
    text[..., K.K_CTR] = np.where(rng.random(shape) < 0.25, rng.integers(1, 64, size=shape),
                                  rng.integers(4 * c, 8 * c, size=shape))
    text[..., K.K_ACT] = rng.integers(0, 5, size=shape)
    text[..., K.K_REF_CTR], text[..., K.K_REF_ACT] = refs(shape)
    text[..., K.K_RUN_LEN] = np.where(
        run, np.where(rng.random(shape) < 0.33, K.MAX_RUN_LEN, rng.integers(1, K.MAX_RUN_LEN, size=shape)), 0)
    text[..., K.K_PAYLOAD] = np.where(run, rng.integers(0, buf_len - K.MAX_RUN_LEN, size=shape),
                                      rng.integers(32, 127, size=shape))
    shape = (r, mark_rows)
    marks = np.zeros((r, mark_rows, K.OP_FIELDS), np.int32)
    marks[..., K.K_KIND] = np.where(rng.random(shape) < 0.85, K.KIND_MARK, K.KIND_PAD)
    marks[..., K.K_CTR] = rng.integers(1, 1000, size=shape)
    marks[..., K.K_ACT] = rng.integers(0, 5, size=shape)
    marks[..., K.K_SKIND] = rng.integers(0, 2, size=shape)
    marks[..., K.K_EKIND] = rng.integers(0, 3, size=shape)
    marks[..., K.K_SCTR], marks[..., K.K_SACT] = refs(shape)
    marks[..., K.K_ECTR], marks[..., K.K_EACT] = refs(shape)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {
        "states": state_from_numpy(fields, device=device),
        "text_ops": to(text),
        "char_buf": to(rng.integers(32, 0x10FFFF, size=(r, buf_len)).astype(np.int32)),
        "mark_ops": to(marks),
        "ranks": to(rng.permutation(64).astype(np.int32)),
    }


def text_row_mix(text_ops: torch.Tensor, char_buf: Optional[torch.Tensor]) -> str:
    """A batch's text rows per replica, each count as min-max over replicas:
    deletes, inserts, runs (no-ops without a ``char_buf``), chars inserted,
    and the most rows any replica has."""
    kind = text_ops[:, :, K.K_KIND]
    runs = (kind == K.KIND_INSERT_RUN) if char_buf is not None else torch.zeros_like(kind, dtype=torch.bool)
    inserts = kind == K.KIND_INSERT
    chars = inserts.sum(1) + torch.where(runs, text_ops[:, :, K.K_RUN_LEN], 0).sum(1)
    rows = (kind != K.KIND_PAD).sum(1)

    def span(x):
        return f"{int(x.min().item())}-{int(x.max().item())}"

    return (f"deletes {span((kind == K.KIND_DELETE).sum(1))}, inserts {span(inserts.sum(1))}, "
            f"runs {span(runs.sum(1))}, chars inserted {span(chars)} per replica; "
            f"most rows in a replica {int(rows.max().item())} of {text_ops.shape[1]}")


# The text rows of a resident 10,000-char fleet's three merges at C = 16384
# (a wire-format genesis, rounds of 4 writers' 64 ops, the all-to-all),
# counted per replica: insert rows, run rows, delete rows, of L rows.
RESIDENT_TEXT_SHAPES = {
    "genesis": {"num_ops": 256, "inserts": 0, "runs": 157, "deletes": 0},
    "round": {"num_ops": 64, "inserts": 4, "runs": 5, "deletes": 42},
    "all_to_all": {"num_ops": 512, "inserts": 7, "runs": 23, "deletes": 259},
}


def document_planes(rng: np.random.Generator, replicas: int, capacity: int, doc_len: int):
    """``replicas`` replicas of a ``doc_len``-char document: unique ids
    (counters below 4 doc_len + 1, actors 0-3), a twentieth tombstoned,
    random chars; slots past it zero.  Returns numpy ``(elem_ctr, elem_act,
    deleted, chars, length)``."""
    r, c, n = replicas, capacity, doc_len
    ec, ea = np.zeros((r, c), np.int32), np.zeros((r, c), np.int32)
    deleted, chars = np.zeros((r, c), bool), np.zeros((r, c), np.int32)
    for i in range(r):
        ec[i, :n] = rng.permutation(np.arange(1, 4 * n + 1))[:n]
        ea[i, :n] = rng.integers(0, 4, n)
        deleted[i, :n] = rng.random(n) < 0.05
        chars[i, :n] = rng.integers(32, 0x10FFFF, n)
    return ec, ea, deleted, chars, np.full(r, n, np.int32)


def genesis_text_rows(rng: np.random.Generator, replicas: int, num_ops: int, chars: int) -> np.ndarray:
    """A genesis as the wire format encodes it: runs of up to MAX_RUN_LEN
    chars appended one after another to an empty document, the first after
    HEAD and each after the last char of the one before, then pads."""
    ops = np.zeros((replicas, num_ops, K.OP_FIELDS), np.int32)
    fields = [K.K_KIND, K.K_CTR, K.K_ACT, K.K_REF_CTR, K.K_REF_ACT, K.K_PAYLOAD, K.K_RUN_LEN]
    for i in range(replicas):
        ctr, act, prev, left, l = 1, int(rng.integers(0, 4)), (0, 0), chars, 0
        while left > 0:
            k = min(K.MAX_RUN_LEN, left)
            ops[i, l, fields] = (K.KIND_INSERT_RUN, ctr, act, prev[0], prev[1], int(rng.integers(0, 64)), k)
            prev, ctr, left, l = (ctr + k - 1, act), ctr + k, left - k, l + 1
    return ops


def round_text_rows(rng: np.random.Generator, ec: np.ndarray, ea: np.ndarray, length: np.ndarray,
                    num_ops: int, inserts: int, runs: int, deletes: int) -> np.ndarray:
    """Text rows of a round or an all-to-all over the planes ``ec``/``ea``
    [R, C] (``length`` >= 1): ``inserts`` single inserts, ``runs`` runs of
    1..MAX_RUN_LEN chars and ``deletes`` deletes shuffled among pads.  A
    reference is a live element, an element the batch inserts earlier,
    HEAD, an absent id, or an earlier insert's reference at a lower
    counter, so the RGA skip rule walks past that insert's elements.  A
    delete target is a live element, an element the batch inserts earlier
    or later, or an absent id."""
    r = ec.shape[0]
    ops = np.zeros((r, num_ops, K.OP_FIELDS), np.int32)
    for i in range(r):
        kinds = ([K.KIND_INSERT] * inserts + [K.KIND_INSERT_RUN] * runs + [K.KIND_DELETE] * deletes
                 + [K.KIND_PAD] * (num_ops - inserts - runs - deletes))
        kinds = [kinds[j] for j in rng.permutation(num_ops)]
        ins = [l for l, kd in enumerate(kinds) if kd in (K.KIND_INSERT, K.KIND_INSERT_RUN)]
        for l in ins:
            run = kinds[l] == K.KIND_INSERT_RUN
            ops[i, l, [K.K_KIND, K.K_CTR, K.K_ACT]] = (kinds[l], 200000 + 100 * l, rng.integers(0, 4))
            ops[i, l, K.K_RUN_LEN] = rng.integers(1, K.MAX_RUN_LEN + 1) if run else 0
            ops[i, l, K.K_PAYLOAD] = rng.integers(0, 200) if run else rng.integers(32, 127)

        def element(before: int):
            u = rng.random()
            earlier = [l for l in ins if l < before]
            if u < 0.3 and earlier:
                l = earlier[rng.integers(0, len(earlier))]
                return ops[i, l, K.K_CTR] + rng.integers(0, max(ops[i, l, K.K_RUN_LEN], 1)), ops[i, l, K.K_ACT]
            if u < 0.35:
                return 999999, 3
            j = int(rng.integers(0, length[i]))
            return ec[i, j], ea[i, j]

        for n_ins, l in enumerate(ins):
            u = rng.random()
            if u < 0.1:
                ref = (0, 0)
            elif u < 0.25 and n_ins > 0:  # an earlier insert's place, at a lower counter
                e = ins[rng.integers(0, n_ins)]
                ref = (ops[i, e, K.K_REF_CTR], ops[i, e, K.K_REF_ACT])
                ops[i, l, K.K_CTR] = ops[i, e, K.K_CTR] - 50
            else:
                ref = element(l)
            ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = ref
        for l in (l for l, kd in enumerate(kinds) if kd == K.KIND_DELETE):
            later = [e for e in ins if e > l]
            if later and rng.random() < 0.1:
                e = later[rng.integers(0, len(later))]
                tgt = (ops[i, e, K.K_CTR], ops[i, e, K.K_ACT])
            else:
                tgt = element(l)
            ops[i, l, K.K_KIND] = K.KIND_DELETE
            ops[i, l, K.K_REF_CTR], ops[i, l, K.K_REF_ACT] = tgt
    return ops


def resident_text_batch(shape: str, replicas: int, seed: int, capacity: int = 16384,
                        doc_len: int = 10000, buf_len: int = 256) -> Dict[str, torch.Tensor]:
    """One of ``RESIDENT_TEXT_SHAPES``' text batches on ``replicas``
    replicas: the genesis on empty planes, a round or the all-to-all on a
    ``doc_len``-char document.  CPU tensors ``elem_ctr``, ``elem_act``,
    ``deleted``, ``chars``, ``length``, ``text_ops``, ``ranks`` [8] and
    ``char_buf`` [R, buf_len], in ``text_phase``'s argument order."""
    rng = np.random.default_rng(seed)
    counts = RESIDENT_TEXT_SHAPES[shape]
    if shape == "genesis":
        empty = np.zeros((replicas, capacity), np.int32)
        planes = (empty, empty, empty.astype(bool), empty, np.zeros(replicas, np.int32))
        ops = genesis_text_rows(rng, replicas, counts["num_ops"], doc_len)
    else:
        planes = document_planes(rng, replicas, capacity, doc_len)
        ops = round_text_rows(rng, planes[0], planes[1], planes[4], counts["num_ops"],
                              counts["inserts"], counts["runs"], counts["deletes"])
    names = ("elem_ctr", "elem_act", "deleted", "chars", "length", "text_ops")
    out = {name: torch.from_numpy(x) for name, x in zip(names, (*planes, ops))}
    out["ranks"] = torch.from_numpy(rng.permutation(8).astype(np.int32))
    out["char_buf"] = torch.from_numpy(rng.integers(32, 0x10FFFF, (replicas, buf_len)).astype(np.int32))
    return out
