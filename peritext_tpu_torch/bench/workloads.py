"""Merge workloads for the port, generated with the port's own oracle.

``make_merge_workload`` is a copy of the JAX package's
(``peritext_tpu/bench/workloads.py``) over the op generators of the port's
``fuzz`` module: the same seed gives the same changes.  ``make_writer_rounds`` extends the
same generator to chained rounds, ``build_device_batch`` encodes a
workload into the stacked device batch the merge kernels take, and
``doc_session`` drives live document replicas through random edits, each
held against an oracle twin.  ``WireAuthor`` and ``wire_rounds`` write
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
from peritext_tpu_torch.ops.state import make_empty_state, map_state
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
    [R, B], ``mark_ops`` [R, Lm, F] and ``ranks`` [A] on ``device``."""
    actors = ActorRegistry()
    attrs = AttrRegistry()
    genesis_rows, _, _ = encode_changes([workload["genesis"]], actors, attrs)
    text_obj = workload["genesis"]["ops"][0]["opId"]  # the makeList op
    text_streams, mark_streams = [], []
    for stream in workload["streams"]:
        rows, _, _ = encode_changes(stream, actors, attrs, text_obj=text_obj)
        t, m = split_rows(rows)
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
