"""Concurrent writer rounds in the op mix of Peritext's ``test/fuzz.ts``.

Frozen copies, at commit bdca3bf, of ``peritext_tpu_torch/fuzz.py``'s
``MARK_TYPES``, ``EXAMPLE_URLS``, ``_text_len``, ``_random_add_mark``,
``_random_insert`` and ``_random_delete`` and of
``peritext_tpu_torch/bench/workloads.py``'s ``_writer_changes``,
``_genesis``, ``make_writer_rounds`` and ``split_rounds``, authored on the
reference's ``Doc``.  One change from the originals: ``prefix`` goes before
every actor id, so that several documents in one universe have actors of
their own.  The same seed gives the same changes.
"""
from __future__ import annotations

import copy
import math
import random
from typing import Any, Dict, List, Optional

from portbench.reference.doc import Doc

MARK_TYPES = ["strong", "em", "link", "comment"]
EXAMPLE_URLS = [f"{c}.com" for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"]


def _text_len(doc: Doc) -> int:
    t = doc.root.get("text")
    if isinstance(t, list):
        return len(t)
    return sum(len(s["text"]) for s in doc.get_text_with_formatting(["text"]))


def _random_add_mark(rng: random.Random, doc: Doc, comment_history: List[str]) -> Dict[str, Any]:
    length = _text_len(doc)
    start = rng.randrange(length)
    end = start + rng.randrange(length - start) + 1
    mark_type = rng.choice(MARK_TYPES)
    op: Dict[str, Any] = {"path": ["text"], "action": "addMark", "startIndex": start, "endIndex": end,
                          "markType": mark_type}
    if mark_type == "link":
        op["attrs"] = {"url": rng.choice(EXAMPLE_URLS)}
    elif mark_type == "comment":
        comment_id = f"comment-{rng.randrange(1 << 16):04x}"
        comment_history.append(comment_id)
        op["attrs"] = {"id": comment_id}
    return op


def _random_insert(rng: random.Random, doc: Doc, max_chars: int) -> Optional[Dict[str, Any]]:
    length = _text_len(doc)
    index = rng.randrange(length) if length else 0
    num = rng.randrange(max_chars)
    values = [rng.choice("0123456789abcdef") for _ in range(num)]
    return {"path": ["text"], "action": "insert", "index": index, "values": values}


def _random_delete(rng: random.Random, doc: Doc) -> Optional[Dict[str, Any]]:
    length = _text_len(doc)
    index = rng.randrange(length) + 1
    count = math.ceil(rng.random() * (length - index))
    if count <= 0:
        return None
    return {"path": ["text"], "action": "delete", "index": index, "count": count}


def _writer_changes(rng: random.Random, writer: Doc, op_budget: int, with_marks: bool) -> List[Dict[str, Any]]:
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


def _genesis(rng: random.Random, doc_len: int, prefix: str = "") -> Dict[str, Any]:
    base = Doc(f"{prefix}base")
    text = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(doc_len))
    genesis, _ = base.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list(text)},
    ])
    return genesis


def make_writer_rounds(doc_len: int, ops_per_round: int, num_writers: int, rounds: int,
                       with_marks: bool = True, seed: int = 0, prefix: str = "") -> Dict[str, Any]:
    """Chained rounds: each round, each writer makes ``ops_per_round``
    concurrent ops on its own copy (writers never see each other).  Returns
    ``genesis`` and ``rounds`` ([round][writer] -> changes)."""
    rng = random.Random(seed)
    genesis = _genesis(rng, doc_len, prefix)
    first = Doc(f"{prefix}writer0")
    first.apply_change(genesis)
    writers = [first]
    for s in range(1, num_writers):
        w = copy.deepcopy(first)
        w.actor_id = f"{prefix}writer{s}"
        writers.append(w)
    per_round = [[_writer_changes(rng, w, ops_per_round, with_marks) for w in writers] for _ in range(rounds)]
    return {"genesis": genesis, "rounds": per_round}


def split_rounds(rounds: List[List[List[Dict[str, Any]]]], ops_per_change: int) -> List[List[List[Dict[str, Any]]]]:
    """``rounds`` with each writer's ops re-cut into changes of
    ``ops_per_change`` internal ops (the last of a round may be shorter),
    numbered on from one round to the next.  The ops, their ids and their
    order are unchanged."""
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
