"""Long documents and their concurrent writer rounds, written out in wire
format with named element ids, so that no document is replayed to author
them (a 10,000-char genesis takes the reference seconds to integrate).

``WireAuthor`` and ``wire_insert`` are frozen copies, at commit bdca3bf, of
``peritext_tpu_torch/bench/workloads.py``'s.  ``wire_fuzz_rounds`` writes
the growth profile of ``peritext_tpu_torch/fuzz.py`` at commit bdca3bf
(``_random_growth_insert``: 1-4 characters, a paste of 100-399 one time in
20; ``_random_bounded_delete``: 1-20 characters) beside
``fuzzmix._random_add_mark``'s marks (strong, em, link, comment), each
change one input op and a round worth ``ops_per_round`` internal ops, as
``fuzzmix._writer_changes`` budgets them.  Editor-sized deletes keep a long
document at its length; the reference fuzzer's deletes of a random share
of the tail would spend a round's budget on one delete.  Ops are written
against each writer's list of visible element ids: an insert references
the character before it (or the head), a delete names each element, and
a mark anchors as the reference's ``change_mark`` anchors it.  The same
seed gives the same changes.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

from portbench.gen.fuzzmix import EXAMPLE_URLS, MARK_TYPES
from portbench.reference.schema import MARK_SPEC


class WireAuthor:
    """One actor's changes in wire format: each op names the element ids it
    references.  ``saw`` records a peer's change."""

    def __init__(self, actor: str):
        self.actor, self.seq, self.max_op, self.clock = actor, 0, 0, {}

    def change(self, build: Callable[[Callable[[], str]], List[Dict[str, Any]]]) -> Dict[str, Any]:
        self.seq += 1
        start = self.max_op + 1
        ops = build(self._new_id)
        change = {"actor": self.actor, "seq": self.seq, "deps": dict(self.clock), "startOp": start, "ops": ops}
        self.clock[self.actor] = self.seq
        return change

    def _new_id(self) -> str:
        self.max_op += 1
        return f"{self.max_op}@{self.actor}"

    def saw(self, change: Dict[str, Any]) -> None:
        self.clock[change["actor"]] = change["seq"]
        self.max_op = max(self.max_op, change["startOp"] + len(change["ops"]) - 1)


def wire_insert(text_obj: str, after: Optional[str], chars: str):
    """Ops inserting ``chars`` as a chain after element ``after`` (None: the
    head)."""
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


def wire_genesis(doc_len: int, rng: random.Random, prefix: str = "") -> Dict[str, Any]:
    """A ``doc_len``-char genesis by actor ``<prefix>genesis``: the text list
    and one chain of characters."""
    base = WireAuthor(f"{prefix}genesis")
    text_obj = f"1@{prefix}genesis"
    body = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(doc_len))
    return base.change(lambda new_id: [{"opId": new_id(), "action": "makeList", "key": "text"}]
                       + wire_insert(text_obj, None, body)(new_id))


class _Writer:
    """A writer's view: its author and its visible element ids in order."""

    def __init__(self, actor: str, genesis: Dict[str, Any]):
        self.author = WireAuthor(actor)
        self.author.saw(genesis)
        self.text_obj = genesis["ops"][0]["opId"]
        self.vis = [op["opId"] for op in genesis["ops"][1:]]

    def insert(self, index: int, chars: str) -> Dict[str, Any]:
        after = self.vis[index - 1] if index > 0 else None
        change = self.author.change(wire_insert(self.text_obj, after, chars))
        self.vis[index:index] = [op["opId"] for op in change["ops"]]
        return change

    def delete(self, index: int, count: int) -> Dict[str, Any]:
        gone = self.vis[index : index + count]
        del self.vis[index : index + count]
        return self.author.change(lambda new_id: [
            {"opId": new_id(), "action": "del", "obj": self.text_obj, "elemId": e} for e in gone])

    def mark(self, start: int, end: int, mark_type: str, attrs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        if MARK_SPEC[mark_type].inclusive:
            last = {"type": "endOfText"} if end >= len(self.vis) else {"type": "before", "elemId": self.vis[end]}
        else:
            last = {"type": "after", "elemId": self.vis[end - 1]}

        def build(new_id):
            op = {"opId": new_id(), "action": "addMark", "obj": self.text_obj,
                  "start": {"type": "before", "elemId": self.vis[start]}, "end": last, "markType": mark_type}
            if attrs:
                op["attrs"] = dict(attrs)
            return [op]
        return self.author.change(build)


def _writer_round(rng: random.Random, w: _Writer, op_budget: int) -> List[Dict[str, Any]]:
    """One writer's changes worth ``op_budget`` internal ops, drawn as
    ``fuzzmix._writer_changes`` draws them."""
    changes: List[Dict[str, Any]] = []
    while op_budget > 0:
        kind = rng.choice(["insert", "remove", "addMark"])
        length = len(w.vis)
        if kind == "insert":
            index = rng.randrange(length) if length else 0
            num = 100 + rng.randrange(300) if rng.random() < 0.05 else 1 + rng.randrange(4)
            chars = "".join(rng.choice("0123456789abcdef") for _ in range(num))[:op_budget]
            changes.append(w.insert(index, chars))
            op_budget -= len(chars)
        elif kind == "remove":
            if length < 2:
                continue
            index = rng.randrange(length - 1) + 1
            count = min(1 + rng.randrange(20), length - index, op_budget)
            changes.append(w.delete(index, count))
            op_budget -= count
        else:
            start = rng.randrange(length)
            end = start + rng.randrange(length - start) + 1
            mark_type = rng.choice(MARK_TYPES)
            attrs = None
            if mark_type == "link":
                attrs = {"url": rng.choice(EXAMPLE_URLS)}
            elif mark_type == "comment":
                attrs = {"id": f"comment-{rng.randrange(1 << 16):04x}"}
            changes.append(w.mark(start, end, mark_type, attrs))
            op_budget -= 1
    return changes


def wire_fuzz_rounds(doc_len: int, ops_per_round: int, num_writers: int, rounds: int, seed: int,
                     prefix: str = "") -> Dict[str, Any]:
    """A ``doc_len``-char genesis and ``rounds`` rounds in which each of
    ``num_writers`` writers makes ``ops_per_round`` concurrent internal ops
    on its own view.  Returns ``genesis`` and ``rounds`` ([round][writer] ->
    changes), as ``fuzzmix.make_writer_rounds`` does."""
    rng = random.Random(seed)
    genesis = wire_genesis(doc_len, rng, prefix)
    writers = [_Writer(f"{prefix}writer{w}", genesis) for w in range(num_writers)]
    per_round = [[_writer_round(rng, w, ops_per_round) for w in writers] for _ in range(rounds)]
    return {"genesis": genesis, "rounds": per_round}
