"""Operation/actor identity primitives.

Reference: micromerge.ts:34-55 (ActorId / OperationId / Clock types) and
micromerge.ts:812-827 (compareOpIds).

On the wire an operation id is the string ``"{counter}@{actorId}"`` and the
total order is (counter, then *lexicographic* actor id) — a Lamport-style
order.  The device engine never touches strings: actors are interned to stable
integer ids by :class:`ActorRegistry`, and comparisons use the actor's
*lexicographic rank* (recomputed when new actors appear) so that the tuple
``(counter, rank)`` compares exactly like the reference's string compare.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_OPID_RE = re.compile(r"^([0-9]+)@(.*)$", re.DOTALL)


def parse_op_id(op_id: str) -> Tuple[int, str]:
    """Split ``"ctr@actor"`` into ``(ctr, actor)``. Reference micromerge.ts:815-823."""
    m = _OPID_RE.match(op_id)
    if m is None:
        raise ValueError(f"Invalid operation ID: {op_id}")
    return int(m.group(1)), m.group(2)


def make_op_id(counter: int, actor: str) -> str:
    return f"{counter}@{actor}"


def op_sort_key(op_id: str) -> Tuple[int, str]:
    """Sort key realizing the reference's total order on op ids."""
    return parse_op_id(op_id)


def compare_op_ids(id1: str, id2: str) -> int:
    """Total order on op ids: counter first, then lexicographic actor.

    Returns -1/0/+1.  Reference micromerge.ts:812-827.
    """
    if id1 == id2:
        return 0
    c1, a1 = parse_op_id(id1)
    c2, a2 = parse_op_id(id2)
    if c1 < c2 or (c1 == c2 and a1 < a2):
        return -1
    return 1


class ActorRegistry:
    """Interns actor-id strings to dense integer ids.

    The integer id is stable for the lifetime of the registry (safe to store
    in device tensors).  ``ranks()`` returns, for each interned id, the
    actor's rank in lexicographic string order — the key the device kernels use
    so that ``(counter, rank)`` tuple comparison reproduces the reference's
    ``compareOpIds`` (micromerge.ts:826: equal counters fall back to
    ``actor1 < actor2`` string comparison).
    """

    def __init__(self) -> None:
        self._id_of: Dict[str, int] = {}
        self._actors: List[str] = []
        self._ranks: List[int] | None = None

    def __len__(self) -> int:
        return len(self._actors)

    def intern(self, actor: str) -> int:
        i = self._id_of.get(actor)
        if i is None:
            i = len(self._actors)
            self._id_of[actor] = i
            self._actors.append(actor)
            self._ranks = None  # invalidate
        return i

    def actor(self, i: int) -> str:
        return self._actors[i]

    def id_of(self, actor: str) -> int:
        return self._id_of[actor]

    def __contains__(self, actor: str) -> bool:
        return actor in self._id_of

    def ranks(self) -> List[int]:
        """rank_of_id[i] = lexicographic rank of actor with intern id i."""
        if self._ranks is None:
            order = sorted(range(len(self._actors)), key=lambda i: self._actors[i])
            ranks = [0] * len(self._actors)
            for rank, i in enumerate(order):
                ranks[i] = rank
            self._ranks = ranks
        return self._ranks

    @property
    def actors(self) -> List[str]:
        return list(self._actors)
