"""Operation ids and their total order (counter, then actor string).

Frozen copy of ``peritext_tpu_torch/ids.py`` at commit bdca3bf (its
``ActorRegistry`` left out: the reference never interns actors).  It must not
follow later edits of the program: it is half of what decides ``correct``.
Reference: micromerge.ts:812-827 (compareOpIds).
"""
from __future__ import annotations

import re
from typing import Tuple

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
