"""The convergence digest, worked out from a replayed document.

The program's ``convergence_digest`` is an order-sensitive checksum of a
replica's visible text and of the marks in force on each character.  Here
it is computed from the reference's formatted spans: for the character at
visible index i with code point c,

    char term  (c * 2654435761 mod 2^32 + i) mod 2^32
    mark term  (sum of the values of its marks mod 2^32) * ((31 i + 7) mod 2^32) mod 2^32

where a mark's value is (type * 1000003 + (attr + 1) * 8191 + 17) mod 2^32,
``type`` its place in the schema (``MARK_TYPE_ID``) and ``attr`` the number
of its attribute dict in the order of first appearance among the changes
handed to the program (-1 for a type without attributes).  The digest is
2166136261 xor (the char terms' sum) xor (31 * the mark terms' sum), all
mod 2^32.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

from portbench.reference.schema import MARK_SPEC, MARK_TYPE_ID

U32 = 0xFFFFFFFF


def attr_numbers(changes: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    """Each attribute dict of a mark op, as canonical JSON, numbered in the
    order it first appears in ``changes``."""
    out: Dict[str, int] = {}
    for change in changes:
        for op in change["ops"]:
            attrs = op.get("attrs")
            if op["action"] in ("addMark", "removeMark") and attrs:
                out.setdefault(json.dumps(attrs, sort_keys=True), len(out))
    return out


def _mark_value(mark_type: str, attrs: Dict[str, Any], attr_ids: Dict[str, int]) -> int:
    attr = attr_ids[json.dumps(attrs, sort_keys=True)] if MARK_SPEC[mark_type].attr_keys else -1
    return (MARK_TYPE_ID[mark_type] * 1000003 + (attr + 1) * 8191 + 17) & U32


def digest(spans: List[Dict[str, Any]], attr_ids: Dict[str, int]) -> int:
    """The digest of a document given as formatted spans."""
    char_mix = mark_mix = 0
    i = 0
    for span in spans:
        per = 0
        for mark_type, value in span["marks"].items():
            for attrs in (value if isinstance(value, list) else [value]):
                per += _mark_value(mark_type, attrs, attr_ids)
        per &= U32
        for ch in span["text"]:
            char_mix += (((ord(ch) * 2654435761) & U32) + i) & U32
            mark_mix += (per * ((31 * i + 7) & U32)) & U32
            i += 1
    return (2166136261 ^ (char_mix & U32) ^ ((31 * (mark_mix & U32)) & U32)) & U32
