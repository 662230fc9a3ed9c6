"""The mark schema the reference replays under.

Frozen copy of the table in ``peritext_tpu_torch/schema.py`` at commit
bdca3bf (reference src/schema.ts:45-96): ``inclusive`` marks grow at their
right end when text is typed there; ``allow_multiple`` marks (comments)
overlap as a set instead of resolving last-writer-wins.  The declaration
order gives each type its number (``MARK_TYPE_ID``), which the program's
convergence digest mixes in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MarkSpec:
    inclusive: bool
    allow_multiple: bool
    attr_keys: Tuple[str, ...] = ()
    excludes: "str | None" = None


MARK_SPEC: "dict[str, MarkSpec]" = {
    "strong": MarkSpec(inclusive=True, allow_multiple=False),
    "em": MarkSpec(inclusive=True, allow_multiple=False),
    "comment": MarkSpec(inclusive=False, allow_multiple=True, attr_keys=("id",), excludes=""),
    "link": MarkSpec(inclusive=False, allow_multiple=False, attr_keys=("url",)),
}

MARK_TYPE_ID = {name: i for i, name in enumerate(MARK_SPEC)}
