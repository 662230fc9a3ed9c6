"""Declarative mark schema — the config table that drives mark semantics.

This is the equivalent of the reference's ProseMirror ``markSpec``
(reference src/schema.ts:45-96): a tiny static table consumed by the
formatting engine.  Two flags drive the whole algorithm:

- ``inclusive``: the mark's *end* grows to absorb text typed at its right
  boundary (bold/italic do; links and comments don't).  Consumed when anchoring
  mark endpoints (see :func:`peritext_tpu_torch.oracle.doc.change_mark`, reference
  peritext.ts:466-467).
- ``allow_multiple``: overlapping same-type marks coexist as a set (comments)
  instead of resolving last-writer-wins (reference peritext.ts:304, schema.ts:77).

The table is extensible at runtime (:func:`register_mark_type`, the
reference's demoMarkSpec pattern).  The tensorized engine therefore consumes
the flags as a small fixed-size *input vector* built at call time
(:func:`allow_multiple_array`) — never as captured kernel constants, which would
go stale when a type registers after a kernel has been traced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MarkSpec:
    """Configuration for one mark type (reference schema.ts:45-96).

    ``excludes`` is the editor-facing exclusion group (reference
    schema.ts:77, the ProseMirror markSpec field): None means the editor
    default (a mark excludes its own type), "" excludes nothing (how
    comment permits same-type overlap at the editor layer), and a
    space-separated name list names an explicit group.  CRDT merge
    behavior reads ``allow_multiple`` — ``excludes`` configures the
    consuming editor's schema, exactly as in the reference where the CRDT
    reads allowMultiple (peritext.ts:304) and ProseMirror reads excludes.
    """

    inclusive: bool
    allow_multiple: bool
    attr_keys: Tuple[str, ...] = ()
    excludes: "str | None" = None


# The four mark types of the reference schema, in declaration order.
# Reference: schema.ts:46-95 and ALL_MARKS at schema.ts:125.
MARK_SPEC: "dict[str, MarkSpec]" = {
    "strong": MarkSpec(inclusive=True, allow_multiple=False),
    "em": MarkSpec(inclusive=True, allow_multiple=False),
    "comment": MarkSpec(
        inclusive=False, allow_multiple=True, attr_keys=("id",), excludes=""
    ),
    "link": MarkSpec(inclusive=False, allow_multiple=False, attr_keys=("url",)),
}

# Mutable registry views.  The tensorized engine consumes the flags as small
# device arrays built at call time (allow_multiple_array), so registered
# types take effect without recompiling anything but the shapes they change.
ALL_MARKS: Tuple[str, ...] = tuple(MARK_SPEC)
MARK_TYPE_ID = {name: i for i, name in enumerate(ALL_MARKS)}
NUM_MARK_TYPES = len(ALL_MARKS)
INCLUSIVE_BY_ID = tuple(MARK_SPEC[t].inclusive for t in ALL_MARKS)
ALLOW_MULTIPLE_BY_ID = tuple(MARK_SPEC[t].allow_multiple for t in ALL_MARKS)

# Kernel flag vectors are padded to a fixed capacity so registering a mark
# type never changes kernel shapes.
MAX_MARK_TYPES = 16


def _rebuild_views() -> None:
    global ALL_MARKS, NUM_MARK_TYPES, INCLUSIVE_BY_ID, ALLOW_MULTIPLE_BY_ID
    ALL_MARKS = tuple(MARK_SPEC)
    # MARK_TYPE_ID mutates in place so `from schema import MARK_TYPE_ID`
    # bindings elsewhere stay live; consumers of the tuple views must access
    # them as schema attributes (`schema.ALL_MARKS`).
    MARK_TYPE_ID.clear()
    MARK_TYPE_ID.update({name: i for i, name in enumerate(ALL_MARKS)})
    NUM_MARK_TYPES = len(ALL_MARKS)
    INCLUSIVE_BY_ID = tuple(MARK_SPEC[t].inclusive for t in ALL_MARKS)
    ALLOW_MULTIPLE_BY_ID = tuple(MARK_SPEC[t].allow_multiple for t in ALL_MARKS)


def register_mark_type(
    name: str,
    inclusive: bool,
    allow_multiple: bool = False,
    attr_keys: Tuple[str, ...] = (),
    excludes: "str | None" = None,
) -> None:
    """Extend the mark schema at runtime (the reference's demoMarkSpec
    pattern, schema.ts:99-121: demos add highlightChange/unhighlightChange
    on top of the core four).

    Idempotent for identical re-registration; conflicting redefinition of an
    existing type raises.  Register before creating the documents that use
    the type — mark-type ids are append-only, so existing docs stay valid.
    """
    spec = MarkSpec(
        inclusive=inclusive,
        allow_multiple=allow_multiple,
        attr_keys=tuple(attr_keys),
        excludes=excludes,
    )
    existing = MARK_SPEC.get(name)
    if existing is not None:
        if existing != spec:
            raise ValueError(f"mark type {name!r} already registered with different flags")
        return
    if len(MARK_SPEC) >= MAX_MARK_TYPES:
        raise ValueError(f"mark schema is full ({MAX_MARK_TYPES} types)")
    MARK_SPEC[name] = spec
    _rebuild_views()


def allow_multiple_array():
    """The allowMultiple flags as a fixed-size numpy vector for kernels."""
    import numpy as np

    out = np.zeros(MAX_MARK_TYPES, bool)
    out[: NUM_MARK_TYPES] = ALLOW_MULTIPLE_BY_ID
    return out


def is_mark_type(s: str) -> bool:
    """Reference schema.ts:133-140 (isMarkType)."""
    return s in MARK_SPEC
