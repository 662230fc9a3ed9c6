"""Causal delivery order for batched ingest.

Reference: test/merge.ts:4-23 (the applyChanges retry loop).  The batched
engine orders a change batch up front with :func:`causal_order`, so one
device launch applies it with no retries, in exactly the order the
reference's retry queue would.  A copy of the JAX package's ordering walk
(``peritext_tpu.runtime.sync``) without its telemetry spans, so the port
imports nothing of that package.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

Change = Dict[str, Any]


def _is_ready(change: Change, clock: Dict[str, int]) -> bool:
    return clock.get(change["actor"], 0) == change["seq"] - 1 and all(
        clock.get(actor, 0) >= dep
        for actor, dep in (change.get("deps") or {}).items()
    )


def _blocker(change: Change, clock: Dict[str, int]) -> Optional[Tuple[str, int]]:
    """The first unmet readiness condition as a ``(actor, value)`` wake key
    (the change becomes re-checkable when ``clock[actor]`` reaches exactly
    ``value``), or None when the change is ready now.  The clock only ever
    advances in +1 steps per actor during an ordering walk, so it passes
    through every integer it will ever exceed — a key whose value the clock
    is already past can never fire, which is exactly the permanently-stuck
    (duplicate/forked seq) case the callers report as unsatisfiable."""
    if clock.get(change["actor"], 0) != change["seq"] - 1:
        return (change["actor"], change["seq"] - 1)
    for actor, dep in (change.get("deps") or {}).items():
        if clock.get(actor, 0) < dep:
            return (actor, dep)
    return None


def _retry_queue_order(
    items: Sequence[Change], clock: Dict[str, int]
) -> Tuple[List[Change], int]:
    """The retry-queue emission order over ``items`` (positions = list
    order), computed with an indexed ready-set instead of repeated passes.

    Semantics are byte-identical to the reference retry loop (test/merge.ts:
    4-23): scan the remaining changes in order, emitting the ones ready at
    scan time; deferred changes keep their relative order and are rescanned
    on the next pass.  Equivalently: within a pass, a change woken by an
    emission at an *earlier* position still emits this pass; one woken by an
    emission at a *later* position waits for the next pass.  The rotating
    deque pays a full O(n) rescan per emission in the worst case (a reversed
    single-actor chain is O(n^2)); here each change parks on the one unmet
    ``(actor, value)`` condition blocking it and is re-examined only when
    that clock entry lands — O(n + e) parks with an O(log n) heap pop per
    emission.  ``clock`` is mutated in place.  Returns (ordered, leftover
    count of unsatisfiable changes).
    """
    ready: List[int] = []  # current pass, heap by position
    next_ready: List[int] = []  # woken at/before the cursor: next pass
    waiting: Dict[Tuple[str, int], List[int]] = {}

    def park(i: int) -> bool:
        key = _blocker(items[i], clock)
        if key is None:
            return False
        waiting.setdefault(key, []).append(i)
        return True

    for i in range(len(items)):
        if not park(i):
            ready.append(i)
    heapq.heapify(ready)
    ordered: List[Change] = []
    parked = len(items) - len(ready)
    while ready or next_ready:
        if not ready:
            ready = next_ready
            next_ready = []
            heapq.heapify(ready)
        pos = heapq.heappop(ready)
        change = items[pos]
        # Re-check at pop time: a same-(actor, seq) duplicate classified
        # ready earlier is stale once its twin emits (the rotating loop
        # would defer it forever; here it re-parks on an unreachable key).
        if not _is_ready(change, clock):
            parked += park(pos)
            continue
        clock[change["actor"]] = change["seq"]
        ordered.append(change)
        woken = waiting.pop((change["actor"], change["seq"]), None)
        if woken:
            parked -= len(woken)
            for w in woken:
                if _is_ready(items[w], clock):
                    # Later position: still scannable this pass.  Earlier:
                    # already deferred this pass, emits next pass.
                    if w > pos:
                        heapq.heappush(ready, w)
                    else:
                        next_ready.append(w)
                else:
                    parked += park(w)
    return ordered, parked


def causal_order(changes: Sequence[Change], clock: Dict[str, int] | None = None) -> List[Change]:
    """Delivery-order-preserving causal ordering.

    The exact order the reference's applyChanges retry loop (test/merge.ts:
    4-23) would apply a batch in: changes apply in delivery order, with
    causally-unready ones deferred to the back of the queue.  This matters
    beyond correctness: *patch streams are delivery-order-sensitive* (patch
    indices depend on what applied before), so batched engines must use this
    order — not an arbitrary topological sort — to emit the same patches an
    incremental replica would.  O(n + e) via the indexed ready-set walk
    (:func:`_retry_queue_order`); output order is byte-identical to the
    rotating-deque formulation (tests/test_sync_order.py pins it against a
    reference copy of the old loop).
    """
    clock = dict(clock or {})
    ordered, leftover = _retry_queue_order(list(changes), clock)
    if leftover:
        raise ValueError(
            f"causal_order: {leftover} changes have unsatisfiable dependencies"
        )
    return ordered
