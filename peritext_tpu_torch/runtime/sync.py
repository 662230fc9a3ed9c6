"""Anti-entropy synchronization between replicas.

Reference: test/merge.ts:4-23 (applyChanges retry loop) and 25-38
(getMissingChanges).  The reference tolerates out-of-order delivery by
retrying causally-unready changes in a queue with a divergence guard
(:func:`apply_available`, :func:`apply_changes`); :func:`causal_order` and
:func:`causal_sort` order a batch up front so the batched engine applies
it in one device launch with no retries.  A copy of the JAX package's
``peritext_tpu.runtime.sync``, its spans and counters included
(``sync.apply``, ``sync.deferred``, through the port's telemetry), so the
port imports nothing of that package.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from peritext_tpu_torch.runtime import telemetry

Change = Dict[str, Any]


class ConvergenceError(RuntimeError):
    """``apply_changes`` could not drain its queue: some changes' causal
    dependencies never arrived (or duplicates/forks kept being rejected).

    Carries the still-pending changes (``pending``) and their ``(actor,
    seq)`` ids (``pending_ids``) so chaos-test triage can see exactly which
    deliveries went missing instead of a bare "did not converge".
    """

    def __init__(self, pending: Sequence[Change]):
        self.pending = list(pending)
        self.pending_ids = [(c["actor"], c["seq"]) for c in self.pending]
        ids = ", ".join(f"{a}@{s}" for a, s in self.pending_ids[:8])
        if len(self.pending_ids) > 8:
            ids += f", ... ({len(self.pending_ids) - 8} more)"
        actors = len({a for a, _ in self.pending_ids})
        super().__init__(
            f"apply_changes did not converge; {len(self.pending)} pending "
            f"(actor, seq) id(s) across {actors} actor(s): [{ids}]"
        )


def apply_available(
    doc: Any, changes: Sequence[Change]
) -> tuple[List[Dict[str, Any]], List[Change]]:
    """Apply every causally-ready change; return (patches, still_pending).

    The retry-queue core shared by :func:`apply_changes` and gap-tolerant
    consumers (the Editor's delivery buffer, chaos fuzzing): unready changes
    rotate to the back (reference test/merge.ts:4-23) until a full rotation
    makes no progress, and the unapplied remainder comes back to the caller
    instead of raising.  Already-seen changes (duplicated deliveries) drop
    idempotently — the same rule as the batched engine's causal gate — so a
    retry buffer fed duplicates cannot grow without bound.
    """
    pending = deque(changes)
    patches: List[Dict[str, Any]] = []
    stuck = 0
    # Causal-flow seam: the retry-queue walk runs inside a span so any lane
    # scoped onto this thread (a pubsub delivery, a queue flush) steps
    # through it — this is where a chaotically-delivered change either
    # applies or defers, exactly the fate a per-change trace must show.
    with telemetry.span("sync.apply", changes=len(pending)):
        if telemetry.enabled:
            telemetry.flow_steps()
        while pending:
            change = pending.popleft()
            if change["seq"] <= doc.clock.get(change["actor"], 0):
                continue  # duplicate delivery: already applied
            try:
                patches.extend(doc.apply_change(change))
                stuck = 0
            except ValueError:
                pending.append(change)
                stuck += 1
                if stuck >= len(pending):
                    break
            except Exception as exc:
                # Non-causal failure mid-batch (backend error, malformed
                # change): earlier changes DID apply and their patches must not
                # be lost, but a function cannot both return and raise — tag the
                # exception with the partial progress so consumers with retry
                # buffers (the Editor) can keep it, and put the failing change
                # back at the front for redelivery-free retry.
                pending.appendleft(change)
                exc.applied_patches = patches  # type: ignore[attr-defined]
                exc.unapplied = list(pending)  # type: ignore[attr-defined]
                raise
        if pending and telemetry.enabled:
            # Chaotic-delivery accounting: how many causally-unready changes
            # each gap-tolerant pass handed back (allow_gaps consumers leave
            # them for a later anti-entropy redelivery).
            telemetry.counter("sync.deferred", len(pending))
            telemetry.record("sync.defer", outcome="deferred", count=len(pending))
            telemetry.flow_steps(deferred=len(pending))
    return patches, list(pending)


def apply_changes(
    doc: Any, changes: Sequence[Change], allow_gaps: bool = False
) -> List[Dict[str, Any]]:
    """Apply changes tolerating causal gaps, retrying until convergence.

    Reference test/merge.ts:4-23: unready changes rotate to the back of the
    queue.  Divergence (a full rotation with no progress — genuinely
    missing dependencies) raises :class:`ConvergenceError` carrying the
    still-pending changes.  With ``allow_gaps`` (chaotic-delivery mode:
    drops/dups/reorders are expected and a later anti-entropy sync
    redelivers), the undeliverable remainder is silently left unapplied
    instead.
    """
    patches, pending = apply_available(doc, changes)
    if pending and not allow_gaps:
        raise ConvergenceError(pending)
    return patches


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


def causal_sort(changes: Sequence[Change], clock: Dict[str, int] | None = None) -> List[Change]:
    """Order a batch of changes so each one's causal dependencies precede it.

    Kahn's algorithm over the (actor seq-chain + deps) DAG, seeded with the
    receiving replica's current ``clock``.  Ties broken by (startOp, actor)
    for determinism.  Raises ``ValueError`` if the batch has unsatisfiable
    dependencies — the batched-engine analog of the reference's
    causal-readiness throw (micromerge.ts:501-509).  The frontier walk is
    the shared :func:`_retry_queue_order` over the sorted positions, so the
    emission order is byte-identical to the repeated-pass formulation at
    O(n + e) instead of O(n * passes).
    """
    clock = dict(clock or {})
    items = sorted(changes, key=lambda c: (c["startOp"], c["actor"], c["seq"]))
    ordered, leftover = _retry_queue_order(items, clock)
    if leftover:
        raise ValueError(
            f"causal_sort: {leftover} changes have unsatisfiable dependencies"
        )
    return ordered


def sync_pair(log: Any, left: Any, right: Any) -> tuple[list, list]:
    """Anti-entropy sync between two replicas through a shared change log.

    Returns (patches applied to left, patches applied to right).  This is the
    reference fuzzer's sync step (fuzz.ts:181-202).
    """
    to_right = log.missing_changes(left.clock, right.clock)
    to_left = log.missing_changes(right.clock, left.clock)
    right_patches = apply_changes(right, to_right)
    left_patches = apply_changes(left, to_left)
    return left_patches, right_patches
