"""Outbound change batching queue (a copy of ``peritext_tpu/runtime/queue.py``
for the PyTorch port).

Reference: the Peritext reference's src/changeQueue.ts:6-52 (ChangeQueue).  Batches
locally generated changes and flushes them through a handler — the host->device
staging-buffer analog in the device engine, and the network-batching analog in
replication.  The reference flushes on a 10ms browser timer (tunable to
simulate latency); here the timer is an optional daemon thread, and manual
``flush()`` covers the demo-style "manual sync button" mode
(reference index.ts:119-128).

Robustness contract: a flush whose handler raises (or is failed by the
``queue_flush`` fault site) re-enqueues the popped batch at the *front*, so
no change is ever lost and a later flush republishes in original order.  The
timer lifecycle is epoch-guarded: ``drop()`` during an in-flight tick cannot
race a subsequent ``start()`` into leaking a second timer chain.

Admission control (the health plane's memory bound): an unbounded queue lets
producers pile up work a sick backend cannot drain — under a wedged backend the
10ms timer re-fails forever while enqueues keep growing the list.  A bound
(``bound=``, default 0 = unbounded) caps the pending depth, with a
pluggable backpressure ``policy``:

- ``block`` (default): ``enqueue`` waits until a flush frees space (an
  optional ``block_timeout`` raises :class:`QueueFullError` instead of
  waiting forever).  Lossless; producers feel the backpressure directly.
- ``coalesce``: per-actor run coalescing — at the bound, *adjacent* pending
  changes from the same actor collapse into one queue entry (the bound
  counts entries), so the single-author editor case (one queue per actor —
  the repo's idiom) stays O(1) entries under a wedged backend while exact
  global FIFO order is preserved.  Lossless; incompressible interleavings
  of distinct actors overflow the bound softly (counted).
- ``shed``: oldest changes are dropped to make room, with telemetry
  (``queue.shed``) and a warning — bounded memory at the cost of relying on
  anti-entropy (the durable change log) to redeliver what was shed.

Every policy decision lands in the telemetry registry: ``queue.blocked`` /
``queue.block_seconds``, ``queue.coalesced`` / ``queue.coalesce_overflow``,
``queue.shed``, alongside the existing depth/flush metrics.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional

from peritext_tpu_torch.runtime import faults
from peritext_tpu_torch.runtime import telemetry

_log = logging.getLogger(__name__)
_queue_ids = itertools.count()

# THE backpressure policy vocabulary, shared by every admission-control
# surface in the runtime: ChangeQueue bounds (this module) and the serving
# plane's per-session lanes (runtime/serve.py) accept exactly these names,
# with the same semantics — block waits, coalesce merges losslessly at the
# bound, shed drops oldest with telemetry.
POLICIES = ("block", "coalesce", "shed")
_POLICIES = POLICIES


class QueueFullError(RuntimeError):
    """A blocking enqueue exceeded its ``block_timeout`` with the queue
    still at its bound (the backend is not draining)."""


class _Run:
    """A coalesced run of adjacent changes from one actor (one queue entry)."""

    __slots__ = ("actor", "changes")

    def __init__(self, actor: Any, changes: List[Any]) -> None:
        self.actor = actor
        self.changes = changes


def _actor_of(entry: Any) -> Any:
    if isinstance(entry, _Run):
        return entry.actor
    if isinstance(entry, dict):
        return entry.get("actor")
    return None


def _flatten(entries) -> List[Any]:
    if not any(isinstance(e, _Run) for e in entries):
        return list(entries)
    out: List[Any] = []
    for e in entries:
        if isinstance(e, _Run):
            out.extend(e.changes)
        else:
            out.append(e)
    return out


def _entry_size(entry: Any) -> int:
    return len(entry.changes) if isinstance(entry, _Run) else 1


class ChangeQueue:
    def __init__(
        self,
        handle_flush: Callable[[List[Any]], None],
        interval: float = 0.01,
        flush_lock: Optional["threading.RLock"] = None,
        name: Optional[str] = None,
        bound: int = 0,
        policy: str = "block",
        block_timeout: Optional[float] = None,
    ) -> None:
        # Chaos stream key: each queue gets its own drop/dup/reorder stream
        # (and holdback buffer) so one queue's held-back changes can never
        # surface through another queue's handler.  Deterministic as long as
        # queue construction order is (pass ``name`` to pin it exactly).
        self._name = name if name is not None else f"queue-{next(_queue_ids)}"
        # Entries (plain changes or coalesced _Runs) + an incrementally
        # tracked flattened depth, so admission never rescans the queue.
        self._changes: Deque[Any] = deque()
        self._depth = 0
        # Causal-flow lanes for the pending entries: one TraceContext per
        # enqueue call (batch granularity, like every instrumented site),
        # popped wholesale by the flush that drains them.  Only populated
        # while telemetry is enabled.
        self._flows: List[Any] = []
        self._handle_flush = handle_flush
        self._interval = interval
        self._timer: Optional[threading.Timer] = None
        # Timer-chain epoch: every start()/drop() bumps it, and a tick only
        # re-arms if its epoch is still current.  Without this, a drop()
        # racing an in-flight tick followed by a fresh start() could leave
        # BOTH the new chain's timer and the old tick's re-arm alive — two
        # timer chains flushing forever.
        self._epoch = 0
        self._lock = threading.Lock()
        # Signaled whenever a flush pops the queue; blocking enqueues wait
        # on it.  Shares the state lock, so waiters observe a consistent
        # depth.
        self._drained = threading.Condition(self._lock)
        self._bound = max(0, bound)
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown queue policy {policy!r}; known policies: "
                f"{', '.join(_POLICIES)}"
            )
        self._policy = policy
        self._block_timeout = block_timeout
        # Held across pop+handle so two concurrent flushes (timer thread vs
        # a manual sync) cannot publish one actor's changes out of seq
        # order.  Callers pass a shared reentrant lock (the Editor passes
        # its publisher's); default is a private one.
        self._flush_lock = flush_lock if flush_lock is not None else threading.RLock()

    # -- admission -----------------------------------------------------------

    def enqueue(self, *changes: Any) -> None:
        """Admit a batch under the bound/policy.  Atomic per call: either
        every change is admitted (one lock hold, FIFO-contiguous) or — the
        block policy's timeout — none is, so callers can safely retry a
        QueueFullError without duplicating a half-admitted prefix."""
        if telemetry.enabled and changes:
            self._enqueue_traced(changes)
            return
        with self._drained:
            self._admit_locked(changes)

    def _admit_locked(self, changes: tuple) -> None:
        if not self._bound:
            self._changes.extend(changes)
            self._depth += len(changes)
        elif self._policy == "block":
            self._admit_blocking_locked(changes)
        elif self._policy == "shed":
            self._admit_shedding_locked(changes)
        else:
            for change in changes:
                self._admit_coalescing_locked(change)

    def _enqueue_traced(self, changes: tuple) -> None:
        """Traced admission.  The lane's start event is emitted BEFORE the
        context is published to the flush side, and publication happens in
        the SAME lock hold that admits the changes — so a timer flush
        racing this enqueue can neither drain the batch without its lane
        nor emit the lane's steps ahead of its start."""
        ctx = telemetry.flow("queue.change", queue=self._name, changes=len(changes))
        with telemetry.span("queue.enqueue", changes=len(changes)):
            telemetry.flow_point(ctx)
            try:
                with self._drained:
                    self._admit_locked(changes)
                    self._flows.append(ctx)
                    depth = self._depth
            except BaseException:
                # Nothing was admitted (block-timeout): the lane ends here
                # instead of dangling as an orphan start.
                telemetry.flow_point(ctx, terminal=True, outcome="rejected")
                raise
        # High-water mark at enqueue time, not just flush time: depth built
        # up between flushes (a wedged handler) must be visible.
        telemetry.gauge_max("queue.depth_max", depth)

    def _admit_blocking_locked(self, changes: tuple) -> None:
        """Wait until the whole batch fits (or the queue is empty — a batch
        larger than the bound must not deadlock; it overflows softly once
        it is the only occupant).  On timeout, nothing was admitted."""
        n = len(changes)
        t0: Optional[float] = None
        deadline = (
            None
            if self._block_timeout is None
            else time.monotonic() + self._block_timeout
        )
        while self._depth > 0 and self._depth + n > self._bound:
            if t0 is None:
                t0 = time.perf_counter()
                if telemetry.enabled:
                    telemetry.counter("queue.blocked")
            if deadline is None:
                self._drained.wait()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._drained.wait(remaining):
                    if telemetry.enabled:
                        telemetry.observe(
                            "queue.block_seconds", time.perf_counter() - t0
                        )
                    raise QueueFullError(
                        f"queue {self._name} still at bound "
                        f"{self._bound} after {self._block_timeout}s"
                    )
        if t0 is not None and telemetry.enabled:
            telemetry.observe("queue.block_seconds", time.perf_counter() - t0)
        self._changes.extend(changes)
        self._depth += n

    def _admit_shedding_locked(self, changes: tuple) -> None:
        # Causal lanes are per enqueue CALL, so shedding individual entries
        # cannot unmap "their" lane; shed batches' lanes terminate at the
        # next flush (their e2e then includes shed residency — an accepted
        # approximation of an explicitly lossy, telemetry-flagged policy).
        self._changes.extend(changes)
        self._depth += len(changes)
        shed = 0
        while self._depth > self._bound:
            shed_n = _entry_size(self._changes.popleft())
            self._depth -= shed_n
            shed += shed_n
        if shed:
            # The entry bound just dropped data, so the lane list must not
            # keep growing either (memory stays flat under a wedged
            # backend).  Terminate the oldest lanes down to the
            # bound — their changes are the ones most likely shed — with an
            # explicit "shed" outcome and no e2e observation.  We are
            # inside the traced enqueue's span (or emitting is a no-op
            # untraced), so the finish events stay bound.
            while len(self._flows) > self._bound:
                telemetry.flow_point(
                    self._flows.pop(0), terminal=True, outcome="shed"
                )
            if telemetry.enabled:
                telemetry.counter("queue.shed", shed)
            _log.warning(
                "change queue %s over bound %d: shed %d oldest "
                "change(s) (redelivery relies on anti-entropy)",
                self._name,
                self._bound,
                shed,
            )

    def _compact_runs_locked(self) -> int:
        """Merge adjacent same-actor entries into runs; returns the number
        of changes absorbed.  Exact global FIFO is preserved: a run sits at
        its first change's position and flattens back in order."""
        merged = 0
        out: List[Any] = []
        for e in self._changes:
            actor = _actor_of(e)
            prev = out[-1] if out else None
            if actor is not None and prev is not None and _actor_of(prev) == actor:
                if not isinstance(prev, _Run):
                    out[-1] = prev = _Run(actor, [prev])
                if isinstance(e, _Run):
                    prev.changes.extend(e.changes)
                    merged += len(e.changes)
                else:
                    prev.changes.append(e)
                    merged += 1
            else:
                out.append(e)
        self._changes = deque(out)
        return merged

    def _admit_coalescing_locked(self, change: Any) -> None:
        self._depth += 1  # coalescing is lossless: depth always grows
        # The bound caps ENTRIES; runs keep the change count exact.
        if len(self._changes) < self._bound:
            self._changes.append(change)
            return
        merged = self._compact_runs_locked()
        actor = _actor_of(change)
        prev = self._changes[-1] if self._changes else None
        if actor is not None and prev is not None and _actor_of(prev) == actor:
            if not isinstance(prev, _Run):
                self._changes[-1] = prev = _Run(actor, [prev])
            prev.changes.append(change)
            merged += 1
        elif len(self._changes) < self._bound:
            self._changes.append(change)
        else:
            # Incompressible (distinct actors interleaved at the bound):
            # keep the change anyway — coalesce bounds entries, never
            # sheds data.
            self._changes.append(change)
            if telemetry.enabled:
                telemetry.counter("queue.coalesce_overflow")
        if merged and telemetry.enabled:
            telemetry.counter("queue.coalesced", merged)

    # -- flushing ------------------------------------------------------------

    def flush(self) -> None:
        with self._flush_lock:
            with self._drained:
                entries, self._changes = self._changes, deque()
                flows, self._flows = self._flows, []
                self._depth = 0
                self._drained.notify_all()
            changes = _flatten(entries)
            # Depth/latency telemetry only for non-empty flushes — idle
            # 10ms timer ticks would otherwise drown the histograms — and
            # only on SUCCESS, so `queue.flush_depth.count ==
            # queue.flushes` holds even under injected flush failures
            # (failed attempts show up as queue.reenqueues instead, and
            # the re-flushed batch counts once when it finally lands).
            record = telemetry.enabled and bool(changes)
            if record:
                depth = len(changes)
                telemetry.gauge_max("queue.depth_max", depth)
                t0 = time.perf_counter()
            try:
                if changes:
                    # Chaos plane: fail/wedge the flush.  Only fired for
                    # non-empty batches so counted schedules aren't consumed
                    # by idle timer ticks.
                    faults.fire("queue_flush")
                # drop/dup/reorder the batch.  Runs for EMPTY batches too:
                # a held-back (reordered) change must be able to re-emerge
                # on a later idle tick, not stay stranded once the editor
                # goes quiet.
                changes = faults.filter_stream(
                    "queue_flush", changes, stream=self._name
                )
                if record:
                    # The flush span is the lanes' hand-off slice: every
                    # pending lane steps through it, the handler runs with
                    # the lanes scoped onto this thread (so ingest seams
                    # join them), and handler success is the terminal seam
                    # — it feeds e2e.enqueue_to_applied and finishes the
                    # flow.
                    with telemetry.span("queue.flush", depth=depth):
                        for ctx in flows:
                            telemetry.flow_point(ctx)
                        with telemetry.flowing(flows):
                            self._handle_flush(changes)
                        for ctx in flows:
                            if ctx is not None:
                                telemetry.observe(
                                    "e2e.enqueue_to_applied",
                                    telemetry.flow_elapsed_s(ctx),
                                )
                                telemetry.flow_point(ctx, terminal=True)
                    telemetry.record(
                        "queue.flush", outcome="applied", depth=depth
                    )
                    telemetry.counter("queue.flushes")
                    telemetry.observe("queue.flush_depth", depth)
                    telemetry.observe(
                        "queue.flush_seconds", time.perf_counter() - t0
                    )
                else:
                    self._handle_flush(changes)
                    if flows and telemetry.enabled:
                        # Lanes popped with no recordable batch (every
                        # entry was shed, or telemetry toggled between
                        # enqueue and flush): terminate them without an
                        # e2e observation — a dropped lane must still end,
                        # never dangle as an orphan start.
                        with telemetry.span("queue.flush_dropped", flows=len(flows)):
                            for ctx in flows:
                                telemetry.flow_point(
                                    ctx, terminal=True, outcome="dropped"
                                )
            except BaseException:
                # A failed flush must not lose the batch: put the surviving
                # changes back at the front so a later flush retries them
                # ahead of anything enqueued meanwhile (changes an enqueue
                # raced in DURING this failed flush sit behind the popped
                # batch — FIFO holds across the failure; pinned by
                # tests/test_faults.py).  Deliberately past the bound: the
                # batch was admitted once and must not be re-judged.
                # The lanes ride along: the retry flush that finally lands
                # is what finishes them.
                with self._lock:
                    self._changes.extendleft(reversed(changes))
                    self._depth += len(changes)
                    self._flows[:0] = flows
                if record:
                    telemetry.counter("queue.reenqueues", len(changes))
                    telemetry.record(
                        "queue.flush", outcome="error", depth=depth
                    )
                raise

    def _tick(self, epoch: int) -> None:
        try:
            self.flush()
        except Exception:
            # A failing flush (handler error, injected fault) must not kill
            # the timer chain: the batch was re-enqueued by flush(), so the
            # next tick retries it.  Log it — the timer thread has no caller
            # to propagate to.
            _log.warning("change-queue flush failed; will retry", exc_info=True)
        finally:
            with self._lock:
                if self._timer is not None and epoch == self._epoch:
                    self._arm_locked()

    def _arm_locked(self) -> None:
        timer = threading.Timer(self._interval, self._tick, args=(self._epoch,))
        timer.daemon = True
        self._timer = timer
        timer.start()

    def start(self) -> None:
        with self._lock:
            if self._timer is not None:
                return  # already running: never arm a second chain
            self._epoch += 1
            self._arm_locked()

    def drop(self) -> None:
        """Stop the timer (go manual-sync).  Reference changeQueue.ts:47-51."""
        with self._lock:
            timer, self._timer = self._timer, None
            self._epoch += 1  # invalidate any in-flight tick's re-arm
        if timer is not None:
            timer.cancel()

    def entries(self) -> int:
        """Pending queue entries (coalesced runs count once — the quantity
        the ``coalesce`` policy bounds)."""
        with self._lock:
            return len(self._changes)

    def __len__(self) -> int:
        """Pending changes (coalesced runs count their members)."""
        with self._lock:
            return self._depth
