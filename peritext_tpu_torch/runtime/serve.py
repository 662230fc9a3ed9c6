"""Serving plane: multi-session admission + deadline-aware continuous
batching in front of ``TorchUniverse`` ingest.

A copy of ``peritext_tpu/runtime/serve.py`` bound to the PyTorch port: the
plane reads only the universe's ``index_of``, ``clocks``, ``capacity``,
``replica_ids``, ``stats`` and ``apply_changes_with_patches``, and runs its
faults, breakers and telemetry through the port's own runtime modules.

Without it every caller drives ``TorchUniverse.apply_changes*`` /
``TorchDoc.change`` directly: one chatty session's per-keystroke launches
starve everyone else, every odd batch shape is a launch of its own, and
there is no latency contract between "change submitted" and "patches
returned".  Server-assisted collaboration frameworks (Collabs, PAPERS.md)
and fast batched merging (Eg-walker) argue the same point: the win comes
from an explicit serving layer that aggregates many clients into few
well-shaped merge operations — the continuous-batching shape of a
production inference stack, applied to CRDT ingest.

The pieces:

- **Sessions** (:class:`ServeSession`): one per fronted replica.  Clients
  ``submit(changes)`` into the session's admission lane and get a
  :class:`Submission` future back; the future resolves with exactly the
  patches *that submission's* changes emitted.  Per-session backpressure
  reuses the ChangeQueue policy vocabulary (``block`` / ``coalesce`` /
  ``shed`` — runtime/queue.py) over a lane bound.
- **The scheduler** (:class:`ServePlane`): forms cross-session cohorts and
  flushes when either the pow2 batch target (``batch_target``, default 64)
  fills or the oldest admitted submission ages past ``deadline_ms``
  (default 25).  Fairness is deficit-weighted
  round-robin across sessions (deficits persist across flushes, so a
  100:1 hot session cannot starve a cold one past its next cohort), with
  a strict priority lane: ``interactive`` sessions are served before
  ``bulk`` (anti-entropy backfill) every flush.
- **One launch per cohort**: the flush calls
  ``TorchUniverse.apply_changes_with_patches(..., with_positions=True)`` —
  one causally-gated device launch for every admitted session — and
  splits each replica's positioned patch stream back into exact
  per-submission lists by flat-op-position ranges.  Because replicas are
  independent and per-session admission preserves FIFO, every session's
  concatenated stream is **byte-identical** to ingesting its changes one
  at a time (``sync.causal_order`` semantics; tests/test_serve.py pins
  the differential, including under seeded chaos and the oracle-degrade
  path).
- **Causal gating at admission**: cohort formation classifies each
  submission against a working clock (duplicates drop exactly like the
  universe gate; causally-unready submissions defer in the lane and
  retry next flush — ``serve.deferred``), so one session's gap can never
  fail another session's launch.
- **Health-plane routing**: when the ``device_launch`` breaker is OPEN,
  ``on_open`` picks the policy — ``degrade`` (default) flushes anyway and
  lets ingest fast-fail: into the oracle CPU path where the universe
  degrades (``PERITEXT_DEGRADE``; off by default on the card), else the
  cohort's submissions fail with ``DeviceLaunchError``; ``hold`` parks
  cohorts until the breaker recovers, shedding them (``ServeShedError``)
  once the oldest submission ages past the deadline.
- **Observability**: every submission mints/joins a ``serve.submit``
  causal lane (admission → flush → launch/readback/assembly → resolve
  renders arrow-linked in Perfetto), resolution feeds the
  ``e2e.admit_to_applied`` histogram, ``serve.*`` counters ride into
  ``telemetry.summary()``, deadline-miss streaks and shed events fire
  black-box dumps, and the ``serve_admit`` fault site joins the chaos
  grammar (fail/wedge hit submit; drop/dup/reorder filter the submitted
  changes).
- **Shape bucketing**: the batch target is pow2 and the underlying encode
  paths pad rows to pow2 buckets, so steady-state cohorts reuse a handful
  of launch shapes; the plane tracks the (replicas, capacity, ops-bucket,
  marks-bucket) shape key per flush as ``serve.compile_cache_{hit,miss}``
  (the JAX package's names; nothing is compiled per shape here, so they
  count shape buckets seen again and new).

Disabled-telemetry contract: every serve site guards on the single
``telemetry.enabled`` attribute (one attr check, no call, no allocation —
tests/test_telemetry.py pins it), and a telemetry-on serving run is
byte-identical to off.

Threading: ``ServePlane(..., start=True)`` runs the scheduler on a daemon
thread (submissions may ``wait=True`` / ``Submission.result()``).
``start=False`` is manual mode — tests, the fuzzer and A/B harnesses call
``step()`` / ``drain()`` on their own thread for deterministic schedules.
The plane assumes it owns its universe's ingest (interleaving direct
``apply_changes*`` calls between flushes is allowed; concurrent ones are
not).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.runtime.queue import POLICIES, QueueFullError
from peritext_tpu_torch.runtime.sync import causal_order

Change = Dict[str, Any]
Patch = Dict[str, Any]

_log = logging.getLogger(__name__)

INTERACTIVE = "interactive"
BULK = "bulk"
_PRIORITIES = (INTERACTIVE, BULK)

ON_OPEN_DEGRADE = "degrade"
ON_OPEN_HOLD = "hold"
_ON_OPEN = (ON_OPEN_DEGRADE, ON_OPEN_HOLD)

# Consecutive deadline misses that constitute a storm worth a post-mortem.
_MISS_STORM = 8


class ServeShedError(RuntimeError):
    """A submission was shed before it could be applied (lane backpressure
    under the ``shed`` policy, or the hold-until-deadline breaker policy
    giving up on a sick backend)."""


class ServeClosedError(RuntimeError):
    """The serving plane was closed with this submission still pending."""


def _bucket_pow2(n: int) -> int:
    out = 1
    while out < n:
        out *= 2
    return out


def cohort_shape_key(universe: Any, per_replica: Dict[str, List[Change]]) -> tuple:
    """The launch-shape key of one cohort: replica count and device
    capacity plus pow2 buckets of the widest per-replica op and mark-row
    counts — the axes that set the launch's tensor shapes (encode pads
    rows to these buckets).  THE one definition, shared by the
    plane's ``serve.compile_cache_{hit,miss}`` tracking and the serve A/B
    harness's naive-leg shape count, so the two sides always compare the
    same key."""
    max_ops = 0
    max_marks = 0
    for stream in per_replica.values():
        ops = sum(len(c["ops"]) for c in stream)
        marks = sum(
            1
            for c in stream
            for op in c["ops"]
            if op.get("action") in ("addMark", "removeMark")
        )
        max_ops = max(max_ops, ops)
        max_marks = max(max_marks, marks)
    return (
        len(universe.replica_ids),
        universe.capacity,
        _bucket_pow2(max(1, max_ops)),
        _bucket_pow2(max(1, max_marks)),
    )


def _classify(
    changes: Sequence[Change], clock: Dict[str, int]
) -> Tuple[Optional[List[Change]], Optional[Dict[str, int]]]:
    """Dispatchability of one submission against a working clock.

    Mirrors the universe gate exactly (ops/universe.py ``_gate``):
    already-seen seqs drop as duplicates, then :func:`causal_order`
    arranges the fresh remainder in the delivery-order-preserving causal
    order the launch will use.  Returns ``(ordered_fresh, advanced_clock)``
    when the whole submission is dispatchable, or ``(None, None)`` when
    any fresh change's dependencies are unsatisfiable from this clock (the
    whole submission defers in the lane — splitting it would tear the
    session's stream).  Because each admitted submission's ordered changes
    are sequentially ready from the working clock, the flush's
    concatenated per-replica stream passes the universe gate unchanged —
    which is what makes the per-submission flat-op position ranges exact.
    ``clock`` is never mutated.
    """
    seen = set()
    fresh: List[Change] = []
    for c in changes:
        key = (c["actor"], c["seq"])
        if c["seq"] > clock.get(c["actor"], 0) and key not in seen:
            seen.add(key)
            fresh.append(c)
    if not fresh:
        return [], clock
    try:
        ordered = causal_order(fresh, clock)
    except ValueError:
        return None, None
    advanced = dict(clock)
    for c in ordered:
        advanced[c["actor"]] = c["seq"]
    return ordered, advanced


class Submission:
    """One ``submit()`` call's future.  Resolves with exactly the patches
    this submission's changes emitted (in stream order), or raises the
    admission/flush error.  Under the ``coalesce`` policy a submit at the
    bound may return the lane-tail submission instead of a fresh one —
    the merged changes then resolve jointly through the shared handle."""

    __slots__ = (
        "session",
        "changes",
        "ctx",
        "t0",
        "t_done",
        "lat_class",
        "fresh",
        "flush_seq",
        "_range",
        "_event",
        "_patches",
        "_error",
    )

    def __init__(self, session: "ServeSession", changes: List[Change], ctx: Any):
        self.session = session
        self.changes = changes
        self.ctx = ctx
        self.t0 = time.perf_counter()
        self.t_done: Optional[float] = None  # perf_counter at resolution
        # Warm/cold admission class (runtime/lifecycle.py): "cold" when this
        # submission's admission had to hydrate an evicted doc first, "warm"
        # for lifecycle-managed resident admissions, None otherwise.  Feeds
        # the e2e.admit_to_applied_{warm,cold} split histograms.
        self.lat_class: Optional[str] = None
        self.fresh: Optional[List[Change]] = None
        self.flush_seq: Optional[int] = None
        self._range: Tuple[int, int] = (0, 0)
        self._event = threading.Event()
        self._patches: Optional[List[Patch]] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[Patch]:
        """Block until applied; returns this submission's patches (raises
        the admission/flush error instead when it failed)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"submission to session {self.session.name!r} still pending "
                f"after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._patches if self._patches is not None else []

    def _resolve(self, patches: List[Patch]) -> None:
        self._patches = patches
        self.t_done = time.perf_counter()
        self._event.set()

    def _reject(self, error: BaseException) -> None:
        self._error = error
        self.t_done = time.perf_counter()
        self._event.set()


class ServeSession:
    """One client session's admission lane, fronting exactly one universe
    replica.  Construct via :meth:`ServePlane.session`."""

    def __init__(
        self,
        plane: "ServePlane",
        name: str,
        replica: str,
        weight: int,
        priority: str,
        bound: int,
        policy: str,
        block_timeout: Optional[float],
        record_stream: bool,
    ) -> None:
        if priority not in _PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r}; known: {', '.join(_PRIORITIES)}"
            )
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; known policies: {', '.join(POLICIES)}"
            )
        if weight < 1:
            raise ValueError(f"weight must be >= 1, got {weight}")
        self._plane = plane
        self.name = name
        self.replica = replica
        self.weight = weight
        self.priority = priority
        self.bound = max(0, bound)
        self.policy = policy
        self.block_timeout = block_timeout
        # The lane: pending submissions, FIFO.  A list, not a deque —
        # cohort formation removes from arbitrary positions (causally
        # unready submissions are skipped in place).
        self._lane: List[Submission] = []
        self._pending = 0  # pending changes across the lane
        self._deficit = 0.0  # DWRR credit, persists across flushes
        # Optional per-session patch log (admission order): the fuzzer and
        # the differential tests accumulate it; off by default so long-
        # lived sessions don't grow without bound.
        self.patch_log: Optional[List[Patch]] = [] if record_stream else None

    def submit(
        self,
        changes: Sequence[Change],
        wait: bool = False,
        timeout: Optional[float] = None,
    ):
        """Admit a batch of changes.  Returns the :class:`Submission`
        future (or, with ``wait=True``, blocks and returns the patches)."""
        return self._plane._submit(self, list(changes), wait, timeout)

    def pending(self) -> int:
        """Pending (admitted, not yet applied) changes in this lane."""
        with self._plane._lock:
            return self._pending


class ServePlane:
    """The serving plane over one :class:`TorchUniverse` (see the module
    docstring).  ``batch_target`` is pow2-bucketed; ``deadline_ms`` is the
    age of the oldest pending submission that forces a flush; ``quantum``
    is the DWRR credit per round."""

    def __init__(
        self,
        universe: Any,
        *,
        batch_target: int = 64,
        deadline_ms: float = 25.0,
        quantum: int = 8,
        on_open: str = ON_OPEN_DEGRADE,
        start: bool = True,
        name: str = "serve",
        shard: Optional[int] = None,
    ) -> None:
        self._uni = universe
        self.name = name
        # Shard id when this plane is one slice of a ShardedServePlane
        # (runtime/serve_shard.py): stamps the serve.submit causal lanes
        # and the serve.flush spans, and keys the per-shard
        # serve.shard.<i>.compile_cache_* counters (the plane-global
        # aggregate stays).
        self.shard = shard
        self._batch_target = _bucket_pow2(max(1, batch_target))
        self._deadline_s = deadline_ms / 1000.0
        self._quantum = max(1, quantum)
        if on_open not in _ON_OPEN:
            raise ValueError(
                f"unknown on_open policy {on_open!r}; known: {', '.join(_ON_OPEN)}"
            )
        self._on_open = on_open
        self._sessions: Dict[str, ServeSession] = {}
        self._by_replica: Dict[str, ServeSession] = {}
        self._lock = threading.RLock()
        # One condition for all plane state: submitters notify the
        # scheduler, flush completion notifies blocked submitters and
        # drain waiters.
        self._work = threading.Condition(self._lock)
        self._flush_seq = 0
        # True while a formed cohort's launch is in flight OUTSIDE the
        # lock (step() releases _work for the device call).  run_quiesced
        # waits on it: universe mutations (replica add/drop)
        # must never interleave with a launch that is reading the state.
        self._flush_busy = False
        self._closed = False
        self._drain_req = 0
        self._miss_streak = 0
        self._storm_dumped = False
        self._shapes: set = set()
        # Plane-local mirrors of the serve.* telemetry (available with
        # collection off; the A/B harness and tests read them directly).
        self.stats: Dict[str, int] = {
            "submits": 0,
            "submitted_changes": 0,
            "flushes": 0,
            "flushed_changes": 0,
            "coalesced": 0,
            "shed": 0,
            "deferred": 0,
            "held": 0,
            "deadline_misses": 0,
            "compile_cache_hits": 0,
            "compile_cache_misses": 0,
            "flush_failures": 0,
        }
        self._thread: Optional[threading.Thread] = None
        # Live ops surface: the plane contributes per-session lane depth +
        # DWRR deficit to telemetry.status().  Held as a weakref — a
        # dropped plane silently leaves the surface.
        telemetry.register_status_source("serve", self._status)
        if start:
            self.start()

    def _status(self) -> Dict[str, Any]:
        """This plane's slice of :func:`telemetry.status`: per-session
        admission-lane occupancy (depth in changes, lane entries, DWRR
        deficit, priority/weight) plus the flush/miss/shed tallies an
        operator watches, read under the plane lock."""
        with self._lock:
            sessions = {
                name: {
                    "depth": s._pending,
                    "lane": len(s._lane),
                    "deficit": round(s._deficit, 3),
                    "priority": s.priority,
                    "weight": s.weight,
                }
                for name, s in self._sessions.items()
            }
            out: Dict[str, Any] = {
                "plane": self.name,
                "sessions": sessions,
                "flushes": self.stats["flushes"],
                "deadline_misses": self.stats["deadline_misses"],
                "deferred": self.stats["deferred"],
                "shed": self.stats["shed"],
                "compiled_shapes": len(self._shapes),
                "closed": self._closed,
            }
            if self.shard is not None:
                out["shard"] = self.shard
            return out

    # -- sessions ------------------------------------------------------------

    def session(
        self,
        name: str,
        replica: str,
        *,
        weight: int = 1,
        priority: str = INTERACTIVE,
        bound: int = 0,
        policy: str = "block",
        block_timeout: Optional[float] = None,
        record_stream: bool = False,
    ) -> ServeSession:
        """Open a session fronting ``replica`` (must exist in the universe;
        one session per replica — the per-session patch stream IS the
        replica's stream, so two writers would alias it).  ``bound`` caps
        the lane's pending changes (0 = unbounded) and ``policy`` (a
        ``runtime.queue`` policy) says what a submit at the bound does."""
        if replica not in self._uni.index_of:
            raise KeyError(f"unknown replica {replica!r}")
        with self._lock:
            if name in self._sessions:
                raise ValueError(f"session {name!r} already exists")
            if replica in self._by_replica:
                raise ValueError(
                    f"replica {replica!r} is already fronted by session "
                    f"{self._by_replica[replica].name!r}"
                )
            s = ServeSession(
                self, name, replica, weight, priority, bound, policy,
                block_timeout, record_stream,
            )
            self._sessions[name] = s
            self._by_replica[replica] = s
            if telemetry.enabled:
                telemetry.gauge("serve.sessions", len(self._sessions))
        return s

    def evict_session(self, name: str) -> List[Submission]:
        """Detach a session from this plane (live migration, elastic.py;
        eviction, lifecycle.py).

        Runs under ``run_quiesced`` semantics on the caller's side: no
        cohort may be forming while a session leaves mid-protocol.  Any
        submissions still in the lane are popped and RETURNED — unresolved,
        so the caller can graft them onto another lane and the callers'
        futures still resolve with their exact patches.  The replica row
        itself stays in the universe; evacuating it is the caller's job."""
        with self._lock:
            s = self._sessions.pop(name, None)
            if s is None:
                raise KeyError(f"unknown session {name!r}")
            self._by_replica.pop(s.replica, None)
            leftover = list(s._lane)
            s._lane = []
            s._pending = 0
            if telemetry.enabled:
                telemetry.gauge("serve.sessions", len(self._sessions))
        return leftover

    # -- admission -----------------------------------------------------------

    def _submit(
        self,
        session: ServeSession,
        changes: List[Change],
        wait: bool,
        timeout: Optional[float],
    ):
        if self._closed:
            raise ServeClosedError(f"serving plane {self.name!r} is closed")
        # Chaos plane: fail/wedge the admission itself, then drop/dup/
        # reorder the submitted changes (client->server transport loss).
        faults.fire("serve_admit")
        changes = faults.filter_stream("serve_admit", changes, stream=session.name)
        if telemetry.enabled:
            flow_meta: Dict[str, Any] = {
                "session": session.name, "changes": len(changes),
            }
            if self.shard is not None:
                flow_meta["shard"] = self.shard
            ctx = telemetry.flow("serve.submit", **flow_meta)
        else:
            ctx = None
        sub = Submission(session, changes, ctx)
        shed: List[Submission] = []
        with telemetry.span("serve.admit", session=session.name, changes=len(changes)):
            telemetry.flow_point(ctx)
            try:
                with self._work:
                    if self._closed:
                        # Re-check under the lock: a close() racing this
                        # submit must not strand the submission in a lane
                        # nothing will ever flush.
                        raise ServeClosedError(
                            f"serving plane {self.name!r} is closed"
                        )
                    sub = self._admit_locked(session, sub, shed)
                    # Mutate the telemetry-off stats mirror under the lock
                    # too — concurrent submitter threads must not lose
                    # increments.
                    self.stats["submits"] += 1
                    self.stats["submitted_changes"] += len(changes)
                    depth = sum(s._pending for s in self._sessions.values())
                    self._work.notify_all()
            except BaseException:
                telemetry.flow_point(ctx, terminal=True, outcome="rejected")
                raise
            if shed:
                # Outside the lock: rejection + the black-box dump do file
                # I/O, which must not stall every other session's submit.
                self._reject_shed(
                    shed, f"lane bound {session.bound} exceeded"
                )
        if telemetry.enabled:
            telemetry.counter("serve.submits")
            telemetry.counter("serve.submitted_changes", len(changes))
            telemetry.gauge_max("serve.depth_max", depth)
        if wait:
            return sub.result(timeout=timeout)
        return sub

    def _admit_locked(
        self, session: ServeSession, sub: Submission, shed_out: List[Submission]
    ) -> Submission:
        n = len(sub.changes)
        if n == 0:
            # An empty submission has nothing to apply: resolve now (the
            # lane must never hold zero-cost entries — DWRR costs are >=1).
            sub._resolve([])
            telemetry.flow_point(sub.ctx, terminal=True, outcome="empty")
            return sub
        bound = session.bound
        if not bound:
            session._lane.append(sub)
            session._pending += n
            return sub
        if session.policy == "block":
            self._admit_blocking_locked(session, n)
            session._lane.append(sub)
            session._pending += n
            return sub
        if session.policy == "coalesce":
            # The bound counts lane ENTRIES (submissions), like the queue's
            # coalesce counts queue entries: at the bound, the new changes
            # merge losslessly into the lane tail and the caller shares the
            # tail's future.
            if len(session._lane) >= bound and session._lane:
                tail = session._lane[-1]
                tail.changes.extend(sub.changes)
                session._pending += n
                self.stats["coalesced"] += n
                if telemetry.enabled:
                    telemetry.counter("serve.coalesced", n)
                telemetry.flow_point(sub.ctx, terminal=True, outcome="coalesced")
                return tail
            session._lane.append(sub)
            session._pending += n
            return sub
        # shed: admit, then drop oldest submissions over the bound.  A
        # single oversized occupant overflows softly (never self-shed the
        # only pending work).  Victims are collected for the caller to
        # reject AFTER the lock releases (the dump does file I/O).
        session._lane.append(sub)
        session._pending += n
        while session._pending > bound and len(session._lane) > 1:
            victim = session._lane.pop(0)
            session._pending -= len(victim.changes)
            shed_out.append(victim)
        return sub

    def _admit_blocking_locked(self, session: ServeSession, n: int) -> None:
        deadline = (
            None
            if session.block_timeout is None
            else time.monotonic() + session.block_timeout
        )
        t0: Optional[float] = None
        while session._pending > 0 and session._pending + n > session.bound:
            if self._closed:
                # close() emptied the lanes and notified: admitting now
                # would strand the submission in a plane nothing flushes.
                raise ServeClosedError(
                    f"serving plane {self.name!r} closed while this submit "
                    "was blocked at the lane bound"
                )
            if t0 is None:
                t0 = time.perf_counter()
                if telemetry.enabled:
                    telemetry.counter("serve.blocked")
            if deadline is None:
                self._work.wait()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._work.wait(remaining):
                    if telemetry.enabled:
                        telemetry.observe(
                            "serve.block_seconds", time.perf_counter() - t0
                        )
                    raise QueueFullError(
                        f"session {session.name!r} still at bound "
                        f"{session.bound} after {session.block_timeout}s"
                    )
        if self._closed:
            # The wait may have been released BY close() zeroing the lanes.
            raise ServeClosedError(
                f"serving plane {self.name!r} closed while this submit "
                "was blocked at the lane bound"
            )
        if t0 is not None and telemetry.enabled:
            telemetry.observe("serve.block_seconds", time.perf_counter() - t0)

    def _reject_shed(self, shed: List[Submission], why: str) -> None:
        """Resolve shed submissions with ServeShedError + post-mortem.
        Runs OUTSIDE the plane lock (file I/O below); the stats mirror
        mutation re-takes it so concurrent submitters cannot lose the
        increment."""
        total = sum(len(s.changes) for s in shed)
        with self._lock:
            self.stats["shed"] += total
        if telemetry.enabled:
            telemetry.counter("serve.shed", total)
            telemetry.record("serve.shed", outcome="shed", changes=total)
        _log.warning(
            "serving plane %s shed %d change(s) across %d submission(s): %s",
            self.name, total, len(shed), why,
        )
        with telemetry.span("serve.shed", changes=total):
            for sub in shed:
                sub._reject(ServeShedError(
                    f"submission to session {sub.session.name!r} shed: {why}"
                ))
                telemetry.flow_point(sub.ctx, terminal=True, outcome="shed")
        # A shed IS the storm signal: admitted work was dropped on the
        # floor, which only happens when the plane is drowning or the
        # backend is sick past its deadline.
        telemetry.blackbox_dump(
            "serve_shed_storm", plane=self.name, shed=total, why=why
        )

    # -- cohort formation ----------------------------------------------------

    def _depth_oldest_locked(self) -> Tuple[int, float]:
        depth = 0
        oldest = None
        for s in self._sessions.values():
            depth += s._pending
            if s._lane and (oldest is None or s._lane[0].t0 < oldest):
                oldest = s._lane[0].t0
        age = 0.0 if oldest is None else time.perf_counter() - oldest
        return depth, age

    def _form_locked(self) -> Optional[Dict[str, Any]]:
        """Pop one cohort under DWRR + the causal admission gate.

        Per priority class (interactive first), rounds of deficit-weighted
        round-robin: each non-empty lane accrues ``quantum * weight``
        credit per round and spends it on dispatchable submissions in lane
        order (causally-unready ones are skipped in place and retried next
        flush — ``serve.deferred``).  Deficits persist across flushes, so
        heavy lanes pay their debt and a cold session's submission rides
        the very next cohort.  If a full sweep admits nothing while
        dispatchable work exists (an oversized submission), the first
        dispatchable submission force-admits — soft overflow, no
        starvation, no empty-flush spin."""
        ordered_sessions = list(self._sessions.values())
        if not any(s._lane for s in ordered_sessions):
            return None
        budget = self._batch_target
        admitted: List[Submission] = []
        clocks: Dict[str, Dict[str, int]] = {}
        # Per-formation classification cache: an unready submission is
        # re-classified (a causal_order run) only when its replica's
        # working clock has advanced since last time — otherwise repeated
        # DWRR rounds would re-run the gate (and re-count serve.deferred)
        # once per round for the same stuck submission.
        clock_ver: Dict[str, int] = {}
        unready_at: Dict[int, int] = {}
        deferred = 0

        def working_clock(replica: str) -> Dict[str, int]:
            clock = clocks.get(replica)
            if clock is None:
                clock = clocks[replica] = dict(
                    self._uni.clocks[self._uni.index_of[replica]]
                )
            return clock

        def try_take(s: ServeSession, enforce_deficit: bool) -> bool:
            nonlocal budget, deferred
            took = False
            i = 0
            while i < len(s._lane) and budget > 0:
                sub = s._lane[i]
                cost = len(sub.changes)
                if enforce_deficit and s._deficit < cost:
                    break  # out of credit this round; it carries over
                ver = clock_ver.get(s.replica, 0)
                if unready_at.get(id(sub)) == ver:
                    i += 1  # already judged unready at this clock state
                    continue
                fresh, new_clock = _classify(sub.changes, working_clock(s.replica))
                if fresh is None:
                    unready_at[id(sub)] = ver
                    i += 1  # causally unready: stays in lane, retried later
                    deferred += 1
                    continue
                if cost > budget and admitted:
                    break  # doesn't fit this cohort; next flush
                clocks[s.replica] = (
                    dict(new_clock) if new_clock is not None else clocks[s.replica]
                )
                clock_ver[s.replica] = ver + 1
                del s._lane[i]
                s._pending -= cost
                s._deficit = max(0.0, s._deficit - cost)
                budget -= cost
                sub.fresh = fresh
                admitted.append(sub)
                took = True
                if not enforce_deficit:
                    return True  # force-admit exactly one
            return took

        for priority in _PRIORITIES:
            lanes = [s for s in ordered_sessions if s.priority == priority]
            while budget > 0 and any(s._lane for s in lanes):
                progressed = False
                for s in lanes:
                    if budget <= 0:
                        break
                    if not s._lane:
                        s._deficit = 0.0  # idle lanes must not hoard credit
                        continue
                    s._deficit += self._quantum * s.weight
                    if try_take(s, enforce_deficit=True):
                        progressed = True
                if not progressed:
                    break
        if not admitted:
            # Everything pending is either causally deferred or oversized;
            # force-admit one oversized submission so the plane never spins.
            for s in ordered_sessions:
                if s._lane and try_take(s, enforce_deficit=False):
                    break
        if deferred:
            self.stats["deferred"] += deferred
            if telemetry.enabled:
                telemetry.counter("serve.deferred", deferred)
        if not admitted:
            return None
        # Per-replica cohort streams + per-submission flat-op ranges (the
        # positions the universe stamps count ONLY gated-fresh ops, which
        # is exactly what ``fresh`` holds).
        per_replica: Dict[str, List[Change]] = {}
        cursor: Dict[str, int] = {}
        for sub in admitted:
            fresh = sub.fresh or []
            stream = per_replica.setdefault(sub.session.replica, [])
            lo = cursor.get(sub.session.replica, 0)
            hi = lo + sum(len(c["ops"]) for c in fresh)
            sub._range = (lo, hi)
            cursor[sub.session.replica] = hi
            stream.extend(fresh)
        return {"subs": admitted, "per_replica": per_replica}

    # -- flushing ------------------------------------------------------------

    def _flush(self, formed: Dict[str, Any]) -> None:
        subs: List[Submission] = formed["subs"]
        per_replica = formed["per_replica"]
        n_changes = sum(len(s.changes) for s in subs)
        self._flush_seq += 1
        seq = self._flush_seq
        shape = cohort_shape_key(self._uni, per_replica)
        with self._lock:
            # _flush runs outside _work (step released it before the
            # launch); shape_keys()/stats readers on other threads need
            # the mutation fenced.
            hit = shape in self._shapes
            self._shapes.add(shape)
            self.stats["compile_cache_hits" if hit else "compile_cache_misses"] += 1
        if telemetry.enabled:
            suffix = "compile_cache_hit" if hit else "compile_cache_miss"
            telemetry.counter("serve." + suffix)
            if self.shard is not None:
                # Per-shard attribution, keyed beside the aggregate above.
                telemetry.counter(f"serve.shard.{self.shard}.{suffix}")
        ctxs = tuple(s.ctx for s in subs if s.ctx is not None)
        err: Optional[BaseException] = None
        out = None
        # Windowed-merge attribution: the cohort's window is the union of
        # its members' (one census over the gated batch), so engagement is
        # read off the universe's stats around the launch.
        windowed0 = self._uni.stats.get("windowed_launches", 0)
        t0 = time.perf_counter()
        span_meta: Dict[str, Any] = {
            "flush": seq, "sessions": len(per_replica), "changes": n_changes,
        }
        if self.shard is not None:
            span_meta["shard"] = self.shard
        with telemetry.span("serve.flush", **span_meta):
            for ctx in ctxs:
                telemetry.flow_point(ctx)
            with telemetry.flowing(ctxs):
                try:
                    out = self._uni.apply_changes_with_patches(
                        per_replica, with_positions=True
                    )
                except BaseException as exc:
                    err = exc
            flush_s = time.perf_counter() - t0
            with telemetry.span("serve.resolve", flush=seq):
                if err is None:
                    self._resolve_subs(subs, out, seq, flush_s)
                else:
                    for sub in subs:
                        sub._reject(err)
                        telemetry.flow_point(
                            sub.ctx, terminal=True, outcome="error"
                        )
        if err is not None:
            # The universe's all-or-nothing contract held (nothing
            # committed); the popped submissions carry the error to their
            # callers, who may resubmit.
            self.stats["flush_failures"] += 1
            if telemetry.enabled:
                telemetry.counter("serve.flush_failures")
                telemetry.record(
                    "serve.flush", outcome="error", flush=seq,
                    error=type(err).__name__,
                )
            with self._work:
                self._work.notify_all()
            raise err
        self.stats["flushes"] += 1
        self.stats["flushed_changes"] += n_changes
        flush_windowed = self._uni.stats.get("windowed_launches", 0) > windowed0
        if flush_windowed:
            self.stats["windowed_flushes"] = self.stats.get("windowed_flushes", 0) + 1
        if telemetry.enabled:
            telemetry.counter("serve.flushes")
            telemetry.counter("serve.flushed_changes", n_changes)
            if flush_windowed:
                telemetry.counter("serve.windowed_flushes")
            telemetry.observe("serve.flush_seconds", flush_s)
            telemetry.observe("serve.batch_changes", n_changes)
            telemetry.record(
                "serve.flush", outcome="applied", flush=seq, changes=n_changes
            )
        with self._work:
            self._work.notify_all()  # blocked submitters + drain waiters

    def _resolve_subs(self, subs, out, seq, flush_s: float) -> None:
        """Split each replica's positioned stream into per-submission
        patch lists (ranges are ascending per replica in admission order —
        one pointer walk per replica) and resolve the futures."""
        ptr: Dict[str, int] = {}
        now = time.perf_counter()
        window = self._deadline_s + flush_s
        misses = 0
        for sub in subs:
            pairs = out[sub.session.replica]
            i = ptr.get(sub.session.replica, 0)
            lo, hi = sub._range
            start = i
            while i < len(pairs) and pairs[i][0] < hi:
                i += 1
            ptr[sub.session.replica] = i
            patches = [p for _, p in pairs[start:i]]
            sub.flush_seq = seq
            log = sub.session.patch_log
            if log is not None:
                log.extend(patches)
            sub._resolve(patches)
            elapsed = now - sub.t0
            if telemetry.enabled:
                telemetry.observe("e2e.admit_to_applied", elapsed)
                if sub.lat_class is not None:
                    telemetry.observe(
                        f"e2e.admit_to_applied_{sub.lat_class}", elapsed
                    )
            if elapsed > window:
                misses += 1
                self.stats["deadline_misses"] += 1
                if telemetry.enabled:
                    telemetry.counter("serve.deadline_miss")
            telemetry.flow_point(sub.ctx, terminal=True)
        # Storm detection: a sustained run of deadline misses is the
        # "serving plane is drowning" post-mortem moment.
        if misses:
            self._miss_streak += misses
            if self._miss_streak >= _MISS_STORM and not self._storm_dumped:
                self._storm_dumped = True
                telemetry.blackbox_dump(
                    "serve_deadline_storm",
                    plane=self.name,
                    consecutive_misses=self._miss_streak,
                    deadline_ms=self._deadline_s * 1000.0,
                )
        else:
            self._miss_streak = 0
            self._storm_dumped = False

    # -- breaker routing -----------------------------------------------------

    def _holding_locked(self) -> bool:
        if self._on_open != ON_OPEN_HOLD:
            return False
        br = health.breaker("device_launch")
        return br is not None and br.state == health.OPEN

    def _pop_all_locked(self) -> List[Submission]:
        popped: List[Submission] = []
        for s in self._sessions.values():
            popped.extend(s._lane)
            s._lane = []
            s._pending = 0
        return popped

    # -- driving -------------------------------------------------------------

    def step(self) -> bool:
        """Form and flush one cohort on the calling thread (manual mode;
        the scheduler thread calls this too).  Returns True when a flush —
        or a hold-policy shed — happened, False when there was nothing
        dispatchable (empty lanes, everything causally deferred, or the
        hold policy parking a cohort inside its deadline)."""
        with self._work:
            if self._holding_locked():
                _, age = self._depth_oldest_locked()
                if age <= self._deadline_s:
                    self.stats["held"] += 1
                    if telemetry.enabled:
                        telemetry.counter("serve.held")
                    return False
                shed = self._pop_all_locked()
                self._work.notify_all()
            else:
                shed = None
                formed = self._form_locked()
                if formed is not None:
                    # Mark the launch in flight BEFORE releasing the lock:
                    # run_quiesced holds _work and waits for this flag, so
                    # no universe mutation can interleave with the flush.
                    self._flush_busy = True
        if shed is not None:
            if shed:
                with telemetry.span("serve.hold_shed", plane=self.name):
                    self._reject_shed(
                        shed,
                        "device_launch breaker open past the "
                        f"{self._deadline_s * 1000:.0f}ms deadline (hold policy)",
                    )
            return bool(shed)
        if formed is None:
            return False
        try:
            self._flush(formed)
        finally:
            with self._work:
                self._flush_busy = False
                self._work.notify_all()
        return True

    def shape_keys(self) -> frozenset:
        """The distinct cohort shape keys this plane has flushed (the
        launch-shape spread behind ``serve.compile_cache_*``)."""
        with self._lock:
            return frozenset(self._shapes)

    def run_quiesced(self, fn):
        """Run ``fn`` while no cohort launch is in flight and none can
        start (cohort formation takes the same lock this holds).  Universe
        mutations under a live plane (``add_replicas``, ``drop_replicas``)
        go through this barrier: they rebuild the device state a
        concurrent launch would be reading."""
        with self._work:
            while self._flush_busy:
                self._work.wait()
            return fn()

    def drain(self, max_steps: int = 1000) -> int:
        """Flush until every lane empties or no progress is possible
        (manual mode).  Returns the number of still-pending submissions
        (0 = fully drained; >0 means causally-undeliverable leftovers)."""
        for _ in range(max_steps):
            with self._lock:
                if not any(s._lane for s in self._sessions.values()):
                    return 0
            if not self.step():
                break
        with self._lock:
            return sum(len(s._lane) for s in self._sessions.values())

    # -- the scheduler thread ------------------------------------------------

    def start(self) -> None:
        """Start the scheduler thread (idempotent)."""
        with self._lock:
            if self._thread is not None or self._closed:
                return
            self._thread = threading.Thread(
                target=self._run, name=f"peritext-{self.name}-scheduler", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._work:
                while True:
                    if self._closed:
                        return
                    depth, age = self._depth_oldest_locked()
                    if depth == 0:
                        self._work.wait(0.05)
                        continue
                    if (
                        depth >= self._batch_target
                        or age >= self._deadline_s
                        or self._drain_req
                    ):
                        break
                    self._work.wait(max(0.001, self._deadline_s - age))
            try:
                worked = self.step()
            except Exception:
                # The failed flush already rejected its submissions; the
                # scheduler must survive to serve the next cohort.
                worked = True
                _log.warning(
                    "serving plane %s flush failed; submissions carry the "
                    "error", self.name, exc_info=True,
                )
            if not worked:
                # Pending work past the deadline but nothing dispatchable
                # (everything causally deferred, or the hold policy parking
                # a cohort): without a wait the loop would spin hot re-
                # scanning the lanes.  A fresh submit notifies _work, so
                # the gap-filling change still wakes us immediately.
                with self._work:
                    self._work.wait(max(0.001, self._deadline_s))

    def flush_and_wait(self, timeout: float = 30.0) -> None:
        """Threaded-mode drain: ask the scheduler to flush everything
        pending and wait until the lanes are empty AND no flush is in
        flight.  (Admitted submissions leave their lane at cohort
        FORMATION, before the launch — an empty lane alone does not mean
        the last cohort's effects are visible, which bites callers that
        submitted without wait=True.)"""
        deadline = time.monotonic() + timeout
        with self._work:
            self._drain_req += 1
            self._work.notify_all()
            try:
                while (
                    any(s._lane for s in self._sessions.values())
                    or self._flush_busy
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"serving plane {self.name!r} did not drain "
                            f"within {timeout}s"
                        )
                    self._work.wait(min(remaining, 0.05))
            finally:
                self._drain_req -= 1

    def close(self, reject_pending: bool = True) -> None:
        """Stop the plane.  Pending submissions resolve with
        :class:`ServeClosedError` (``reject_pending=False`` leaves them
        unresolved for a caller that already drained)."""
        with self._work:
            self._closed = True
            self._work.notify_all()
            leftover = self._pop_all_locked() if reject_pending else []
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if leftover:
            # Inside a span so the terminal flow events bind to a slice.
            with telemetry.span("serve.close", pending=len(leftover)):
                for sub in leftover:
                    sub._reject(ServeClosedError(
                        f"serving plane {self.name!r} closed with the "
                        "submission pending"
                    ))
                    telemetry.flow_point(sub.ctx, terminal=True, outcome="closed")

    def __enter__(self) -> "ServePlane":
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.close()
        return False
