"""Sharded serving: partition sessions across N universe shards.

A copy of ``peritext_tpu/runtime/serve_shard.py`` bound to the PyTorch
port: each shard is one :class:`~peritext_tpu_torch.ops.universe.
TorchUniverse` behind one :class:`~peritext_tpu_torch.runtime.serve.
ServePlane` scheduler, and the facade

- **partitions sessions across the shards** (cohort launches on different
  shards proceed independently — per-launch device work scales with the
  SHARD width, not the fleet width);
- **places shard i on slice i of ``parallel.mesh.mesh_slices(shards,
  devices)``**, its universe on the slice's lead device (with more shards
  than devices the slices are singletons round-robin): ``devices=None``
  means every visible CUDA device, and with none visible the first
  session raises instead of moving to the CPU (tests pass
  ``devices=["cpu"]`` or a ``universe_factory``).  With
  ``mesh_within_shard=True`` a shard whose slice has two or more devices
  lays its universe's replica axis over them
  (``TorchUniverse.shard(make_mesh(slice, len(slice), 1),
  shard_seq=False)``) whenever its width divides the slice, re-judged
  after every width change (the port keeps exact widths, so a shard is
  sharded only at such widths; JAX's pow2 buckets make that its steady
  state);
- **holds each shard's width to its sessions**: a shard fronting n
  sessions runs an n-wide universe (the JAX package's ``bucket="exact"``).
  Its default, pow2 widths padded with inert rows so that shards share
  XLA launch shapes, is not ported: the port compiles nothing per shape,
  and pad rows would only widen every flush's launches and hold the
  tenancy (documents per device row) down.  A shard whose last
  session leaves keeps one inert spare row (a universe is never empty),
  which the next session to arrive takes over;
- **wires cross-shard anti-entropy** through pubsub: sessions declaring
  the same ``doc`` form a replication group with a shared gap-tolerant
  group log and a :class:`~peritext_tpu_torch.runtime.pubsub.Publisher` —
  every client submit fans out live to the sibling sessions on other
  shards (through the ``pubsub_deliver`` chaos site, so drops/dups/
  reorders exercise each shard's causal admission gate), and
  :meth:`ShardedServePlane.anti_entropy` redelivers each member's missing
  contiguous suffix so replicas of the same document on different shards
  converge byte-identically.

Byte-identity stays the hard wall: each session's concatenated patch
stream equals direct per-change ingest of exactly what that session was
handed (client submits + cross-shard deliveries), because every shard is
a full ServePlane with the same admission gate.

Manual mode (``start=False``) steps/drains every shard deterministically;
threaded mode runs one scheduler thread per shard.  Everything is an
argument: ``shards``, ``placement`` (``rr`` | ``load`` — new sessions
round-robin or join the least-loaded shard) and the per-shard planes'
scheduler knobs.  Constructing an ``ElasticController`` (runtime/
elastic.py) or a ``DocLifecycle`` (runtime/lifecycle.py) over the plane
attaches it; the JAX package's ``PERITEXT_SERVE_SHARDS``,
``_SHARD_BUCKET``, ``_PLACEMENT``, ``PERITEXT_ELASTIC`` and
``PERITEXT_LIFECYCLE`` variables are not read.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from peritext_tpu_torch.runtime import telemetry
from peritext_tpu_torch.runtime.pubsub import Publisher
from peritext_tpu_torch.runtime.serve import (
    ServePlane,
    ServeSession,
    Submission,
)

Change = Dict[str, Any]

_log = logging.getLogger(__name__)

PLACEMENT_RR = "rr"
PLACEMENT_LOAD = "load"
_PLACEMENTS = (PLACEMENT_RR, PLACEMENT_LOAD)


class ParkedSubmission:
    """Future handed to a client whose submit landed while its session was
    mid-migration (runtime/elastic.py) or mid-eviction (runtime/
    lifecycle.py).  The protocol's commit (or rollback) replays the park
    buffer onto the surviving inner session and binds each wrapper to the
    real :class:`~peritext_tpu_torch.runtime.serve.Submission`;
    ``result``/``done`` then delegate, so callers cannot tell a parked
    submit from a direct one."""

    __slots__ = ("_bound", "_sub", "_error")

    def __init__(self) -> None:
        self._bound = threading.Event()
        self._sub: Any = None
        self._error: Optional[BaseException] = None

    def _bind(self, sub: Any) -> None:
        self._sub = sub
        self._bound.set()

    def _reject(self, error: BaseException) -> None:
        self._error = error
        self._bound.set()

    def done(self) -> bool:
        if not self._bound.is_set():
            return False
        return True if self._error is not None else self._sub.done()

    def result(self, timeout: Optional[float] = None):
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        if not self._bound.wait(timeout):
            raise TimeoutError(
                f"parked submission still migrating after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        remaining = (
            None if deadline is None else max(0.0, deadline - _time.monotonic())
        )
        return self._sub.result(timeout=remaining)


class _GroupLog:
    """Gap-tolerant per-document change log for cross-shard anti-entropy.

    Unlike :class:`~peritext_tpu_torch.runtime.log.ChangeLog` (strictly
    sequential appends), submissions may arrive with causal gaps (chaotic
    delivery routed a suffix to one shard before its prefix): every
    change is held by ``(actor, seq)``, and redelivery hands out each
    actor's **contiguous** prefix beyond the receiver's clock — exactly
    what a shard's admission gate can use.  A same-key record that
    differs byte-for-byte is a forked actor history and must surface.
    """

    def __init__(self) -> None:
        self._by_key: Dict[Tuple[str, int], Change] = {}

    def record(self, change: Change) -> None:
        key = (change["actor"], change["seq"])
        prev = self._by_key.get(key)
        if prev is None:
            self._by_key[key] = change
        elif prev != change:
            raise ValueError(
                f"conflicting change recorded for {key}: forked actor history"
            )

    def contiguous(self, target_clock: Dict[str, int]) -> List[Change]:
        """Each actor's contiguous run of changes past ``target_clock``,
        in per-actor seq order (the shape ``ChangeLog.missing_changes``
        hands to the gate)."""
        out: List[Change] = []
        actors = sorted({a for a, _ in self._by_key})
        for actor in actors:
            seq = target_clock.get(actor, 0) + 1
            while (actor, seq) in self._by_key:
                out.append(self._by_key[(actor, seq)])
                seq += 1
        return out


class ShardSession:
    """One client session on the sharded plane: wraps the shard-local
    :class:`ServeSession` and, for ``doc``-grouped sessions, fans every
    client submit out to the sibling sessions on other shards."""

    def __init__(
        self,
        plane: "ShardedServePlane",
        inner: ServeSession,
        shard: int,
        doc: Optional[str],
    ) -> None:
        self._plane = plane
        self._inner = inner
        self.shard = shard
        self.doc = doc
        self.name = inner.name
        self.replica = inner.replica
        # Live-migration parking (runtime/elastic.py): non-None while a
        # migration of THIS session is mid-protocol — deliveries buffer
        # here and the commit/rollback replays them onto the surviving
        # inner session.  None on the hot path, so submit()/_deliver()
        # pay exactly one attribute check when elasticity is off.
        self._parked: Optional[List[Tuple[List[Change], Optional[ParkedSubmission]]]] = None
        # Document-lifecycle state (runtime/lifecycle.py): True while this
        # session's replica row is evicted to a durable checkpoint.  A
        # client submit to a cold session transparently hydrates it; cross-
        # shard deliveries to a cold session drop (the group log holds
        # them, and hydration replays the tail through the admission gate).
        self._cold = False

    @property
    def patch_log(self):
        return self._inner.patch_log

    def pending(self) -> int:
        return self._inner.pending()

    def submit(
        self,
        changes: Sequence[Change],
        wait: bool = False,
        timeout: Optional[float] = None,
    ):
        """Admit a client batch on this session's shard, then (for a
        ``doc`` group) record it in the group log and publish it to the
        sibling sessions on other shards — one change per publish, so
        per-link chaos (drop/dup/reorder) lands on each sibling's
        admission gate independently."""
        changes = list(changes)
        lc = self._plane.lifecycle
        cold = False
        if lc is not None and self._cold:
            # Hydrate-on-submit BEFORE recording: the hydration tail
            # replays whatever the logs already hold, so this batch must
            # not be logged yet — its patches belong to the Submission
            # future minted below, not to the anonymous tail replay.
            # ``pending=`` additionally excludes the batch from the tail
            # should it already be logged (a parked replay re-entering).
            lc.ensure_resident(self, pending=changes)
            cold = True
        if lc is not None and changes:
            # Lifecycle log + LRU touch BEFORE admission (mirrors the
            # group-log record-then-admit contract): a change must be
            # logged before any admission-side chaos can drop it, so a
            # later hydration can still replay it.
            lc._observe(self, changes)
        if self.doc is not None and changes:
            # Record into the group log BEFORE admission: a forked actor
            # history must reject loudly up front, never after the local
            # shard already accepted the submission.
            self._plane._record(self, changes)
        if self._parked is not None:
            sub = self._plane._park(self, changes)
        else:
            sub = self._inner.submit(changes)
            if lc is not None and isinstance(sub, Submission):
                sub.lat_class = "cold" if cold else "warm"
        if self.doc is not None and changes:
            self._plane._fan_out(self, changes)
        if wait:
            return sub.result(timeout=timeout)
        return sub

    def _deliver(self, changes: Sequence[Change]) -> None:
        """Cross-shard delivery entry (live fan-out, anti-entropy): drops
        while this session is evicted (the group log already holds the
        change — hydration replays the contiguous tail), parks during a
        migration of this session, else straight to the shard-local
        admission lane."""
        if self._cold:
            return
        if self._parked is not None:
            self._plane._park(self, list(changes), deliver=True)
            return
        self._inner.submit(changes)


class _Shard:
    """One shard slot: a lazily-created universe (first session brings it
    up on the shard's device) plus its ServePlane scheduler."""

    __slots__ = ("index", "devices", "device", "universe", "plane", "real", "spare")

    def __init__(self, index: int) -> None:
        self.index = index
        # Resolved lazily at first universe creation (a universe_factory
        # plane never resolves a device: the factory owns placement): the
        # shard's mesh slice, and its lead device, which holds the universe.
        self.devices: Optional[List[torch.device]] = None
        self.device: Optional[torch.device] = None
        self.universe: Any = None
        self.plane: Optional[ServePlane] = None
        self.real: List[str] = []  # replicas fronted by sessions
        # The inert row a shard keeps once its last session has left.
        self.spare: Optional[str] = None


class ShardedServePlane:
    """N universe shards behind one session-routing facade (see the
    module docstring).  The per-shard scheduler knobs (batch target / deadline / quantum /
    on_open) pass straight through to each shard's :class:`ServePlane`
    (``None`` keeps its default)."""

    def __init__(
        self,
        shards: int = 1,
        *,
        batch_target: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        quantum: Optional[int] = None,
        on_open: Optional[str] = None,
        start: bool = True,
        name: str = "serve",
        placement: str = PLACEMENT_RR,
        capacity: int = 256,
        max_mark_ops: int = 64,
        universe_factory: Optional[Callable[[List[str], int], Any]] = None,
        devices: Optional[Sequence[Any]] = None,
        mesh_within_shard: bool = False,
    ) -> None:
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if placement not in _PLACEMENTS:
            raise ValueError(
                f"unknown placement policy {placement!r}; "
                f"known: {', '.join(_PLACEMENTS)}"
            )
        self.name = name
        self.placement = placement
        self._capacity = capacity
        self._max_mark_ops = max_mark_ops
        self._universe_factory = universe_factory
        self._mesh_within_shard = mesh_within_shard
        self._plane_kw = {
            k: v
            for k, v in dict(
                batch_target=batch_target,
                deadline_ms=deadline_ms,
                quantum=quantum,
                on_open=on_open,
            ).items()
            if v is not None
        }
        self._start = start
        self._lock = threading.RLock()
        self._devices: Optional[List[torch.device]] = (
            None if devices is None else [torch.device(d) for d in devices]
        )
        self.shards: List[_Shard] = [_Shard(i) for i in range(shards)]
        self._sessions: Dict[str, ShardSession] = {}
        self._by_replica: Dict[str, ShardSession] = {}
        self._next_shard = 0
        # doc -> replication group: gap-tolerant log + live pubsub fan-out.
        self._docs: Dict[str, Dict[str, Any]] = {}
        # Fleet view on the ops surface: per-shard occupancy + the
        # launch-shape pressure (the UNION across shards — equal widths
        # share shapes).  The per-shard ServePlanes contribute their own
        # per-session "serve" entries.
        telemetry.register_status_source("serve_shards", self._status)
        if telemetry.enabled:
            telemetry.gauge("serve.shards", shards)
        # The SLO-driven autoscaler (elastic.ElasticController) and the
        # evict/hydrate lifecycle (lifecycle.DocLifecycle) attach
        # themselves here when constructed over this plane.  Without them
        # the serving hot paths pay one attribute check each.
        self.elastic: Any = None
        self.lifecycle: Any = None

    def _status(self) -> Dict[str, Any]:
        with self._lock:
            shards: List[Dict[str, Any]] = []
            shapes: set = set()
            for shard in self.shards:
                if shard.plane is None:
                    shards.append({"shard": shard.index, "sessions": 0})
                    continue
                shapes |= shard.plane.shape_keys()
                # Per-shard pending is read under the INNER plane's lock
                # (facade-lock -> plane-lock, the established order): a
                # concurrent session() on that plane mutates _sessions
                # under the plane lock, and an unlocked dict iteration
                # here would intermittently blow up the whole status tick.
                with shard.plane._lock:
                    pending = sum(
                        s._pending for s in shard.plane._sessions.values()
                    )
                shards.append(
                    {
                        "shard": shard.index,
                        "sessions": len(shard.real),
                        "width": len(shard.universe.replica_ids),
                        "flushes": shard.plane.stats["flushes"],
                        "pending": pending,
                    }
                )
            return {
                "plane": self.name,
                "shards": shards,
                "doc_groups": len(self._docs),
                "fleet_compiled_shapes": len(shapes),
            }

    # -- shard provisioning --------------------------------------------------

    def _resolve_devices(self) -> List[torch.device]:
        """The shards' devices: ``devices=None`` means every visible CUDA
        device, resolved at the first universe (not at construction); with
        none visible that is an error, never a silent move to the CPU."""
        if self._devices is None:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if count == 0:
                raise RuntimeError(
                    "no CUDA device is available; pass devices=['cpu'] (or a "
                    "universe_factory) to serve on the CPU"
                )
            self._devices = [torch.device("cuda", k) for k in range(count)]
        return self._devices

    def _make_universe(self, shard: _Shard, replica_ids: List[str]) -> Any:
        if self._universe_factory is not None:
            return self._universe_factory(replica_ids, shard.index)
        # Imported here: the universe imports this package.
        from peritext_tpu_torch.ops.universe import TorchUniverse
        from peritext_tpu_torch.parallel.mesh import mesh_slices

        shard.devices = mesh_slices(len(self.shards), self._resolve_devices())[shard.index]
        shard.device = shard.devices[0]
        return TorchUniverse(
            replica_ids,
            capacity=self._capacity,
            max_mark_ops=self._max_mark_ops,
            device=shard.device,
        )

    def _reshard_slice(self, shard: _Shard) -> None:
        """Lay the shard universe's replica axis over its mesh slice
        (``mesh_within_shard``), when the slice has two or more devices
        and the width divides it; otherwise leave it as the last change
        left it (a membership change leaves it unsharded) until the next
        width change re-judges it.  A factory-backed shard's placement is
        the factory's."""
        if not self._mesh_within_shard or shard.devices is None or len(shard.devices) < 2:
            return
        if len(shard.universe.replica_ids) % len(shard.devices) != 0:
            return
        from peritext_tpu_torch.parallel.mesh import make_mesh

        shard.universe.shard(make_mesh(shard.devices, len(shard.devices), 1), shard_seq=False)

    def _provision_locked(self, shard: _Shard, replica: str) -> None:
        """Bring ``replica`` up on ``shard``: the first session creates the
        shard's universe, a later one takes over the spare row where the
        shard keeps one (pure bookkeeping, no state rebuild), else the
        universe widens by one row.  On a running shard the mutation runs
        under the plane's flush quiescence barrier — ``add_replicas`` and
        ``rename_replica`` rebuild the state or caches a concurrent launch
        would be reading."""
        if shard.universe is None and self._universe_factory is None:
            self._resolve_devices()  # raises before anything is touched
        shard.real.append(replica)
        if shard.universe is None:
            shard.universe = self._make_universe(shard, [replica])
            shard.plane = ServePlane(
                shard.universe,
                start=self._start,
                name=f"{self.name}.shard{shard.index}",
                shard=shard.index,
                **self._plane_kw,
            )
            self._reshard_slice(shard)
            return

        def mutate() -> None:
            if shard.spare is not None:
                shard.universe.rename_replica(shard.spare, replica)
                shard.spare = None
            else:
                shard.universe.add_replicas([replica])
            self._reshard_slice(shard)

        shard.plane.run_quiesced(mutate)

    def _evacuate_locked(self, shard: _Shard, replica: str) -> None:
        """Take ``replica``'s row off ``shard`` — the inverse of
        :meth:`_provision_locked`, for a migration's source row, an
        eviction, or a provision rolled back.  The width shrinks by one;
        ``drop_replicas`` refuses to empty a universe, so the last row
        gives way to the spare instead: renamed in place while it holds
        nothing, else replaced by a fresh row."""
        shard.real.remove(replica)

        def mutate() -> None:
            uni = shard.universe
            if len(uni.replica_ids) > 1:
                uni.drop_replicas([replica])
            else:
                shard.spare = f"__spare_{shard.index}"
                if not uni.clocks[uni.index_of[replica]]:
                    uni.rename_replica(replica, shard.spare)
                else:
                    uni.add_replicas([shard.spare])
                    uni.drop_replicas([replica])
            self._reshard_slice(shard)

        shard.plane.run_quiesced(mutate)

    # -- sessions ------------------------------------------------------------

    def session(
        self,
        name: str,
        replica: str,
        *,
        doc: Optional[str] = None,
        shard: Optional[int] = None,
        **session_kw: Any,
    ) -> ShardSession:
        """Open a session fronting ``replica`` on a shard (explicit
        ``shard=`` pins it; the default round-robins across shards so
        load — and a doc group's members — spread over the fleet).
        ``doc`` names the replication group for cross-shard anti-entropy;
        the remaining kwargs are :meth:`ServePlane.session`'s."""
        if self.lifecycle is not None:
            # Capacity-pressure eviction BEFORE the facade lock (the evict
            # protocol takes it): admitting this session must not push the
            # resident population past the lifecycle watermark.
            self.lifecycle._admission_pressure(exclude=name)
        with self._lock:
            if name in self._sessions:
                raise ValueError(f"session {name!r} already exists")
            if replica in self._by_replica:
                raise ValueError(
                    f"replica {replica!r} is already fronted by session "
                    f"{self._by_replica[replica].name!r}"
                )
            if shard is None:
                if self.placement == PLACEMENT_LOAD:
                    shard = self._least_loaded_locked()
                else:
                    shard = self._next_shard
                    self._next_shard = (self._next_shard + 1) % len(self.shards)
            if not (0 <= shard < len(self.shards)):
                raise ValueError(
                    f"shard {shard} out of range [0, {len(self.shards)})"
                )
            slot = self.shards[shard]
            self._provision_locked(slot, replica)
            inner = slot.plane.session(name, replica, **session_kw)
            sess = ShardSession(self, inner, shard, doc)
            self._sessions[name] = sess
            self._by_replica[replica] = sess
            if doc is not None:
                group = self._docs.get(doc)
                if group is None:
                    group = self._docs[doc] = {
                        "log": _GroupLog(),
                        "publisher": Publisher(),
                        "members": [],
                    }
                group["members"].append(sess)
                # Deliveries route through _deliver so a mid-migration
                # sibling parks them instead of racing the row handoff.
                group["publisher"].subscribe(
                    name, lambda change, s=sess: s._deliver([change])
                )
            if self.lifecycle is not None:
                self.lifecycle._admitted(sess)
            if telemetry.enabled:
                telemetry.gauge("serve.sessions", len(self._sessions))
                telemetry.counter(f"serve.shard.{shard}.sessions")
        return sess

    # -- placement + load ----------------------------------------------------

    def _shard_load_locked(self, shard: _Shard) -> int:
        """One shard's admission load: pending (admitted, unapplied)
        changes across its lanes plus its session count — the tie-break
        metric placement and the autoscaler agree on."""
        if shard.plane is None:
            return 0
        with shard.plane._lock:
            pending = sum(s._pending for s in shard.plane._sessions.values())
        return pending + len(shard.real)

    def _least_loaded_locked(self) -> int:
        """The ``load`` placement policy: the shard minimizing (load,
        sessions, index) — deterministic, and biased toward genuinely
        empty shards over merely-idle ones."""
        return min(
            range(len(self.shards)),
            key=lambda i: (
                self._shard_load_locked(self.shards[i]),
                len(self.shards[i].real),
                i,
            ),
        )

    # -- migration parking (runtime/elastic.py) ------------------------------

    def _park(
        self,
        sess: ShardSession,
        changes: List[Change],
        deliver: bool = False,
    ):
        """Buffer a delivery that raced a live migration.  Re-checks the
        parked flag under the facade lock: a caller that read a stale flag
        after the migration already unparked routes straight to the (by
        then rebound) inner session instead of stranding the changes in a
        dead buffer."""
        with self._lock:
            if sess._parked is not None:
                wrapper = None if deliver else ParkedSubmission()
                sess._parked.append((changes, wrapper))
                if telemetry.enabled:
                    telemetry.counter("elastic.parked_deliveries")
                return wrapper
            cold = sess._cold
        if cold:
            # The protocol that parked us committed an EVICTION while this
            # call raced it: a delivery simply drops (the group log holds
            # it for the hydration tail); a client submit hydrates and
            # admits like any other cold submit.
            if deliver:
                return None
            if self.lifecycle is not None:
                # pending=: this batch is already in the logs (recorded
                # before parking), but its patches belong to the future
                # minted just below — keep it out of the hydration tail.
                self.lifecycle.ensure_resident(sess, pending=changes)
        return sess._inner.submit(changes)

    # -- cross-shard anti-entropy --------------------------------------------

    def _record(self, sess: ShardSession, changes: List[Change]) -> None:
        group = self._docs[sess.doc]
        with self._lock:
            for change in changes:
                group["log"].record(change)

    def _fan_out(self, sess: ShardSession, changes: List[Change]) -> None:
        """Live cross-shard delivery, best-effort by design: the change
        is already durably in the group log and admitted on its home
        shard, so a failing link (chaos fail/wedge, a sibling's
        backpressure rejection) must never surface to the submitter or
        void its future — anti-entropy redelivers what the live fan-out
        missed.  A failed publish skips that change's remaining siblings
        (Publisher fans per change); later changes still go out."""
        group = self._docs[sess.doc]
        if telemetry.enabled:
            telemetry.counter("serve.fanout_changes", len(changes))
        for change in changes:
            try:
                group["publisher"].publish(sess.name, change)
            except Exception:
                if telemetry.enabled:
                    telemetry.counter("serve.fanout_failures")
                _log.warning(
                    "doc group %r: live fan-out of (%s, %s) from %s failed; "
                    "anti-entropy will redeliver",
                    sess.doc, change.get("actor"), change.get("seq"),
                    sess.name, exc_info=True,
                )

    def anti_entropy(self) -> int:
        """Redeliver every doc-group member's missing contiguous suffix
        from the group log (fault-free, dedup-idempotent — the shard
        gates drop what already landed).  Returns the number of changes
        redelivered; callers drain afterwards.

        Locking: membership snapshots under the facade lock; each
        member's universe clock is then read through its own plane's
        flush-quiescence barrier with NO facade lock held (one shard's
        slow or wedged launch must not stall submits fleet-wide), and the
        group-log read retakes the facade lock briefly.  No lock is ever
        nested inside another here, so no ordering constraint arises; a
        clock read racing a later submit only redelivers changes the
        gate will drop."""
        with self._lock:
            groups = [(g, list(g["members"])) for g in self._docs.values()]
        pending: List[Tuple[ShardSession, List[Change]]] = []
        for group, members in groups:
            for sess in members:
                if sess._parked is not None or sess._cold:
                    # Mid-migration: the commit replays the group-log tail
                    # itself; redelivering here would race the row handoff.
                    # Cold (evicted): the row is gone — hydration replays
                    # the tail, and redelivering would just rehydrate it.
                    continue
                shard = self.shards[sess.shard]
                if shard.plane is None:
                    continue
                try:
                    clock = shard.plane.run_quiesced(
                        lambda s=shard, r=sess.replica: s.universe.clock(r)
                    )
                except KeyError:
                    # The row moved shards between the membership snapshot
                    # and this read; the next pass sees the new home.
                    continue
                with self._lock:
                    missing = group["log"].contiguous(clock)
                if missing:
                    pending.append((sess, missing))
        redelivered = 0
        for sess, missing in pending:
            sess._deliver(missing)
            redelivered += len(missing)
        if redelivered and telemetry.enabled:
            telemetry.counter("serve.anti_entropy_changes", redelivered)
        return redelivered

    # -- driving -------------------------------------------------------------

    def _planes(self) -> List[ServePlane]:
        return [s.plane for s in self.shards if s.plane is not None]

    def step(self) -> bool:
        """Manual mode: one cohort-formation step on every shard.
        Returns True when any shard flushed."""
        worked = False
        for plane in self._planes():
            worked = plane.step() or worked
        return worked

    def drain(self, max_steps: int = 1000) -> int:
        """Manual mode: flush every shard until all lanes empty or no
        shard can progress.  Returns still-pending submissions fleet-wide
        (0 = fully drained).  Shard drains are independent: cross-shard
        fan-out happens at submit time, never during a flush, so one
        shard's flush can never unblock another's deferred lane."""
        return sum(plane.drain(max_steps) for plane in self._planes())

    def flush_and_wait(self, timeout: float = 30.0) -> None:
        for plane in self._planes():
            plane.flush_and_wait(timeout=timeout)

    def close(self, reject_pending: bool = True) -> None:
        if self.lifecycle is not None:
            self.lifecycle.close()
        if self.elastic is not None:
            self.elastic.close()
        for plane in self._planes():
            plane.close(reject_pending=reject_pending)

    def __enter__(self) -> "ShardedServePlane":
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.close()
        return False

    # -- introspection -------------------------------------------------------

    def shard_of(self, replica: str) -> int:
        return self._by_replica[replica].shard

    def universe_of(self, replica: str) -> Any:
        return self.shards[self.shard_of(replica)].universe

    def clock(self, replica: str) -> Dict[str, int]:
        return self.universe_of(replica).clock(replica)

    def spans(self, replica: str) -> List[Dict[str, Any]]:
        """One replica's formatted spans, routed through its shard."""
        uni = self.universe_of(replica)
        return uni.spans(replica)

    @property
    def stats(self) -> Dict[str, Any]:
        """Fleet aggregate of the per-shard plane stats, plus the
        per-shard list under ``"shards"`` and the fleet-wide distinct
        launch-shape count under the JAX package's name (shards of equal
        width share shapes, so the union — not the sum — is the pressure)."""
        agg: Dict[str, Any] = {}
        per_shard: List[Dict[str, int]] = []
        shapes: set = set()
        for shard in self.shards:
            if shard.plane is None:
                per_shard.append({})
                continue
            per_shard.append(dict(shard.plane.stats))
            shapes |= shard.plane.shape_keys()
            for key, val in shard.plane.stats.items():
                agg[key] = agg.get(key, 0) + val
        agg["shards"] = per_shard
        agg["fleet_compiled_shapes"] = len(shapes)
        return agg
