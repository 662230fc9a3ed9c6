"""Elastic serving: SLO-driven shard autoscaling with live session migration.

A copy of ``peritext_tpu/runtime/elastic.py`` bound to the PyTorch port's
sharded plane, checkpoints (``export_replica``/``import_replica`` move a
row between shard universes, which may sit on different devices and at
different capacities) and fault, SLO and telemetry planes.

The sharded serving plane (runtime/serve_shard.py) is statically
partitioned at construction — a traffic spike on one shard burns its SLOs
until someone rebuilds the fleet.  This module closes the loop:

- :func:`migrate_session` moves ONE session between shards of a
  :class:`~peritext_tpu_torch.runtime.serve_shard.ShardedServePlane` with zero
  byte-stream disruption.  The protocol: park the session (new deliveries
  buffer), drain the source lane, export the replica row under the source
  plane's flush-quiescence barrier (``runtime/checkpoint.export_replica``),
  provision a row on the target (its spare row, or one more row),
  import (masked intern-id remap, digest
  verified), then commit: evict + evacuate the source row, rebind the
  session to a fresh inner lane on the target (the patch log is the SAME
  list object, so the concatenated stream is seamless), graft any
  still-laned submissions, catch up the doc group's log tail, and replay
  the park buffer in order.  Every pre-commit step is a
  ``faults.fire("shard_migrate")`` chokepoint; any failure rolls back —
  the target row unwinds, parked deliveries replay onto the source lane,
  a rate-limited black-box dump fires — and the source shard stays
  authoritative, so a failed migration is invisible to byte-identity.

- :class:`ElasticController` is the autoscaler control loop: it watches
  per-shard load (pending changes + sessions, the same metric the
  ``load`` placement policy uses), fleet launch-shape pressure, and the
  SLO plane's burn state (:func:`peritext_tpu_torch.runtime.slo.active`), and
  rebalances live — migrating a session off the hottest shard when its
  load spreads past ``spread`` times the coldest (or an
  SLO objective is burning), and consolidating a near-idle fleet's
  stragglers into its fullest shard so fewer shards flush.
  Actions respect ``cooldown``; the loop thread ticks every ``interval``
  seconds (constructor arguments: the JAX package's ``PERITEXT_ELASTIC_*``
  variables are not read).  Constructing a controller attaches it to
  its plane (``plane.elastic``), whose ``close`` closes it; the JAX
  package's ``PERITEXT_ELASTIC`` is not read.

Telemetry: ``elastic.*`` counters (ticks, migrations, failures,
rollbacks, splits, merges, parked deliveries), an ``elastic.migrate``
flow lane per protocol run (terminal outcome ``migrated`` /
``rolled_back``), and an ``elastic`` block in ``obs.status()`` (per-shard
load, last rebalance action, migrations in flight, rollbacks).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from peritext_tpu_torch.runtime import faults, slo, telemetry

_log = logging.getLogger(__name__)


class MigrationError(RuntimeError):
    """A migration failed and was rolled back; the source shard is
    authoritative and the session kept serving there."""


# -- the migration protocol ----------------------------------------------------


def migrate_session(plane: Any, name: str, target_shard: int) -> None:
    """Move session ``name`` to ``target_shard`` live (module docstring).

    Raises :class:`MigrationError` after rolling back on any protocol
    failure; raises ``ValueError``/``KeyError`` for caller mistakes
    (unknown session, out-of-range or same-shard target, concurrent
    migration of the same session) before anything is touched.
    """
    # Imported here: checkpoint imports the universe, which imports this
    # package.
    from peritext_tpu_torch.runtime import checkpoint

    with plane._lock:
        sess = plane._sessions.get(name)
        if sess is None:
            raise KeyError(f"unknown session {name!r}")
        if not (0 <= target_shard < len(plane.shards)):
            raise ValueError(
                f"shard {target_shard} out of range [0, {len(plane.shards)})"
            )
        if target_shard == sess.shard:
            raise ValueError(f"session {name!r} is already on shard {target_shard}")
        if sess._parked is not None:
            raise ValueError(f"session {name!r} is already migrating")
        if getattr(sess, "_cold", False):
            # Migration-vs-eviction serialization (runtime/lifecycle.py):
            # a cold session has no device row to move — the caller must
            # hydrate first.  Both protocols park under the facade lock,
            # so a mid-eviction session surfaces as "already migrating".
            raise ValueError(
                f"session {name!r} is evicted (cold); hydrate before migrating"
            )
        source_index = sess.shard
        source_slot = plane.shards[source_index]
        target_slot = plane.shards[target_shard]
        old_inner = sess._inner
        # Park: from here every delivery (client submit, fan-out,
        # anti-entropy) buffers until commit/rollback replays it.
        sess._parked = []
    if telemetry.enabled:
        ctx = telemetry.flow(
            "elastic.migrate", session=name, source=source_index,
            target=target_shard,
        )
        telemetry.counter("elastic.migrations_started")
    else:
        ctx = None
    source_plane = source_slot.plane
    provisioned = False
    try:
        with telemetry.span(
            "elastic.migrate", session=name, source=source_index,
            target=target_shard,
        ):
            telemetry.flow_point(ctx)
            # Step 1: drain the source lane — the parked flag stops new
            # admissions, so after this the lane holds only causally-
            # undeliverable leftovers (swept at commit).
            faults.fire("shard_migrate")
            if source_plane._thread is not None:
                source_plane.flush_and_wait()
            else:
                source_plane.drain()
            # Step 2: export the replica row under the source plane's
            # quiescence barrier (no cohort may be mid-launch over it).
            faults.fire("shard_migrate")
            payload = source_plane.run_quiesced(
                lambda: checkpoint.export_replica(
                    source_slot.universe, sess.replica
                )
            )
            # Step 3: provision the target row (spare row / one more row /
            # first-session universe bring-up — serve_shard owns the policy).
            faults.fire("shard_migrate")
            with plane._lock:
                plane._provision_locked(target_slot, sess.replica)
                provisioned = True
            # Step 4: import (digest-verified, masked intern remap).
            faults.fire("shard_migrate")
            with plane._lock:
                target_slot.plane.run_quiesced(
                    lambda: checkpoint.import_replica(
                        target_slot.universe, sess.replica, payload
                    )
                )
            # Step 5: the commit gate — the last point a failure can
            # abort; past it the target row is authoritative.
            faults.fire("shard_migrate")
    except BaseException as exc:
        with telemetry.span(
            "elastic.rollback", session=name, source=source_index,
            target=target_shard, error=type(exc).__name__,
        ):
            _rollback(plane, sess, old_inner, target_slot, provisioned, name, exc)
            telemetry.flow_point(ctx, terminal=True, outcome="rolled_back")
        raise MigrationError(
            f"migration of session {name!r} shard {source_index} -> "
            f"{target_shard} failed and rolled back: {exc}"
        ) from exc

    # COMMIT: pure host bookkeeping from here — no fault chokepoints, so
    # the protocol can never die half-moved.
    with plane._lock:
        leftovers = source_plane.evict_session(name)
        plane._evacuate_locked(source_slot, sess.replica)
        new_inner = target_slot.plane.session(
            name,
            sess.replica,
            weight=old_inner.weight,
            priority=old_inner.priority,
            bound=old_inner.bound,
            policy=old_inner.policy,
            block_timeout=old_inner.block_timeout,
        )
        # The per-session patch stream must concatenate seamlessly across
        # the move: hand the target lane the SAME list object.
        new_inner.patch_log = old_inner.patch_log
        sess._inner = new_inner
        sess.shard = target_shard
        if leftovers:
            # Causally-undeliverable submissions swept from the drained
            # source lane: graft the SAME Submission objects into the new
            # lane so the callers' futures still resolve.
            with target_slot.plane._work:
                for sub in leftovers:
                    sub.session = new_inner
                    new_inner._lane.append(sub)
                    new_inner._pending += len(sub.changes)
                target_slot.plane._work.notify_all()
        # Parked deliveries replay FIRST so a parked client submit's
        # future resolves with its own patches; the log-tail catch-up
        # below then re-offers anything it duplicated and the admission
        # gate drops it.
        _replay_parked(sess, new_inner, name, filter_chaos=True)
        # Doc-group log-tail handoff: anything siblings recorded while the
        # session was mid-flight redelivers through the normal gate.
        if sess.doc is not None:
            group = plane._docs.get(sess.doc)
            if group is not None:
                clock = target_slot.plane.run_quiesced(
                    lambda: target_slot.universe.clock(sess.replica)
                )
                missing = group["log"].contiguous(clock)
                if missing:
                    new_inner.submit(missing)
    with telemetry.span(
        "elastic.commit", session=name, source=source_index,
        target=target_shard,
    ):
        if telemetry.enabled:
            telemetry.counter("elastic.migrations")
            telemetry.record(
                "elastic.migrate", outcome="migrated", session=name,
                source=source_index, target=target_shard,
            )
        telemetry.flow_point(ctx, terminal=True, outcome="migrated")


def _replay_parked(sess: Any, inner: Any, name: str, filter_chaos: bool) -> None:
    """Drain the park buffer onto ``inner`` in admission order, binding
    each parked submit's wrapper to its real submission.  On the commit
    path the replayed changes pass the ``shard_migrate`` chaos filter
    (drop/dup/reorder — transport loss across the handoff; anti-entropy
    redelivers doc-grouped drops); the rollback path replays verbatim."""
    buf, sess._parked = sess._parked, None
    for changes, wrapper in buf or []:
        if filter_chaos:
            changes = faults.filter_stream("shard_migrate", changes, stream=name)
        try:
            sub = inner.submit(changes)
        except Exception as exc:
            if wrapper is not None:
                wrapper._reject(exc)
            else:
                _log.warning(
                    "parked delivery replay for %s failed; anti-entropy "
                    "will redeliver", name, exc_info=True,
                )
            continue
        if wrapper is not None:
            wrapper._bind(sub)
    if buf and telemetry.enabled:
        telemetry.counter("elastic.replayed_deliveries", len(buf))


def _rollback(
    plane: Any,
    sess: Any,
    old_inner: Any,
    target_slot: Any,
    provisioned: bool,
    name: str,
    exc: BaseException,
) -> None:
    """Unwind a failed migration: the target row unprovisions, parked
    deliveries replay onto the (still-registered) source lane, and a
    rate-limited black-box dump records the failure."""
    with plane._lock:
        if provisioned:
            try:
                plane._evacuate_locked(target_slot, sess.replica)
            except Exception:
                _log.warning(
                    "rollback of session %s could not unprovision the "
                    "target row; shard %d carries a stray row",
                    name, target_slot.index, exc_info=True,
                )
        _replay_parked(sess, old_inner, name, filter_chaos=False)
    if telemetry.enabled:
        telemetry.counter("elastic.migration_failures")
        telemetry.counter("elastic.rollbacks")
        telemetry.record(
            "elastic.migrate", outcome="rolled_back", session=name,
            error=type(exc).__name__,
        )
    telemetry.blackbox_dump(
        "shard_migrate_failed",
        dedupe_key=f"shard_migrate:{name}",
        session=name,
        target=target_slot.index,
        error=f"{type(exc).__name__}: {exc}",
    )


# -- the autoscaler control loop -----------------------------------------------


class ElasticController:
    """The control loop over one ShardedServePlane (module docstring).

    ``tick()`` makes at most one rebalance decision; threaded mode calls
    it every ``interval`` seconds.  Decisions are pure functions of the
    observed loads + SLO burn state, so a manual-mode test drives the
    loop deterministically."""

    def __init__(
        self,
        plane: Any,
        *,
        interval: float = 1.0,
        spread: float = 4.0,
        cooldown: float = 5.0,
        merge_low: float = 1.0,
        watch_slo: bool = True,
        start: bool = True,
    ) -> None:
        self.plane = plane
        plane.elastic = self
        # ``watch_slo=False`` blinds the controller to live SLO burn, so
        # decisions become a pure function of the observed loads — what a
        # measurement harness needs for a shape-deterministic warmup
        # (burn depends on real latencies, so a burn-fed decision sequence
        # can mint launch shapes the warmup pass never saw).
        self.watch_slo = watch_slo
        self.interval = interval
        # A hot shard must carry ``spread`` times the coldest shard's
        # load (+1 smooths the empty-shard asymptote) before a migration
        # is worth its protocol cost.
        self.spread = spread
        self.cooldown = cooldown
        # Fleet-wide pending below this consolidates stragglers (merge).
        self.merge_low = merge_low
        # Consecutive quiet ticks required before a merge: a migration's
        # own source-shard drain momentarily empties the lanes, and
        # without this hysteresis a split's very next tick would read
        # that lull as "quiet fleet" and merge the session straight back.
        self.merge_quiet = 3
        self._quiet_ticks = 0
        self.stats: Dict[str, int] = {
            "ticks": 0,
            "migrations": 0,
            "splits": 0,
            "merges": 0,
            "failures": 0,
            "rollbacks": 0,
        }
        self.last_action: Optional[Dict[str, Any]] = None
        self._last_action_t = float("-inf")
        self._inflight = 0
        self._closed = False
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        telemetry.register_status_source("elastic", self._status)
        if start:
            self.start()

    # -- observation ---------------------------------------------------------

    def _loads(self) -> List[Dict[str, Any]]:
        """Per-shard load snapshot (facade lock): pending changes +
        session count, the metric placement and the autoscaler share."""
        plane = self.plane
        with plane._lock:
            out = []
            for s in plane.shards:
                load = plane._shard_load_locked(s)
                out.append(
                    {
                        "shard": s.index,
                        "load": load,
                        # Traffic pressure alone (load minus the session
                        # count): the merge path judges quietness on this,
                        # because sessions never drain away on their own.
                        "pending": load - len(s.real),
                        "sessions": len(s.real),
                        "width": (
                            len(s.universe.replica_ids)
                            if s.universe is not None else 0
                        ),
                    }
                )
            return out

    def _burning(self) -> bool:
        if not self.watch_slo:
            return False
        plan = slo.active()
        return plan is not None and plan.breach_active()

    def _status(self) -> Dict[str, Any]:
        return {
            "plane": self.plane.name,
            "interval": self.interval,
            "spread": self.spread,
            "cooldown": self.cooldown,
            "loads": self._loads(),
            "slo_burning": self._burning(),
            "last_action": self.last_action,
            "in_flight": self._inflight,
            "ticks": self.stats["ticks"],
            "migrations": self.stats["migrations"],
            "rollbacks": self.stats["rollbacks"],
            "failures": self.stats["failures"],
        }

    # -- the decision --------------------------------------------------------

    def _pick_victim(self, shard_index: int) -> Optional[str]:
        """The hot shard's busiest migratable session (deterministic:
        max pending, ties broken by name)."""
        plane = self.plane
        with plane._lock:
            candidates = [
                s for s in plane._sessions.values()
                if s.shard == shard_index
                and s._parked is None
                and not getattr(s, "_cold", False)
            ]
            if not candidates:
                return None
            return max(
                candidates, key=lambda s: (s._inner.pending(), s.name)
            ).name

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control decision.  Returns the action taken ("split" /
        "merge") or None (cooldown, balanced fleet, nothing migratable)."""
        self.stats["ticks"] += 1
        if telemetry.enabled:
            telemetry.counter("elastic.ticks")
        t = time.monotonic() if now is None else now
        if t - self._last_action_t < self.cooldown:
            return None
        loads = self._loads()
        if len(loads) < 2:
            return None
        burning = self._burning()
        hot = max(loads, key=lambda e: (e["pending"], e["sessions"]))
        cold = min(loads, key=lambda e: (e["pending"], e["sessions"], e["shard"]))
        action: Optional[str] = None
        victim: Optional[str] = None
        target: Optional[int] = None
        # Split on traffic pressure (pending spread), never on session
        # count alone — an idle-but-populated fleet must not oscillate.
        # Under an active SLO burn, session imbalance >= 2 also splits
        # (narrower hot-shard width is the latency lever), and moving one
        # session strictly shrinks the imbalance, so burn-driven splits
        # terminate at a balanced fleet.
        spread_hit = hot["pending"] >= self.spread * (cold["pending"] + 1)
        burn_hit = burning and hot["sessions"] >= cold["sessions"] + 2
        quiet = not burning and sum(e["pending"] for e in loads) <= self.merge_low
        self._quiet_ticks = self._quiet_ticks + 1 if quiet else 0
        if (
            hot["sessions"] >= 2
            and hot["shard"] != cold["shard"]
            and (spread_hit or burn_hit)
        ):
            # Split: shed the hottest shard's busiest session to the
            # coldest shard.
            action, target = "split", cold["shard"]
            victim = self._pick_victim(hot["shard"])
            self._quiet_ticks = 0
        elif quiet and self._quiet_ticks >= self.merge_quiet:
            # Merge: a quiet fleet consolidates a straggler session from
            # its least-populated shard into its most-populated one, so
            # fewer shards flush.  (The JAX package merges only into free
            # pad rows; the port's shards keep no pads.)  The host always
            # carries at least as many sessions as the donor, so
            # consolidation is monotone — no swap loops.
            donors = [e for e in loads if 0 < e["sessions"]]
            if len(donors) >= 2:
                donor = min(donors, key=lambda e: (e["sessions"], e["shard"]))
                host = max(
                    (e for e in donors if e is not donor),
                    key=lambda e: (e["sessions"], -e["shard"]),
                )
                action, target = "merge", host["shard"]
                victim = self._pick_victim(donor["shard"])
        if action is None or victim is None or target is None:
            return None
        self._inflight += 1
        try:
            migrate_session(self.plane, victim, target)
        except MigrationError:
            # Every failed migration rolled back exactly once.
            self.stats["failures"] += 1
            self.stats["rollbacks"] += 1
            self._record_action(action, victim, target, t, ok=False)
            return None
        except (KeyError, ValueError):
            # The fleet changed under the decision (session closed or
            # moved concurrently); not a protocol failure.
            return None
        finally:
            self._inflight -= 1
        self.stats["migrations"] += 1
        self.stats["splits" if action == "split" else "merges"] += 1
        self._record_action(action, victim, target, t, ok=True)
        return action

    def _record_action(
        self, action: str, victim: str, target: int, t: float, ok: bool
    ) -> None:
        self._last_action_t = t
        self.last_action = {
            "action": action,
            "session": victim,
            "to_shard": target,
            "ok": ok,
            "t": time.time(),
        }

    # -- the loop thread -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or self._closed:
            return
        self._thread = threading.Thread(
            target=self._run,
            name=f"peritext-{self.plane.name}-elastic",
            daemon=True,
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._closed:
            self._wake.wait(self.interval)
            if self._closed:
                return
            try:
                self.tick()
            except Exception:
                _log.warning(
                    "elastic tick failed; the loop survives", exc_info=True
                )

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
