"""Multi-tenant document lifecycle: crash-safe evict/hydrate over the
sharded serving plane.

A copy of ``peritext_tpu/runtime/lifecycle.py`` bound to the PyTorch
port's sharded plane, checkpoints and fault and telemetry planes.  A
generation keeps the JAX package's file layout (the npz of the row arrays
with its dtypes, ``bnd_mask`` as uint32, and the JSON sidecar with the
same ``_row_digest``), so either engine hydrates what the other evicted.

Every universe today holds its replica rows device-resident forever, so
device capacity is the tenancy wall — a fleet fronting N documents needs N
rows even when most documents are idle.  This module makes residency a
cache, not a commitment:

- :meth:`DocLifecycle.evict` checkpoints ONE session's replica row to a
  durable per-document generation directory (npz + digest sidecar, atomic
  tmp+rename writes, rotating ``keep`` generations) together with its
  causal position (the eviction-time clock), then frees the device row
  (``_evacuate_locked``: the shard's width shrinks by one) under the shard's flush-quiescence barrier.  The session
  object survives — cold, with no row.

- A ``session.submit`` to a cold document transparently **hydrates** it:
  re-provision a row (the shard's spare or one more row), import the newest
  loadable generation (digest-verified; a corrupt generation falls back
  to the previous one, and with no loadable generation at all the row
  rebuilds by full log replay from genesis), replay the log tail through
  the normal causal admission gate, rebind the session to a fresh inner
  lane (the patch log is the SAME list object, so the per-session stream
  concatenates seamlessly), then admit the triggering submission.  The
  serving API is unchanged; the only visible difference is latency,
  split into first-class ``e2e.admit_to_applied_{warm,cold}`` histograms
  (``PERITEXT_SLO``-able).

- Every pre-commit protocol step is a ``faults.fire("doc_evict")`` /
  ``faults.fire("doc_hydrate")`` chokepoint with rollback semantics
  mirroring :func:`~peritext_tpu_torch.runtime.elastic.migrate_session`: a
  failed evict leaves the session resident and authoritative (parked
  deliveries replay verbatim onto the still-live lane); a failed hydrate
  unwinds the provisioned row and leaves the session cold (the next
  submit retries).  A SIGKILL between checkpoint write and row free just
  leaves a stale newer generation behind — the session is still
  resident, and the next successful evict writes a newer generation, so
  hydration always prefers the newest *loadable* truth.

Byte-identity is the hard wall throughout: each session's concatenated
patch stream equals direct ingest of exactly what it was handed, through
evictions, hydrations, corrupt-generation fallbacks, full replays, and
every rollback path (tests/test_torch_lifecycle.py).  Replay never duplicates
the stream: changes at or below the eviction-time clock re-apply with
the patch sink detached (they were already streamed before eviction),
and only genuinely-new tail changes emit.

Policy: :meth:`DocLifecycle.tick` (``ElasticController``-style loop;
constructing a DocLifecycle attaches it to its plane, storing under
``directory`` or a fresh temporary directory; the JAX package's
``PERITEXT_LIFECYCLE`` and ``PERITEXT_LIFECYCLE_*`` variables are not
read, their values are constructor arguments here)
evicts the least-recently-active session once it idles past ``idle_s``
seconds, and holds the fleet-wide resident population at ``watermark``
(0 = unbounded) — both at
tick time and synchronously at admission/hydration (capacity-pressure
eviction), which is what lets ``docs served / device rows`` (the tenancy
ratio, a measured line in ``telemetry.status()``) exceed 1.0.

Sessions without a ``doc`` replication group get a lifecycle-private
gap-tolerant log fed at submit time, so the corrupt-fallback and
full-replay chains work uniformly for grouped and ungrouped sessions.

Telemetry: ``lifecycle.*`` counters, ``lifecycle.evict`` /
``lifecycle.hydrate`` flow lanes (terminal ``evicted`` / ``hydrated`` /
``rolled_back``), rate-limited ``doc_evict_failed`` / ``doc_hydrate_failed``
black-box dumps (per-doc dedupe keys), and a ``lifecycle`` block in
``telemetry.status()``.
"""
from __future__ import annotations

import collections
import io
import json
import logging
import os
import re
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from peritext_tpu_torch.runtime import faults, telemetry
from peritext_tpu_torch.runtime.serve_shard import _GroupLog

_log = logging.getLogger(__name__)

# Sidecar keys copied verbatim from the export_replica payload.
_SIDECAR_KEYS = (
    "replica", "capacity", "max_mark_ops", "clock", "length",
    "mark_count", "store", "text_obj", "actors", "attrs", "digest",
)
_LOAD_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile)


class EvictionError(RuntimeError):
    """An eviction failed and was rolled back; the session is still
    resident and its shard authoritative."""


class HydrationError(RuntimeError):
    """A hydration failed and was rolled back; the session is still cold
    (the next submit retries the protocol)."""


class DocLifecycle:
    """Evict/hydrate layer + LRU reaper over one ShardedServePlane (module
    docstring).  Construct directly (``start=False`` + manual ``tick()``
    for deterministic tests); construction attaches it to ``plane``.
    """

    def __init__(
        self,
        plane: Any,
        *,
        directory: Optional[str] = None,
        idle_s: float = 30.0,
        watermark: int = 0,
        interval: float = 1.0,
        cooldown: float = 1.0,
        keep: int = 2,
        start: bool = True,
    ) -> None:
        self.plane = plane
        plane.lifecycle = self
        if not directory:
            import tempfile

            directory = tempfile.mkdtemp(prefix=f"peritext-lifecycle-{plane.name}-")
        self.directory = directory
        self.idle_s = idle_s
        # Fleet-wide resident-session cap (0 = unbounded): enforced at tick
        # time AND synchronously at admission/hydration, so a bounded fleet
        # stays bounded even between ticks.
        self.watermark = int(watermark)
        self.interval = interval
        self.cooldown = cooldown
        self.keep = max(1, int(keep))
        # One protocol at a time: evict, hydrate, and pressure sweeps all
        # serialize here (reentrant — hydration's own pressure sweep may
        # evict).  Never acquired while holding plane._lock.
        self._op_lock = threading.RLock()
        # Per-session lifecycle records (survive across evict/hydrate
        # cycles): replica/shard/doc, eviction-time clock, the carried
        # patch-log list object, swept-lane leftovers, session kwargs.
        self._records: Dict[str, Dict[str, Any]] = {}
        # Lifecycle-private change logs for sessions WITHOUT a doc group
        # (grouped sessions replay from the shared group log instead).
        self._logs: Dict[str, _GroupLog] = {}
        self._log_lock = threading.Lock()
        self._last_active: Dict[str, float] = {}
        self._cold_starts: collections.deque = collections.deque(maxlen=256)
        self.stats: Dict[str, int] = {
            "ticks": 0,
            "evictions": 0,
            "hydrations": 0,
            "evict_failures": 0,
            "hydrate_failures": 0,
            "rollbacks": 0,
            "corrupt_fallbacks": 0,
            "full_replays": 0,
            "pressure_evictions": 0,
            "pressure_failures": 0,
            "replayed_changes": 0,
        }
        self.last_eviction: Optional[Dict[str, Any]] = None
        self._last_action_t = float("-inf")
        self._closed = False
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        telemetry.register_status_source("lifecycle", self._status)
        if start:
            self.start()

    # -- hot-path hooks (called from serve_shard) -----------------------------

    def _observe(self, sess: Any, changes: List[Dict[str, Any]]) -> None:
        """Submit-time hook: LRU touch + (for ungrouped sessions) record
        into the lifecycle-private log BEFORE admission, so the hydration
        tail can always replay what admission-side chaos dropped."""
        self._last_active[sess.name] = time.monotonic()
        if sess.doc is None:
            with self._log_lock:
                log = self._logs.get(sess.name)
                if log is None:
                    log = self._logs[sess.name] = _GroupLog()
                for change in changes:
                    log.record(change)

    def _admitted(self, sess: Any) -> None:
        """New-session hook (under the facade lock): seed the LRU clock so
        a never-submitting session is evictable once it idles."""
        self._last_active[sess.name] = time.monotonic()

    def ensure_resident(
        self, sess: Any, pending: Optional[List[Dict[str, Any]]] = None
    ) -> bool:
        """Hydrate ``sess`` if cold (idempotent; serialized on the
        protocol lock).  ``pending`` is the batch the caller is about to
        submit with its own future — excluded from the hydration tail so
        its patches resolve on THAT future, not the anonymous replay.
        Returns True when a hydration actually ran."""
        if not sess._cold:
            return False
        with self._op_lock:
            if not sess._cold:
                return False
            self.hydrate(sess.name, _exclude=pending)
            return True

    # -- the eviction protocol ------------------------------------------------

    def evict(self, name: str, reason: str = "manual") -> None:
        """Evict session ``name``: durable checkpoint, then free the row.

        Raises :class:`EvictionError` after rolling back on any protocol
        failure (the session stays resident and authoritative); raises
        ``KeyError``/``ValueError`` for caller mistakes (unknown session,
        already cold, mid-migration) before anything is touched."""
        # Imported here: checkpoint imports the universe, which imports
        # this package.
        from peritext_tpu_torch.runtime import checkpoint

        plane = self.plane
        with self._op_lock:
            with plane._lock:
                sess = plane._sessions.get(name)
                if sess is None:
                    raise KeyError(f"unknown session {name!r}")
                if sess._cold:
                    raise ValueError(f"session {name!r} is already evicted")
                if sess._parked is not None:
                    raise ValueError(f"session {name!r} is migrating")
                slot = plane.shards[sess.shard]
                inner = sess._inner
                # Park: deliveries buffer until commit/rollback replays them.
                sess._parked = []
            if telemetry.enabled:
                ctx = telemetry.flow(
                    "lifecycle.evict", session=name, shard=sess.shard,
                    reason=reason,
                )
                telemetry.counter("lifecycle.evictions_started")
            else:
                ctx = None
            try:
                with telemetry.span(
                    "lifecycle.evict", session=name, shard=sess.shard
                ):
                    telemetry.flow_point(ctx)
                    # Step 1: drain the source lane — the parked flag stops
                    # new admissions, so after this the lane holds only
                    # causally-undeliverable leftovers (swept at commit and
                    # grafted back at hydration).
                    faults.fire("doc_evict")
                    if slot.plane._thread is not None:
                        slot.plane.flush_and_wait()
                    else:
                        slot.plane.drain()
                    # Step 2: export the row under the shard's quiescence
                    # barrier (no cohort may be mid-launch over it).
                    faults.fire("doc_evict")
                    payload = slot.plane.run_quiesced(
                        lambda: checkpoint.export_replica(
                            slot.universe, sess.replica
                        )
                    )
                    # Step 3: persist a durable generation (atomic writes;
                    # the doc_evict:corrupt drill truncates the npz after).
                    faults.fire("doc_evict")
                    self._persist(name, payload)
                    # Step 4: the commit gate — the last point a failure
                    # can abort; past it the device row frees.  A process
                    # kill HERE (checkpoint written, row not yet freed) is
                    # safe: the session is still resident, and the stale
                    # generation is simply superseded by the next evict.
                    faults.fire("doc_evict")
            except BaseException as exc:
                with telemetry.span(
                    "lifecycle.evict_rollback", session=name,
                    error=type(exc).__name__,
                ):
                    self._evict_rollback(sess, name, exc)
                    telemetry.flow_point(ctx, terminal=True, outcome="rolled_back")
                raise EvictionError(
                    f"eviction of session {name!r} failed and rolled back: {exc}"
                ) from exc
            # COMMIT: pure host bookkeeping — no fault chokepoints, so the
            # protocol can never die half-evicted.
            with plane._lock:
                leftovers = slot.plane.evict_session(name)
                plane._evacuate_locked(slot, sess.replica)
                rec = self._records.setdefault(name, {})
                rec.update(
                    replica=sess.replica,
                    shard=sess.shard,
                    doc=sess.doc,
                    clock=dict(payload["clock"]),
                    patch_log=inner.patch_log,
                    leftovers=leftovers,
                    session_kw=dict(
                        weight=inner.weight,
                        priority=inner.priority,
                        bound=inner.bound,
                        policy=inner.policy,
                        block_timeout=inner.block_timeout,
                    ),
                )
                sess._cold = True
                buf, sess._parked = sess._parked, None
            # Parked client submits raced the eviction: route them back
            # through the session (which hydrates straight back — rare, and
            # correctness beats residency).  Parked deliveries drop: the
            # log already holds them for the hydration tail.
            for changes, wrapper in buf or []:
                if wrapper is None:
                    continue
                try:
                    sub = sess.submit(changes)
                except Exception as replay_exc:
                    wrapper._reject(replay_exc)
                    continue
                wrapper._bind(sub)
            self.stats["evictions"] += 1
            if reason == "pressure":
                self.stats["pressure_evictions"] += 1
            self.last_eviction = {
                "session": name,
                "shard": slot.index,
                "reason": reason,
                "t": time.time(),
            }
            if telemetry.enabled:
                telemetry.counter("lifecycle.evictions")
                if reason == "pressure":
                    telemetry.counter("lifecycle.pressure_evictions")
                telemetry.record(
                    "lifecycle.evict", outcome="evicted", session=name,
                    shard=slot.index, reason=reason,
                )
            # The terminal seam is spanned so the flow lane binds (the
            # trace_report schema contract — same as elastic's commit).
            with telemetry.span("lifecycle.evict_commit", session=name):
                telemetry.flow_point(ctx, terminal=True, outcome="evicted")

    def _evict_rollback(self, sess: Any, name: str, exc: BaseException) -> None:
        """Unwind a failed eviction: unpark, replay parked deliveries
        verbatim onto the still-authoritative inner lane, dump."""
        with self.plane._lock:
            buf, sess._parked = sess._parked, None
        for changes, wrapper in buf or []:
            try:
                sub = sess._inner.submit(changes)
            except Exception as replay_exc:
                if wrapper is not None:
                    wrapper._reject(replay_exc)
                else:
                    _log.warning(
                        "parked delivery replay for %s failed after evict "
                        "rollback; anti-entropy will redeliver",
                        name, exc_info=True,
                    )
                continue
            if wrapper is not None:
                wrapper._bind(sub)
        self.stats["evict_failures"] += 1
        self.stats["rollbacks"] += 1
        if telemetry.enabled:
            telemetry.counter("lifecycle.evict_failures")
            telemetry.counter("lifecycle.rollbacks")
            telemetry.record(
                "lifecycle.evict", outcome="rolled_back", session=name,
                error=type(exc).__name__,
            )
        telemetry.blackbox_dump(
            "doc_evict_failed",
            dedupe_key=f"doc_evict:{name}",
            session=name,
            error=f"{type(exc).__name__}: {exc}",
        )

    # -- the hydration protocol -----------------------------------------------

    def hydrate(
        self,
        name: str,
        _exclude: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        """Restore cold session ``name``: provision a row, import the
        newest loadable generation (corrupt generations fall back; none
        loadable → full log replay from genesis), replay the log tail
        through the causal gate, rebind the lane.  Idempotent when the
        session is already resident.  ``_exclude``: logged changes a
        caller will submit itself right after (their patches belong to
        that caller's future, so the tail must not claim them).  Raises
        :class:`HydrationError` after rolling back (the session stays
        cold)."""
        from peritext_tpu_torch.runtime import checkpoint

        plane = self.plane
        with self._op_lock:
            with plane._lock:
                sess = plane._sessions.get(name)
                if sess is None:
                    raise KeyError(f"unknown session {name!r}")
                if not sess._cold:
                    return
                if sess._parked is not None:
                    raise ValueError(f"session {name!r} is migrating")
                rec = self._records.get(name)
                if rec is None:
                    raise KeyError(f"no lifecycle record for session {name!r}")
                slot = plane.shards[rec["shard"]]
                sess._parked = []
            # Hydrating past the watermark evicts someone else first (the
            # page-cache shape); a pressure failure must not block this
            # hydration — availability wins, the reaper catches up later.
            try:
                self._admission_pressure(exclude=name)
            except Exception:
                self.stats["pressure_failures"] += 1
                _log.warning(
                    "capacity-pressure sweep before hydrating %s failed; "
                    "hydrating anyway", name, exc_info=True,
                )
            if telemetry.enabled:
                ctx = telemetry.flow(
                    "lifecycle.hydrate", session=name, shard=slot.index,
                )
                telemetry.counter("lifecycle.hydrations_started")
            else:
                ctx = None
            t0 = time.perf_counter()
            provisioned = False
            new_inner = None
            try:
                with telemetry.span("lifecycle.hydrate", session=name):
                    telemetry.flow_point(ctx)
                    # Step 1: provision the row (spare row / one more row).
                    faults.fire("doc_hydrate")
                    with plane._lock:
                        plane._provision_locked(slot, rec["replica"])
                        provisioned = True
                    # Step 2: newest loadable generation (digest-verified;
                    # corrupt generations fall back one at a time).
                    faults.fire("doc_hydrate")
                    payload, fallbacks = self._load_latest(name)
                    if fallbacks:
                        self.stats["corrupt_fallbacks"] += fallbacks
                        if telemetry.enabled:
                            telemetry.counter(
                                "lifecycle.corrupt_fallbacks", fallbacks
                            )
                        telemetry.blackbox_dump(
                            "doc_hydrate_failed",
                            dedupe_key=f"doc_hydrate:{name}",
                            session=name,
                            corrupt_generations=fallbacks,
                            recovered="older_generation" if payload is not None
                            else "full_replay",
                        )
                    # Step 3: digest-verified import (or leave the fresh
                    # row empty: full replay rebuilds it from the log).
                    faults.fire("doc_hydrate")
                    if payload is not None:
                        with plane._lock:
                            slot.plane.run_quiesced(
                                lambda: checkpoint.import_replica(
                                    slot.universe, rec["replica"], payload
                                )
                            )
                    else:
                        self.stats["full_replays"] += 1
                        if telemetry.enabled:
                            telemetry.counter("lifecycle.full_replays")
                    # Step 4: rebind a fresh inner lane + causal replay.
                    faults.fire("doc_hydrate")
                    with plane._lock:
                        new_inner = slot.plane.session(
                            name, rec["replica"], **rec["session_kw"]
                        )
                    restored = dict(payload["clock"]) if payload is not None else {}
                    tail = self._replay_tail(
                        sess, new_inner, slot, rec, restored
                    )
                    # Step 5: the commit gate.
                    faults.fire("doc_hydrate")
            except BaseException as exc:
                with telemetry.span(
                    "lifecycle.hydrate_rollback", session=name,
                    error=type(exc).__name__,
                ):
                    self._hydrate_rollback(
                        sess, slot, rec, provisioned, new_inner, name, exc
                    )
                    telemetry.flow_point(ctx, terminal=True, outcome="rolled_back")
                raise HydrationError(
                    f"hydration of session {name!r} failed and rolled back "
                    f"(still cold): {exc}"
                ) from exc
            # COMMIT: pure host bookkeeping.
            with plane._lock:
                leftovers = rec.pop("leftovers", None) or []
                if leftovers:
                    # Causally-undeliverable submissions swept at eviction:
                    # graft the SAME Submission objects so callers' futures
                    # still resolve with their exact patches.
                    with slot.plane._work:
                        for sub in leftovers:
                            sub.session = new_inner
                            new_inner._lane.append(sub)
                            new_inner._pending += len(sub.changes)
                        slot.plane._work.notify_all()
                sess._inner = new_inner
                sess._cold = False
                buf, sess._parked = sess._parked, None
                # Future-bearing batches (the caller's pending submit +
                # parked client submits) re-submit below with their OWN
                # Submissions; the tail must not claim their patches.
                # Snapshotted under the facade lock — nothing can park
                # after this point (unparked + warm).
                claimed = {
                    (c["actor"], c["seq"]) for c in (_exclude or [])
                }
                for changes, wrapper in buf or []:
                    if wrapper is not None:
                        claimed.update((c["actor"], c["seq"]) for c in changes)
            tail = [c for c in tail if (c["actor"], c["seq"]) not in claimed]
            if tail:
                new_inner.submit(tail)
                self.stats["replayed_changes"] += len(tail)
                if telemetry.enabled:
                    telemetry.counter("lifecycle.replayed_changes", len(tail))
            # Parked client submits replay verbatim (their futures rebind);
            # parked DELIVERIES replay through the chaos filter — transport
            # loss across the handoff, the log + anti-entropy redeliver.
            for changes, wrapper in buf or []:
                if wrapper is None:
                    changes = faults.filter_stream(
                        "doc_hydrate", changes, stream=name
                    )
                try:
                    sub = new_inner.submit(changes)
                except Exception as replay_exc:
                    if wrapper is not None:
                        wrapper._reject(replay_exc)
                    continue
                if wrapper is not None:
                    wrapper._bind(sub)
            dt = time.perf_counter() - t0
            self._cold_starts.append(dt)
            self._last_active[name] = time.monotonic()
            self.stats["hydrations"] += 1
            if telemetry.enabled:
                telemetry.counter("lifecycle.hydrations")
                telemetry.observe("lifecycle.hydrate_seconds", dt)
                telemetry.record(
                    "lifecycle.hydrate", outcome="hydrated", session=name,
                    shard=slot.index,
                )
            # Spanned terminal seam: the flow lane must bind for
            # trace_report validation (the elastic commit precedent).
            with telemetry.span("lifecycle.hydrate_commit", session=name):
                telemetry.flow_point(ctx, terminal=True, outcome="hydrated")

    def _replay_tail(
        self,
        sess: Any,
        inner: Any,
        slot: Any,
        rec: Dict[str, Any],
        restored_clock: Dict[str, int],
    ) -> List[Dict[str, Any]]:
        """Replay the logged PREFIX (changes at or below the eviction-time
        clock: already streamed before eviction, so they re-apply with the
        patch sink still detached, rebuilding state without duplicating
        the stream) and reattach the carried patch log.  Returns the TAIL
        (changes past the eviction clock — arrived while cold) for the
        commit to submit once it knows which batches belong to callers'
        own futures."""
        if rec["doc"] is not None:
            group = self.plane._docs.get(rec["doc"])
            log = group["log"] if group is not None else None
            log_lock = self.plane._lock
        else:
            with self._log_lock:
                log = self._logs.get(sess.name)
            log_lock = self._log_lock
        missing: List[Dict[str, Any]] = []
        if log is not None:
            with log_lock:
                missing = log.contiguous(restored_clock)
        evict_clock = rec.get("clock") or {}
        prefix = [
            c for c in missing if c["seq"] <= evict_clock.get(c["actor"], 0)
        ]
        tail = [
            c for c in missing if c["seq"] > evict_clock.get(c["actor"], 0)
        ]
        if prefix:
            # The fresh inner session's patch_log is None here, so the
            # prefix's (re-)patches discard.  Resolve them NOW — patch
            # routing reads session.patch_log at resolution time.
            inner.submit(prefix)
            if slot.plane._thread is not None:
                slot.plane.flush_and_wait()
            else:
                slot.plane.drain()
            if inner._lane:
                raise RuntimeError(
                    f"hydration prefix replay for {sess.name!r} did not "
                    f"fully apply ({len(inner._lane)} submissions stuck)"
                )
        inner.patch_log = rec.get("patch_log")
        if prefix:
            self.stats["replayed_changes"] += len(prefix)
            if telemetry.enabled:
                telemetry.counter("lifecycle.replayed_changes", len(prefix))
        return tail

    def _hydrate_rollback(
        self,
        sess: Any,
        slot: Any,
        rec: Dict[str, Any],
        provisioned: bool,
        new_inner: Any,
        name: str,
        exc: BaseException,
    ) -> None:
        """Unwind a failed hydration: discard the half-built inner lane,
        unprovision the target row, leave the session cold.  Parked client
        submits reject (their callers retry and re-trigger hydration);
        parked deliveries drop — the log holds them."""
        with self.plane._lock:
            if new_inner is not None:
                try:
                    slot.plane.evict_session(name)
                except KeyError:
                    pass
            if provisioned:
                try:
                    self.plane._evacuate_locked(slot, rec["replica"])
                except Exception:
                    _log.warning(
                        "hydrate rollback of session %s could not "
                        "unprovision the row; shard %d carries a stray row",
                        name, slot.index, exc_info=True,
                    )
            buf, sess._parked = sess._parked, None
        for _, wrapper in buf or []:
            if wrapper is not None:
                wrapper._reject(exc)
        self.stats["hydrate_failures"] += 1
        self.stats["rollbacks"] += 1
        if telemetry.enabled:
            telemetry.counter("lifecycle.hydrate_failures")
            telemetry.counter("lifecycle.rollbacks")
            telemetry.record(
                "lifecycle.hydrate", outcome="rolled_back", session=name,
                error=type(exc).__name__,
            )
        telemetry.blackbox_dump(
            "doc_hydrate_failed",
            dedupe_key=f"doc_hydrate:{name}",
            session=name,
            error=f"{type(exc).__name__}: {exc}",
        )

    # -- the durable generation store -----------------------------------------

    def _doc_dir(self, name: str) -> str:
        return os.path.join(
            self.directory, re.sub(r"[^A-Za-z0-9._-]", "_", name)
        )

    def _generations(self, d: str) -> List[int]:
        try:
            names = os.listdir(d)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("gen-") and n.endswith(".json"):
                try:
                    out.append(int(n[4:-5]))
                except ValueError:
                    continue
        return sorted(out)

    def _persist(self, name: str, payload: Dict[str, Any]) -> str:
        """Write one durable generation: npz of the row arrays + a JSON
        sidecar carrying the control planes and both digests (the row
        digest import verifies, and a sha256 of the npz bytes so
        truncation is caught at load).  Atomic tmp+rename for both files;
        prunes past ``keep``; then the ``doc_evict:corrupt`` drill may
        truncate the just-written npz (crash-corruption simulation)."""
        d = self._doc_dir(name)
        os.makedirs(d, exist_ok=True)
        gens = self._generations(d)
        gen = (gens[-1] + 1) if gens else 0
        base = os.path.join(d, f"gen-{gen:08d}")
        buf = io.BytesIO()
        np.savez_compressed(buf, **payload["arrays"])
        blob = buf.getvalue()
        tmp = base + ".npz.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, base + ".npz")
        import hashlib

        sidecar: Dict[str, Any] = {k: payload[k] for k in _SIDECAR_KEYS}
        sidecar["format"] = 1
        sidecar["npz_sha256"] = hashlib.sha256(blob).hexdigest()
        tmp = base + ".json.tmp"
        with open(tmp, "w") as f:
            # default=int: lengths/counts may arrive as numpy scalars.
            json.dump(sidecar, f, default=int)
        os.replace(tmp, base + ".json")
        for old in self._generations(d)[: -self.keep]:
            for suffix in (".json", ".npz"):
                try:
                    os.remove(os.path.join(d, f"gen-{old:08d}{suffix}"))
                except OSError:
                    pass
        if faults.take("doc_evict", "corrupt"):
            with open(base + ".npz", "r+b") as f:
                f.truncate(max(1, len(blob) // 2))
        return base

    def _load_generation(self, base: str) -> Dict[str, Any]:
        from peritext_tpu_torch.runtime import checkpoint

        with open(base + ".json") as f:
            sidecar = json.load(f)
        with open(base + ".npz", "rb") as f:
            blob = f.read()
        import hashlib

        expected = sidecar.get("npz_sha256")
        if expected is not None and hashlib.sha256(blob).hexdigest() != expected:
            raise ValueError(
                f"generation {base!r}: npz digest mismatch (truncated or corrupt)"
            )
        data = np.load(io.BytesIO(blob))
        arrays = {f: data[f] for f in checkpoint._STATE_FIELDS}
        if checkpoint._row_digest(arrays) != sidecar["digest"]:
            raise ValueError(
                f"generation {base!r}: row digest mismatch (corrupt state)"
            )
        payload = {k: sidecar[k] for k in _SIDECAR_KEYS}
        payload["arrays"] = arrays
        return payload

    def _load_latest(
        self, name: str
    ) -> Tuple[Optional[Dict[str, Any]], int]:
        """Newest loadable generation's payload (or None — full replay),
        plus the number of corrupt generations skipped on the way."""
        d = self._doc_dir(name)
        fallbacks = 0
        for gen in reversed(self._generations(d)):
            base = os.path.join(d, f"gen-{gen:08d}")
            try:
                return self._load_generation(base), fallbacks
            except _LOAD_ERRORS as exc:
                fallbacks += 1
                if telemetry.enabled:
                    telemetry.record(
                        "lifecycle.hydrate", outcome="corrupt_fallback",
                        session=name, generation=gen,
                        error=type(exc).__name__,
                    )
                _log.warning(
                    "lifecycle generation %d for %s unreadable (%s: %s); "
                    "falling back", gen, name, type(exc).__name__, exc,
                )
                continue
        return None, fallbacks

    # -- policy: capacity pressure + the LRU reaper ---------------------------

    def _resident_locked(self) -> List[str]:
        return [
            n for n, s in self.plane._sessions.items() if not s._cold
        ]

    def _lru_victim(self, exclude: Optional[str] = None) -> Optional[str]:
        """Least-recently-active resident session eligible for eviction
        (not parked, not cold, not ``exclude``)."""
        with self.plane._lock:
            candidates = [
                n for n, s in self.plane._sessions.items()
                if not s._cold and s._parked is None and n != exclude
            ]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda n: (self._last_active.get(n, float("-inf")), n),
        )

    def _admission_pressure(self, exclude: Optional[str] = None) -> None:
        """Synchronous watermark enforcement: evict LRU residents until
        admitting one more session keeps the fleet at the watermark."""
        if self.watermark <= 0:
            return
        with self._op_lock:
            while True:
                with self.plane._lock:
                    resident = len(self._resident_locked())
                if resident < self.watermark:
                    return
                victim = self._lru_victim(exclude)
                if victim is None:
                    return
                try:
                    self.evict(victim, reason="pressure")
                except (EvictionError, ValueError, KeyError):
                    # Rolled back (or the fleet changed underneath): give
                    # up this sweep — availability beats boundedness, and
                    # the reaper tick retries.
                    self.stats["pressure_failures"] += 1
                    if telemetry.enabled:
                        telemetry.counter("lifecycle.pressure_failures")
                    return

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One reaper decision (cooldown-gated): watermark overflow evicts
        the LRU resident; otherwise the LRU resident idle past ``idle_s``
        with an empty lane evicts.  Returns "evict" or None."""
        self.stats["ticks"] += 1
        if telemetry.enabled:
            telemetry.counter("lifecycle.ticks")
        t = time.monotonic() if now is None else now
        if t - self._last_action_t < self.cooldown:
            return None
        victim: Optional[str] = None
        reason = "idle"
        with self.plane._lock:
            resident = self._resident_locked()
        if self.watermark > 0 and len(resident) > self.watermark:
            victim = self._lru_victim()
            reason = "pressure"
        else:
            idle_candidates = []
            with self.plane._lock:
                for n in resident:
                    s = self.plane._sessions.get(n)
                    if s is None or s._parked is not None or s._cold:
                        continue
                    last = self._last_active.get(n, float("-inf"))
                    if t - last >= self.idle_s and s._inner.pending() == 0:
                        idle_candidates.append((last, n))
            if idle_candidates:
                victim = min(idle_candidates)[1]
        if victim is None:
            return None
        try:
            self.evict(victim, reason=reason)
        except EvictionError:
            self._last_action_t = t
            return None
        except (KeyError, ValueError):
            return None
        self._last_action_t = t
        return "evict"

    # -- observability --------------------------------------------------------

    def _cold_p95_ms(self) -> Optional[float]:
        if not self._cold_starts:
            return None
        xs = sorted(self._cold_starts)
        return xs[min(len(xs) - 1, int(0.95 * (len(xs) - 1) + 0.5))] * 1000.0

    def _status(self) -> Dict[str, Any]:
        plane = self.plane
        with plane._lock:
            resident = len(self._resident_locked())
            evicted = sum(1 for s in plane._sessions.values() if s._cold)
            rows = sum(
                len(s.universe.replica_ids)
                for s in plane.shards
                if s.universe is not None
            )
        docs = resident + evicted
        p95 = self._cold_p95_ms()
        return {
            "plane": plane.name,
            "resident": resident,
            "evicted": evicted,
            "docs": docs,
            "device_rows": rows,
            "tenancy_ratio": round(docs / rows, 3) if rows else None,
            "watermark": self.watermark,
            "idle_s": self.idle_s,
            "cold_start_p95_ms": None if p95 is None else round(p95, 3),
            "last_eviction": self.last_eviction,
            "ticks": self.stats["ticks"],
            "evictions": self.stats["evictions"],
            "hydrations": self.stats["hydrations"],
            "rollbacks": self.stats["rollbacks"],
            "corrupt_fallbacks": self.stats["corrupt_fallbacks"],
            "full_replays": self.stats["full_replays"],
        }

    # -- the loop thread ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or self._closed:
            return
        self._thread = threading.Thread(
            target=self._run,
            name=f"peritext-{self.plane.name}-lifecycle",
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
                    "lifecycle tick failed; the loop survives", exc_info=True
                )

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
