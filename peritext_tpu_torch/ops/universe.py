"""TorchUniverse: a batch of document replicas resident on a GPU.

Counterpart of ``peritext_tpu/ops/universe.py``'s ``TpuUniverse``.  A
universe holds R replica states stacked into one [R, ...] ``DocState`` of
torch tensors, shares actor/attr interning across the batch, and ingests
causally-gated change batches with one merge per call.

``apply_changes`` runs, by default, the exact per-op merge with the two
CUDA kernels (``cuda_kernels.merge_step_full``: text kernel, boundary
permute, mark kernel, table append).  ``PERITEXT_MERGE_PATH=sorted``
selects the JAX package's default route instead, as
``TpuUniverse.apply_changes`` takes it: sort-based placement and the
batched mark phase (``sorted_merge.merge_step_sorted_batch``), inside the
frontier-bounded window when the host census bounds the batch
(``sorted_merge.merge_step_sorted_windowed_batch``, ``ops/window.py``), and
the kernels' merge for batches deeper than ``PERITEXT_SORTED_MAX_ROUNDS``
(counted in ``stats["scan_fallbacks"]``).  On an H100 the sorted route is
several times slower than the kernels' (``PERF.md``), so it is not the
default.  A universe whose capacity is past what the kernels hold in one
block's shared memory (``cuda_kernels.kernel_capacity_limit``) merges on
the sorted route with no depth cap instead, on every device, counted in
``stats["capacity_routes"]``.

``apply_changes_with_patches`` emits each replica's reference patch
stream.  By default it runs the per-op loop ``kernels.apply_ops_patched``;
under ``PERITEXT_MERGE_PATH=sorted`` it takes the JAX package's default
patch route (``sorted_patched``): placement rounds, analytic text records
and the compact-delta scan over mark rows, inside the census window where
one is planned, with a per-slot winner cache (``_wcaches``) carried
between ingests and an allowMultiple group census (``_multi_groups``)
that sends over-cap groups to the per-op loop.  The sorted, windowed and
patch paths are plain torch on the universe's device: the JAX package
runs them as XLA, with no Pallas kernel.

Host responsibilities (the control plane): causal ordering and the
seq/deps gate per replica, wire-op encoding and interning, capacity
pre-checks with re-bucketing, the window census over a host mirror of the
committed element ids, the host object store, and span decoding.  Device
responsibilities (the data plane): all per-op document mutation,
boundary-set algebra, mark resolution and digests.

Every launch runs under the JAX universe's resilience policy
(``_run_launch``): retries with backoff, an optional per-attempt deadline
judged after a host readback barrier, the ``device_launch`` circuit
breaker, and on exhaustion either the oracle CPU degrade path
(``_degrade_apply``, byte-identical to a launch) or a ``DeviceLaunchError``
with nothing committed.  Degradation is on by default for a universe on
the CPU and off for one on the card (``PERITEXT_DEGRADE`` overrides both).
A kernel that cannot build is not retried.
Fault sites, breakers and telemetry are the port's own runtime modules.
Fleet membership changes with ``add_replicas``, ``rename_replica`` and
``drop_replicas``.
"""
from __future__ import annotations

import copy
import functools
import hashlib
import json
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from peritext_tpu_torch import schema
from peritext_tpu_torch.ids import ActorRegistry, make_op_id, parse_op_id
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops import window as W
from peritext_tpu_torch.ops._build import KernelBuildError
from peritext_tpu_torch.ops import sorted_patched as SP
from peritext_tpu_torch.ops.cuda_kernels import kernel_capacity_limit, merge_step_full
from peritext_tpu_torch.ops.sorted_merge import (
    merge_step_sorted_batch,
    merge_step_sorted_windowed_batch,
)
from peritext_tpu_torch.ops.encode import (
    TIME_PAD,
    AttrRegistry,
    bucket_length,
    encode_changes,
    env_int,
    pad_rows,
    prepare_sorted_batch,
    split_rows,
)
from peritext_tpu_torch.ops.patches import (
    assemble_patches,
    assemble_patches_sorted,
    assemble_patches_sorted_compact,
    codepoints_to_str as _codepoints_to_str,
    copy_jsonlike,
    fold_multi_group_rows,
    initial_span_cap,
    patch_readback,
    strip_pos,
)
from peritext_tpu_torch.ops.state import (
    FIELDS,
    MASK_WORD_BITS,
    DocState,
    grow_state,
    make_empty_state,
    map_state,
    state_from_numpy,
    state_to_numpy,
)
from peritext_tpu_torch.oracle.doc import (
    ListItem,
    ObjectStore,
    get_list_element_id,
    get_text_with_formatting as oracle_spans,
    op_from_wire,
    ops_to_marks,
)
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.runtime.sync import causal_order
from peritext_tpu_torch.schema import allow_multiple_array

Change = Dict[str, Any]

_log = logging.getLogger(__name__)


class DeviceLaunchError(RuntimeError):
    """A device launch kept failing after the configured retry budget.

    ``__cause__`` / ``cause`` carry the last attempt's exception.  With
    degradation enabled (the default on the CPU; ``PERITEXT_DEGRADE=1`` on
    the card) callers never see this for ingest: the batch completes on
    the oracle CPU path instead.
    """

    def __init__(self, attempts: int, cause: Optional[BaseException]):
        super().__init__(f"device launch failed after {attempts} attempt(s): {cause!r}")
        self.attempts = attempts
        self.cause = cause


def _launch_policy() -> Tuple[int, float, float]:
    """(retries, backoff base seconds, per-attempt deadline seconds):
    ``PERITEXT_LAUNCH_RETRIES`` extra attempts (default 2) with backoff
    ``PERITEXT_LAUNCH_BACKOFF * 2**i`` (default 0.05 s, capped at 2 s);
    ``PERITEXT_LAUNCH_TIMEOUT`` > 0 adds a wall-clock deadline per attempt,
    judged after the attempt's host readback barrier."""
    return (
        int(os.environ.get("PERITEXT_LAUNCH_RETRIES", "2")),
        float(os.environ.get("PERITEXT_LAUNCH_BACKOFF", "0.05")),
        float(os.environ.get("PERITEXT_LAUNCH_TIMEOUT", "0")),
    )


def _degrade_enabled(device: torch.device) -> bool:
    """``PERITEXT_DEGRADE``: ``0`` raises on retry exhaustion, anything else
    completes the batch on the oracle.  Unset, it is on for a universe on
    the CPU (as in the JAX package) and off for one on the card, so a
    kernel that keeps failing there raises instead of serving from the
    CPU unnoticed."""
    default = "0" if device.type == "cuda" else "1"
    return os.environ.get("PERITEXT_DEGRADE", default) != "0"


# Transient failures retry, semantic errors propagate untouched; torch's
# CUDA errors subclass RuntimeError and so count as transient.
_retryable = faults.retryable


def _blackbox_on_error(fn):
    """Black-box post-mortem on an unhandled ingest exception (a no-op
    unless ``PERITEXT_BLACKBOX`` is armed).  ``DeviceLaunchError`` is left
    out: the retry policy dumped at budget exhaustion already.  The
    exception always propagates unchanged."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except DeviceLaunchError:
            raise
        except Exception as exc:
            telemetry.blackbox_dump(
                "ingest_exception", method=fn.__name__, error=f"{type(exc).__name__}: {exc}"
            )
            raise

    return wrapper


def _window_enabled() -> bool:
    """``PERITEXT_MERGE_WINDOW``: default on; ``0`` pins the full table."""
    return os.environ.get("PERITEXT_MERGE_WINDOW", "1") != "0"


def _window_min_cap() -> int:
    """Smallest capacity the window engages at (``PERITEXT_MERGE_WINDOW_MIN``,
    default 512): below it the census and gather/scatter cost more than
    the window saves."""
    return env_int("PERITEXT_MERGE_WINDOW_MIN", "512", 1)


# Census-rejection backoff (the JAX universe's PERITEXT_WINDOW_BACKOFF
# default): after this many consecutive batches whose census plan_windows
# rejected, the census and its mirror rebuild are skipped for twice as many
# batches, which take the full table.
_WINDOW_BACKOFF = 4


def _merge_path() -> str:
    """``PERITEXT_MERGE_PATH``: ``scan`` (the default, the kernels' exact
    merge) or ``sorted`` (the JAX package's default route)."""
    path = os.environ.get("PERITEXT_MERGE_PATH") or "scan"
    if path not in ("scan", "sorted"):
        raise ValueError(f"PERITEXT_MERGE_PATH must be 'scan' or 'sorted', got {path!r}")
    return path


def _patch_path() -> str:
    """``PERITEXT_PATCH_PATH`` on the sorted route: ``delta`` (unset, the
    compact-delta mark scan) or ``scan`` (the per-op loop)."""
    path = os.environ.get("PERITEXT_PATCH_PATH") or "delta"
    if path not in ("delta", "scan"):
        raise ValueError(f"PERITEXT_PATCH_PATH must be 'delta' or 'scan', got {path!r}")
    return path


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the GPU; without one that is an error, never a silent
    move to the CPU (pass ``device="cpu"`` for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def apply_host_op(store: ObjectStore, op: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Apply one wire-format structural/host-object op to a replica's host
    object store (the oracle's per-object dispatch, micromerge.ts:534-608).
    The device plane is the root text list; every other object lives in the
    host store, which shares the oracle's exact semantics."""
    return store.apply_op(op_from_wire(op))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchUniverse:
    # Process-wide floor of the compact readback's span capacity: an
    # overflow in any universe raises it, so later universes start wide
    # enough.  An explicit PERITEXT_PATCH_SPAN_CAP ignores it.
    _span_cap_floor = 1

    def __init__(
        self,
        replica_ids: Sequence[str],
        capacity: int = 256,
        max_mark_ops: int = 64,
        max_actors: int = 64,
        device: Optional[str | torch.device] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.replica_ids = list(replica_ids)
        self.index_of = {r: i for i, r in enumerate(self.replica_ids)}
        self.actors = ActorRegistry()
        self.attrs = AttrRegistry()
        self.max_actors = max_actors
        self.capacity = capacity
        self.max_mark_ops = max_mark_ops
        n = len(self.replica_ids)
        empty = make_empty_state(capacity, max_mark_ops, self.device)
        self._states_version = 0
        self.states = map_state(lambda x: x.unsqueeze(0).expand(n, *x.shape).contiguous(), empty)
        # Causal mirror of the window census: per-replica numpy copies of the
        # committed element ids, tombstones and boundary definedness, keyed
        # to the states token they were read from (``_states_token``).  Any
        # path that assigns or writes ``states`` without splicing the mirror
        # invalidates it, and the next census rebuilds it with one readback;
        # windowed commits splice the merged windows in instead.  Byte-equal
        # replicas share one mirror and one class id, so a converged fleet
        # pays one census per (class, gate group).
        self._mirror: Optional[List[W.Mirror]] = None
        self._mirror_token: Any = None
        self._mirror_class: List[Any] = []
        self._mirror_class_counter = 0
        self._window_reject_streak = 0
        self._window_census_skip = 0
        # Host control-plane mirrors (never require a device sync).
        self.clocks: List[Dict[str, int]] = [dict() for _ in self.replica_ids]
        self.lengths = [0] * n
        self.mark_counts = [0] * n
        # Host structural plane: per-replica object store plus the permanent
        # device binding (the first root makeList with key "text").  Replicas
        # with equal store_versions may share one ObjectStore instance, so
        # stores are only ever replaced through the _prepare copy-swap.
        self.stores: List[ObjectStore] = [ObjectStore() for _ in self.replica_ids]
        self.store_versions: List[int] = [0] * n
        self._store_version_counter = 0
        self.text_objs: List[Optional[str]] = [None] * n
        self._ranks_cache: Optional[Tuple[Tuple[int, int], torch.Tensor]] = None
        self._multi_cache: Optional[Tuple[bytes, torch.Tensor]] = None
        # allowMultiple group census: (type_id, attr_id) -> distinct (ctr,
        # act_id) op identities over every ingested change, a bound on any
        # replica's group width.  The patched sorted scan resolves a group
        # over at most PATCH_GROUP_K columns; a batch targeting a wider one
        # takes the per-op loop (stats["multi_group_fallbacks"]).
        self._multi_groups: Dict[Tuple[int, int], set] = {}
        # Per-slot per-type winner cache [R, 2C, T, 4] of the patched sorted
        # merge, carried between its ingests so its init runs once.  Derived
        # state: dropped by every path that rewrites boundary rows without
        # maintaining it (the other merges, the per-op loop, degrade,
        # TorchDoc's local path, capacity growth, fleet membership, row
        # imports), and keyed to the actor registry's size, since interning
        # renumbers the ranks it stores.
        self._wcaches: Optional[torch.Tensor] = None
        self._wcaches_actors = 0
        # Per-mark-row span capacity of the compact patch readback; grows
        # when a batch overflows it (_span_overflow).
        if "PERITEXT_PATCH_SPAN_CAP" in os.environ:
            self._span_cap = initial_span_cap()
        else:
            self._span_cap = max(initial_span_cap(), TorchUniverse._span_cap_floor)
        self.stats: Dict[str, Any] = {
            "launches": 0,
            "ops_applied": 0,
            "rows_padded": 0,
            "capacity_growths": 0,
            "changes_ingested": 0,
            "duplicates_dropped": 0,
            # apply_changes' routes: batches deeper than the sorted path's
            # round budget, windowed merges that committed, windowed merges
            # the device census check rejected (relaunched full-table),
            # mirror rebuilds, and batches the census backoff skipped.
            "scan_fallbacks": 0,
            # Patched batches whose allowMultiple group outgrew the sorted
            # scan's cap, and merges the kernels cannot hold (capacity past
            # kernel_capacity_limit) that took the sorted merge instead.
            "multi_group_fallbacks": 0,
            "capacity_routes": 0,
            "windowed_launches": 0,
            "window_fallbacks": 0,
            "window_rebuilds": 0,
            "window_census_skips": 0,
            "readback_overflows": 0,
            # Resilience: extra launch attempts the retry policy took,
            # batches completed on the oracle CPU path after the budget
            # ran out, and launches an open breaker refused outright.
            "launch_retries": 0,
            "degraded_batches": 0,
            "fastfails": 0,
            # Wall time of the host control plane (gate, encode, fuse, pad,
            # upload, commit); the merge itself is asynchronous on the card.
            "host_seconds": 0.0,
            # The patch path's split: the patch merge on the device (the
            # per-op loop or the patched sorted merge, timed to a
            # synchronize), the record readback to the host, and the host's
            # patch assembly.
            "patch_loop_seconds": 0.0,
            "patch_readback_seconds": 0.0,
            "patch_assemble_seconds": 0.0,
        }

    # -- the states and their version ----------------------------------------

    @property
    def states(self) -> DocState:
        return self._states

    @states.setter
    def states(self, value: DocState) -> None:
        self._states = value
        self._states_version += 1

    def _states_token(self) -> Any:
        """Changes whenever ``states`` is assigned or one of its tensors is
        written in place (torch's per-tensor version counter).  Tensors
        that keep no counter (inference mode) give a token equal to
        nothing, so the mirror is always rebuilt."""
        try:
            return (self._states_version,) + tuple(
                getattr(self._states, f)._version for f in FIELDS
            )
        except RuntimeError:
            return object()

    def _replica_axis_changed(self) -> None:
        """Drop what is keyed to the replica axis: the census mirror and its
        classes (the states assignment already moved the version on) and
        the device flag cache."""
        self._mirror = None
        self._mirror_token = None
        self._mirror_class = []
        self._multi_cache = None
        self._wcaches = None

    # -- fleet membership ----------------------------------------------------

    def add_replicas(self, names: Sequence[str]) -> None:
        """Grow the fleet with fresh, empty replicas.  A new replica catches
        up by ingesting ``ChangeLog.missing_changes(log.clock(), {})``
        through the causal gate, as the reference rebuilds any replica."""
        fresh = list(names)
        for n in fresh:
            if n in self.index_of:
                raise ValueError(f"replica {n!r} already exists")
        if not fresh:
            return
        empty = make_empty_state(self.capacity, self.max_mark_ops, self.device)
        k = len(fresh)
        self.states = DocState(**{
            f: torch.cat([getattr(self.states, f), getattr(empty, f).unsqueeze(0).expand(k, *getattr(empty, f).shape)])
            for f in FIELDS
        })
        self._replica_axis_changed()
        for n in fresh:
            self.index_of[n] = len(self.replica_ids)
            self.replica_ids.append(n)
            self.clocks.append({})
            self.lengths.append(0)
            self.mark_counts.append(0)
            self.stores.append(ObjectStore())
            # Version 0 always means an untouched empty store, so fresh
            # replicas may share a version class with untouched founders.
            self.store_versions.append(0)
            self.text_objs.append(None)

    def rename_replica(self, old: str, new: str) -> None:
        """Rebind an empty replica row (one that never ingested anything) to
        a new id: host bookkeeping only, no device work."""
        if new in self.index_of:
            raise ValueError(f"replica {new!r} already exists")
        if old not in self.index_of:
            raise KeyError(f"unknown replica {old!r}")
        i = self.index_of[old]
        if self.clocks[i]:
            raise ValueError(
                f"cannot rename non-empty replica {old!r} (clock {self.clocks[i]}); "
                "only untouched rows rebind"
            )
        del self.index_of[old]
        self.replica_ids[i] = new
        self.index_of[new] = i
        # A fresh store, so the row never aliases a shared version-0 one.
        self.stores[i] = ObjectStore()
        self.store_versions[i] = 0
        self.text_objs[i] = None

    def drop_replicas(self, names: Sequence[str]) -> None:
        """Shrink the fleet with one gather; a dropped replica's state is
        gone (durable history lives in the change log)."""
        drop = set(names)
        missing = drop - set(self.replica_ids)
        if missing:
            raise KeyError(f"unknown replicas: {sorted(missing)}")
        keep = [i for i, n in enumerate(self.replica_ids) if n not in drop]
        if not keep:
            raise ValueError("cannot drop every replica")
        idx = torch.as_tensor(keep, dtype=torch.long, device=self.device)
        self.states = map_state(lambda x: x.index_select(0, idx), self.states)
        self._replica_axis_changed()
        self.replica_ids = [self.replica_ids[i] for i in keep]
        self.index_of = {n: i for i, n in enumerate(self.replica_ids)}
        self.clocks = [self.clocks[i] for i in keep]
        self.lengths = [self.lengths[i] for i in keep]
        self.mark_counts = [self.mark_counts[i] for i in keep]
        self.stores = [self.stores[i] for i in keep]
        self.store_versions = [self.store_versions[i] for i in keep]
        self.text_objs = [self.text_objs[i] for i in keep]

    # -- capacity management ------------------------------------------------

    def _ensure_capacity(self, need_len: int, need_marks: int) -> None:
        new_c, new_m = self.capacity, self.max_mark_ops
        while need_len > new_c:
            new_c *= 2
        while need_marks > new_m:
            new_m *= 2
        if (new_c, new_m) != (self.capacity, self.max_mark_ops):
            self.stats["capacity_growths"] += 1
            self.states = grow_state(self.states, new_c, new_m)
            self.capacity, self.max_mark_ops = new_c, new_m
            self._wcaches = None  # slot coordinates changed shape

    def _ranks(self) -> np.ndarray:
        ranks = self.actors.ranks()
        n = self.max_actors
        while len(ranks) > n:
            n *= 2
        self.max_actors = n
        out = np.zeros(n, np.int32)
        out[: len(ranks)] = ranks
        return out

    def _ranks_device(self) -> torch.Tensor:
        """Device rank table, uploaded once per actor-registry change
        (interning renumbers ranks)."""
        key = (len(self.actors.actors), self.max_actors)
        if self._ranks_cache is None or self._ranks_cache[0] != key:
            ranks = torch.from_numpy(self._ranks()).to(self.device)
            self._ranks_cache = ((len(self.actors.actors), self.max_actors), ranks)
        return self._ranks_cache[1]

    def _multi_device(self) -> torch.Tensor:
        """Device allowMultiple flags, uploaded again only when the mark
        type registry changes."""
        arr = allow_multiple_array()
        key = arr.tobytes()
        if self._multi_cache is None or self._multi_cache[0] != key:
            self._multi_cache = (key, torch.from_numpy(arr).to(self.device))
        return self._multi_cache[1]

    # -- resilient launch policy -------------------------------------------

    def _run_launch(self, attempt, needs_barrier: bool = False):
        """Run a device-launch attempt under the retry/backoff policy
        (``TpuUniverse._run_launch``).

        ``attempt()`` fires the ``device_launch`` site itself, runs the
        merge against the committed states and returns ``(result,
        barrier_tensor)``.  Nothing it does writes ``self`` or a committed
        tensor (every merge writes fresh outputs), so a failed attempt
        needs no rollback: its result is dropped and the next attempt
        reruns from the same inputs.

        With ``needs_barrier`` (``PERITEXT_STRICT_COMMIT=1``) or a
        ``PERITEXT_LAUNCH_TIMEOUT``, each attempt ends with a host copy of
        ``barrier_tensor``: on a GPU that is where an asynchronous CUDA
        error surfaces, so a fault of the merge fails its attempt instead of
        being committed; the deadline is judged after it.  After the budget
        is spent, raises :class:`DeviceLaunchError` carrying the last cause.

        An active ``device_launch`` breaker gates every launch: open
        fast-fails with no attempt (``stats["fastfails"]``), half-open
        admits one canary attempt, and a trip mid-budget stops the retries.
        """
        br = health.breaker("device_launch")
        decision = health.ALLOW if br is None else br.admit()
        if decision == health.FASTFAIL:
            self.stats["fastfails"] += 1
            if telemetry.enabled:
                telemetry.flow_keep()
                telemetry.record("ingest.launch", flow=telemetry.current_flow(), outcome="fastfail")
            raise DeviceLaunchError(0, health.BreakerOpenError("device_launch"))
        retries, backoff, timeout = _launch_policy()
        if decision == health.CANARY:
            retries = 0  # half-open admits exactly one probe launch
        last: Optional[BaseException] = None
        attempts = 0
        try:
            for i in range(retries + 1):
                if i:
                    self.stats["launch_retries"] += 1
                    sleep_s = min(backoff * (2 ** (i - 1)), 2.0)
                    if telemetry.enabled:
                        telemetry.counter("ingest.launch_retries")
                        telemetry.observe("ingest.backoff_seconds", sleep_s)
                    time.sleep(sleep_s)
                t0 = time.monotonic()
                attempts = i + 1
                try:
                    if telemetry.enabled:
                        telemetry.counter("ingest.launch_attempts")
                    with telemetry.span("ingest.launch_attempt", attempt=i):
                        if telemetry.enabled:
                            telemetry.flow_steps(attempt=i)
                        result, barrier = attempt()
                        if needs_barrier or timeout > 0:
                            faults.fire("device_readback")
                            tb = time.monotonic()
                            barrier.cpu()
                            if telemetry.enabled:
                                telemetry.observe("ingest.readback_wait_seconds", time.monotonic() - tb)
                            if timeout > 0 and time.monotonic() - t0 > timeout:
                                raise TimeoutError(
                                    f"device launch attempt exceeded the {timeout}s deadline"
                                )
                except Exception as exc:
                    if isinstance(exc, KernelBuildError) or not _retryable(exc):
                        # A semantic error, or a kernel that cannot build:
                        # no backend-health signal, and a rerun fails alike.
                        raise
                    if telemetry.enabled:
                        telemetry.counter("ingest.launch_failures")
                        telemetry.flow_keep()
                        telemetry.record(
                            "ingest.launch", flow=telemetry.current_flow(), outcome="fail",
                            attempt=i, error=type(exc).__name__,
                        )
                    if br is not None:
                        br.record_failure()
                    last = exc
                    if br is not None and br.state == health.OPEN:
                        break  # tripped mid-budget: stop spending retries
                    continue
                if br is not None:
                    br.record_success()
                if telemetry.enabled:
                    telemetry.record("ingest.launch", flow=telemetry.current_flow(), outcome="ok", attempt=i)
                return result
            telemetry.blackbox_dump(
                "launch_budget_exhausted", site="device_launch", attempts=attempts, cause=repr(last)
            )
            raise DeviceLaunchError(attempts, last) from last
        except BaseException:
            # A verdict-less exit (a semantic error, an interrupt) releases a
            # held canary slot, or the breaker would fast-fail for ever.
            if br is not None:
                br.abandon()
            raise

    # -- oracle degradation (the CPU path after retry exhaustion) -------------

    def _degrade_apply(self, prep: Dict[str, Any]) -> Dict[int, List[Any]]:
        """Traced wrapper of :meth:`_degrade_apply_impl` (every causal lane
        riding the batch steps through the degradation)."""
        with telemetry.span("ingest.degrade", ingested=prep["ingested"]):
            if telemetry.enabled:
                telemetry.flow_keep()
                telemetry.flow_steps(path="degrade")
                telemetry.record("ingest.degrade", outcome="ok", ingested=prep["ingested"])
            return self._degrade_apply_impl(prep)

    def _degrade_apply_impl(self, prep: Dict[str, Any]) -> Dict[int, List[Any]]:
        """Complete a prepared batch through the oracle CPU engine
        (``TpuUniverse._degrade_apply_impl``), per replica with a non-empty
        gated batch:

        1. read the committed states back (``state_to_numpy``, the JAX
           dtypes) and materialize each replica's text list into oracle
           metadata inside a copy of its host store;
        2. apply every gated wire op through ``store.apply_op``;
        3. convert the list back into dense arrays (new mark ops append to
           the table in batch order, as the merge would) and restore the
           store's device placeholder.

        Nothing of ``self`` changes until every replica converted; then the
        arrays go back to the universe's device (``state_from_numpy``) and
        the batch commits.  Returns each replica's ``(pos, patch)`` stream.
        """
        groups, group_of = prep["groups"], prep["group_of"]
        self.stats["degraded_batches"] += 1
        if telemetry.enabled:
            telemetry.counter("ingest.degraded_batches")
            telemetry.counter("ingest.path.degraded")
        _log.warning(
            "device launch retry budget exhausted; ingesting %d change(s) via the oracle CPU "
            "degradation path", prep["ingested"],
        )
        # One readback of the committed states; writable copies, which
        # become the new device tensors.
        arrays = {f: np.array(a) for f, a in state_to_numpy(self.states).items()}
        elem_ctr, elem_act, deleted, chars = (arrays[f] for f in ("elem_ctr", "elem_act", "deleted", "chars"))
        bnd_def, bnd_mask = arrays["bnd_def"], arrays["bnd_mask"]
        mark_cols = {f: arrays["mark_" + f] for f in ("ctr", "act", "action", "type", "attr")}
        length_col, mark_count_col = arrays["length"], arrays["mark_count"]
        words = bnd_mask.shape[-1]

        out: Dict[int, List[Any]] = {}
        staged: List[Tuple[int, ObjectStore]] = []
        for r in range(len(self.replica_ids)):
            g = groups[group_of[r]]
            if not g["ordered"]:
                out[r] = []
                continue
            store = copy.deepcopy(self.stores[r])
            text_obj = g["text_obj"] if g["text_obj"] is not None else self.text_objs[r]
            n_el = self.lengths[r]
            n_mk = self.mark_counts[r]
            # Ids of the existing mark table rows (bit m <=> table row m).
            old_mark_ids = [
                make_op_id(int(mark_cols["ctr"][r, m]), self.actors.actor(int(mark_cols["act"][r, m])))
                for m in range(n_mk)
            ]
            char_of: Dict[str, int] = {}
            injected_ids: List[str] = []
            text_mark_new: List[str] = []

            if text_obj is not None and isinstance(store.metadata.get(text_obj), list):
                # 1. Materialize the device plane into the store copy.
                store.device_objects.discard(text_obj)
                values = store.objects[text_obj]
                values.clear()  # in place: the parent map aliases this list
                meta: List[ListItem] = []
                for i in range(n_el):
                    eid = make_op_id(int(elem_ctr[r, i]), self.actors.actor(int(elem_act[r, i])))
                    item = ListItem(eid, eid, bool(deleted[r, i]))
                    for side, p in (("before", 2 * i), ("after", 2 * i + 1)):
                        if bnd_def[r, p]:
                            row = bnd_mask[r, p]
                            item.set_side(
                                side, {old_mark_ids[m] for m in range(n_mk) if row[m // 32] >> (m % 32) & 1}
                            )
                    meta.append(item)
                    char_of[eid] = int(chars[r, i])
                    if not item.deleted:
                        values.append(chr(int(chars[r, i])))
                store.metadata[text_obj] = meta
                for m, op_id in enumerate(old_mark_ids):
                    if op_id not in store.mark_ops:
                        op: Dict[str, Any] = {
                            "opId": op_id,
                            "action": "addMark" if int(mark_cols["action"][r, m]) == 0 else "removeMark",
                            "markType": schema.ALL_MARKS[int(mark_cols["type"][r, m])],
                        }
                        attrs = self.attrs.decode(int(mark_cols["attr"][r, m]))
                        if attrs is not None:
                            op["attrs"] = attrs
                        store.mark_ops[op_id] = op
                        injected_ids.append(op_id)

            # 2. Sequential oracle application of the whole gated batch.
            pairs: List[Any] = []
            pos = 0
            for change in g["ordered"]:
                for op in change["ops"]:
                    pairs.extend((pos, p) for p in apply_host_op(store, op))
                    if op.get("obj") == text_obj and op["action"] in ("addMark", "removeMark"):
                        text_mark_new.append(op["opId"])
                    pos += 1

            # 3. The (possibly batch-created) text list back into dense
            # arrays, and the placeholder restored.
            if text_obj is not None and isinstance(store.metadata.get(text_obj), list):
                final_meta: List[ListItem] = store.metadata[text_obj]
                rows = g["rows"]
                for row in rows:
                    if row[K.K_KIND] == K.KIND_INSERT:
                        char_of[make_op_id(int(row[K.K_CTR]), self.actors.actor(int(row[K.K_ACT])))] = int(
                            row[K.K_PAYLOAD]
                        )
                mark_rows = rows[rows[:, K.K_KIND] == K.KIND_MARK]
                new_table_ids = old_mark_ids + [
                    make_op_id(int(mr[K.K_CTR]), self.actors.actor(int(mr[K.K_ACT]))) for mr in mark_rows
                ]
                if len(final_meta) != int(prep["new_lengths"][r]) or len(new_table_ids) != int(
                    prep["new_mark_counts"][r]
                ):
                    raise RuntimeError(
                        "oracle degradation produced inconsistent capacity accounting for replica "
                        f"{self.replica_ids[r]!r}: {len(final_meta)} elements (expected "
                        f"{int(prep['new_lengths'][r])}), {len(new_table_ids)} mark ops (expected "
                        f"{int(prep['new_mark_counts'][r])})"
                    )
                bit_of = {op_id: m for m, op_id in enumerate(new_table_ids)}
                C = self.capacity
                ec = np.zeros(C, np.int32)
                ea = np.zeros(C, np.int32)
                dl = np.zeros(C, bool)
                ch = np.zeros(C, np.int32)
                bd = np.zeros(2 * C, bool)
                bm = np.zeros((2 * C, words), np.uint32)
                for i, item in enumerate(final_meta):
                    ctr_, actor_ = parse_op_id(item.elem_id)
                    ec[i] = ctr_
                    ea[i] = self.actors.id_of(actor_)
                    dl[i] = item.deleted
                    ch[i] = char_of[item.elem_id]
                    for side, p in (("before", 2 * i), ("after", 2 * i + 1)):
                        ops_set = item.get_side(side)
                        if ops_set is not None:
                            bd[p] = True
                            for op_id in ops_set:
                                m = bit_of[op_id]
                                bm[p, m // 32] |= np.uint32(1 << (m % 32))
                elem_ctr[r], elem_act[r] = ec, ea
                deleted[r], chars[r] = dl, ch
                bnd_def[r], bnd_mask[r] = bd, bm
                for m, mr in enumerate(mark_rows, start=n_mk):
                    mark_cols["ctr"][r, m] = int(mr[K.K_CTR])
                    mark_cols["act"][r, m] = int(mr[K.K_ACT])
                    mark_cols["action"][r, m] = int(mr[K.K_MACTION])
                    mark_cols["type"][r, m] = int(mr[K.K_MTYPE])
                    mark_cols["attr"][r, m] = int(mr[K.K_MATTR])
                length_col[r] = len(final_meta)
                mark_count_col[r] = len(new_table_ids)
                store.objects[text_obj].clear()
                store.metadata[text_obj] = []
                store.device_objects.add(text_obj)
                for op_id in injected_ids + text_mark_new:
                    store.mark_ops.pop(op_id, None)
            out[r] = pairs
            staged.append((r, store))

        # Every replica converted: publish the device plane, stage the
        # applied stores (a fresh version class each) and commit.
        self.states = state_from_numpy(arrays, self.device)
        self._wcaches = None  # boundary rows rewritten outside the merges
        for r, store in staged:
            self._store_version_counter += 1
            prep["new_stores"][r] = store
            prep["new_store_versions"][r] = self._store_version_counter
        self._commit(prep)
        return out

    # -- the causal gate (host) --------------------------------------------

    def _gate(self, clock: Dict[str, int], changes: Sequence[Change]) -> Tuple[List[Change], int]:
        """Order + validate a change batch against a replica clock (the
        reference's applyChange seq/deps gate, micromerge.ts:501-509, and
        retry loop, test/merge.ts:4-23).  Already-seen changes drop.
        ``clock`` is mutated in place; callers pass a copy and commit it
        only after the device merge succeeds."""
        seen = set()
        fresh = []
        dupes = 0
        for c in changes:
            key = (c["actor"], c["seq"])
            if c["seq"] > clock.get(c["actor"], 0) and key not in seen:
                seen.add(key)
                fresh.append(c)
            else:
                dupes += 1
        ordered = causal_order(fresh, clock)
        for change in ordered:
            clock[change["actor"]] = change["seq"]
        return ordered, dupes

    def _prepare(self, batches: List[Sequence[Change]]) -> Dict[str, Any]:
        """Gate + encode every replica without touching committed state.

        Raises before any commit if any replica's batch is causally
        unsatisfiable.  Gate and encode are memoized per distinct (batch
        content, clock, text object) group, so a fleet ingesting one shared
        stream pays for one encode, not one per replica."""
        n = len(batches)
        groups: List[Dict[str, Any]] = []
        memo: Dict[Any, int] = {}
        group_of = np.zeros(n, np.int32)
        n_ingested = 0
        hash_by_id: Dict[int, str] = {}

        def change_digest(c: Change) -> str:
            h = hash_by_id.get(id(c))
            if h is None:
                h = hashlib.sha1(
                    json.dumps(c, sort_keys=True, separators=(",", ":")).encode()
                ).hexdigest()
                hash_by_id[id(c)] = h
            return h

        for r, changes in enumerate(batches):
            clock = self.clocks[r]
            text_obj = self.text_objs[r]
            key = (
                tuple(change_digest(c) for c in changes),
                tuple(sorted(clock.items())),
                text_obj,
            )
            gi = memo.get(key)
            if gi is None:
                new_clock = dict(clock) if changes else clock
                ordered, dupes = self._gate(new_clock, changes)
                rows, host_ops, counts = encode_changes(
                    ordered, self.actors, self.attrs, text_obj=text_obj
                )
                gi = len(groups)
                memo[key] = gi
                groups.append(
                    {
                        "clock": new_clock,
                        "ordered": ordered,
                        "dupes": dupes,
                        "rows": rows,
                        "host_ops": host_ops,
                        "row_pos": counts["row_pos"],
                        "text_obj": counts["text_obj"],
                        "inserts": counts["insert"],
                        "marks": counts["mark"],
                    }
                )
            n_ingested += len(groups[gi]["ordered"])
            group_of[r] = gi

        # Host structural ops dry-run against store copies, one per (group,
        # store version) class; a bad op raises here, before any commit.
        # Their patches are kept per class, tagged with each op's position
        # in the batch stream, for the patch path to interleave.
        new_stores: Dict[int, ObjectStore] = {}
        new_versions: Dict[int, int] = {}
        host_patches: Dict[int, List[Any]] = {}
        by_class: Dict[Any, Any] = {}
        for r in range(n):
            g = groups[group_of[r]]
            if not g["host_ops"]:
                continue
            key = (group_of[r], self.store_versions[r])
            hit = by_class.get(key)
            if hit is None:
                store = copy.deepcopy(self.stores[r])
                emitted: List[Any] = []
                for pos, op in g["host_ops"]:
                    emitted.extend((pos, p) for p in apply_host_op(store, op))
                if g["text_obj"] is not None:
                    store.device_objects.add(g["text_obj"])
                self._store_version_counter += 1
                hit = by_class[key] = (store, self._store_version_counter, emitted)
            new_stores[r], new_versions[r], host_patches[r] = hit

        ins = np.asarray([g["inserts"] for g in groups], np.int64)[group_of]
        mks = np.asarray([g["marks"] for g in groups], np.int64)[group_of]
        lengths = np.asarray(self.lengths, np.int64) + ins
        mark_counts = np.asarray(self.mark_counts, np.int64) + mks
        return {
            "groups": groups,
            "group_of": group_of,
            "new_stores": new_stores,
            "new_store_versions": new_versions,
            "host_patches": host_patches,
            "new_lengths": lengths,
            "new_mark_counts": mark_counts,
            "ingested": n_ingested,
            "need_len": int(lengths.max(initial=0)),
            "need_marks": int(mark_counts.max(initial=0)),
        }

    def _commit(self, prep: Dict[str, Any]) -> None:
        """Publish a prepared batch's control-plane effects (post-merge)."""
        groups = prep["groups"]
        group_of = prep["group_of"]
        self.lengths = [int(v) for v in prep["new_lengths"]]
        self.mark_counts = [int(v) for v in prep["new_mark_counts"]]
        for r in range(len(self.replica_ids)):
            g = groups[group_of[r]]
            if g["ordered"]:
                self.clocks[r] = dict(g["clock"])
            if r in prep["new_stores"]:
                self.stores[r] = prep["new_stores"][r]
                self.store_versions[r] = prep["new_store_versions"][r]
                if g["text_obj"] is not None:
                    self.text_objs[r] = g["text_obj"]
        self.stats["changes_ingested"] += prep["ingested"]
        sizes = np.bincount(group_of, minlength=len(groups))
        dupes = np.asarray([g["dupes"] for g in groups], np.int64)
        self.stats["duplicates_dropped"] += int((dupes * sizes).sum())
        for g in groups:
            self._count_multi_groups(g["rows"])

    def _count_multi_groups(self, rows: np.ndarray) -> None:
        """Fold a batch's allowMultiple mark rows into ``_multi_groups``."""
        fold_multi_group_rows(self._multi_groups, rows)

    def _multi_group_need(self, extra_rows: List[np.ndarray]) -> int:
        """Largest allowMultiple group any of this batch's multi ops
        targets once ``extra_rows`` land (``TpuUniverse._multi_group_need``;
        unioned over all replicas, 0 without multi ops, saturating at
        PATCH_GROUP_K + 1)."""
        pending: Dict[Tuple[int, int], set] = {}
        for rows in extra_rows:
            fold_multi_group_rows(pending, rows)
        return max(
            (len(ops | self._multi_groups.get(key, set())) for key, ops in pending.items()),
            default=0,
        )

    def _account_rows(self, groups, group_of):
        """Replicas per group and rows per group; tallies ops_applied."""
        sizes = np.bincount(group_of, minlength=len(groups))
        row_counts = np.asarray([g["rows"].shape[0] for g in groups], np.int64)
        self.stats["ops_applied"] += int((row_counts * sizes).sum())
        return sizes, row_counts

    def _normalize_batches(
        self, per_replica: Dict[str, Sequence[Change]] | List[Sequence[Change]]
    ) -> List[Sequence[Change]]:
        if isinstance(per_replica, dict):
            batches: List[Sequence[Change]] = [[] for _ in self.replica_ids]
            for name, changes in per_replica.items():
                batches[self.index_of[name]] = changes
            return batches
        batches = list(per_replica)
        if len(batches) != len(self.replica_ids):
            raise ValueError("need one change list per replica")
        return batches

    # -- frontier-bounded window: host census and causal mirror -------------

    def _mirrors(self) -> List[W.Mirror]:
        """Per-replica causal mirrors, rebuilt with one readback whenever
        the states changed since the last windowed commit."""
        if self._mirror is not None and self._mirror_token == self._states_token():
            return self._mirror
        ec, ea, dl, bd = (
            _numpy(getattr(self.states, f)) for f in ("elem_ctr", "elem_act", "deleted", "bnd_def")
        )
        mirrors: List[W.Mirror] = []
        classes: List[Any] = []
        shared: Dict[str, W.Mirror] = {}
        for r, n in enumerate(self.lengths):
            parts = (ec[r, :n], ea[r, :n], dl[r, :n], bd[r, : 2 * n])
            digest = hashlib.sha1(b"".join(p.tobytes() for p in parts)).hexdigest()
            m = shared.get(digest)
            if m is None:
                m = shared[digest] = W.make_mirror(*(p.copy() for p in parts))
            mirrors.append(m)
            classes.append(digest)
        self._mirror = mirrors
        self._mirror_class = classes
        self._mirror_token = self._states_token()
        self.stats["window_rebuilds"] += 1
        return mirrors

    def _window_plan(self, prep: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The window plan of a prepared batch, or None for the full table
        (``TpuUniverse._window_plan``): off under PERITEXT_MERGE_WINDOW=0,
        under replica chunking (PERITEXT_SORTED_CHUNK or
        PERITEXT_PATCH_CHUNK set), below PERITEXT_MERGE_WINDOW_MIN, when a
        replica with rows has an empty document, while the census backoff
        skips, and when plan_windows cannot bound the batch or its window
        would cover over half the table."""
        if not _window_enabled():
            return None
        if os.environ.get("PERITEXT_SORTED_CHUNK") or os.environ.get("PERITEXT_PATCH_CHUNK"):
            return None
        if self.capacity < _window_min_cap():
            return None
        groups, group_of = prep["groups"], prep["group_of"]
        n = len(self.replica_ids)
        rows_of = [groups[group_of[r]]["rows"] for r in range(n)]
        ins_of = [int(groups[group_of[r]]["inserts"]) for r in range(n)]
        # Genesis fast-reject before the mirror readback: the census of an
        # empty document with rows always fails.
        if any(self.lengths[r] == 0 and rows_of[r].shape[0] for r in range(n)):
            return None
        if self._window_census_skip > 0:
            self._window_census_skip -= 1
            self.stats["window_census_skips"] += 1
            return None
        mirrors = self._mirrors()
        keys = [(self._mirror_class[r], int(group_of[r])) for r in range(n)]
        plan = W.plan_windows(
            mirrors, rows_of, ins_of, self._ranks(), self.capacity, _window_min_cap(),
            census_keys=keys,
        )
        if plan is None:
            self._window_reject_streak += 1
            if self._window_reject_streak >= _WINDOW_BACKOFF:
                self._window_census_skip = 2 * _WINDOW_BACKOFF
                self._window_reject_streak = 0
        else:
            self._window_reject_streak = 0
        return plan

    def _mirror_commit(self, wplan: Dict[str, Any], wrec: Dict[str, np.ndarray], prep: Dict[str, Any]) -> None:
        """Splice a windowed merge's window readback into the mirrors and key
        them to the just-committed states.  Members of one (mirror class,
        gate group) share the spliced mirror and a new class id."""
        groups, group_of = prep["groups"], prep["group_of"]
        starts, hulls = wplan["starts"], wplan["hulls"]
        mirrors = self._mirror
        shared: Dict[Any, Tuple[W.Mirror, int]] = {}
        for r in range(len(self.replica_ids)):
            hull = int(hulls[r])
            ins = int(groups[group_of[r]]["inserts"])
            if hull == 0 and ins == 0:
                continue
            key = (self._mirror_class[r], int(group_of[r]))
            hit = shared.get(key)
            if hit is None:
                self._mirror_class_counter += 1
                spliced = W.splice_mirror(
                    mirrors[r], int(starts[r]), hull, hull + ins,
                    wrec["w_ctr"][r], wrec["w_act"][r], wrec["w_del"][r], wrec["w_def"][r],
                )
                hit = shared[key] = (spliced, self._mirror_class_counter)
            mirrors[r], self._mirror_class[r] = hit
        self._mirror_token = self._states_token()

    def _window_fallback(self) -> None:
        """Count a windowed merge the device census check rejected: its
        result is discarded and the full table runs (correctness never
        rests on the census).  It ran, so it counts as a launch."""
        self.stats["window_fallbacks"] += 1
        self.stats["launches"] += 1
        _log.warning("windowed merge census check failed on device; relaunching the full-table path")

    @_blackbox_on_error
    def apply_changes(
        self, per_replica: Dict[str, Sequence[Change]] | List[Sequence[Change]]
    ) -> None:
        """Apply a batch of changes to each named replica in one merge.

        Gate + encode run first for all replicas against clock copies; the
        control plane (clocks, lengths, host stores) commits only after the
        merge, so a causally-unready change in one replica's batch never
        strands another replica's clock ahead of its device state.

        By default the batch runs the exact per-op merge with the two CUDA
        kernels, its runs fused to MAX_RUN_LEN.  Under
        ``PERITEXT_MERGE_PATH=sorted`` the merge is chosen as
        ``TpuUniverse.apply_changes`` chooses it by default: text rows fuse
        into unbounded insert runs and place in O(reference depth) rounds
        (``merge_step_sorted_batch``), inside the census window when one is
        planned; a window the device check rejects is counted and
        relaunched on the full table, and a batch deeper than
        ``PERITEXT_SORTED_MAX_ROUNDS`` (default 8) takes the kernels'
        merge, counted in ``stats["scan_fallbacks"]``.

        When the capacity is past what the kernels hold
        (``kernel_capacity_limit``), every batch the kernels would have
        taken (each one on the default route, a deep one on the sorted
        route) takes the sorted merge with no depth cap instead, counted in
        ``stats["capacity_routes"]``: the choice is made from the shapes
        before the launch, the same on every device.  Every merge runs
        under ``_run_launch``; a batch whose launch budget runs out
        raises ``DeviceLaunchError`` with nothing committed, or completes
        on the oracle CPU path where degradation is on (``_degrade_enabled``).
        """
        t_host = time.perf_counter()
        use_scan = _merge_path() == "scan"
        batches = self._normalize_batches(per_replica)
        prep = self._prepare(batches)
        groups, group_of = prep["groups"], prep["group_of"]

        text_rows_list: List[np.ndarray] = []
        mark_rows_list: List[np.ndarray] = []
        for g in groups:
            text_rows, mark_rows = split_rows(g["rows"])
            text_rows_list.append(text_rows)
            mark_rows_list.append(mark_rows)
        sizes, row_counts = self._account_rows(groups, group_of)
        self._ensure_capacity(prep["need_len"], prep["need_marks"])
        if not row_counts.any():
            self._commit(prep)
            self.stats["host_seconds"] += time.perf_counter() - t_host
            return
        max_rounds = None if use_scan else env_int("PERITEXT_SORTED_MAX_ROUNDS", "8", 0)
        if self.capacity <= kernel_capacity_limit(self.max_mark_ops // MASK_WORD_BITS):
            sorted_prep = prepare_sorted_batch(
                text_rows_list, max_run=K.MAX_RUN_LEN if use_scan else 0,
                fallback_max_rounds=max_rounds,
            )
            if sorted_prep["fell_back"]:
                use_scan = True
                self.stats["scan_fallbacks"] += 1
        else:
            # The capacity route: the kernels cannot hold this capacity, so
            # a batch they would take places in as many rounds as it needs.
            sorted_prep = prepare_sorted_batch(text_rows_list, max_run=0)
            if use_scan or sorted_prep["num_rounds"] > max_rounds:
                self.stats["capacity_routes"] += 1
                if telemetry.enabled:
                    telemetry.counter("ingest.path.capacity")
            use_scan = False
        mark_pad = bucket_length(max(max(m.shape[0] for m in mark_rows_list), 1))
        g_mark = np.stack([pad_rows(rows, mark_pad) for rows in mark_rows_list])
        pad_per_group = (sorted_prep["text"][:, :, K.K_KIND] == K.KIND_PAD).sum(axis=1) + (
            g_mark[:, :, K.K_KIND] == K.KIND_PAD
        ).sum(axis=1)
        self.stats["rows_padded"] += int((pad_per_group * sizes).sum())
        wplan = None if use_scan else self._window_plan(prep)

        # Upload one copy per group; the replica batch is a device gather.
        idx = torch.from_numpy(group_of.astype(np.int64)).to(self.device)

        def per_replica_rows(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device).index_select(0, idx).contiguous()

        text = per_replica_rows(sorted_prep["text"])
        marks = per_replica_rows(g_mark)
        bufs = per_replica_rows(sorted_prep["bufs"])
        ranks = self._ranks_device()
        if not use_scan:
            rounds = per_replica_rows(sorted_prep["rounds"])
            sorted_args = (text, rounds, sorted_prep["num_rounds"], marks, ranks, bufs, sorted_prep["maxk"])
        self.stats["host_seconds"] += time.perf_counter() - t_host

        strict = os.environ.get("PERITEXT_STRICT_COMMIT") == "1"

        def h2d_bytes() -> int:
            return sum(t.numel() * t.element_size() for t in (text, marks, bufs))

        if wplan is not None:
            starts, hulls = (torch.from_numpy(wplan[k]).to(self.device) for k in ("starts", "hulls"))

            def wattempt():
                faults.fire("device_launch")
                st, wrec = merge_step_sorted_windowed_batch(self.states, starts, hulls, *sorted_args, wplan["w_cap"])
                faults.fire("device_readback")
                # The verdict and mirror readback is this path's barrier.
                return (st, {k: _numpy(v) for k, v in wrec.items()}), st.length

            try:
                new_states, wrec_np = self._run_launch(wattempt, needs_barrier=strict)
            except DeviceLaunchError:
                if not _degrade_enabled(self.device):
                    raise
                self._degrade_apply(prep)
                return
            if wrec_np["wok"].all():
                self.states = new_states
                self.stats["launches"] += 1
                self.stats["windowed_launches"] += 1
                if telemetry.enabled:
                    telemetry.flow_steps(path="windowed", window=int(wplan["w_cap"]))
                    for name in ("ingest.launches", "ingest.path.sorted", "ingest.path.windowed"):
                        telemetry.counter(name)
                    telemetry.counter("ingest.h2d_bytes", h2d_bytes())
                    telemetry.counter("ingest.d2h_bytes", int(sum(v.nbytes for v in wrec_np.values())))
                t_host = time.perf_counter()
                self._wcaches = None
                self._mirror_commit(wplan, wrec_np, prep)
                self._commit(prep)
                self.stats["host_seconds"] += time.perf_counter() - t_host
                return
            self._window_fallback()

        def attempt():
            faults.fire("device_launch")
            if use_scan:
                st = merge_step_full(self.states, text, marks, ranks, bufs)
            else:
                st = merge_step_sorted_batch(self.states, *sorted_args)
            return st, st.length

        # PERITEXT_STRICT_COMMIT=1: the attempt ends with a host readback,
        # so a merge that fails on the device fails its attempt (and leaves
        # the committed state as it was) instead of surfacing at a later
        # readback behind a committed control plane.
        try:
            new_states = self._run_launch(attempt, needs_barrier=strict)
        except DeviceLaunchError:
            if not _degrade_enabled(self.device):
                raise  # nothing was assigned: the committed state is untouched
            self._degrade_apply(prep)
            return
        self.states = new_states
        self.stats["launches"] += 1
        if telemetry.enabled:
            telemetry.counter("ingest.launches")
            telemetry.counter("ingest.path.scan" if use_scan else "ingest.path.sorted")
            telemetry.counter("ingest.h2d_bytes", h2d_bytes())
        # The no-patch merges rewrite boundary rows without maintaining the
        # patched route's winner cache.
        self._wcaches = None
        t_host = time.perf_counter()
        self._commit(prep)
        self.stats["host_seconds"] += time.perf_counter() - t_host

    # -- patch-emitting ingestion -------------------------------------------

    @staticmethod
    def _patch_chunk(n: int, limit: Optional[int] = None) -> int:
        """Replicas per patch-path launch (``PERITEXT_PATCH_CHUNK``, 0 or
        unset = all, and at most ``limit``), equalized so the chunks differ
        by at most one."""
        chunk = min(env_int("PERITEXT_PATCH_CHUNK", "0", 0) or n, limit or n)
        return math.ceil(n / math.ceil(n / chunk))

    def _span_overflow(self, record_chunks: List[Dict[str, np.ndarray]], span_cap: int) -> bool:
        """Did a mark row's true span count exceed the compact tables?  If
        so, count it and grow the cap (pow2) to the largest count seen, and
        the class floor unless the cap is pinned by the environment."""
        overflow = max((int(rec["mcount"].max(initial=0)) for rec in record_chunks), default=0)
        if overflow <= span_cap:
            return False
        self.stats["readback_overflows"] += 1
        self._span_cap = bucket_length(overflow, minimum=1)
        if "PERITEXT_PATCH_SPAN_CAP" not in os.environ:
            TorchUniverse._span_cap_floor = max(TorchUniverse._span_cap_floor, self._span_cap)
        return True

    @_blackbox_on_error
    def apply_changes_with_patches(
        self,
        per_replica: Dict[str, Sequence[Change]] | List[Sequence[Change]],
        with_positions: bool = False,
    ) -> Dict[str, List[Any]]:
        """Causally gated ingestion that also returns each replica's
        reference patch stream (micromerge.ts:25-30).

        By default the batch runs the exact per-op loop
        (``TpuUniverse._patched_scan``).  Under ``PERITEXT_MERGE_PATH=sorted``
        it is routed as ``TpuUniverse.apply_changes_with_patches`` routes
        it: the patched sorted merge (``_patched_sorted``), windowed where
        the census plans a window; the per-op loop for a batch deeper than
        ``PERITEXT_SORTED_MAX_ROUNDS`` (``stats["scan_fallbacks"]``), for
        one that targets an allowMultiple group wider than PATCH_GROUP_K
        (``stats["multi_group_fallbacks"]``) and under
        ``PERITEXT_PATCH_PATH=scan``.

        ``PERITEXT_PATCH_READBACK`` picks the record format ("compact", the
        default, or "planes"); a compact batch whose span counts overflow
        the adaptive cap is run again with planes.  Every route and format
        gives the same stream, and it equals every JAX patch path's stream.

        With ``with_positions`` each list holds ``(pos, patch)`` pairs,
        ``pos`` being the patch's op's flat index in the replica's gated
        batch stream; stripping the positions gives the default return."""
        batches = self._normalize_batches(per_replica)
        prep = self._prepare(batches)
        groups, group_of = prep["groups"], prep["group_of"]
        group_sizes, row_counts = self._account_rows(groups, group_of)
        max_rows = int(row_counts.max(initial=0))
        self._ensure_capacity(prep["need_len"], prep["need_marks"])

        def host_patches_for(r: int) -> List[Any]:
            return [(pos, copy_jsonlike(p)) for pos, p in prep["host_patches"].get(r, [])]

        if max_rows == 0:
            self._commit(prep)
            return {
                name: strip_pos(sorted(host_patches_for(r), key=lambda t: t[0]), with_positions)
                for r, name in enumerate(self.replica_ids)
            }
        patch_path = _patch_path()
        if _merge_path() == "sorted" and patch_path != "scan":
            text_rows_list: List[np.ndarray] = []
            mark_rows_list: List[np.ndarray] = []
            text_pos_list: List[np.ndarray] = []
            mark_pos_list: List[np.ndarray] = []
            for g in groups:
                rows = g["rows"]
                rp = np.asarray(g["row_pos"])
                is_mark = rows[:, K.K_KIND] == K.KIND_MARK
                text_rows_list.append(rows[~is_mark])
                mark_rows_list.append(rows[is_mark])
                text_pos_list.append(rp[~is_mark])
                mark_pos_list.append(rp[is_mark])
            sorted_prep = prepare_sorted_batch(
                text_rows_list, max_run=0,
                fallback_max_rounds=env_int("PERITEXT_SORTED_MAX_ROUNDS", "8", 0),
                pos_list=text_pos_list, restack_on_fallback=False,
            )
            multi_need = self._multi_group_need(mark_rows_list)
            if sorted_prep["fell_back"]:
                self.stats["scan_fallbacks"] += 1
            elif multi_need > SP.PATCH_GROUP_K:
                # The sorted scan resolves allowMultiple groups over at most
                # PATCH_GROUP_K columns; a wider group takes the per-op loop.
                self.stats["multi_group_fallbacks"] += 1
            else:
                return self._patched_sorted(
                    prep, host_patches_for, sorted_prep, mark_rows_list, mark_pos_list,
                    group_sizes, multi_need, with_positions, wplan=self._window_plan(prep),
                )
        return self._patched_scan(prep, host_patches_for, group_sizes, max_rows, with_positions)

    def _launch_patched(self, prep, host_patches_for, with_positions: bool, path: str, h2d: int,
                        chunk: int, merge_chunk, assemble_one, merge_window=None, wplan=None):
        """The launch policy both patch routes share.  ``merge_chunk(sl,
        readback)`` merges the replica slice ``sl`` of the committed states
        into ``(states, records)``, the records holding the new winner cache
        under ``wcache`` where the route keeps one; ``merge_window(readback)``
        (with ``wplan``) merges the whole batch inside its windows.

        Every launch's records come back to the host inside the attempt, so
        a failure mid-loop drops the partial results and nothing of self is
        written: the states, the winner cache and the census commit only
        after the attempt succeeded, and a retried attempt starts from the
        committed cache.  A window the device check rejects is counted and
        run again on the full table; a compact readback whose span counts
        overflow the adaptive cap is run again reading planes;
        ``PERITEXT_WINDOW_CHECK=1`` recomputes every windowed batch on the
        full table and raises on any difference.  ``assemble_one(rec, i, r,
        table, readback)`` turns replica ``r``'s records (row ``i`` of its
        chunk's) into ``(pos, patch)`` pairs."""
        n = len(self.replica_ids)
        span_cap = self._span_cap

        def make_attempt(rb: str, windowed: bool):
            def attempt():
                slices = [slice(0, n)] if windowed else [slice(i, min(i + chunk, n)) for i in range(0, n, chunk)]
                state_slices: List[DocState] = []
                record_chunks: List[Dict[str, np.ndarray]] = []
                wcache_slices: List[Optional[torch.Tensor]] = []
                for sl in slices:
                    faults.fire("device_launch")
                    t = time.perf_counter()
                    st, records = merge_window(rb) if windowed else merge_chunk(sl, rb)
                    wcache_slices.append(records.pop("wcache", None))
                    _synchronize(self.device)
                    self.stats["patch_loop_seconds"] += time.perf_counter() - t
                    state_slices.append(st)
                    faults.fire("device_readback")
                    t_read = time.perf_counter()
                    with telemetry.span("ingest.readback", readback=rb, chunk=sl.start):
                        if telemetry.enabled:
                            telemetry.flow_steps(readback=rb)
                        record_chunks.append({k: _numpy(v) for k, v in records.items()})
                    self.stats["patch_readback_seconds"] += time.perf_counter() - t_read
                states = state_slices[0] if len(state_slices) == 1 else DocState(**{
                    f: torch.cat([getattr(s_, f) for s_ in state_slices]) for f in FIELDS
                })
                # A launch without a cache (the per-op loop, a cacheless
                # mark-free or cold windowed merge) leaves no stale one.
                if any(w is None for w in wcache_slices):
                    wcache = None
                else:
                    wcache = wcache_slices[0] if len(wcache_slices) == 1 else torch.cat(wcache_slices)
                return (states, slices, record_chunks, wcache), states.length

            return attempt

        readback = patch_readback()
        use_window = merge_window is not None
        try:
            result = self._run_launch(make_attempt(readback, use_window))
            if use_window and not result[2][0]["wok"].all():
                # The device check rejected the window: drop the result
                # (nothing was committed) and run the full table.
                self._window_fallback()
                use_window = False
                result = self._run_launch(make_attempt(readback, False))
            launches = len(result[2])
            if readback == "compact" and self._span_overflow(result[2], span_cap):
                # A mark row emitted more spans than the tables hold: run the
                # batch again from the same states, reading the planes.
                readback = "planes"
                result = self._run_launch(make_attempt("planes", use_window))
                launches += len(result[2])
        except DeviceLaunchError:
            if not _degrade_enabled(self.device):
                raise
            pairs = self._degrade_apply(prep)
            return {name: strip_pos(pairs[r], with_positions) for r, name in enumerate(self.replica_ids)}
        new_states, slices, record_chunks, wcache = result
        if use_window and os.environ.get("PERITEXT_WINDOW_CHECK") == "1":
            ref_states = self._run_launch(make_attempt(readback, False))[0]
            self._assert_states_match(ref_states, new_states, wplan, prep)
        self.states = new_states
        self.stats["launches"] += launches
        if use_window:
            self.stats["windowed_launches"] += 1
            self._mirror_commit(wplan, record_chunks[0], prep)
        if telemetry.enabled:
            telemetry.counter("ingest.launches", launches)
            telemetry.counter("ingest.path." + path)
            if use_window:
                telemetry.counter("ingest.path.windowed")
                telemetry.flow_steps(path="windowed", window=int(wplan["w_cap"]))
            telemetry.counter("ingest.readback." + readback)
            telemetry.counter("ingest.h2d_bytes", h2d)
            telemetry.counter("ingest.d2h_bytes", int(sum(v.nbytes for rec in record_chunks for v in rec.values())))
        self._wcaches = wcache
        if wcache is not None:
            # Keyed to the registry this launch's ranks came from.
            self._wcaches_actors = len(self.actors.actors)
        self._commit(prep)

        t = time.perf_counter()
        with telemetry.span("ingest.assemble", replicas=n):
            if telemetry.enabled:
                telemetry.flow_steps()
            tables = self._mark_tables(range(n))
            out: Dict[str, List[Any]] = {}
            for sl, rec in zip(slices, record_chunks):
                for r in range(sl.start, sl.stop):
                    dev = assemble_one(rec, r - sl.start, r, tables[r], readback)
                    merged = sorted(dev + host_patches_for(r), key=lambda p: p[0])
                    out[self.replica_ids[r]] = strip_pos(merged, with_positions)
        self.stats["patch_assemble_seconds"] += time.perf_counter() - t
        return out

    def _patched_scan(self, prep, host_patches_for, group_sizes, max_rows, with_positions):
        """The exact interleaved per-op patch path (``K.apply_ops_patched``)
        in replica chunks of ``_patch_chunk``, under ``_launch_patched``."""
        groups, group_of = prep["groups"], prep["group_of"]
        pad = bucket_length(max_rows)
        g_ops = np.stack([pad_rows(g["rows"], pad) for g in groups])
        ops = g_ops[group_of]
        pad_per_group = (g_ops[:, :, K.K_KIND] == K.KIND_PAD).sum(axis=1)
        self.stats["rows_padded"] += int((pad_per_group * group_sizes).sum())
        idx = torch.from_numpy(group_of.astype(np.int64)).to(self.device)
        d_ops = torch.from_numpy(g_ops).to(self.device).index_select(0, idx)
        ranks = self._ranks_device()
        multi = self._multi_device()
        span_cap = self._span_cap

        def merge_chunk(sl, rb):
            return K.apply_ops_patched(
                map_state(lambda x: x[sl], self.states), d_ops[sl], ranks, multi,
                readback=rb, span_cap=span_cap,
            )

        def assemble_one(rec, i, r, table, rb):
            return assemble_patches(rec, i, ops[r], table, self.attrs, row_pos=groups[group_of[r]]["row_pos"])

        return self._launch_patched(
            prep, host_patches_for, with_positions, "scan", int(ops.nbytes),
            self._patch_chunk(len(self.replica_ids)), merge_chunk, assemble_one,
        )

    @staticmethod
    def _cand_cap(prep: Dict[str, Any]) -> int:
        """Candidate-axis width of the sorted route's compact readback:
        defined boundary slots never outnumber twice the mark table (anchor
        writes are the only first definitions), and the host knows every
        replica's post-batch mark count."""
        return bucket_length(2 * int(np.asarray(prep["new_mark_counts"]).max(initial=0)) + 2, minimum=8)

    def _assert_states_match(self, ref: DocState, got: DocState, wplan, prep) -> None:
        """``PERITEXT_WINDOW_CHECK=1``: a windowed result against the
        full-table recompute of the same batch, field by field."""
        ref_np, got_np = state_to_numpy(ref), state_to_numpy(got)
        for f in FIELDS:
            bad = np.argwhere(ref_np[f] != got_np[f])
            if bad.size:
                groups, group_of = prep["groups"], prep["group_of"]
                rows = {r: groups[group_of[r]]["rows"].tolist() for r in {int(x[0]) for x in bad[:8]}}
                raise RuntimeError(
                    f"windowed merge diverged from full-table on plane {f}: first diffs "
                    f"{bad[:8].tolist()}; wplan starts={wplan['starts'].tolist()} "
                    f"hulls={wplan['hulls'].tolist()} w_cap={wplan['w_cap']}; rows={rows}"
                )

    def _patched_sorted(self, prep, host_patches_for, sorted_prep, mark_rows_list, mark_pos_list,
                        sizes, multi_need: int, with_positions: bool,
                        wplan: Optional[Dict[str, Any]] = None):
        """The patched sorted merge (``TpuUniverse._patched_sorted``):
        placement rounds, analytic text records and a scan over the mark
        rows only (``sorted_patched.merge_step_sorted_patched``), or its
        windowed form when ``wplan`` is given, under ``_launch_patched``.
        Under the compact readback the mark planes are reduced on the
        device to run tables and assembled vectorized
        (``assemble_patches_sorted_compact``).

        The persisted winner cache is passed in when it matches the current
        shapes and actor registry; the merge's cache becomes the new one.
        ``multi_need`` (the census's widest targeted group, under
        PATCH_GROUP_K) sizes the delta scan's group resolution."""
        groups, group_of = prep["groups"], prep["group_of"]
        has_multi = multi_need > 0
        group_k = bucket_length(multi_need, minimum=1)
        # The batch-winner table needs only the live type registry.
        t_act = min(bucket_length(schema.NUM_MARK_TYPES, minimum=1), schema.MAX_MARK_TYPES)
        mark_pad = bucket_length(max(max((m.shape[0] for m in mark_rows_list), default=1), 1))
        g_mark = np.stack([pad_rows(m, mark_pad) for m in mark_rows_list])
        g_mark_pos = np.stack([
            np.pad(p.astype(np.int64), (0, mark_pad - p.shape[0]), constant_values=TIME_PAD)
            for p in mark_pos_list
        ]).astype(np.int32)
        pad_per_group = (sorted_prep["text"][:, :, K.K_KIND] == K.KIND_PAD).sum(axis=1) + (
            g_mark[:, :, K.K_KIND] == K.KIND_PAD
        ).sum(axis=1)
        self.stats["rows_padded"] += int((pad_per_group * sizes).sum())

        # One upload per group; the replica batch is a device gather.
        idx = torch.from_numpy(group_of.astype(np.int64)).to(self.device)

        def per_replica(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device).index_select(0, idx).contiguous()

        d_text, d_rounds, d_bufs, d_tpos, d_mark, d_mpos = (
            per_replica(a) for a in (
                sorted_prep["text"], sorted_prep["rounds"], sorted_prep["bufs"],
                sorted_prep["text_pos"], g_mark, g_mark_pos,
            )
        )
        h2d = int(sum(t.numel() * t.element_size() for t in (d_text, d_rounds, d_bufs, d_tpos, d_mark, d_mpos)))
        ranks = self._ranks_device()
        multi = self._multi_device()
        n = len(self.replica_ids)
        has_marks = any(m.shape[0] for m in mark_rows_list)
        wc = self._wcaches
        if wc is not None and (
            self._wcaches_actors != len(self.actors.actors)
            or tuple(wc.shape) != (n, 2 * self.capacity, multi.shape[0], 4)
        ):
            wc = None
        num_rounds, maxk = sorted_prep["num_rounds"], sorted_prep["maxk"]
        kw = dict(has_marks=has_marks, group_k=group_k, has_multi=has_multi, t_act=t_act,
                  span_cap=self._span_cap, cand_cap=self._cand_cap(prep))

        def merge_chunk(sl, rb):
            return SP.merge_step_sorted_patched(
                map_state(lambda x: x[sl], self.states), d_text[sl], d_rounds[sl], num_rounds,
                d_mark[sl], ranks, d_bufs[sl], multi, d_tpos[sl], d_mpos[sl], maxk,
                wcache_in=None if wc is None else wc[sl], readback=rb, **kw,
            )

        merge_window = None
        if wplan is not None:
            d_wstart, d_whull, d_wvb, d_wva = (
                torch.from_numpy(wplan[k]).to(self.device) for k in ("starts", "hulls", "vis_base", "vis_after")
            )

            def merge_window(rb):
                return SP.merge_step_sorted_patched_windowed_batch(
                    self.states, d_wstart, d_whull, d_wvb, d_wva, d_text, d_rounds, num_rounds, d_mark,
                    ranks, d_bufs, multi, d_tpos, d_mpos, maxk, wplan["w_cap"], wcache_in=wc,
                    readback=rb, **kw,
                )

        def assemble_one(rec, i, r, table, rb):
            gi = int(group_of[r])
            assemble = assemble_patches_sorted_compact if rb == "compact" else assemble_patches_sorted
            return assemble(
                rec, i, sorted_prep["text"][gi], sorted_prep["text_pos"][gi], sorted_prep["bufs"][gi],
                g_mark[gi], g_mark_pos[gi], table, self.attrs,
            )

        # The full-table launches are the only replica slicing: each chunk
        # keeps the merge's transients under the memory bound.
        chunk = self._patch_chunk(n, SP.patched_replica_step(self.states, d_text, d_mark, multi, maxk))
        return self._launch_patched(
            prep, host_patches_for, with_positions, "delta", h2d, chunk, merge_chunk, assemble_one,
            merge_window, wplan,
        )

    # -- materialization ----------------------------------------------------

    def _build_mark_table(self, ctr, act, action, mtype, attr) -> Dict[str, Dict[str, Any]]:
        table: Dict[str, Dict[str, Any]] = {}
        for m in range(ctr.shape[0]):
            op_id = make_op_id(int(ctr[m]), self.actors.actor(int(act[m])))
            op: Dict[str, Any] = {
                "opId": op_id,
                "action": "addMark" if action[m] == 0 else "removeMark",
                "markType": schema.ALL_MARKS[int(mtype[m])],
            }
            attrs = self.attrs.decode(int(attr[m]))
            if attrs is not None:
                op["attrs"] = attrs
            table[op_id] = op
        return table

    def _mark_tables(self, rows: Sequence[int]) -> List[Dict[str, Dict[str, Any]]]:
        """Per-replica mark tables from one readback, deduped so replicas
        with identical tables share one decoded object."""
        sel = torch.as_tensor(list(rows), dtype=torch.long, device=self.device)
        cols = [
            _numpy(getattr(self.states, f).index_select(0, sel))
            for f in ("mark_ctr", "mark_act", "mark_action", "mark_type", "mark_attr")
        ]
        counts = _numpy(self.states.mark_count.index_select(0, sel))
        cache: Dict[bytes, Dict[str, Dict[str, Any]]] = {}
        tables = []
        for i in range(len(rows)):
            n = min(int(counts[i]), self.max_mark_ops)
            key = b"".join(a[i, :n].tobytes() for a in cols)
            t = cache.get(key)
            if t is None:
                t = cache[key] = self._build_mark_table(*(a[i, :n] for a in cols))
            tables.append(t)
        return tables

    def _spans_from_arrays(
        self,
        mask_np: np.ndarray,
        has_np: np.ndarray,
        deleted: np.ndarray,
        chars: np.ndarray,
        table: Dict[str, Dict[str, Any]],
        mark_cache: Dict[Any, Dict[str, Any]],
    ) -> List[Dict[str, Any]]:
        """Segment one replica's flattened arrays into reference spans:
        boundaries are where consecutive visible elements' resolved bitsets
        differ, and adjacent spans with equal marks coalesce (the oracle's
        rule, peritext.ts:438-451)."""
        op_ids = list(table)

        def decode_row(row: np.ndarray) -> frozenset:
            return frozenset(
                op_id for m, op_id in enumerate(op_ids) if row[m // 32] >> (m % 32) & 1
            )

        vis = np.flatnonzero(~deleted)
        if vis.size == 0:
            return []
        v_has = has_np[vis]
        v_mask = mask_np[vis]
        v_chars = chars[vis]
        change = np.empty(vis.size, bool)
        change[0] = True
        np.not_equal(v_has[1:], v_has[:-1], out=change[1:])
        change[1:] |= (v_mask[1:] != v_mask[:-1]).any(axis=1)
        starts = np.flatnonzero(change)
        ends = np.append(starts[1:], vis.size)

        spans: List[Dict[str, Any]] = []
        for s, e in zip(starts, ends):
            if v_has[s]:
                key = (id(table), v_mask[s].tobytes())
                marks = mark_cache.get(key)
                if marks is None:
                    marks = mark_cache[key] = ops_to_marks(decode_row(v_mask[s]), table)
            else:
                marks = {}
            text = _codepoints_to_str(v_chars[s:e])
            if spans and spans[-1]["marks"] == marks:
                spans[-1]["text"] += text
            else:
                spans.append({"marks": dict(marks), "text": text})
        return spans

    def _text_source(self, r: int) -> Optional[str]:
        """None when ``root.text`` resolves to the device-bound list, else
        the id of the list that map-key LWW elected instead (it lives in the
        host store; see TpuUniverse._text_source)."""
        winner = self.stores[r].metadata[None].children.get("text")
        if winner is None or winner == self.text_objs[r]:
            return None
        return winner

    def _host_spans(self, r: int, host: str) -> List[Dict[str, Any]]:
        store = self.stores[r]
        return oracle_spans(store.objects[host], store.metadata[host], store.mark_ops)

    def _spans_rows(self, rows: Sequence[int]) -> List[List[Dict[str, Any]]]:
        sel = torch.as_tensor(list(rows), dtype=torch.long, device=self.device)
        sub = map_state(lambda x: x.index_select(0, sel), self.states)
        mask, has = K.flatten_sources(sub)
        mask_np = _numpy(mask).view(np.uint32)
        has_np = _numpy(has)
        deleted = _numpy(sub.deleted)
        chars = _numpy(sub.chars)
        lengths = _numpy(sub.length)
        tables = self._mark_tables(rows)
        mark_cache: Dict[Any, Dict[str, Any]] = {}
        out = []
        for i, r in enumerate(rows):
            host = self._text_source(r)
            if host is not None:
                out.append(self._host_spans(r, host))
                continue
            n = int(lengths[i])
            out.append(
                self._spans_from_arrays(
                    mask_np[i, :n], has_np[i, :n], deleted[i, :n], chars[i, :n],
                    tables[i], mark_cache,
                )
            )
        return out

    def spans(self, replica: str | int) -> List[Dict[str, Any]]:
        """One replica as formatted spans: boundary resolution on device
        (flatten_sources), bitset decoding and opsToMarks on host."""
        r = replica if isinstance(replica, int) else self.index_of[replica]
        return self._spans_rows([r])[0]

    def spans_batch(self) -> List[List[Dict[str, Any]]]:
        """All replicas' formatted spans from one batched flatten."""
        return self._spans_rows(range(len(self.replica_ids)))

    def text(self, replica: str | int) -> str:
        r = replica if isinstance(replica, int) else self.index_of[replica]
        host = self._text_source(r)
        if host is not None:
            return "".join(self.stores[r].objects[host])
        n = int(self.states.length[r])
        chars = _numpy(self.states.chars[r, :n])
        deleted = _numpy(self.states.deleted[r, :n])
        return _codepoints_to_str(chars[~deleted])

    def texts(self) -> List[str]:
        """All replicas' visible texts from one readback."""
        chars = _numpy(self.states.chars)
        deleted = _numpy(self.states.deleted)
        lengths = _numpy(self.states.length)
        out = []
        for r in range(len(self.replica_ids)):
            host = self._text_source(r)
            if host is not None:
                out.append("".join(self.stores[r].objects[host]))
                continue
            n = int(lengths[r])
            out.append(_codepoints_to_str(chars[r, :n][~deleted[r, :n]]))
        return out

    def digests(self) -> np.ndarray:
        """Per-replica convergence digests (uint32), computed on device."""
        digests = K.convergence_digest(self.states, self._ranks_device(), self._multi_device())
        return _numpy(digests).astype(np.uint32)

    # -- cursors -------------------------------------------------------------

    def _row(self, r: int) -> DocState:
        return map_state(lambda x: x[r : r + 1], self.states)

    def _elem_op_id(self, ctr: int, act: int) -> str:
        return make_op_id(int(ctr), self.actors.actor(int(act)))

    def get_cursor(self, replica: str | int, index: int) -> Dict[str, Any]:
        """Stable cursor for a visible index (reference micromerge.ts:465-472)."""
        r = replica if isinstance(replica, int) else self.index_of[replica]
        host = self._text_source(r)
        if host is not None:
            return {
                "objectId": host,
                "elemId": get_list_element_id(self.stores[r].metadata[host], index),
            }
        idx = torch.tensor([index], dtype=torch.int32, device=self.device)
        ctr, act, found = (_numpy(x)[0] for x in K.cursor_elems(self._row(r), idx))
        if not found:
            raise IndexError(f"List index out of bounds: {index}")
        return {"objectId": self.text_objs[r], "elemId": self._elem_op_id(ctr, act)}

    def _cursor_target(self, cursor: Dict[str, Any]) -> Tuple[int, int]:
        ctr, actor = parse_op_id(cursor["elemId"])
        if actor not in self.actors:
            raise KeyError(f"List element not found: {cursor['elemId']}")
        return ctr, self.actors.id_of(actor)

    def resolve_cursor(self, replica: str | int, cursor: Dict[str, Any]) -> int:
        """Current visible index of a cursor (reference micromerge.ts:475-477)."""
        r = replica if isinstance(replica, int) else self.index_of[replica]
        obj = cursor.get("objectId")
        if obj is not None and obj != self.text_objs[r]:
            # A cursor into a host-side list.
            _, visible = self.stores[r].find_list_element(obj, cursor["elemId"])
            return visible
        ctr, act = self._cursor_target(cursor)
        index, found = K.resolve_cursor_indices(
            self._row(r),
            torch.tensor([ctr], dtype=torch.int32, device=self.device),
            torch.tensor([act], dtype=torch.int32, device=self.device),
        )
        if not bool(found[0]):
            raise KeyError(f"List element not found: {cursor['elemId']}")
        return int(index[0])

    def get_cursors(self, indices: Sequence[int]) -> List[Dict[str, Any]]:
        """One cursor per replica, from one batched query."""
        if len(indices) != len(self.replica_ids):
            raise ValueError("need one index per replica")
        if any(self._text_source(r) is not None for r in range(len(indices))):
            return [self.get_cursor(r, i) for r, i in enumerate(indices)]
        idx = torch.from_numpy(np.asarray(indices, np.int32)).to(self.device)
        ctrs, acts, founds = (_numpy(x) for x in K.cursor_elems(self.states, idx))
        if not founds.all():
            bad = int(np.flatnonzero(~founds)[0])
            raise IndexError(f"List index out of bounds: {indices[bad]} (replica {bad})")
        return [
            {"objectId": self.text_objs[r], "elemId": self._elem_op_id(ctrs[r], acts[r])}
            for r in range(len(self.replica_ids))
        ]

    def resolve_cursors(self, cursors: Sequence[Dict[str, Any]]) -> List[int]:
        """Current visible index of one cursor per replica, from one query."""
        if len(cursors) != len(self.replica_ids):
            raise ValueError("need one cursor per replica")
        if any(
            c.get("objectId") is not None and c.get("objectId") != self.text_objs[r]
            for r, c in enumerate(cursors)
        ):
            return [self.resolve_cursor(r, c) for r, c in enumerate(cursors)]
        targets = np.asarray([self._cursor_target(c) for c in cursors], np.int32).reshape(-1, 2)
        t = torch.from_numpy(targets).to(self.device)
        idxs, founds = (_numpy(x) for x in K.resolve_cursor_indices(self.states, t[:, 0], t[:, 1]))
        if not founds.all():
            bad = int(np.flatnonzero(~founds)[0])
            raise KeyError(f"List element not found: {cursors[bad]['elemId']}")
        return [int(i) for i in idxs]

    def clock(self, replica: str | int) -> Dict[str, int]:
        r = replica if isinstance(replica, int) else self.index_of[replica]
        return dict(self.clocks[r])
