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
default.  ``apply_changes_with_patches``
emits each replica's reference patch stream through the per-op loop
``kernels.apply_ops_patched``.  The sorted, windowed and patch paths are
plain torch on the universe's device: the JAX package runs them as XLA,
with no Pallas kernel.

Host responsibilities (the control plane): causal ordering and the
seq/deps gate per replica, wire-op encoding and interning, capacity
pre-checks with re-bucketing, the window census over a host mirror of the
committed element ids, the host object store, and span decoding.  Device
responsibilities (the data plane): all per-op document mutation,
boundary-set algebra, mark resolution and digests.

Not here yet (the JAX universe has them): the sorted and windowed patch
paths, launch retries, degradation, fault injection, breakers, telemetry
and fleet elasticity.  A failed launch raises, and the control plane
commits nothing.
"""
from __future__ import annotations

import copy
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
from peritext_tpu_torch.ops.cuda_kernels import merge_step_full
from peritext_tpu_torch.ops.sorted_merge import (
    merge_step_sorted_batch,
    merge_step_sorted_windowed_batch,
)
from peritext_tpu_torch.ops.encode import (
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
    copy_jsonlike,
    initial_span_cap,
    patch_readback,
    strip_pos,
)
from peritext_tpu_torch.ops.state import (
    FIELDS,
    DocState,
    grow_state,
    make_empty_state,
    map_state,
)
from peritext_tpu_torch.oracle.doc import (
    ObjectStore,
    get_list_element_id,
    get_text_with_formatting as oracle_spans,
    op_from_wire,
    ops_to_marks,
)
from peritext_tpu_torch.runtime.sync import causal_order
from peritext_tpu_torch.schema import allow_multiple_array

Change = Dict[str, Any]

_log = logging.getLogger(__name__)


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


def _codepoints_to_str(codepoints: np.ndarray) -> str:
    """Codepoint array -> str without a per-char loop (surrogatepass, so the
    batch decode accepts exactly what ``chr()`` accepts)."""
    return codepoints.astype("<u4").tobytes().decode("utf-32-le", "surrogatepass")


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
            "windowed_launches": 0,
            "window_fallbacks": 0,
            "window_rebuilds": 0,
            "window_census_skips": 0,
            "readback_overflows": 0,
            # Wall time of the host control plane (gate, encode, fuse, pad,
            # upload, commit); the merge itself is asynchronous on the card.
            "host_seconds": 0.0,
            # The patch path's split: the per-op loop on the device (timed
            # to a synchronize), the record readback to the host, and the
            # host's patch assembly.
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
        sorted_prep = prepare_sorted_batch(
            text_rows_list,
            max_run=K.MAX_RUN_LEN if use_scan else 0,
            fallback_max_rounds=None if use_scan else env_int("PERITEXT_SORTED_MAX_ROUNDS", "8", 0),
        )
        if sorted_prep["fell_back"]:
            use_scan = True
            self.stats["scan_fallbacks"] += 1
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

        if wplan is not None:
            starts, hulls = (torch.from_numpy(wplan[k]).to(self.device) for k in ("starts", "hulls"))
            new_states, wrec = merge_step_sorted_windowed_batch(
                self.states, starts, hulls, *sorted_args, wplan["w_cap"]
            )
            # The verdict and mirror readback is this path's barrier.
            wrec_np = {k: _numpy(v) for k, v in wrec.items()}
            if wrec_np["wok"].all():
                self.states = new_states
                self.stats["launches"] += 1
                self.stats["windowed_launches"] += 1
                t_host = time.perf_counter()
                self._mirror_commit(wplan, wrec_np, prep)
                self._commit(prep)
                self.stats["host_seconds"] += time.perf_counter() - t_host
                return
            self._window_fallback()

        if use_scan:
            self.states = merge_step_full(self.states, text, marks, ranks, bufs)
        else:
            self.states = merge_step_sorted_batch(self.states, *sorted_args)
        self.stats["launches"] += 1
        t_host = time.perf_counter()
        self._commit(prep)
        self.stats["host_seconds"] += time.perf_counter() - t_host

    # -- patch-emitting ingestion -------------------------------------------

    @staticmethod
    def _patch_chunk(n: int) -> int:
        """Replicas per patch-path launch (``PERITEXT_PATCH_CHUNK``, 0 or
        unset = all), equalized so the chunks differ by at most one."""
        chunk = env_int("PERITEXT_PATCH_CHUNK", "0", 0) or n
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

    def apply_changes_with_patches(
        self,
        per_replica: Dict[str, Sequence[Change]] | List[Sequence[Change]],
        with_positions: bool = False,
    ) -> Dict[str, List[Any]]:
        """Causally gated ingestion that also returns each replica's
        reference patch stream (micromerge.ts:25-30), on the exact per-op
        path (``TpuUniverse._patched_scan``).

        ``PERITEXT_PATCH_READBACK`` picks the record format ("compact", the
        default, or "planes"); a compact batch whose span counts overflow
        the adaptive cap is run again with planes.  Both give the same
        stream, and it equals every JAX patch path's stream.

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
        return self._patched_scan(prep, host_patches_for, group_sizes, max_rows, with_positions)

    def _patched_scan(self, prep, host_patches_for, group_sizes, max_rows, with_positions):
        """The exact interleaved per-op patch path, in replica chunks of
        ``_patch_chunk``; each chunk's records come back to the host before
        the next chunk runs.  The committed states are not touched until
        every chunk has succeeded."""
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
        n = len(self.replica_ids)
        chunk = self._patch_chunk(n)
        span_cap = self._span_cap

        def launch(readback: str):
            state_slices: List[DocState] = []
            record_chunks: List[Dict[str, np.ndarray]] = []
            for i in range(0, n, chunk):
                sl = slice(i, min(i + chunk, n))
                t = time.perf_counter()
                st, rec = K.apply_ops_patched(
                    map_state(lambda x: x[sl], self.states), d_ops[sl], ranks, multi,
                    readback=readback, span_cap=span_cap,
                )
                _synchronize(self.device)
                t_read = time.perf_counter()
                record_chunks.append({k: _numpy(v) for k, v in rec.items()})
                self.stats["patch_readback_seconds"] += time.perf_counter() - t_read
                self.stats["patch_loop_seconds"] += t_read - t
                state_slices.append(st)
            if len(state_slices) == 1:
                return state_slices[0], record_chunks
            return DocState(**{
                f: torch.cat([getattr(s, f) for s in state_slices]) for f in FIELDS
            }), record_chunks

        readback = patch_readback()
        new_states, record_chunks = launch(readback)
        launches = len(record_chunks)
        if readback == "compact" and self._span_overflow(record_chunks, span_cap):
            # A mark row emitted more spans than the tables hold: run the
            # batch again from the same states, reading the planes.
            new_states, record_chunks = launch("planes")
            launches += len(record_chunks)
        self.states = new_states
        self.stats["launches"] += launches
        self._commit(prep)

        t = time.perf_counter()
        tables = self._mark_tables(range(n))
        out: Dict[str, List[Any]] = {}
        for r, name in enumerate(self.replica_ids):
            rec = record_chunks[r // chunk]
            g = groups[group_of[r]]
            dev = assemble_patches(rec, r % chunk, ops[r], tables[r], self.attrs, row_pos=g["row_pos"])
            merged = sorted(dev + host_patches_for(r), key=lambda p: p[0])
            out[name] = strip_pos(merged, with_positions)
        self.stats["patch_assemble_seconds"] += time.perf_counter() - t
        return out

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
