"""TorchUniverse: a batch of document replicas resident on a GPU.

Counterpart of ``peritext_tpu/ops/universe.py``'s ``TpuUniverse`` on its
exact per-op merge path (``PERITEXT_MERGE_PATH=scan`` there).  A universe
holds R replica states stacked into one [R, ...] ``DocState`` of torch
tensors, shares actor/attr interning across the batch, and ingests
causally-gated change batches with one merge per call: the text kernel,
the boundary permute, the mark kernel and the mark-table append
(``cuda_kernels.merge_step_full``).

Host responsibilities (the control plane): causal ordering and the
seq/deps gate per replica, wire-op encoding and interning, capacity
pre-checks with re-bucketing, the host object store, and span decoding.
Device responsibilities (the data plane): all per-op document mutation,
boundary-set algebra, mark resolution and digests.

Not here yet (the JAX universe has them): patch emission, the sorted and
windowed merges, launch retries, degradation, fault injection, breakers,
telemetry and fleet elasticity.  A failed launch raises.
"""
from __future__ import annotations

import copy
import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from peritext_tpu_torch import schema
from peritext_tpu_torch.ids import ActorRegistry, make_op_id
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.cuda_kernels import merge_step_full
from peritext_tpu_torch.ops.encode import (
    AttrRegistry,
    bucket_length,
    encode_changes,
    pad_rows,
    prepare_sorted_batch,
    split_rows,
)
from peritext_tpu_torch.ops.state import (
    DocState,
    grow_state,
    make_empty_state,
    map_state,
)
from peritext_tpu_torch.oracle.doc import (
    ObjectStore,
    get_text_with_formatting as oracle_spans,
    op_from_wire,
    ops_to_marks,
)
from peritext_tpu_torch.runtime.sync import causal_order
from peritext_tpu_torch.schema import allow_multiple_array

Change = Dict[str, Any]


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


class TorchUniverse:
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
        self.states: DocState = map_state(
            lambda x: x.unsqueeze(0).expand(n, *x.shape).contiguous(), empty
        )
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
        self.stats: Dict[str, Any] = {
            "launches": 0,
            "ops_applied": 0,
            "rows_padded": 0,
            "capacity_growths": 0,
            "changes_ingested": 0,
            "duplicates_dropped": 0,
            # Wall time of the host control plane (gate, encode, fuse, pad,
            # upload, commit); the merge itself is asynchronous on the card.
            "host_seconds": 0.0,
        }

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
                        "text_obj": counts["text_obj"],
                        "inserts": counts["insert"],
                        "marks": counts["mark"],
                    }
                )
            n_ingested += len(groups[gi]["ordered"])
            group_of[r] = gi

        # Host structural ops dry-run against store copies, one per (group,
        # store version) class; a bad op raises here, before any commit.
        new_stores: Dict[int, ObjectStore] = {}
        new_versions: Dict[int, int] = {}
        by_class: Dict[Any, Any] = {}
        for r in range(n):
            g = groups[group_of[r]]
            if not g["host_ops"]:
                continue
            key = (group_of[r], self.store_versions[r])
            hit = by_class.get(key)
            if hit is None:
                store = copy.deepcopy(self.stores[r])
                for _, op in g["host_ops"]:
                    apply_host_op(store, op)
                if g["text_obj"] is not None:
                    store.device_objects.add(g["text_obj"])
                self._store_version_counter += 1
                hit = by_class[key] = (store, self._store_version_counter)
            new_stores[r], new_versions[r] = hit

        ins = np.asarray([g["inserts"] for g in groups], np.int64)[group_of]
        mks = np.asarray([g["marks"] for g in groups], np.int64)[group_of]
        lengths = np.asarray(self.lengths, np.int64) + ins
        mark_counts = np.asarray(self.mark_counts, np.int64) + mks
        return {
            "groups": groups,
            "group_of": group_of,
            "new_stores": new_stores,
            "new_store_versions": new_versions,
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

    def apply_changes(
        self, per_replica: Dict[str, Sequence[Change]] | List[Sequence[Change]]
    ) -> None:
        """Apply a batch of changes to each named replica in one merge.

        Gate + encode run first for all replicas against clock copies; the
        control plane (clocks, lengths, host stores) commits only after the
        merge, so a causally-unready change in one replica's batch never
        strands another replica's clock ahead of its device state.  Text
        rows are fused into insert runs of at most MAX_RUN_LEN and applied
        in causal order by the text kernel; mark rows by the mark kernel.
        """
        t_host = time.perf_counter()
        batches = self._normalize_batches(per_replica)
        prep = self._prepare(batches)
        groups, group_of = prep["groups"], prep["group_of"]

        text_rows_list: List[np.ndarray] = []
        mark_rows_list: List[np.ndarray] = []
        for g in groups:
            text_rows, mark_rows = split_rows(g["rows"])
            text_rows_list.append(text_rows)
            mark_rows_list.append(mark_rows)
        sizes = np.bincount(group_of, minlength=len(groups))
        row_counts = np.asarray([g["rows"].shape[0] for g in groups], np.int64)
        self.stats["ops_applied"] += int((row_counts * sizes).sum())

        self._ensure_capacity(prep["need_len"], prep["need_marks"])
        if not row_counts.any():
            self._commit(prep)
            self.stats["host_seconds"] += time.perf_counter() - t_host
            return
        fused = prepare_sorted_batch(
            text_rows_list, max_run=K.MAX_RUN_LEN, fallback_max_rounds=None
        )
        mark_pad = bucket_length(max(max(m.shape[0] for m in mark_rows_list), 1))
        g_mark = np.stack([pad_rows(rows, mark_pad) for rows in mark_rows_list])
        pad_per_group = (fused["text"][:, :, K.K_KIND] == K.KIND_PAD).sum(axis=1) + (
            g_mark[:, :, K.K_KIND] == K.KIND_PAD
        ).sum(axis=1)
        self.stats["rows_padded"] += int((pad_per_group * sizes).sum())

        # Upload one copy per group; the replica batch is a device gather.
        idx = torch.from_numpy(group_of.astype(np.int64)).to(self.device)

        def per_replica_rows(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device).index_select(0, idx).contiguous()

        args = (
            per_replica_rows(fused["text"]),
            per_replica_rows(g_mark),
            self._ranks_device(),
            per_replica_rows(fused["bufs"]),
        )
        self.stats["host_seconds"] += time.perf_counter() - t_host
        self.states = merge_step_full(self.states, *args)
        self.stats["launches"] += 1
        t_host = time.perf_counter()
        self._commit(prep)
        self.stats["host_seconds"] += time.perf_counter() - t_host

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
        ranks = torch.from_numpy(self._ranks()).to(self.device)
        multi = torch.from_numpy(allow_multiple_array()).to(self.device)
        return _numpy(K.convergence_digest(self.states, ranks, multi)).astype(np.uint32)
