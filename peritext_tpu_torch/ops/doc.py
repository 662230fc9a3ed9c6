"""TorchDoc: the full document API with its text held as torch tensors.

A drop-in peer of the oracle ``Doc`` and of the JAX package's ``TpuDoc``:
local change generation (``change()``), remote ingestion behind the causal
gate (``apply_change()``), materialization, patch streams and cursors.
Every mutation and lookup of the text runs on a one-replica
``TorchUniverse`` (on the card unless ``device="cpu"``); the host keeps
the control plane (seq, clock, max_op, registries, the root map).

Local generation mirrors the reference change() path (micromerge.ts:
308-441): each input op resolves its anchors against the current state
(index -> element id, with the tombstone-peek rule for inserts), expands
into internal ops and applies at once through ``kernels.apply_ops_patched``,
so the returned patches are the oracle's.  A multi-character delete
resolves all its targets in one query (the k visible elements from the
index): deleting the visible element at a constant index k times
tombstones exactly those (micromerge.ts:362-392).

Local application rides the universe's launch policy (``_run_launch``) as
``TpuDoc`` does: retries, the deadline and the breaker, but no
degradation.  When the budget runs out the ``DeviceLaunchError`` reaches
``change()``, which rolls the change back (seq, clock, max_op, states,
capacities, lengths and the host store) and re-raises; a semantic error
(a bad index, ``NotImplementedError``) passes through as the oracle's.
Remote ingestion (``apply_change``) goes through the universe's patch path
with its full policy, degradation included, and takes the patched sorted
route under ``PERITEXT_MERGE_PATH=sorted``; local mark rows join the
universe's allowMultiple group census, and a rolled-back change restores
the census and the winner cache with the rest of the control plane.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from peritext_tpu_torch.ids import make_op_id
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.patches import assemble_patches, patch_readback
from peritext_tpu_torch.ops.universe import TorchUniverse, _retryable
from peritext_tpu_torch.oracle.doc import (
    ROOT,
    generate_input_op,
    get_list_element_id,
    get_text_with_formatting as oracle_spans,
    op_to_wire,
)
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.schema import MARK_SPEC, MARK_TYPE_ID

Change = Dict[str, Any]
Patch = Dict[str, Any]


class TorchDoc:
    def __init__(
        self,
        actor_id: str,
        capacity: int = 256,
        max_mark_ops: int = 64,
        device: Optional[str | torch.device] = None,
    ):
        self._uni = TorchUniverse(
            [actor_id], capacity=capacity, max_mark_ops=max_mark_ops, device=device
        )
        self.actor_id = actor_id
        self._actor_int = self._uni.actors.intern(actor_id)
        self.seq = 0
        self.max_op = 0
        # Control-plane snapshot for the duration of one change() call (the
        # rollback when the device step fails); None outside change().
        self._snap: Optional[Dict[str, Any]] = None

    # -- views ---------------------------------------------------------------

    @property
    def clock(self) -> Dict[str, int]:
        return self._uni.clock(0)

    @property
    def root(self) -> Dict[str, Any]:
        """Root view; ``root["text"]`` materializes the visible characters
        while the root key still holds the device-bound list (``is_linked``:
        a winning set or del on the key hides it).  Other keys come from
        the host object store."""
        store = self._store
        root = dict(store.objects[ROOT])
        text_obj = self._text_obj()
        if (
            text_obj is not None
            and store.metadata[ROOT].children.get("text") == text_obj
            and store.is_linked(ROOT, "text")
        ):
            root["text"] = list(self._uni.text(0))
        return root

    def get_text_with_formatting(self, path: Sequence[str]) -> List[Dict[str, Any]]:
        obj_id = self._store.get_object_id_for_path(path)
        if obj_id == self._text_obj() and obj_id is not None:
            return self._uni.spans(0)
        text = self._store.objects.get(obj_id)
        meta = self._store.metadata.get(obj_id)
        if not isinstance(text, list) or not isinstance(meta, list):
            raise TypeError(f"Expected a list at object ID {obj_id}")
        return oracle_spans(text, meta, self._store.mark_ops)

    def get_cursor(self, path: Sequence[str], index: int) -> Dict[str, Any]:
        obj_id = self._store.get_object_id_for_path(path)
        if obj_id == self._text_obj() and obj_id is not None:
            return self._uni.get_cursor(0, index)
        meta = self._store.metadata.get(obj_id)
        if not isinstance(meta, list):
            raise TypeError(f"Expected a list at object ID {obj_id}")
        return {"objectId": obj_id, "elemId": get_list_element_id(meta, index)}

    def resolve_cursor(self, cursor: Dict[str, Any]) -> int:
        if cursor.get("objectId") == self._text_obj() and cursor.get("objectId") is not None:
            return self._uni.resolve_cursor(0, cursor)
        _, visible = self._store.find_list_element(cursor["objectId"], cursor["elemId"])
        return visible

    @property
    def _store(self):
        return self._uni.stores[0]

    def _text_obj(self) -> Optional[str]:
        return self._uni.text_objs[0]

    def _state(self):
        return self._uni._row(0)

    # -- remote ingestion ----------------------------------------------------

    def apply_change(self, change: Change) -> List[Patch]:
        """Causal gate identical to the oracle's (micromerge.ts:501-509)."""
        last_seq = self.clock.get(change["actor"], 0)
        if change["seq"] != last_seq + 1:
            raise ValueError(f"Expected sequence number {last_seq + 1}, got {change['seq']}")
        for actor, dep in (change.get("deps") or {}).items():
            if self.clock.get(actor, 0) < dep:
                raise ValueError(f"Missing dependency: change {dep} by actor {actor}")
        patches = self._uni.apply_changes_with_patches({self.actor_id: [change]})[self.actor_id]
        self.max_op = max(self.max_op, change["startOp"] + len(change["ops"]) - 1)
        return patches

    # -- local change generation ---------------------------------------------

    def change(self, input_ops: Sequence[Dict[str, Any]]) -> Tuple[Change, List[Patch]]:
        uni = self._uni
        # Local generation commits the clock, seq and lengths before each
        # device step, so snapshot the control plane: a device failure
        # mid-change must not leave this actor's stream ahead of its state.
        # The states are replaced, never mutated, by every step; the store
        # is copied lazily before the first host op.
        snap: Dict[str, Any] = {
            "seq": self.seq,
            "max_op": self.max_op,
            "clock_entry": uni.clocks[0].get(self.actor_id),
            "states": uni.states,
            # Capacities travel with the states (_ensure_capacity may grow
            # both mid-change).
            "capacity": uni.capacity,
            "max_mark_ops": uni.max_mark_ops,
            "length": uni.lengths[0],
            "marks": uni.mark_counts[0],
            # The group census and winner cache move with local application.
            "census": {k: set(v) for k, v in uni._multi_groups.items()},
            "wcaches": uni._wcaches,
            "wcaches_actors": uni._wcaches_actors,
            "store": None,
            "store_version": uni.store_versions[0],
            "text_obj": uni.text_objs[0],
        }
        self._snap = snap
        # Causal lane of this local change, finished at commit or rollback.
        ctx = telemetry.flow("doc.change", actor=self.actor_id) if telemetry.enabled else None
        try:
            deps = dict(self.clock)
            # Seq resumes from our own clock entry after log-replay recovery
            # (the rule of oracle.Doc.change).
            self.seq = max(self.seq, self.clock.get(self.actor_id, 0)) + 1
            uni.clocks[0][self.actor_id] = self.seq
            change: Change = {
                "actor": self.actor_id,
                "seq": self.seq,
                "deps": deps,
                "startOp": self.max_op + 1,
                "ops": [],
            }
            patches: List[Patch] = []
            with telemetry.span("doc.change", actor=self.actor_id):
                telemetry.flow_point(ctx)
                with telemetry.flowing((ctx,)):
                    for input_op in input_ops:
                        patches.extend(self._generate_input_op(change, input_op))
                if ctx is not None:
                    telemetry.observe("e2e.change_to_applied", telemetry.flow_elapsed_s(ctx))
                    telemetry.flow_point(ctx, terminal=True)
            if telemetry.enabled:
                telemetry.counter("doc.local_changes")
                telemetry.record("doc.change", flow=ctx, outcome="applied")
            return change, patches
        except Exception as exc:
            # A backend failure (retry exhaustion, an injected fault, a raw
            # device error from an anchor query): the change never
            # happened.  Semantic errors keep the oracle's behavior.
            if not _retryable(exc):
                raise
            if telemetry.enabled:
                telemetry.counter("doc.local_gen_rollbacks")
                if isinstance(getattr(exc, "cause", None), health.BreakerOpenError):
                    telemetry.counter("doc.local_fastfails")
                telemetry.record("doc.change", flow=ctx, outcome="rollback", error=type(exc).__name__)
                if ctx is not None:
                    with telemetry.span("doc.rollback", actor=self.actor_id):
                        telemetry.flow_point(ctx, terminal=True, outcome="rollback")
            self.seq = snap["seq"]
            self.max_op = snap["max_op"]
            if snap["clock_entry"] is None:
                uni.clocks[0].pop(self.actor_id, None)
            else:
                uni.clocks[0][self.actor_id] = snap["clock_entry"]
            uni.states = snap["states"]
            uni.capacity = snap["capacity"]
            uni.max_mark_ops = snap["max_mark_ops"]
            uni.lengths[0] = snap["length"]
            uni.mark_counts[0] = snap["marks"]
            uni._multi_groups = snap["census"]
            uni._wcaches = snap["wcaches"]
            uni._wcaches_actors = snap["wcaches_actors"]
            if snap["store"] is not None:
                uni.stores[0] = snap["store"]
                uni.store_versions[0] = snap["store_version"]
                uni.text_objs[0] = snap["text_obj"]
            raise
        finally:
            self._snap = None

    def _elem_id(self, index: int, peek: bool) -> Tuple[int, int]:
        """One anchor query; its host readback is a completion barrier, so
        it fires the ``device_readback`` site as ``TpuDoc._elem_id`` does."""
        faults.fire("device_readback")
        return self._elem_ids([index], peek)[0]

    def _elem_ids(self, indices: Sequence[int], peek: bool) -> List[Tuple[int, int]]:
        """Element ids of visible indices, in one query; IndexError names
        the first index out of bounds."""
        idx = torch.tensor([list(indices)], dtype=torch.int32, device=self._uni.device)
        ctrs, acts, founds = (x[0].cpu().numpy() for x in K.visible_elem_ids(self._state(), idx, peek))
        if not founds.all():
            bad = int(np.flatnonzero(~founds)[0])
            raise IndexError(f"List index out of bounds: {indices[bad]}")
        return list(zip(ctrs.tolist(), acts.tolist()))

    def _wire_id(self, ctr: int, act: int) -> str:
        return make_op_id(ctr, self._uni.actors.actor(act))

    def _op_row(self, kind: int, fields: Dict[int, int]) -> np.ndarray:
        """An op row with this actor's id and counter ``max_op``."""
        row = np.zeros(K.OP_FIELDS, np.int32)
        row[K.K_KIND] = kind
        row[K.K_CTR] = self.max_op
        row[K.K_ACT] = self._actor_int
        for field, value in fields.items():
            row[field] = value
        return row

    def _generate_input_op(self, change: Change, input_op: Dict[str, Any]) -> List[Patch]:
        obj = self._store.get_object_id_for_path(list(input_op["path"]))
        if obj is None or obj != self._text_obj():
            # Root and nested maps and host-side lists: the oracle's
            # generation against the host store.
            return generate_input_op(self._store, input_op, lambda op: self._make_host_op(change, op))

        action = input_op["action"]
        rows: List[np.ndarray] = []
        if action == "insert":
            index = input_op["index"]
            ref = (0, 0) if index == 0 else self._elem_id(index - 1, peek=True)
            for value in input_op["values"]:
                self.max_op += 1
                rows.append(self._op_row(K.KIND_INSERT, {
                    K.K_REF_CTR: ref[0], K.K_REF_ACT: ref[1], K.K_PAYLOAD: ord(value),
                }))
                wire: Dict[str, Any] = {
                    "opId": make_op_id(self.max_op, self.actor_id),
                    "action": "set",
                    "obj": obj,
                    "insert": True,
                    "value": value,
                }
                if ref != (0, 0):
                    wire["elemId"] = self._wire_id(*ref)
                change["ops"].append(wire)
                ref = (self.max_op, self._actor_int)
        elif action == "delete":
            start = input_op["index"]
            for ctr, act in self._elem_ids(range(start, start + input_op["count"]), peek=False):
                self.max_op += 1
                rows.append(self._op_row(K.KIND_DELETE, {K.K_REF_CTR: ctr, K.K_REF_ACT: act}))
                change["ops"].append({
                    "opId": make_op_id(self.max_op, self.actor_id),
                    "action": "del",
                    "obj": obj,
                    "elemId": self._wire_id(ctr, act),
                })
        elif action in ("addMark", "removeMark"):
            row, wire = self._generate_mark_op(input_op, obj)
            rows.append(row)
            change["ops"].append(wire)
        else:
            raise NotImplementedError(f"{action} on a list")
        return self._apply_rows(rows)

    def _generate_mark_op(self, input_op: Dict[str, Any], obj: str) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Anchor resolution (reference changeMark, peritext.ts:458-501)."""
        mark_type = input_op["markType"]
        end_grows = MARK_SPEC[mark_type].inclusive
        vis_len = int(K.visible_length(self._state())[0])
        start = self._elem_id(input_op["startIndex"], peek=False)
        self.max_op += 1
        fields = {
            K.K_MACTION: 0 if input_op["action"] == "addMark" else 1,
            K.K_MTYPE: MARK_TYPE_ID[mark_type],
            K.K_MATTR: self._uni.attrs.intern(input_op.get("attrs")),
            K.K_SKIND: 0,  # the start never grows (peritext.ts:466)
            K.K_SCTR: start[0],
            K.K_SACT: start[1],
        }
        wire: Dict[str, Any] = {
            "opId": make_op_id(self.max_op, self.actor_id),
            "action": input_op["action"],
            "obj": obj,
            "start": {"type": "before", "elemId": self._wire_id(*start)},
            "markType": mark_type,
        }
        if end_grows and input_op["endIndex"] >= vis_len:
            fields[K.K_EKIND] = 2
            wire["end"] = {"type": "endOfText"}
        else:
            kind, index = (0, input_op["endIndex"]) if end_grows else (1, input_op["endIndex"] - 1)
            end = self._elem_id(index, peek=False)
            fields.update({K.K_EKIND: kind, K.K_ECTR: end[0], K.K_EACT: end[1]})
            wire["end"] = {"type": ("before", "after")[kind], "elemId": self._wire_id(*end)}
        if input_op.get("attrs"):
            wire["attrs"] = dict(input_op["attrs"])
        return self._op_row(K.KIND_MARK, fields), wire

    def _make_host_op(self, change: Change, op: Dict[str, Any]) -> Tuple[str, List[Patch]]:
        """Allocate an op id, apply to the host store, record the wire form
        (the host half of the reference's makeNewOp, micromerge.ts:483-493)."""
        if self._snap is not None and self._snap["store"] is None:
            # First host op of this change: keep the store as it was, for
            # the rollback (the local path mutates it in place).
            self._snap["store"] = copy.deepcopy(self._store)
        self.max_op += 1
        op_id = make_op_id(self.max_op, self.actor_id)
        op_with_id = {"opId": op_id, **op}
        patches = self._store.apply_op(op_with_id)
        # An in-place mutation moves this replica to a fresh version class.
        self._uni._store_version_counter += 1
        self._uni.store_versions[0] = self._uni._store_version_counter
        change["ops"].append(op_to_wire(op_with_id))
        if (
            op["action"] == "makeList"
            and op.get("obj") is None
            and op.get("key") == "text"
            and self._uni.text_objs[0] is None
        ):
            # The first root text list: bind the tensor state to it.
            self._uni.text_objs[0] = op_id
            self._store.device_objects.add(op_id)
        return op_id, patches

    def _apply_rows(self, rows: List[np.ndarray]) -> List[Patch]:
        if not rows:
            return []
        uni = self._uni
        op_rows = np.stack(rows)
        kinds = op_rows[:, K.K_KIND]
        uni.lengths[0] += int((kinds == K.KIND_INSERT).sum())
        uni.mark_counts[0] += int((kinds == K.KIND_MARK).sum())
        uni._ensure_capacity(uni.lengths[0], uni.mark_counts[0])

        state = self._state()
        ops = torch.from_numpy(op_rows[None]).to(uni.device)
        args = (state, ops, uni._ranks_device(), uni._multi_device())
        readback = patch_readback()
        span_cap = uni._span_cap

        # The launch policy of ingest without degradation: the step is
        # pure, so a failed attempt reruns from the same state, and on
        # exhaustion DeviceLaunchError reaches change()'s rollback.
        def make_attempt(rb: str):
            def attempt():
                faults.fire("device_launch")
                ns, recs = K.apply_ops_patched(*args, readback=rb, span_cap=span_cap)
                return (ns, recs), ns.length

            return attempt

        new_state, records = uni._run_launch(make_attempt(readback))
        records = {k: v.cpu().numpy() for k, v in records.items()}
        if readback == "compact" and uni._span_overflow([records], span_cap):
            # Overflowed span tables: the same step again, reading planes.
            new_state, records = uni._run_launch(make_attempt("planes"))
            records = {k: v.cpu().numpy() for k, v in records.items()}
        uni.states = new_state
        # Local mark rows take table columns as ingested ones do, so they
        # count toward the allowMultiple group census (after the launch
        # succeeded, as _commit counts them); the local per-op application
        # does not maintain the patched route's winner cache.
        uni._count_multi_groups(op_rows)
        uni._wcaches = None
        table = uni._mark_tables([0])[0]
        return assemble_patches(records, 0, op_rows, table, uni.attrs)
