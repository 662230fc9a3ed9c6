"""Append-only per-actor change logs — the durable replication substrate.

Reference: the fuzzer's ``SharedHistory`` (test/fuzz.ts:160-163) and the
vector-clock diff ``getMissingChanges`` (test/merge.ts:25-38).  A change log
is the CRDT's only durable state: any replica is reconstructible by replaying
logs through ``apply_change`` (this is exactly how the reference's failure
traces work — they serialize ``queues``).

A copy of ``peritext_tpu/runtime/log.py`` for the PyTorch port.  Its binary
form (``to_bytes``/``from_bytes``) is the JAX package's columnar varint
format, written and read by the port's native codec
(``runtime/native_codec.py``, its plain-Python coder where no C++ compiler
exists), so either package reads the other's logs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

from peritext_tpu_torch.runtime import faults
from peritext_tpu_torch.runtime import telemetry

Change = Dict[str, Any]
Clock = Mapping[str, int]


class ChangeLog:
    """Per-actor append-only sequences of changes, indexed by seq."""

    def __init__(self) -> None:
        self._queues: Dict[str, List[Change]] = {}

    def append(self, change: Change) -> None:
        # Durability chokepoint: an injected ``log_append`` failure models a
        # lost write — it raises *before* any mutation, so the log never
        # holds a half-recorded change.
        faults.fire("log_append")
        if telemetry.enabled:
            telemetry.counter("log.appends")
        queue = self._queues.setdefault(change["actor"], [])
        expected = len(queue) + 1
        if change["seq"] != expected:
            raise ValueError(
                f"Log gap for {change['actor']}: expected seq {expected}, got {change['seq']}"
            )
        queue.append(change)

    def record(self, change: Change) -> None:
        """Append if this change extends the log; ignore if already present.

        An already-covered seq must match the stored change byte-for-byte:
        a mismatch means a forked actor history or a corrupted log, which
        must surface rather than silently drop.
        """
        faults.fire("log_append")
        if telemetry.enabled:
            telemetry.counter("log.appends")
        if change["seq"] < 1:
            # Validate before touching the log: a rejected record must not
            # create a phantom actor entry in clock()/missing_changes.
            raise ValueError(
                f"Invalid seq {change['seq']} for {change['actor']}: seqs are 1-based"
            )
        queue = self._queues.setdefault(change["actor"], [])
        if change["seq"] == len(queue) + 1:
            queue.append(change)
        elif change["seq"] > len(queue) + 1:
            raise ValueError(
                f"Log gap for {change['actor']}: have {len(queue)}, got seq {change['seq']}"
            )
        else:
            stored = queue[change["seq"] - 1]
            if stored != change:
                raise ValueError(
                    f"Log conflict for {change['actor']} seq {change['seq']}: "
                    "incoming change differs from the stored one (forked history?)"
                )

    def clock(self) -> Dict[str, int]:
        return {actor: len(queue) for actor, queue in self._queues.items()}

    def changes_for(self, actor: str) -> List[Change]:
        return list(self._queues.get(actor, []))

    def missing_changes(self, source_clock: Clock, target_clock: Clock) -> List[Change]:
        """Changes the source has seen that the target hasn't.

        Reference test/merge.ts:25-38 (getMissingChanges): vector-clock diff,
        pulling from the per-actor queues.
        """
        changes: List[Change] = []
        for actor, count in source_clock.items():
            have = target_clock.get(actor)
            if have is None:
                changes.extend(self._queues.get(actor, [])[:count])
            elif have < count:
                changes.extend(self._queues.get(actor, [])[have:count])
        return changes

    def all_changes(self) -> List[Change]:
        out: List[Change] = []
        for queue in self._queues.values():
            out.extend(queue)
        return out

    @property
    def actors(self) -> List[str]:
        return list(self._queues)

    # -- binary persistence (native codec) ----------------------------------

    def to_bytes(self) -> bytes:
        """Serialize the whole log: columnar-varint op rows (the native
        codec, runtime/native_codec.py) + a JSON envelope for headers,
        intern tables, and structural ops.

        The binary analog of the reference's JSON change format
        (micromerge.ts:60-71, which cites Automerge's binary change format
        as the real-world encoding).
        """
        import json

        from peritext_tpu_torch.runtime.native_codec import encode_columns

        envelope, matrix = log_columns(self)
        payload = encode_columns(matrix)
        head = json.dumps(envelope).encode()
        return (
            len(head).to_bytes(8, "little") + head + payload
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "ChangeLog":
        import json

        from peritext_tpu_torch.ids import ActorRegistry
        from peritext_tpu_torch.ops import kernels as K
        from peritext_tpu_torch.ops.encode import AttrRegistry, decode_internal_op
        from peritext_tpu_torch.runtime.native_codec import decode_columns

        head_len = int.from_bytes(data[:8], "little")
        envelope = json.loads(data[8 : 8 + head_len])
        matrix = decode_columns(
            data[8 + head_len :], K.OP_FIELDS + 1, envelope["n_rows"]
        )
        actors = ActorRegistry()
        for actor in envelope["actors"]:
            actors.intern(actor)
        attrs = AttrRegistry()
        for attr in envelope["attrs"]:
            attrs.intern(attr)

        log = cls()
        row_i = 0
        for entry in envelope["changes"]:
            ops = []
            for op_meta in entry["ops"]:
                if op_meta is not None:
                    ops.append(op_meta)
                else:
                    obj = envelope["obj_table"][int(matrix[K.OP_FIELDS, row_i])]
                    ops.append(
                        decode_internal_op(matrix[:, row_i], actors, attrs, obj)
                    )
                    row_i += 1
            log.record({**entry["header"], "ops": ops})
        return log


def log_columns(log: ChangeLog) -> Tuple[Dict[str, Any], Any]:
    """The JSON envelope and the int32 [OP_FIELDS + 1, n_rows] op-row
    matrix that :meth:`ChangeLog.to_bytes` writes; the matrix's last row
    is each op's index into the envelope's ``obj_table``."""
    import numpy as np

    from peritext_tpu_torch.ids import ActorRegistry
    from peritext_tpu_torch.ops import kernels as K
    from peritext_tpu_torch.ops.encode import AttrRegistry, encode_internal_op

    actors = ActorRegistry()
    attrs = AttrRegistry()
    rows: List[Any] = []
    obj_table: List[Any] = []
    obj_index: Dict[Any, int] = {}
    obj_col: List[int] = []
    envelope: Dict[str, Any] = {"changes": []}
    for queue in log._queues.values():
        for change in queue:
            header = {k: change[k] for k in ("actor", "seq", "deps", "startOp")}
            ops_meta: List[Any] = []
            for op in change["ops"]:
                try:
                    row = encode_internal_op(op, actors, attrs)
                except ValueError:
                    # Host-list op with a value the char plane can't
                    # carry (e.g. a multi-codepoint element in a nested
                    # list — legal in the object model): envelope JSON,
                    # like structural ops.
                    row = None
                if row is None:
                    ops_meta.append(op)  # structural / unencodable: raw JSON
                else:
                    ops_meta.append(None)  # device op: row stream
                    rows.append(row)
                    obj = op.get("obj")
                    if obj not in obj_index:
                        obj_index[obj] = len(obj_table)
                        obj_table.append(obj)
                    obj_col.append(obj_index[obj])
            envelope["changes"].append({"header": header, "ops": ops_meta})
    matrix = (
        np.concatenate(
            [np.stack(rows).T, np.asarray(obj_col, np.int32)[None, :]]
        )
        if rows
        else np.zeros((K.OP_FIELDS + 1, 0), np.int32)
    )
    envelope["obj_table"] = obj_table
    envelope["actors"] = actors.actors
    envelope["attrs"] = attrs.values
    envelope["n_rows"] = matrix.shape[1]
    return envelope, matrix
