"""Checkpoint/resume: device-state snapshots + change-log tail replay.

The PyTorch port's copy of ``peritext_tpu/runtime/checkpoint.py``, bound to
``TorchUniverse``: the same ``CHECKPOINT_FORMAT`` npz payload and sidecar
and the same ``_row_digest``.  Arrays leave and enter the universe through
``state_to_numpy`` / ``state_from_numpy``, which keep the JAX package's
dtypes (``bnd_mask`` as uint32), so either package loads the other's
snapshots and exported rows.  Loading puts the state on the GPU unless the
caller passes ``device="cpu"``.

The reference's durability story is the append-only per-actor change log —
any replica is reconstructible by replaying logs through applyChange (that
is exactly how its failure-trace JSONs work, SURVEY.md §5).  This module
keeps that model and adds the device-scale fast path: snapshot the dense device
state (one npz of the stacked arrays + a JSON control-plane sidecar), then on
resume replay only the log tail past the snapshot's vector clocks.

Format:
- ``<path>.npz``  — every DocState leaf, batched [R, ...]
- ``<path>.json`` — replica ids, per-replica clocks/lengths/mark counts,
  actor and attr intern tables, capacities, host object stores + device
  text-list bindings
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from peritext_tpu_torch import schema
from peritext_tpu_torch.ids import ActorRegistry
from peritext_tpu_torch.ops.encode import AttrRegistry
from peritext_tpu_torch.ops.patches import fold_multi_groups
from peritext_tpu_torch.ops.state import FIELDS, grow_state, map_state, state_from_numpy, state_to_numpy
from peritext_tpu_torch.ops.universe import TorchUniverse
from peritext_tpu_torch.oracle.doc import ObjectStore
from peritext_tpu_torch.runtime import faults
from peritext_tpu_torch.runtime import telemetry

_log = logging.getLogger(__name__)

_STATE_FIELDS = list(FIELDS)

# Sidecar format version.  2 = the host-object-store plane ('stores' +
# 'text_objs' + 'format'); 1 (implicit, no 'format' key) = the same layout
# before the version field existed.  Anything older (the pre-round-2
# 'roots' layout) is rejected with an explicit error instead of a bare
# KeyError deep in load.
CHECKPOINT_FORMAT = 2


def save_universe(uni: TorchUniverse, path: str) -> None:
    with telemetry.span("checkpoint.save", path=path):
        _save_universe(uni, path)
    if telemetry.enabled:
        telemetry.counter("checkpoint.saves")


def _save_universe(uni: TorchUniverse, path: str) -> None:
    # Chaos chokepoint: an injected failure raises before anything is
    # written; the previous generation stays intact (atomic writes below).
    faults.fire("checkpoint_write")
    arrays = state_to_numpy(uni.states)
    # Write both files atomically so a crash mid-save never destroys the
    # previous good snapshot.  The npz payload is built in memory first so
    # its digest can ride in the sidecar — restore verifies it and treats a
    # mismatch (truncation, bit rot) like any other unreadable generation.
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    payload = buf.getvalue()
    tmp_npz = path + ".npz.tmp"
    with open(tmp_npz, "wb") as f:
        f.write(payload)
    os.replace(tmp_npz, path + ".npz")
    sidecar = {
        "format": CHECKPOINT_FORMAT,
        "npz_sha256": hashlib.sha256(payload).hexdigest(),
        "replica_ids": uni.replica_ids,
        "clocks": uni.clocks,
        "lengths": uni.lengths,
        "mark_counts": uni.mark_counts,
        "stores": [s.to_json() for s in uni.stores],
        "text_objs": uni.text_objs,
        "capacity": uni.capacity,
        "max_mark_ops": uni.max_mark_ops,
        "max_actors": uni.max_actors,
        "actors": uni.actors.actors,
        "attrs": uni.attrs.values,
        # Snapshots index mark types by position in the runtime-extensible
        # schema registry; persist the registry so a restoring process with
        # different register_mark_type calls can't silently remap types.
        "mark_schema": [
            {
                "name": name,
                "inclusive": spec.inclusive,
                "allow_multiple": spec.allow_multiple,
                "attr_keys": list(spec.attr_keys),
                "excludes": spec.excludes,
            }
            for name, spec in schema.MARK_SPEC.items()
        ],
    }
    tmp = path + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump(sidecar, f)
    os.replace(tmp, path + ".json")
    # Crash-corruption drill (``checkpoint_write:corrupt=N``): truncate the
    # just-written npz after the atomic replace, simulating a torn write
    # that slipped past rename atomicity (e.g. lost page cache on power
    # failure).  restore_latest must detect it via the digest and fall back.
    if faults.take("checkpoint_write", "corrupt"):
        with open(path + ".npz", "r+b") as f:
            f.truncate(max(1, len(payload) // 2))


def _restore_mark_schema(sidecar: Dict[str, Any]) -> None:
    """Validate the snapshot's mark registry against the live one.

    Stored mark-type ids are positional, so the snapshot's registry must be
    a prefix of the current one (same names, same flags, same order).
    Types the snapshot has beyond the live registry are auto-registered;
    any mismatch within the shared prefix fails loudly.
    """
    saved = sidecar.get("mark_schema")
    if saved is None:  # pre-schema-sidecar snapshot: assume the core four
        return
    live = list(schema.ALL_MARKS)
    for i, entry in enumerate(saved):
        if i < len(live):
            name = live[i]
            spec = schema.MARK_SPEC[name]
            if (
                entry["name"] != name
                or entry["inclusive"] != spec.inclusive
                or entry["allow_multiple"] != spec.allow_multiple
                or tuple(entry["attr_keys"]) != spec.attr_keys
                # Older snapshots (no 'excludes' key) validate flags only.
                or ("excludes" in entry and entry["excludes"] != spec.excludes)
            ):
                raise ValueError(
                    f"snapshot mark schema mismatch at id {i}: snapshot has "
                    f"{entry['name']!r}, process has {name!r} (or flags differ); "
                    "register mark types in the same order before restoring"
                )
        else:
            schema.register_mark_type(
                entry["name"],
                inclusive=entry["inclusive"],
                allow_multiple=entry["allow_multiple"],
                attr_keys=tuple(entry["attr_keys"]),
                excludes=entry.get("excludes"),
            )


def load_universe(path: str, device: Optional[str | torch.device] = None) -> TorchUniverse:
    with telemetry.span("checkpoint.restore", path=path):
        uni = _load_universe(path, device)
    if telemetry.enabled:
        telemetry.counter("checkpoint.restores")
    return uni


def _load_universe(path: str, device: Optional[str | torch.device]) -> TorchUniverse:
    with open(path + ".json") as f:
        sidecar = json.load(f)
    fmt = sidecar.get("format", 1)
    if fmt > CHECKPOINT_FORMAT or "stores" not in sidecar:
        raise ValueError(
            f"snapshot {path!r} has format {fmt} "
            f"(this build reads <= {CHECKPOINT_FORMAT}"
            + ("" if "stores" in sidecar else "; pre-round-2 'roots' layout")
            + "); re-save it with a matching build or replay its change log"
        )
    _restore_mark_schema(sidecar)
    uni = TorchUniverse(
        sidecar["replica_ids"],
        capacity=sidecar["capacity"],
        max_mark_ops=sidecar["max_mark_ops"],
        max_actors=sidecar["max_actors"],
        device=device,
    )
    uni.clocks = [dict(c) for c in sidecar["clocks"]]
    uni.lengths = list(sidecar["lengths"])
    uni.mark_counts = list(sidecar["mark_counts"])
    uni.text_objs = list(sidecar["text_objs"])
    # Reconstruct store-version classes from content so a restored converged
    # fleet keeps the one-copy-per-class host plane (universe.store_versions
    # invariant: equal version ⟹ equal store): deserialize ONE store per
    # distinct digest and share the instance across its class — restore is
    # O(classes), not O(R), in both time and memory.
    digest_version: Dict[str, int] = {}
    digest_store: Dict[str, ObjectStore] = {}
    versions, stores = [], []
    for s in sidecar["stores"]:
        d = json.dumps(s, sort_keys=True)
        if d not in digest_version:
            uni._store_version_counter += 1
            digest_version[d] = uni._store_version_counter
            digest_store[d] = ObjectStore.from_json(s)
        versions.append(digest_version[d])
        stores.append(digest_store[d])
    uni.stores = stores
    uni.store_versions = versions
    actors = ActorRegistry()
    for actor in sidecar["actors"]:
        actors.intern(actor)
    uni.actors = actors
    attrs = AttrRegistry()
    for attr in sidecar["attrs"]:
        attrs.intern(attr)
    uni.attrs = attrs

    with open(path + ".npz", "rb") as f:
        payload = f.read()
    expected = sidecar.get("npz_sha256")
    if expected is not None and hashlib.sha256(payload).hexdigest() != expected:
        raise ValueError(
            f"snapshot {path!r}: state payload digest mismatch "
            "(truncated or corrupt .npz)"
        )
    data = np.load(io.BytesIO(payload))
    # Each read of an npz member decompresses it again: read each once.
    arrays = {f: data[f] for f in _STATE_FIELDS}
    uni.states = state_from_numpy(arrays, uni.device)
    # Rebuild the allowMultiple group census (the patched sorted route's
    # gate) from the restored mark tables.
    for r in range(len(uni.replica_ids)):
        count = uni.mark_counts[r]
        fold_multi_groups(
            uni._multi_groups,
            types=arrays["mark_type"][r][:count],
            attr_ids=arrays["mark_attr"][r][:count],
            ctrs=arrays["mark_ctr"][r][:count],
            act_ids=arrays["mark_act"][r][:count],
        )
    return uni


def _row_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Deterministic digest of one replica row's state arrays (field order,
    dtype and shape included, so a torn or re-shaped handoff can't verify)."""
    h = hashlib.sha256()
    for f in _STATE_FIELDS:
        a = np.ascontiguousarray(arrays[f])
        h.update(f"{f}:{a.dtype}:{a.shape};".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def export_replica(uni: TorchUniverse, replica: str) -> Dict[str, Any]:
    """Snapshot ONE replica row as a self-contained in-memory payload.

    The live-migration handoff (runtime/elastic.py): the payload carries the
    row's device state (D2H), its host control planes (clock / length / mark
    count / object store / text binding), and the SOURCE universe's intern
    tables — elem_act / mark_act hold registry-LOCAL actor ids and mark_attr
    holds AttrRegistry-local ids, so :func:`import_replica` must remap them
    into the target's registries.  A digest over the state arrays rides
    along; import verifies it so a torn handoff fails loudly instead of
    corrupting the target fleet.
    """
    with telemetry.span("checkpoint.export_replica", replica=replica):
        i = uni.index_of[replica]
        arrays = {
            f: np.array(a) for f, a in state_to_numpy(map_state(lambda x: x[i], uni.states)).items()
        }
        payload = {
            "replica": replica,
            "arrays": arrays,
            "capacity": uni.capacity,
            "max_mark_ops": uni.max_mark_ops,
            "clock": dict(uni.clocks[i]),
            "length": uni.lengths[i],
            "mark_count": uni.mark_counts[i],
            "store": uni.stores[i].to_json(),
            "text_obj": uni.text_objs[i],
            "actors": uni.actors.actors,
            "attrs": uni.attrs.values,
            "digest": _row_digest(arrays),
        }
    if telemetry.enabled:
        telemetry.counter("checkpoint.replica_exports")
    return payload


def import_replica(uni: TorchUniverse, replica: str, payload: Dict[str, Any]) -> None:
    """Graft an exported replica row onto an EMPTY row of another universe.

    The target row must never have ingested anything (empty clock) — the
    migration protocol provisions it via the pow2 pad plane + rename.  Actor
    and attr ids are remapped through the target registries with MASKS
    (elem_act only where ``elem_ctr > 0``, mark rows only below
    ``mark_count``, attrs only where ``>= 0``): inert slots hold 0, which is
    a *valid* intern id, and rewriting them would scramble dead-slot
    contents the kernels rely on being stable.  ``bnd_mask`` needs no remap
    (bits index the same replica's mark-op rows, which move row-for-row).
    Capacities reconcile both ways: the target grows to fit the payload
    (pow2, normal `_ensure_capacity`), a smaller payload row grows to the
    target's buckets.
    """
    with telemetry.span("checkpoint.import_replica", replica=replica):
        _import_replica(uni, replica, payload)
    if telemetry.enabled:
        telemetry.counter("checkpoint.replica_imports")


def _import_replica(uni: TorchUniverse, replica: str, payload: Dict[str, Any]) -> None:
    i = uni.index_of[replica]
    if uni.clocks[i]:
        raise ValueError(
            f"cannot import over non-empty replica {replica!r} "
            f"(clock {uni.clocks[i]}); provision a fresh row first"
        )
    arrays = payload["arrays"]
    if _row_digest(arrays) != payload["digest"]:
        raise ValueError(
            f"replica payload digest mismatch for {replica!r} "
            "(torn or corrupted handoff)"
        )
    # Grow the target's buckets to fit the payload, then the payload row to
    # the target's (possibly already larger) buckets.
    uni._ensure_capacity(payload["capacity"], payload["max_mark_ops"])
    # Masked intern-id remap through the TARGET registries.
    actor_map = np.asarray(
        [uni.actors.intern(a) for a in payload["actors"]], np.int32
    )
    attr_map = np.asarray(
        [uni.attrs.intern(a) for a in payload["attrs"]], np.int32
    )
    elem_act = np.array(arrays["elem_act"], np.int32)
    live = np.asarray(arrays["elem_ctr"]) > 0
    if actor_map.size:
        elem_act[live] = actor_map[elem_act[live]]
    mark_act = np.array(arrays["mark_act"], np.int32)
    mark_attr = np.array(arrays["mark_attr"], np.int32)
    mc = int(payload["mark_count"])
    if mc and actor_map.size:
        mark_act[:mc] = actor_map[mark_act[:mc]]
    has_attr = np.zeros(mark_attr.shape, bool)
    has_attr[:mc] = mark_attr[:mc] >= 0
    if attr_map.size:
        mark_attr[has_attr] = attr_map[mark_attr[has_attr]]
    remapped = dict(arrays)
    remapped["elem_act"] = elem_act
    remapped["mark_act"] = mark_act
    remapped["mark_attr"] = mark_attr
    row = state_from_numpy(remapped, uni.device)
    if row.capacity < uni.capacity or row.max_mark_ops < uni.max_mark_ops:
        row = grow_state(row, uni.capacity, uni.max_mark_ops)

    def put_row(full: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        # Committed tensors are never written in place (a retried launch
        # reruns from them), so the row lands in a copy.
        out = full.clone()
        out[i] = r
        return out

    # Assigning ``uni.states`` invalidates the census mirror.
    uni.states = type(uni.states)(**{f: put_row(getattr(uni.states, f), getattr(row, f)) for f in _STATE_FIELDS})
    uni._wcaches = None  # row contents changed under the winner cache
    uni.clocks[i] = dict(payload["clock"])
    uni.lengths[i] = int(payload["length"])
    uni.mark_counts[i] = int(payload["mark_count"])
    uni.stores[i] = ObjectStore.from_json(payload["store"])
    uni._store_version_counter += 1
    uni.store_versions[i] = uni._store_version_counter
    uni.text_objs[i] = payload["text_obj"]
    # The imported mark rows (remapped ids) join the group census.
    fold_multi_groups(
        uni._multi_groups,
        types=np.asarray(arrays["mark_type"])[:mc],
        attr_ids=mark_attr[:mc],
        ctrs=np.asarray(arrays["mark_ctr"])[:mc],
        act_ids=mark_act[:mc],
    )


class CheckpointManager:
    """Rotating snapshot schedule: save every ``interval`` steps, keep the
    newest ``keep`` snapshots, resume from the newest loadable one.

    Snapshots are written atomically (save_universe), so a crash mid-save
    leaves the previous generation intact; ``latest`` is derived from the
    on-disk generation numbers rather than a pointer file.
    """

    def __init__(self, directory: str, interval: int = 1, keep: int = 3) -> None:
        self.directory = directory
        self.interval = max(1, interval)
        self.keep = max(1, keep)
        self._step = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, generation: int) -> str:
        return os.path.join(self.directory, f"snap-{generation:08d}")

    def generations(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("snap-") and name.endswith(".json"):
                try:
                    out.append(int(name[5:-5]))
                except ValueError:
                    continue
        return sorted(out)

    def maybe_save(self, uni: TorchUniverse) -> Optional[str]:
        """Call once per ingest step; saves on the schedule and prunes."""
        self._step += 1
        if self._step % self.interval != 0:
            return None
        return self.save(uni)

    def save(self, uni: TorchUniverse) -> str:
        gens = self.generations()
        generation = (gens[-1] + 1) if gens else 0
        path = self._path(generation)
        save_universe(uni, path)
        for old in self.generations()[: -self.keep]:
            for suffix in (".json", ".npz"):
                try:
                    os.remove(self._path(old) + suffix)
                except OSError:
                    pass
        return path

    def restore_latest(
        self, log: Any = None, device: Optional[str | torch.device] = None
    ) -> Optional[TorchUniverse]:
        """Newest loadable snapshot (+ optional log-tail replay), or None.

        Only snapshot-load failures fall back a generation; errors during
        log-tail replay indicate a log problem and propagate.
        """
        import zipfile

        for generation in reversed(self.generations()):
            try:
                uni = load_universe(self._path(generation), device)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as exc:
                # Corrupt/partial snapshot (bad digest, truncated zip,
                # unreadable sidecar): log it and fall back a generation —
                # the change log replays the gap, so an older snapshot only
                # costs replay time, never data.
                if telemetry.enabled:
                    telemetry.counter("checkpoint.corrupt_fallbacks")
                    telemetry.record(
                        "checkpoint.restore",
                        outcome="corrupt_fallback",
                        generation=generation,
                        error=type(exc).__name__,
                    )
                # Durability post-mortem: a corrupt generation means a torn
                # write slipped past rename atomicity — worth a black-box
                # dump (no-op unless PERITEXT_BLACKBOX is armed).
                telemetry.blackbox_dump(
                    "checkpoint_corrupt",
                    generation=generation,
                    error=f"{type(exc).__name__}: {exc}",
                )
                _log.warning(
                    "checkpoint generation %d unreadable (%s: %s); "
                    "falling back to the previous generation",
                    generation,
                    type(exc).__name__,
                    exc,
                )
                continue
            if log is not None:
                _replay_tail(uni, log)
            return uni
        return None


def _replay_tail(uni: TorchUniverse, log: Any, replicas: Optional[List[str]] = None) -> None:
    frontier = log.clock()
    batches: Dict[str, List[Dict[str, Any]]] = {}
    for name in replicas or uni.replica_ids:
        batches[name] = log.missing_changes(frontier, uni.clock(name))
    uni.apply_changes(batches)


def resume_universe(
    path: str,
    log: Any,
    replicas: Optional[List[str]] = None,
    device: Optional[str | torch.device] = None,
) -> TorchUniverse:
    """Load a snapshot and replay the change-log tail past its clocks
    through ``apply_changes`` (on the GPU, the merge kernels).

    ``log`` is a :class:`peritext_tpu_torch.runtime.log.ChangeLog` (or
    anything with ``missing_changes``).  Replicas named in the snapshot
    resume to the log's frontier; this is the crash-recovery path.
    """
    uni = load_universe(path, device)
    _replay_tail(uni, log, replicas)
    return uni
