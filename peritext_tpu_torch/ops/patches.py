"""Host patch assembly: reference-format patches from per-op records.

A copy of the JAX package's host-side assembly (``peritext_tpu/ops/
universe.py``: ``assemble_patches`` and its helpers, the readback knobs and
the span-cap policy), pure numpy over the records that ``kernels.
apply_ops_patched`` returns.  The stream is the reference's Patch stream
(micromerge.ts:25-30) patch for patch.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from peritext_tpu_torch import schema
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.encode import AttrRegistry, bucket_length, env_int
from peritext_tpu_torch.oracle.doc import ops_to_marks


def patch_readback() -> str:
    """Record format of the patch path (``PERITEXT_PATCH_READBACK``):
    "compact" (default) reads back the run tables that ``kernels.
    compact_mark_records`` builds on the device, "planes" the full per-slot
    planes.  Both assemble byte-identical streams."""
    mode = os.environ.get("PERITEXT_PATCH_READBACK", "compact")
    if mode not in ("compact", "planes"):
        raise ValueError(
            f"PERITEXT_PATCH_READBACK must be 'compact' or 'planes', got {mode!r}"
        )
    return mode


def initial_span_cap() -> int:
    """Starting per-mark-row span capacity of the compact readback
    (``PERITEXT_PATCH_SPAN_CAP``, default 8, pow2-bucketed).  A mark op's
    patch count depends on the data, so the cap adapts: a batch that
    overflows it re-reads via planes and the universe grows its cap."""
    return bucket_length(env_int("PERITEXT_PATCH_SPAN_CAP", "8", 1), minimum=1)


def decode_mask_row(
    row: np.ndarray,
    op_ids: List[str],
    table: Dict[str, Dict[str, Any]],
    cache: Dict[bytes, Dict[str, Any]],
) -> Dict[str, Any]:
    """One boundary bitset row as an effective mark map (the oracle's
    ``ops_to_marks``), memoized on the row bytes.  Returns the cached dict:
    copy it (``copy_jsonlike``) before handing it out."""
    key = row.tobytes()
    marks = cache.get(key)
    if marks is None:
        present = frozenset(
            op_id for m, op_id in enumerate(op_ids) if row[m // 32] >> (m % 32) & 1
        )
        marks = cache[key] = ops_to_marks(present, table)
    return marks


def copy_jsonlike(x: Any) -> Any:
    """Structural copy of JSON-shaped values (dicts, lists, scalars): equal
    to ``copy.deepcopy`` on these shapes, at a fraction of its cost."""
    if isinstance(x, dict):
        return {k: copy_jsonlike(v) for k, v in x.items()}
    if isinstance(x, list):
        return [copy_jsonlike(v) for v in x]
    return x


def strip_pos(pairs: List[Any], with_positions: bool) -> List[Any]:
    """One replica's ``(pos, patch)`` stream, already in stream order: the
    pairs when the caller asked for positions, else the bare patches."""
    if with_positions:
        return list(pairs)
    return [p for _, p in pairs]


def assemble_patches(
    records: Dict[str, np.ndarray],
    r: int,
    op_rows: np.ndarray,
    table: Dict[str, Dict[str, Any]],
    attrs: AttrRegistry,
    row_pos: Optional[np.ndarray] = None,
) -> List[Any]:
    """Reference-format patches of replica ``r`` from its per-op records.

    With ``row_pos`` (each op row's flat position in the batch stream, from
    ``encode_changes``) returns ``(pos, patch)`` pairs, so the caller can
    interleave host-object patches in op order.  Takes either record
    format; with the compact one, kind and payload come from ``op_rows``."""
    patches: List[Any] = []

    def emit(i: int, patch: Dict[str, Any]) -> None:
        patches.append(patch if row_pos is None else (int(row_pos[i]), patch))

    op_ids = list(table)
    mask_cache: Dict[bytes, Dict[str, Any]] = {}
    compact = "mstart" in records
    num_ops = op_rows.shape[0] if compact else records["kind"].shape[1]
    for i in range(num_ops):
        kind = int(op_rows[i, K.K_KIND]) if compact else int(records["kind"][r, i])
        if kind == K.KIND_PAD or not records["valid"][r, i]:
            continue
        if kind == K.KIND_INSERT:
            char = int(op_rows[i, K.K_PAYLOAD]) if compact else int(records["char"][r, i])
            marks = decode_mask_row(records["ins_mask"][r, i], op_ids, table, mask_cache)
            emit(i, {
                "path": ["text"],
                "action": "insert",
                "index": int(records["index"][r, i]),
                "values": [chr(char)],
                "marks": copy_jsonlike(marks),
            })
        elif kind == K.KIND_DELETE:
            emit(i, {
                "path": ["text"],
                "action": "delete",
                "index": int(records["index"][r, i]),
                "count": 1,
            })
        elif kind == K.KIND_MARK:
            if compact:
                span_patches = mark_span_patches(
                    records["mstart"][r, i], records["mend"][r, i],
                    int(records["mcount"][r, i]), op_rows[i], attrs,
                )
            else:
                span_patches = mark_patch_list(
                    records["written"][r, i], records["during"][r, i],
                    records["changed"][r, i], records["vis"][r, i],
                    int(records["obj_len"][r, i]), op_rows[i], attrs,
                )
            for patch in span_patches:
                emit(i, patch)
    return patches


def _mark_patch(op_row: np.ndarray, attrs: AttrRegistry, start: int, end: int) -> Dict[str, Any]:
    action = "addMark" if int(op_row[K.K_MACTION]) == 0 else "removeMark"
    mark_type = schema.ALL_MARKS[int(op_row[K.K_MTYPE])]
    patch: Dict[str, Any] = {
        "action": action,
        "markType": mark_type,
        "path": ["text"],
        "startIndex": start,
        "endIndex": end,
    }
    if action == "addMark" and mark_type in ("link", "comment"):
        patch["attrs"] = attrs.decode(int(op_row[K.K_MATTR]))
    return patch


def mark_patch_list(
    written: np.ndarray,
    during: np.ndarray,
    changed: np.ndarray,
    vis: np.ndarray,
    obj_len: int,
    op_row: np.ndarray,
    attrs: AttrRegistry,
) -> List[Dict[str, Any]]:
    """Reference peritext.ts:198-221 over one row's planes: a patch opens
    at every written DURING slot whose effective marks change and closes at
    the next written slot (or the end of the walk), then the
    finishPartialPatch filters (peritext.ts:269-281) apply."""
    written_idx = np.flatnonzero(written)
    patches: List[Dict[str, Any]] = []
    for j, p in enumerate(written_idx):
        if not (during[p] and changed[p]):
            continue
        start = int(vis[p])
        end = int(vis[written_idx[j + 1]]) if j + 1 < written_idx.size else obj_len
        if end > start and start < obj_len:
            patches.append(_mark_patch(op_row, attrs, start, min(end, obj_len)))
    return patches


def mark_span_patches(
    starts: np.ndarray,
    ends: np.ndarray,
    count: int,
    op_row: np.ndarray,
    attrs: AttrRegistry,
) -> List[Dict[str, Any]]:
    """Patches from one compact run-table row: the device already applied
    the walk and the filters (a filtered lane reads ``end <= start``)."""
    patches: List[Dict[str, Any]] = []
    for j in range(min(count, starts.shape[0])):
        start, end = int(starts[j]), int(ends[j])
        if end > start:
            patches.append(_mark_patch(op_row, attrs, start, end))
    return patches
