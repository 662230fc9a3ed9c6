"""Host patch assembly: reference-format patches from per-op records.

A copy of the JAX package's host-side assembly (``peritext_tpu/ops/
universe.py``: ``assemble_patches``, ``assemble_patches_sorted(_compact)``
and their helpers, the readback knobs, the span-cap policy and the
allowMultiple group census ``fold_multi_groups``), pure numpy over the
records that ``kernels.apply_ops_patched`` and ``sorted_patched.
merge_step_sorted_patched_batch`` return.  The stream is the reference's
Patch stream (micromerge.ts:25-30) patch for patch.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from peritext_tpu_torch import schema
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.encode import AttrRegistry, bucket_length, env_int
from peritext_tpu_torch.ops.sorted_patched import PATCH_GROUP_K
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


def codepoints_to_str(codepoints: np.ndarray) -> str:
    """Codepoint array -> str without a per-char loop (surrogatepass, so the
    batch decode accepts exactly what ``chr()`` accepts)."""
    return np.asarray(codepoints).astype("<u4").tobytes().decode("utf-32-le", "surrogatepass")


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


def assemble_patches_sorted(
    records: Dict[str, np.ndarray],
    r: int,
    text_rows: np.ndarray,
    text_pos: np.ndarray,
    char_buf: np.ndarray,
    mark_rows: np.ndarray,
    mark_pos: np.ndarray,
    table: Dict[str, Dict[str, Any]],
    attrs: AttrRegistry,
) -> List[Any]:
    """``(pos, patch)`` pairs of replica ``r`` from the patched sorted
    merge's planes records (``universe.assemble_patches_sorted``).  Text
    rows are fused: a run expands to k insert patches at consecutive
    stream positions and visible indices, sharing one inherited-marks
    decode."""
    patches: List[Any] = []
    op_ids = list(table)
    mask_cache: Dict[bytes, Dict[str, Any]] = {}
    kind = records["kind"][r]
    tvalid = records["tvalid"][r]
    index0 = records["index0"][r]
    for l in range(text_rows.shape[0]):
        kd = int(kind[l])
        if kd == K.KIND_PAD or not tvalid[l]:
            continue
        pos0 = int(text_pos[l])
        idx0 = int(index0[l])
        if kd == K.KIND_DELETE:
            patches.append((pos0, {"path": ["text"], "action": "delete", "index": idx0, "count": 1}))
            continue
        if kd == K.KIND_INSERT_RUN:
            n = int(text_rows[l, K.K_RUN_LEN])
            start = int(text_rows[l, K.K_PAYLOAD])
            values = [chr(int(c)) for c in char_buf[start : start + n]]
        else:
            n = 1
            values = [chr(int(text_rows[l, K.K_PAYLOAD]))]
        row_mask = records["ins_mask"][r, l]
        for j in range(n):
            patches.append((pos0 + j, {
                "path": ["text"],
                "action": "insert",
                "index": idx0 + j,
                "values": [values[j]],
                "marks": copy_jsonlike(decode_mask_row(row_mask, op_ids, table, mask_cache)),
            }))
    for m in range(mark_rows.shape[0]):
        if int(mark_rows[m, K.K_KIND]) != K.KIND_MARK:
            continue
        pos = int(mark_pos[m])
        for patch in mark_patch_list(
            records["written"][r, m], records["during"][r, m], records["changed"][r, m],
            records["vis"][r, m], int(records["obj_len"][r, m]), mark_rows[m], attrs,
        ):
            patches.append((pos, patch))
    return patches


def assemble_patches_sorted_compact(
    records: Dict[str, np.ndarray],
    r: int,
    text_rows: np.ndarray,
    text_pos: np.ndarray,
    char_buf: np.ndarray,
    mark_rows: np.ndarray,
    mark_pos: np.ndarray,
    table: Dict[str, Dict[str, Any]],
    attrs: AttrRegistry,
) -> List[Any]:
    """``assemble_patches_sorted`` over the compact run-table records,
    vectorized (``universe.assemble_patches_sorted_compact``): run
    expansion, index and position arithmetic and char decoding are numpy
    operations over all text rows at once, and mark patches come straight
    from the device-compacted spans.  Emits the same ``(pos, patch)`` set
    as the planes assembler; every stream position is unique per op, so
    the caller's stable sort by position gives the same stream."""
    patches: List[Any] = []
    op_ids = list(table)
    mask_cache: Dict[bytes, Dict[str, Any]] = {}
    kind = np.asarray(text_rows[:, K.K_KIND])
    tvalid = np.asarray(records["tvalid"][r]).astype(bool)
    index0 = np.asarray(records["index0"][r])
    live = (kind != K.KIND_PAD) & tvalid

    for l in np.flatnonzero(live & (kind == K.KIND_DELETE)).tolist():
        patches.append((
            int(text_pos[l]),
            {"path": ["text"], "action": "delete", "index": int(index0[l]), "count": 1},
        ))

    ins = np.flatnonzero(live & ((kind == K.KIND_INSERT) | (kind == K.KIND_INSERT_RUN)))
    if ins.size:
        is_run = kind[ins] == K.KIND_INSERT_RUN
        lens = np.where(is_run, text_rows[ins, K.K_RUN_LEN], 1).astype(np.int64)
        payload = text_rows[ins, K.K_PAYLOAD].astype(np.int64)
        total = int(lens.sum())
        row_of = np.repeat(np.arange(ins.size), lens)
        off = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        buf_idx = np.minimum(payload[row_of] + off, char_buf.shape[0] - 1)
        codes = np.where(is_run[row_of], np.asarray(char_buf)[buf_idx], payload[row_of])
        text = codepoints_to_str(codes)
        pos_flat = (text_pos[ins][row_of] + off).tolist()
        idx_flat = (index0[ins][row_of] + off).tolist()
        row_marks = [
            decode_mask_row(records["ins_mask"][r, l], op_ids, table, mask_cache) for l in ins.tolist()
        ]
        for j in range(total):
            patches.append((pos_flat[j], {
                "path": ["text"],
                "action": "insert",
                "index": idx_flat[j],
                "values": [text[j]],
                "marks": copy_jsonlike(row_marks[row_of[j]]),
            }))

    mcount = np.asarray(records["mcount"][r])
    mk = np.flatnonzero((np.asarray(mark_rows[:, K.K_KIND]) == K.KIND_MARK) & (mcount > 0))
    for m in mk.tolist():
        pos = int(mark_pos[m])
        for patch in mark_span_patches(
            records["mstart"][r, m], records["mend"][r, m], int(mcount[m]), mark_rows[m], attrs,
        ):
            patches.append((pos, patch))
    return patches


def fold_multi_groups(
    census: Dict[Tuple[int, int], Set[Tuple[int, int]]], *, types, attr_ids, ctrs, act_ids
) -> None:
    """Fold mark-op columns into an allowMultiple group census
    (``universe.fold_multi_groups``): ``census[(type_id, attr_id)]``
    gathers the distinct ``(ctr, act_id)`` op identities, the one
    definition of group identity for the live census, the pre-launch gate
    and the checkpoint rebuild.  Each set keeps at most PATCH_GROUP_K + 1
    of its smallest identities: the gate only asks whether a group is past
    the cap, and the kept subset does not depend on the fold order."""
    multi_by_id = schema.ALLOW_MULTIPLE_BY_ID
    cap = PATCH_GROUP_K + 1
    for t, attr, ctr, act in zip(types, attr_ids, ctrs, act_ids):
        t = int(t)
        if t < len(multi_by_id) and multi_by_id[t]:
            ops = census.setdefault((t, int(attr)), set())
            ops.add((int(ctr), int(act)))
            if len(ops) > cap:
                ops.discard(max(ops))


def fold_multi_group_rows(census: Dict[Tuple[int, int], Set[Tuple[int, int]]], rows) -> None:
    """``fold_multi_groups`` over encoded op rows (mark rows only)."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return
    marks = rows[rows[:, K.K_KIND] == K.KIND_MARK]
    fold_multi_groups(
        census, types=marks[:, K.K_MTYPE], attr_ids=marks[:, K.K_MATTR],
        ctrs=marks[:, K.K_CTR], act_ids=marks[:, K.K_ACT],
    )
