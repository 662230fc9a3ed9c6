"""Host-side encoding: wire-format changes -> dense op tensors.

The ChangeQueue analog at the host<->device boundary (SURVEY.md §2.4): a
causally-sorted batch of changes is flattened into fixed-width int32 op rows
(one row per *internal* op, kernels.py field layout), padded to a bucketed
length so launch shapes stay few, and uploaded once per apply call.

Actor strings and mark attrs are interned to dense ids here; the device only
ever sees integers.  Map-object ops (makeList/makeMap/set/del on maps —
structural control-plane ops, micromerge.ts:578-602) are split out for host
handling: the device engine's data plane is the text list.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from peritext_tpu_torch.ids import ActorRegistry, make_op_id, parse_op_id
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.schema import ALL_MARKS, MARK_TYPE_ID


class AttrRegistry:
    """Interns mark attr dicts to dense ids (canonical-JSON keyed)."""

    def __init__(self) -> None:
        self._id_of: Dict[str, int] = {}
        self._attrs: List[Dict[str, Any]] = []

    def intern(self, attrs: Optional[Dict[str, Any]]) -> int:
        if not attrs:
            return -1
        key = json.dumps(attrs, sort_keys=True)
        i = self._id_of.get(key)
        if i is None:
            i = len(self._attrs)
            self._id_of[key] = i
            self._attrs.append(dict(attrs))
        return i

    def decode(self, i: int) -> Optional[Dict[str, Any]]:
        if i < 0:
            return None
        return dict(self._attrs[i])

    @property
    def values(self) -> List[Dict[str, Any]]:
        return [dict(a) for a in self._attrs]


_BOUNDARY_KIND = {"before": 0, "after": 1, "endOfText": 2}

def encode_internal_op(
    op: Dict[str, Any], actors: ActorRegistry, attrs: AttrRegistry
) -> Optional[np.ndarray]:
    """One wire-format internal op -> an int32 op row, or None for map ops."""
    row = np.zeros(K.OP_FIELDS, np.int32)
    ctr, actor = parse_op_id(op["opId"])
    row[K.K_CTR] = ctr
    row[K.K_ACT] = actors.intern(actor)
    action = op["action"]

    if action == "set" and op.get("insert"):
        row[K.K_KIND] = K.KIND_INSERT
        elem = op.get("elemId")
        if elem is not None:
            ref_ctr, ref_actor = parse_op_id(elem)
            row[K.K_REF_CTR] = ref_ctr
            row[K.K_REF_ACT] = actors.intern(ref_actor)
        value = op["value"]
        if not isinstance(value, str) or len(value) != 1:
            raise ValueError(f"Expected 1-char string insert value, got {value!r}")
        row[K.K_PAYLOAD] = ord(value)
        return row

    if action == "del" and op.get("elemId") is not None:
        row[K.K_KIND] = K.KIND_DELETE
        ref_ctr, ref_actor = parse_op_id(op["elemId"])
        row[K.K_REF_CTR] = ref_ctr
        row[K.K_REF_ACT] = actors.intern(ref_actor)
        return row

    if action in ("addMark", "removeMark"):
        row[K.K_KIND] = K.KIND_MARK
        row[K.K_MACTION] = 0 if action == "addMark" else 1
        row[K.K_MTYPE] = MARK_TYPE_ID[op["markType"]]
        row[K.K_MATTR] = attrs.intern(op.get("attrs"))
        start, end = op["start"], op["end"]
        if start["type"] not in ("before", "after"):
            # startGrows is hardcoded false upstream (peritext.ts:466), so
            # startOfText anchors cannot be produced by any writer.
            raise NotImplementedError(f"start anchor {start['type']!r}")
        row[K.K_SKIND] = _BOUNDARY_KIND[start["type"]]
        sctr, sact = parse_op_id(start["elemId"])
        row[K.K_SCTR] = sctr
        row[K.K_SACT] = actors.intern(sact)
        row[K.K_EKIND] = _BOUNDARY_KIND[end["type"]]
        if end["type"] != "endOfText":
            ectr, eact = parse_op_id(end["elemId"])
            row[K.K_ECTR] = ectr
            row[K.K_EACT] = actors.intern(eact)
        return row

    # Map-object / structural op: host concern.
    return None


_BOUNDARY_NAME = {v: k for k, v in _BOUNDARY_KIND.items()}


def decode_internal_op(
    row: np.ndarray, actors: ActorRegistry, attrs: AttrRegistry, obj: Optional[str]
) -> Dict[str, Any]:
    """Inverse of encode_internal_op: an op row back to the wire format.
    ``obj`` is the containing list's id (op rows do not carry it; the
    change log's envelope does)."""

    def op_id(ctr_field: int, act_field: int) -> str:
        return make_op_id(int(row[ctr_field]), actors.actor(int(row[act_field])))

    oid = op_id(K.K_CTR, K.K_ACT)
    kind = int(row[K.K_KIND])
    if kind == K.KIND_INSERT:
        op: Dict[str, Any] = {
            "opId": oid, "action": "set", "obj": obj, "insert": True,
            "value": chr(int(row[K.K_PAYLOAD])),
        }
        if int(row[K.K_REF_CTR]) != 0 or int(row[K.K_REF_ACT]) != 0:
            op["elemId"] = op_id(K.K_REF_CTR, K.K_REF_ACT)
        return op
    if kind == K.KIND_DELETE:
        return {"opId": oid, "action": "del", "obj": obj, "elemId": op_id(K.K_REF_CTR, K.K_REF_ACT)}
    if kind == K.KIND_MARK:
        op = {
            "opId": oid,
            "action": "addMark" if int(row[K.K_MACTION]) == 0 else "removeMark",
            "obj": obj,
            "start": {"type": _BOUNDARY_NAME[int(row[K.K_SKIND])], "elemId": op_id(K.K_SCTR, K.K_SACT)},
            "markType": ALL_MARKS[int(row[K.K_MTYPE])],
        }
        if int(row[K.K_EKIND]) == 2:
            op["end"] = {"type": "endOfText"}
        else:
            op["end"] = {"type": _BOUNDARY_NAME[int(row[K.K_EKIND])], "elemId": op_id(K.K_ECTR, K.K_EACT)}
        attr = attrs.decode(int(row[K.K_MATTR]))
        if attr is not None:
            op["attrs"] = attr
        return op
    raise ValueError(f"cannot decode op row of kind {kind}")


def encode_changes(
    changes: Sequence[Dict[str, Any]],
    actors: ActorRegistry,
    attrs: AttrRegistry,
    text_obj: Optional[str] = None,
) -> Tuple[np.ndarray, List[Dict[str, Any]], Dict[str, int]]:
    """Flatten a causally-ordered change batch into device op rows.

    Returns (rows [N, OP_FIELDS], host_ops, counts) where host_ops is a list
    of ``(pos, op)`` pairs — structural/nested-object ops routed to the host
    object store, tagged with their flat position in the batch's op stream so
    the patch path can interleave host and device patches in true op order —
    and counts tallies device inserts and mark ops for capacity pre-checks
    (plus ``row_pos``, the flat positions of the device rows, and
    ``text_obj``, the device text-list binding after this batch).

    Ops route by target object, mirroring the reference's per-object dispatch
    (micromerge.ts:534-608): ops on the device text list become op rows;
    everything else — map ops, nested lists, second lists — goes host-side.
    The first root ``makeList`` with key "text" establishes the device
    binding; an op targeting an object the host store doesn't know raises
    there rather than being silently spliced into the text document.

    ``text_obj`` is the replica's established device text-list id (None
    before genesis).
    """
    rows: List[np.ndarray] = []
    row_pos: List[int] = []
    host_ops: List[Tuple[int, Dict[str, Any]]] = []
    counts: Dict[str, Any] = {"insert": 0, "mark": 0}
    pos = 0
    for change in changes:
        for op in change["ops"]:
            obj = op.get("obj")
            if obj != text_obj or text_obj is None:
                # Structural op (map makeList/makeMap/set/del), or a list op
                # on a host-side (non-device) list: the host store applies
                # it.  Route before encoding — host lists may hold values the
                # device char plane can't (and must not) encode.
                # The device binding is the first makeList with key "text"
                # on the ROOT map only (absent obj == ROOT on the wire); a
                # "text"-keyed list inside a nested map stays host-side.
                if (
                    op["action"] == "makeList"
                    and op.get("obj") is None
                    and op.get("key") == "text"
                    and text_obj is None
                ):
                    text_obj = op["opId"]
                host_ops.append((pos, op))
            else:
                row = encode_internal_op(op, actors, attrs)
                if row is None:
                    raise ValueError(
                        f"op {op.get('opId')!r} is a map op targeting the "
                        f"device text list {text_obj!r}"
                    )
                if row[K.K_KIND] == K.KIND_INSERT:
                    counts["insert"] += 1
                elif row[K.K_KIND] == K.KIND_MARK:
                    counts["mark"] += 1
                rows.append(row)
                row_pos.append(pos)
            pos += 1
    if rows:
        out = np.stack(rows)
    else:
        out = np.zeros((0, K.OP_FIELDS), np.int32)
    counts["row_pos"] = np.asarray(row_pos, np.int64)
    counts["text_obj"] = text_obj
    return out, host_ops, counts


def split_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split encoded op rows into (text ops, mark ops), each in causal order.

    Feeds the two-phase fast merge path (kernels.merge_step); see the
    state-equivalence argument there for why the split preserves semantics.
    """
    kinds = rows[:, K.K_KIND]
    is_mark = kinds == K.KIND_MARK
    return rows[~is_mark], rows[is_mark]


def fuse_insert_runs(
    rows: np.ndarray,
    max_run: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse chained insert rows into KIND_INSERT_RUN rows + a char buffer.

    A chain is consecutive rows where each insert references the previous
    row's op id with consecutive counters from the same actor — exactly what
    one insert input op expands to (micromerge.ts:351-361).  Chains apply as
    one scan step each (see kernels._apply_text_op's contiguity argument).
    Returns (fused rows, char buffer padded for in-bounds dynamic slices).

    ``max_run`` caps chain length; the default (kernels.MAX_RUN_LEN) is what
    the kernels' static char windows require.
    """
    if max_run is None:
        max_run = K.MAX_RUN_LEN
    if max_run <= 0:
        max_run = 1 << 30
    fused: List[np.ndarray] = []
    chars: List[int] = []
    i = 0
    n = rows.shape[0]
    while i < n:
        row = rows[i]
        if row[K.K_KIND] != K.KIND_INSERT:
            fused.append(row)
            i += 1
            continue
        j = i + 1
        while (
            j < n
            and j - i < max_run
            and rows[j][K.K_KIND] == K.KIND_INSERT
            and rows[j][K.K_ACT] == rows[j - 1][K.K_ACT]
            and rows[j][K.K_CTR] == rows[j - 1][K.K_CTR] + 1
            and rows[j][K.K_REF_CTR] == rows[j - 1][K.K_CTR]
            and rows[j][K.K_REF_ACT] == rows[j - 1][K.K_ACT]
        ):
            j += 1
        if j - i == 1:
            fused.append(row)
        else:
            run = np.zeros(K.OP_FIELDS, np.int32)
            run[K.K_KIND] = K.KIND_INSERT_RUN
            run[K.K_CTR] = row[K.K_CTR]
            run[K.K_ACT] = row[K.K_ACT]
            run[K.K_REF_CTR] = row[K.K_REF_CTR]
            run[K.K_REF_ACT] = row[K.K_REF_ACT]
            run[K.K_PAYLOAD] = len(chars)
            run[K.K_RUN_LEN] = j - i
            chars.extend(int(rows[p][K.K_PAYLOAD]) for p in range(i, j))
            fused.append(run)
        i = j
    out_rows = np.stack(fused) if fused else np.zeros((0, K.OP_FIELDS), np.int32)
    buf = np.zeros(len(chars) + K.MAX_RUN_LEN, np.int32)
    buf[: len(chars)] = chars
    return out_rows, buf


def compute_rounds(rows: np.ndarray) -> Tuple[np.ndarray, int]:
    """Reference-depth labels for sort-based batch placement.

    An op whose reference element pre-exists the batch gets round 0; an op
    referencing an element *created by an earlier row of this batch* gets
    that row's round + 1 (it must wait until its reference is placed).
    Returns (round_of [N] int32, num_rounds).  Causal order guarantees a
    reference row always precedes its dependents.
    """
    n = rows.shape[0]
    round_of = np.zeros(n, np.int32)
    if n == 0:
        return round_of, 1
    created: Dict[Tuple[int, int], int] = {}
    kinds = rows[:, K.K_KIND]
    for i in range(n):
        kind = kinds[i]
        if kind == K.KIND_PAD:
            continue
        ref = (int(rows[i, K.K_REF_ACT]), int(rows[i, K.K_REF_CTR]))
        j = created.get(ref)
        if j is not None:
            round_of[i] = round_of[j] + 1
        if kind == K.KIND_INSERT:
            created[(int(rows[i, K.K_ACT]), int(rows[i, K.K_CTR]))] = i
        elif kind == K.KIND_INSERT_RUN:
            act = int(rows[i, K.K_ACT])
            first = int(rows[i, K.K_CTR])
            for ctr in range(first, first + int(rows[i, K.K_RUN_LEN])):
                created[(act, ctr)] = i
    return round_of, int(round_of.max()) + 1


def _fuse_and_rounds(
    text_rows_list: Sequence[np.ndarray], max_run: int
) -> Tuple[list, list, list, int, int]:
    fused, bufs, round_labels = [], [], []
    num_rounds, maxk = 1, 1
    for rows in text_rows_list:
        fr, fb = fuse_insert_runs(rows, max_run=max_run)
        ro, nr = compute_rounds(fr)
        num_rounds = max(num_rounds, nr)
        runs = fr[:, K.K_KIND] == K.KIND_INSERT_RUN
        if runs.any():
            maxk = max(maxk, int(fr[runs, K.K_RUN_LEN].max()))
        fused.append(fr)
        bufs.append(fb)
        round_labels.append(ro)
    return fused, bufs, round_labels, num_rounds, maxk


def prepare_sorted_batch(
    text_rows_list: Sequence[np.ndarray],
    max_run: int = 0,
    fallback_max_rounds: Optional[int] = None,
) -> Dict[str, Any]:
    """Fuse insert runs (at most ``max_run`` long; 0 = unbounded), label
    reference-depth rounds, and pad/stack the per-stream row arrays — the
    JAX package's shared preparation, which its exact path calls with
    ``max_run=MAX_RUN_LEN``.  Returns ``text`` [G, L, F], ``rounds``
    [G, L], ``bufs`` [G, B], ``num_rounds``, ``maxk`` (bucketed run-length
    cap) and ``fell_back``.

    With ``fallback_max_rounds``, batches whose reference depth exceeds it
    are re-fused with the MAX_RUN_LEN window and flagged ``fell_back``.
    """
    fused, bufs, round_labels, num_rounds, maxk = _fuse_and_rounds(text_rows_list, max_run)
    fell_back = False
    if fallback_max_rounds is not None and num_rounds > fallback_max_rounds:
        fell_back = True
        fused, bufs, round_labels, num_rounds, maxk = _fuse_and_rounds(
            text_rows_list, K.MAX_RUN_LEN
        )
    text_pad = bucket_length(max(max(f.shape[0] for f in fused), 1))
    buf_pad = bucket_length(max(max(b.shape[0] for b in bufs), K.MAX_RUN_LEN))
    return {
        "text": np.stack([pad_rows(f, text_pad) for f in fused]),
        "rounds": np.stack(
            [np.pad(ro, (0, text_pad - ro.shape[0])) for ro in round_labels]
        ).astype(np.int32),
        "bufs": np.stack([pad_buffer(b, buf_pad) for b in bufs]),
        "num_rounds": num_rounds,
        "maxk": bucket_length(maxk, minimum=1),
        "fell_back": fell_back,
    }


def pad_buffer(buf: np.ndarray, length: int) -> np.ndarray:
    if buf.shape[0] > length:
        raise ValueError(f"char buffer of {buf.shape[0]} exceeds pad length {length}")
    out = np.zeros(length, np.int32)
    out[: buf.shape[0]] = buf
    return out


def pad_rows(rows: np.ndarray, length: int) -> np.ndarray:
    """Pad op rows with KIND_PAD to a fixed length."""
    if rows.shape[0] > length:
        raise ValueError(f"op batch of {rows.shape[0]} exceeds pad length {length}")
    out = np.zeros((length, K.OP_FIELDS), np.int32)
    out[: rows.shape[0]] = rows
    return out


def env_int(name: str, default: str, least: int) -> int:
    """An integer knob from the environment, with the JAX package's errors:
    not an integer, or below ``least``, raises ValueError naming it."""
    raw = os.environ.get(name, default)
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")
    if v < least:
        raise ValueError(f"{name} must be >= {least}, got {v}")
    return v


def bucket_length(n: int, minimum: int = 8) -> int:
    """Round up to a power of two so launch shapes stay few."""
    length = minimum
    while length < n:
        length *= 2
    return length
