"""The exact per-op merge as plain PyTorch, batched over replicas.

Counterpart of ``peritext_tpu/ops/kernels.py`` (the exact path: ``merge_step``
and the views ``flatten_sources`` / ``convergence_digest``).  Every function
here takes the replica axis explicitly ([R, ...] tensors) — the JAX
package's ``vmap`` written out — and loops over op rows in Python where the
JAX package runs ``lax.scan``.  These are the *plain versions* of the two
hand-written kernels in ``cuda_kernels.py``: the CPU path runs them, and
the kernels are held byte-for-byte against them on the card.

Integer state stays int32 and flags stay bool after every step (torch's
``arange``/``cumsum``/``sum`` default to int64, so each result is cast
back).  Boundary masks are int32 bitcasts of the JAX package's uint32 words:
bitwise operations are bit-identical either way, and torch lacks uint32
shifts on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from peritext_tpu_torch.ops.state import MASK_WORD_BITS, DocState, map_state

# Op-row field indices — byte-for-byte the JAX package's layout, so one
# encoded numpy tensor feeds both engines (see encode.py).
K_KIND = 0  # 0 pad, 1 insert, 2 delete, 3 mark
K_CTR = 1
K_ACT = 2
K_REF_CTR = 3  # insert: reference elem (0 = HEAD); delete: target elem
K_REF_ACT = 4
K_PAYLOAD = 5  # insert: codepoint
K_MACTION = 6  # 0 addMark, 1 removeMark
K_MTYPE = 7
K_MATTR = 8
K_SKIND = 9  # start boundary: 0 before, 1 after
K_SCTR = 10
K_SACT = 11
K_EKIND = 12  # end boundary: 0 before, 1 after, 2 endOfText
K_ECTR = 13
K_EACT = 14
OP_FIELDS = 15

KIND_PAD = 0
KIND_INSERT = 1
KIND_DELETE = 2
KIND_MARK = 3
# A fused run of chained inserts (encode.fuse_insert_runs).  Fields: K_CTR =
# first op counter, K_REF_* = the run's reference element, K_PAYLOAD =
# offset into the side char buffer, K_RUN_LEN = run length.
KIND_INSERT_RUN = 4
K_RUN_LEN = K_MACTION  # field reuse; insert runs carry no mark fields
MAX_RUN_LEN = 64

_U32 = 0xFFFFFFFF


def _first_match(match: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row, 0 when the row has none — the
    JAX package's ``argmax`` over a bool vector, made explicit (torch's
    argmax on bool differs by version and device)."""
    c = match.shape[-1]
    ar = torch.arange(c, dtype=torch.int32, device=match.device)
    first = torch.where(match, ar, c).amin(dim=-1)
    return torch.where(first == c, 0, first).to(torch.int32)


def _gather_clamped(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with JAX's clamping of out-of-range gather indices."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _roll_rows(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Right-roll each row of ``x`` [R, C] by its own amount ``k`` [R]."""
    c = x.shape[1]
    ar = torch.arange(c, device=x.device)
    src = (ar[None, :] - k.long()[:, None]) % c
    return torch.gather(x, 1, src)


def _rga_insert_position(
    elem_ctr: torch.Tensor,  # [R, C] int32
    elem_act: torch.Tensor,
    length: torch.Tensor,  # [R] int32
    op: torch.Tensor,  # [R, OP_FIELDS] int32
    ranks: torch.Tensor,
) -> torch.Tensor:
    """RGA insert position per replica (``kernels._rga_insert_position``,
    reference micromerge.ts:614-635): after the reference element (HEAD
    when the reference is 0@0), past the contiguous run of elements whose
    (ctr, actor rank) exceeds the op's.  Returns t [R] int32; t == C means
    the element falls off the end.  An absent reference counts as element 0
    (the ``argmax``-over-all-False rule)."""
    r, c = elem_ctr.shape
    ar = torch.arange(c, dtype=torch.int32, device=elem_ctr.device)[None, :]
    live = ar < length[:, None]
    is_head = (op[:, K_REF_CTR] == 0) & (op[:, K_REF_ACT] == 0)
    match = live & (elem_ctr == op[:, K_REF_CTR, None]) & (elem_act == op[:, K_REF_ACT, None])
    idx = torch.where(is_head, -1, _first_match(match))
    ctr = op[:, K_CTR, None]
    op_rank = _gather_clamped(ranks, op[:, K_ACT])[:, None]
    elem_rank = _gather_clamped(ranks, elem_act.reshape(-1)).reshape(r, c)
    gt = (elem_ctr > ctr) | ((elem_ctr == ctr) & (elem_rank > op_rank))
    stop = (ar > idx[:, None]) & ~(live & gt)
    return torch.where(stop, ar, c).amin(dim=1).to(torch.int32)


def text_phase_plain(
    elem_ctr: torch.Tensor,  # [R, C] int32
    elem_act: torch.Tensor,  # [R, C] int32
    deleted: torch.Tensor,  # [R, C] bool
    chars: torch.Tensor,  # [R, C] int32
    length: torch.Tensor,  # [R] int32
    text_ops: torch.Tensor,  # [R, L, OP_FIELDS] int32
    ranks: torch.Tensor,  # [A] int32
    char_buf: Optional[torch.Tensor] = None,  # [R, BUF] int32
) -> Tuple[torch.Tensor, ...]:
    """Inserts and deletes in op order (``kernels._apply_text_op`` looped
    over op rows).  Returns ``(elem_ctr, elem_act, deleted, chars,
    orig_idx, length)``; ``orig_idx`` tags each element with its pre-batch
    position (-1 for elements this batch inserted).

    Without ``char_buf``, KIND_INSERT_RUN rows are no-ops, as in the JAX
    package's unfused ``merge_step``.  An insert whose reference element is
    absent goes after element 0 (the ``argmax``-over-all-False rule)."""
    r, c = elem_ctr.shape
    dev = elem_ctr.device
    ar = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    ec, ea, dl, ch = elem_ctr, elem_act, deleted, chars
    oi = ar.expand(r, c).clone()
    ln = length.clone()
    for l in range(text_ops.shape[1]):
        op = text_ops[:, l, :]
        kind = op[:, K_KIND]
        live = ar < ln[:, None]
        is_ins = kind == KIND_INSERT
        is_run = (kind == KIND_INSERT_RUN) if char_buf is not None else torch.zeros_like(is_ins)
        is_del = kind == KIND_DELETE
        any_ins = is_ins | is_run
        ref_ctr, ref_act = op[:, K_REF_CTR, None], op[:, K_REF_ACT, None]

        match = live & (ec == ref_ctr) & (ea == ref_act)
        dl = dl | (match & is_del[:, None])
        if not bool(any_ins.any()):
            continue

        ctr = op[:, K_CTR, None]
        t = _rga_insert_position(ec, ea, ln, op, ranks)[:, None]
        k = torch.where(is_run, op[:, K_RUN_LEN], 1).to(torch.int32)
        keep = ar < t
        block = (ar >= t) & (ar < t + k[:, None])
        offset = ar - t

        if char_buf is not None:
            # dynamic_slice_in_dim(char_buf, payload, MAX_RUN_LEN) clamps its
            # start into the buffer; the offset clips into the window.
            buf_len = char_buf.shape[1]
            start = (op[:, K_PAYLOAD] * is_run).clamp(0, buf_len - MAX_RUN_LEN)
            col = start[:, None] + offset.clamp(0, MAX_RUN_LEN - 1)
            run_chars = torch.gather(char_buf, 1, col.long())
            char_vals = torch.where(is_run[:, None], run_chars, op[:, K_PAYLOAD, None])
        else:
            char_vals = op[:, K_PAYLOAD, None].expand(r, c)

        sel = any_ins[:, None]

        def splice(x, v):
            out = torch.where(keep, x, torch.where(block, v, _roll_rows(x, k)))
            return torch.where(sel, out, x).to(x.dtype)

        ec = splice(ec, ctr + offset)
        ea = splice(ea, op[:, K_ACT, None].expand(r, c))
        dl = splice(dl, torch.zeros_like(dl))
        ch = splice(ch, char_vals)
        oi = splice(oi, torch.full_like(oi, -1))
        ln = (ln + torch.where(any_ins, k, 0)).to(torch.int32)
    return ec, ea, dl, ch, oi, ln


def _slot_permutation(orig_idx: torch.Tensor):
    """Flat slot-axis form of a text phase's element permutation: ``(valid
    [R, 2C], flat_src [R, 2C])`` mapping each post-splice boundary slot to
    its pre-splice slot (``kernels._slot_permutation``)."""
    c = orig_idx.shape[-1]
    slots = torch.arange(2 * c, device=orig_idx.device)
    elem = orig_idx[:, slots // 2]
    valid = elem >= 0
    flat_src = 2 * elem.clamp(min=0).long() + (slots % 2)[None, :]
    return valid, flat_src


def _permute_boundaries(bnd_def, bnd_mask, orig_idx):
    """Re-align boundary tables after a text phase, in one gather.  Moves
    the whole [R, 2C, W] mask plane."""
    valid, flat_src = _slot_permutation(orig_idx)
    new_def = torch.gather(bnd_def, 1, flat_src) & valid
    rows = torch.arange(bnd_mask.shape[0], device=bnd_mask.device)[:, None]
    new_mask = torch.where(valid[:, :, None], bnd_mask[rows, flat_src], 0)
    return new_def, new_mask.to(torch.int32)


def _mask_bit(m: torch.Tensor) -> torch.Tensor:
    """``1 << (m % 32)`` as an int32 bitcast of the uint32 word."""
    b = torch.ones_like(m, dtype=torch.int64) << (m.long() % MASK_WORD_BITS)
    return (b - ((b >> 31) << 32)).to(torch.int32)


def mark_phase_plain(
    bnd_def: torch.Tensor,  # [R, 2C] bool
    bnd_mask: torch.Tensor,  # [R, 2C, W] int32 (uint32 bitcast)
    elem_ctr: torch.Tensor,  # [R, C] int32
    elem_act: torch.Tensor,
    length: torch.Tensor,  # [R] int32
    mark_count: torch.Tensor,  # [R] int32
    mark_ops: torch.Tensor,  # [R, Lm, OP_FIELDS] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boundary-set mark application in op order (``kernels.
    _apply_mark_fast`` looped over mark rows).  Returns the updated
    ``(bnd_def, bnd_mask)``; the mark table is ``append_mark_table``'s.

    Per op only three kinds of slot change: defined slots inside [s, e) OR
    in the op's bit, slot s takes (nearest defined row at or left of s) |
    bit, and slot e takes its carry row unless it is endOfText.  Both
    carry rows are read before any write.  An op whose table index m is
    past the table (m >= M) sets no bit, as the JAX scatter drops it, but
    still writes its anchor slots."""
    r, two_c, w = bnd_mask.shape
    c = two_c // 2
    dev = bnd_mask.device
    big = 2 * c + 2
    rows = torch.arange(r, device=dev)
    slots = torch.arange(two_c, dtype=torch.int32, device=dev)[None, :]
    word_idx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    live = torch.arange(c, device=dev)[None, :] < length[:, None]
    defined_zone = slots < 2 * length[:, None]
    bdef = bnd_def.clone()
    mask = bnd_mask.clone()  # updated in place below: one copy per call
    m = mark_count.clone()
    for l in range(mark_ops.shape[1]):
        op = mark_ops[:, l, :]
        is_mark = op[:, K_KIND] == KIND_MARK
        if not bool(is_mark.any()):
            continue
        s_match = live & (elem_ctr == op[:, K_SCTR, None]) & (elem_act == op[:, K_SACT, None])
        e_match = live & (elem_ctr == op[:, K_ECTR, None]) & (elem_act == op[:, K_EACT, None])
        s_slot = 2 * _first_match(s_match) + op[:, K_SKIND]
        e_slot = torch.where(
            op[:, K_EKIND] == 2,
            big,
            2 * _first_match(e_match) + op[:, K_EKIND].clamp(max=1),
        )
        e_slot = torch.where(e_slot == s_slot, big, e_slot)
        defined = bdef & defined_zone

        def carry_row(p):
            src = torch.where(defined & (slots <= p[:, None]), slots, -1).amax(dim=1)
            row = mask[rows, src.clamp(min=0).long()]
            return torch.where((src >= 0)[:, None], row, 0)

        bit = _mask_bit(m)
        word = (m // MASK_WORD_BITS).long()
        op_bit_row = torch.where(word_idx == word[:, None], bit[:, None], 0)
        s_lt_e = s_slot < e_slot
        write_s = is_mark & s_lt_e
        e_clamped = e_slot.clamp(max=two_c - 1)
        write_e = is_mark & (e_slot < two_c)
        row_s = carry_row(s_slot) | op_bit_row
        row_e = carry_row(e_clamped)

        # Defined slots inside [s, e) OR in the bit: one word column.
        in_range = (slots >= s_slot[:, None]) & (slots < e_slot[:, None]) & write_s[:, None]
        col_sel = (in_range & defined & (word < w)[:, None])
        wc = word.clamp(max=w - 1)[:, None, None].expand(r, two_c, 1)
        col = torch.gather(mask, 2, wc)[:, :, 0]
        col = torch.where(col_sel, col | bit[:, None], col)
        mask.scatter_(2, wc, col[:, :, None])

        sr = rows[write_s]
        mask[sr, s_slot[write_s].long()] = row_s[write_s]
        bdef[sr, s_slot[write_s].long()] = True
        er = rows[write_e]
        mask[er, e_clamped[write_e].long()] = row_e[write_e]
        bdef[er, e_clamped[write_e].long()] = True
        m = (m + is_mark).to(torch.int32)
    return bdef, mask


_TABLE_FIELDS = (
    ("mark_ctr", K_CTR),
    ("mark_act", K_ACT),
    ("mark_action", K_MACTION),
    ("mark_type", K_MTYPE),
    ("mark_attr", K_MATTR),
)


def append_mark_table(states: DocState, mark_ops: torch.Tensor) -> DocState:
    """Append each replica's mark rows to its mark table: entry = mark_count
    + rank of the row among the batch's mark rows.  Rows past the table
    drop, as the JAX scatter's out-of-bounds writes do: they (and the
    batch's other rows) scatter into one spare column past the table,
    which is cut off, so the append never waits on the host."""
    m = states.max_mark_ops
    is_mark = mark_ops[:, :, K_KIND] == KIND_MARK  # [R, L]
    order = torch.cumsum(is_mark.to(torch.int32), dim=1) - 1
    idx = states.mark_count[:, None] + order
    cols = torch.where(is_mark & (idx < m), idx, m).long()
    spare = torch.zeros_like(states.mark_ctr[:, :1])
    updates = {}
    for name, field in _TABLE_FIELDS:
        col = torch.cat([getattr(states, name), spare], dim=1)
        col.scatter_(1, cols, mark_ops[:, :, field])
        updates[name] = col[:, :m].contiguous()
    updates["mark_count"] = (states.mark_count + is_mark.sum(dim=1)).to(torch.int32)
    return dataclasses.replace(states, **updates)


def merge_step_plain(
    states: DocState,
    text_ops: torch.Tensor,
    mark_ops: torch.Tensor,
    ranks: torch.Tensor,
    char_buf: Optional[torch.Tensor] = None,
) -> DocState:
    """Exact batched merge: text phase -> boundary permute -> mark phase ->
    mark-table append (``kernels.merge_step`` vmapped over replicas)."""
    ec, ea, dl, ch, oi, ln = text_phase_plain(
        states.elem_ctr, states.elem_act, states.deleted, states.chars,
        states.length, text_ops, ranks, char_buf,
    )
    bnd_def, bnd_mask = _permute_boundaries(states.bnd_def, states.bnd_mask, oi)
    bnd_def, bnd_mask = mark_phase_plain(
        bnd_def, bnd_mask, ec, ea, ln, states.mark_count, mark_ops
    )
    out = dataclasses.replace(
        states, elem_ctr=ec, elem_act=ea, deleted=dl, chars=ch, length=ln,
        bnd_def=bnd_def, bnd_mask=bnd_mask,
    )
    return append_mark_table(out, mark_ops)


# ---------------------------------------------------------------------------
# The exact per-op path with patch records (kernels.apply_op /
# apply_ops_patched).  No TPU kernel lies on it: the JAX package runs it as
# an XLA ``lax.scan``, and here it is plain torch on whatever device the
# states are on.  It never calls the two kernels' plain versions.
# ---------------------------------------------------------------------------

_NEG = -(2**31) + 1
# Elements of the [R, D, M'] winner temporaries held at once.
_WINNER_CHUNK_ELEMS = 1 << 24


def _find_elem(elem_ctr, elem_act, length, ctr, act):
    """Position of the element created by op (ctr@act) per replica and
    whether it is live (``kernels._find_elem``); position 0 when absent."""
    ar = torch.arange(elem_ctr.shape[1], device=elem_ctr.device)[None, :]
    match = (ar < length[:, None]) & (elem_ctr == ctr[:, None]) & (elem_act == act[:, None])
    return _first_match(match), match.any(dim=1)


@dataclasses.dataclass
class _Walk:
    """The working state of a per-op loop over [R, ...] replicas (the JAX
    scan's carry).  Element planes and ``bdef`` are positional and splice
    on every insert as in JAX.  The [R, 2C, W] mask plane does not move:
    ``phys`` maps each position to its element's row pair in ``mask``, a
    working copy with ``spare`` zero pairs appended for the elements this
    loop inserts, so an insert shifts [R, C] indices, not the plane.
    ``mask``, ``bdef`` and the table columns are private copies, updated in
    place; ``_finish_walk`` gathers the plane back into positional order."""

    ec: torch.Tensor
    ea: torch.Tensor
    dl: torch.Tensor
    ch: torch.Tensor
    bdef: torch.Tensor  # [R, 2C] bool
    phys: torch.Tensor  # [R, C] int64 row-pair index of each position
    mask: torch.Tensor  # [R, 2 * (C + spare), W] int32
    next_phys: torch.Tensor  # [R] int64
    length: torch.Tensor
    mark_count: torch.Tensor
    table: dict
    moved: bool = False


def _begin_walk(states: DocState, spare: int) -> _Walk:
    r, c = states.elem_ctr.shape
    dev = states.elem_ctr.device
    pad = states.bnd_mask.new_zeros(r, 2 * spare, states.bnd_mask.shape[-1])
    return _Walk(
        ec=states.elem_ctr, ea=states.elem_act, dl=states.deleted, ch=states.chars,
        bdef=states.bnd_def.clone(),
        phys=torch.arange(c, device=dev).expand(r, c).clone(),
        mask=torch.cat([states.bnd_mask, pad], dim=1),
        next_phys=torch.full((r,), c, dtype=torch.int64, device=dev),
        length=states.length, mark_count=states.mark_count,
        table={name: getattr(states, name).clone() for name, _ in _TABLE_FIELDS},
    )


def _finish_walk(w: _Walk) -> DocState:
    r, two_c = w.bdef.shape
    if w.moved:
        slots = torch.arange(two_c, device=w.bdef.device).expand(r, two_c)
        idx = _mask_rows(w, slots)[:, :, None].expand(r, two_c, w.mask.shape[-1])
        mask = torch.gather(w.mask, 1, idx)
    else:
        mask = w.mask[:, :two_c].contiguous()
    return DocState(
        elem_ctr=w.ec, elem_act=w.ea, deleted=w.dl, chars=w.ch,
        bnd_def=w.bdef, bnd_mask=mask, length=w.length, mark_count=w.mark_count,
        **w.table,
    )


def _mask_rows(w: _Walk, slots: torch.Tensor) -> torch.Tensor:
    """Rows of ``w.mask`` holding the boundary slots ``slots`` [R, K]."""
    slots = slots.long()
    return 2 * torch.gather(w.phys, 1, slots // 2) + slots % 2


def _defined(w: _Walk) -> torch.Tensor:
    two_c = w.bdef.shape[1]
    slots = torch.arange(two_c, dtype=torch.int32, device=w.bdef.device)[None, :]
    return w.bdef & (slots < 2 * w.length[:, None])


def _carry_rows(w: _Walk, defined: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The nearest defined set at or left of slot ``p`` [R] per replica (the
    mark walk's carried ``currentOps``), zero where there is none."""
    r, two_c = defined.shape
    slots = torch.arange(two_c, dtype=torch.int32, device=defined.device)[None, :]
    src = torch.where(defined & (slots <= p[:, None]), slots, -1).amax(dim=1)
    rows = torch.arange(r, device=defined.device)
    row = w.mask[rows, _mask_rows(w, src.clamp(min=0)[:, None])[:, 0]]
    return torch.where((src >= 0)[:, None], row, 0)


def _splice(x, keep, here, value, sel):
    """Insert ``value`` at each row's position (``keep`` before it, ``here``
    at it), shifting the rest right by one, in the rows ``sel`` [R, 1]."""
    out = torch.where(keep, x, torch.where(here, value, torch.roll(x, 1, dims=1)))
    return torch.where(sel, out, x).to(x.dtype)


def _apply_insert(w: _Walk, op: torch.Tensor, t: torch.Tensor, sel: torch.Tensor) -> None:
    """RGA insert at position t (``kernels._apply_insert``, reference
    micromerge.ts:614-672) in the replicas ``sel``.  The two new boundary
    slots are undefined; the mask plane is not moved."""
    c = w.ec.shape[1]
    dev = w.ec.device
    ar = torch.arange(c, device=dev)[None, :]
    keep = ar < t[:, None]
    here = ar == t[:, None]
    s = sel[:, None]
    w.ec = _splice(w.ec, keep, here, op[:, K_CTR, None], s)
    w.ea = _splice(w.ea, keep, here, op[:, K_ACT, None], s)
    w.dl = _splice(w.dl, keep, here, False, s)
    w.ch = _splice(w.ch, keep, here, op[:, K_PAYLOAD, None], s)
    w.phys = _splice(w.phys, keep, here, w.next_phys[:, None], s)
    slots = torch.arange(2 * c, device=dev)[None, :]
    moved = s & (slots >= 2 * t[:, None])
    w.bdef = torch.where(
        moved, (slots // 2 != t[:, None]) & torch.roll(w.bdef, 2, dims=1), w.bdef
    )
    w.next_phys = w.next_phys + sel
    w.length = (w.length + sel).to(torch.int32)
    w.moved = True


def _apply_delete(w: _Walk, op: torch.Tensor, sel: torch.Tensor) -> None:
    """Tombstone every live element matching the target (``kernels.
    _apply_delete``; re-deleting is a no-op, micromerge.ts:689)."""
    ar = torch.arange(w.ec.shape[1], device=w.ec.device)[None, :]
    match = (ar < w.length[:, None]) & (w.ec == op[:, K_REF_CTR, None]) & (w.ea == op[:, K_REF_ACT, None])
    w.dl = w.dl | (match & sel[:, None])


def _mark_slot_context(w: _Walk, op: torch.Tensor):
    """``(s_slot, e_slot, defined)`` of a mark op (``kernels.
    _mark_slot_context``): anchors resolve to their first live match (slot 0
    when absent); endOfText, and an end on the start's slot, become the
    sentinel 2C + 2 (the walk's start branch fires first, peritext.ts:236-241)."""
    c = w.ec.shape[1]
    ar = torch.arange(c, device=w.ec.device)[None, :]
    live = ar < w.length[:, None]
    s_match = live & (w.ec == op[:, K_SCTR, None]) & (w.ea == op[:, K_SACT, None])
    e_match = live & (w.ec == op[:, K_ECTR, None]) & (w.ea == op[:, K_EACT, None])
    s_slot = 2 * _first_match(s_match) + op[:, K_SKIND]
    e_slot = torch.where(
        op[:, K_EKIND] == 2, 2 * c + 2, 2 * _first_match(e_match) + op[:, K_EKIND].clamp(max=1)
    )
    e_slot = torch.where(e_slot == s_slot, 2 * c + 2, e_slot).to(torch.int32)
    return s_slot.to(torch.int32), e_slot, _defined(w)


def _apply_mark(w: _Walk, op: torch.Tensor, ctx, sel: torch.Tensor) -> None:
    """Write a mark op into the boundary sets (``kernels._apply_mark_ctx``,
    reference peritext.ts:154-223) in the replicas ``sel``: defined slots
    inside [s, e) OR in the op's bit, slot s takes its pre-op carry | bit,
    slot e its pre-op carry (unless endOfText), and the op fills table entry
    mark_count.  A bit or entry past the table drops, as JAX's scatter does."""
    s_slot, e_slot, defined = ctx
    r, two_c = defined.shape
    words = w.mask.shape[-1]
    dev = defined.device
    rows = torch.arange(r, device=dev)
    m = w.mark_count
    bit = _mask_bit(m)
    word = (m // MASK_WORD_BITS).long()
    op_bit_row = torch.where(
        torch.arange(words, device=dev)[None, :] == word[:, None], bit[:, None], 0
    )
    write_s = sel & (s_slot < e_slot) & (s_slot < two_c)
    e_cl = e_slot.clamp(max=two_c - 1)
    write_e = sel & (e_slot < two_c)
    row_s = _carry_rows(w, defined, s_slot) | op_bit_row
    row_e = _carry_rows(w, defined, e_cl)

    slots = torch.arange(two_c, device=dev)[None, :]
    col_sel = (
        (slots >= s_slot[:, None]) & (slots < e_slot[:, None]) & write_s[:, None]
        & defined & (word < words)[:, None]
    )
    flat = w.mask.view(-1)
    idx = ((rows[:, None] * w.mask.shape[1] + _mask_rows(w, slots.expand(r, two_c))) * words
           + word.clamp(max=words - 1)[:, None])
    col = flat[idx]
    flat[idx] = torch.where(col_sel, col | bit[:, None], col)

    for slot, write, row in ((s_slot.clamp(max=two_c - 1), write_s, row_s), (e_cl, write_e, row_e)):
        p = _mask_rows(w, slot[:, None])[:, 0]
        w.mask[rows, p] = torch.where(write[:, None], row, w.mask[rows, p])
        w.bdef[rows, slot.long()] = w.bdef[rows, slot.long()] | write

    m_cap = w.table["mark_ctr"].shape[1]
    ok = sel & (m < m_cap)
    mc = m.clamp(max=m_cap - 1).long()
    for name, field in _TABLE_FIELDS:
        col = w.table[name]
        col[rows, mc] = torch.where(ok, op[:, field], col[rows, mc])
    w.mark_count = (m + sel).to(torch.int32)


def _op_kinds(ops: torch.Tensor) -> torch.Tensor:
    """Kinds as JAX's ``kernels.apply_op`` dispatches them: clipped to
    [0, 3], so a fused run row (kind 4) would apply as a mark, as in JAX;
    the per-op path takes unfused rows only."""
    return ops[..., K_KIND].clamp(0, 3)


def _apply_row(w: _Walk, op, kind, ranks, present, t=None, ctx=None) -> None:
    """One op row on every replica; ``present`` [4] (host bools) says which
    kinds occur in the row, so absent kinds cost nothing."""
    if present[KIND_INSERT]:
        if t is None:
            t = _rga_insert_position(w.ec, w.ea, w.length, op, ranks)
        _apply_insert(w, op, t, kind == KIND_INSERT)
    if present[KIND_DELETE]:
        _apply_delete(w, op, kind == KIND_DELETE)
    if present[KIND_MARK]:
        _apply_mark(w, op, ctx if ctx is not None else _mark_slot_context(w, op), kind == KIND_MARK)


def _rows_present(kinds_np: np.ndarray) -> np.ndarray:
    """[L, 4] bool: which kinds occur in each op row over all replicas."""
    return (kinds_np[:, :, None] == np.arange(4)[None, None, :]).any(axis=0)


def apply_ops(states: DocState, ops: torch.Tensor, ranks: torch.Tensor) -> DocState:
    """Apply causally ordered op rows [R, L, OP_FIELDS] in order
    (``kernels.apply_ops_batch``, a scan of ``kernels.apply_op``)."""
    kinds = _op_kinds(ops)
    kinds_np = kinds.cpu().numpy()
    present = _rows_present(kinds_np)
    w = _begin_walk(states, int((kinds_np == KIND_INSERT).sum(axis=1).max(initial=0)))
    for l in range(ops.shape[1]):
        _apply_row(w, ops[:, l], kinds[:, l], ranks, present[l])
    return _finish_walk(w)


def _walk_signals(ctx, visible: torch.Tensor):
    """written / during / visibleIndex planes of the reference mark walk
    (``kernels._walk_signals``, peritext.ts:181-214) and the visible length."""
    s_slot, e_slot, defined = ctx
    r, c = visible.shape
    slots = torch.arange(2 * c, dtype=torch.int32, device=visible.device)[None, :]
    s, e = s_slot[:, None], e_slot[:, None]
    during = (slots >= s) & (slots < e) & (s < e)
    written = (during & ((slots == s) | defined)) | (slots == e)
    vis, final_vis = _visible_index(visible)
    return written, during, vis, final_vis


def _visible_index(visible: torch.Tensor):
    """visibleIndex per boundary slot: the before-slot of element i sees the
    visible elements before i, its after-slot those through i."""
    v = visible.to(torch.int32)
    vcum = torch.cumsum(v, dim=1).to(torch.int32)
    vis = torch.stack([vcum - v, vcum], dim=2).reshape(v.shape[0], -1)
    final = vcum[:, -1] if v.shape[1] else torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
    return vis, final


def _changed_vs_winner(op, op_rank, w_ctr, w_rank, w_action, w_attr, has_winner):
    """``opsToMarks(current) != opsToMarks(new)`` restricted to the op's
    group (``kernels._changed_vs_winner``, peritext.ts:294-326): the op must
    win the LWW tie-break and flip the effective value."""
    ctr = op[:, K_CTR, None]
    op_wins = ~has_winner | (ctr > w_ctr) | ((ctr == w_ctr) & (op_rank[:, None] > w_rank))
    old_active = has_winner & (w_action == 0)
    new_active = (op[:, K_MACTION] == 0)[:, None]
    value_differs = (old_active != new_active) | (
        old_active & new_active & (w_attr != op[:, K_MATTR, None])
    )
    return op_wins & value_differs


def _first_k_set(mask: torch.Tensor, k: int):
    """Positions of the first ``k`` set entries of each row of ``mask``
    [R, N], ascending (``kernels._first_k_set``: one cumsum, then binary
    searches).  Returns ``(idx [R, k] int64 clamped into range, ok [R, k],
    total [R])``."""
    r, n = mask.shape
    cs = torch.cumsum(mask.to(torch.int32), dim=1).to(torch.int32)
    q = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device).expand(r, k).contiguous()
    idx = torch.searchsorted(cs, q)
    return idx.clamp(max=n - 1), q <= cs[:, -1:], cs[:, -1]


def _group_winners(w: _Walk, op, defined, ranks, multi, cand: int, mp: int):
    """Per boundary slot, the pre-op winner of the op's resolution group
    among the slot's inherited set (``kernels._mark_patch_signals``): returns
    ``(w_ctr, w_rank, w_action, w_attr, has_winner)`` [R, 2C].

    JAX expands the carried set of every slot into [2C, M] presence bits.
    Here the winner is found once per defined slot, since every slot
    inherits the set of the nearest defined slot at or left of it: defined
    slots number at most ``cand`` (a bound the caller takes from this
    batch), and only the table's first ``mp`` columns are live."""
    r, two_c = defined.shape
    dev = defined.device
    out = []
    step = max(1, _WINNER_CHUNK_ELEMS // max(cand * mp, 1))
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        n = defined[sl].shape[0]
        pos, ok, _ = _first_k_set(defined[sl], cand)
        sub_rows = torch.arange(lo, lo + n, device=dev)[:, None]
        phys = 2 * torch.gather(w.phys[sl], 1, pos // 2) + pos % 2
        words = w.mask[sub_rows, phys, : mp // MASK_WORD_BITS]  # [n, cand, W']
        present = expand_mask_bits(words, mp) & ok[:, :, None]
        mtype = w.table["mark_type"][sl, :mp]
        attr = w.table["mark_attr"][sl, :mp]
        ctr = w.table["mark_ctr"][sl, :mp][:, None, :]
        action = w.table["mark_action"][sl, :mp][:, None, :]
        rank = _gather_clamped(ranks, w.table["mark_act"][sl, :mp].reshape(-1)).reshape(n, 1, mp)
        m_live = torch.arange(mp, device=dev)[None, :] < w.mark_count[sl, None]
        o = op[sl]
        is_multi = _gather_clamped(multi, o[:, K_MTYPE]).to(torch.bool)[:, None]
        group = m_live & (mtype == o[:, K_MTYPE, None]) & (~is_multi | (attr == o[:, K_MATTR, None]))
        cand_m = present & group[:, None, :]
        max_ctr = torch.where(cand_m, ctr, _NEG).amax(dim=2)
        tie = cand_m & (ctr == max_ctr[:, :, None])
        max_rank = torch.where(tie, rank, _NEG).amax(dim=2)
        win = tie & (rank == max_rank[:, :, None])
        has = cand_m.any(dim=2)
        out.append((
            torch.where(has, max_ctr, -1),
            torch.where(has, max_rank, -1),
            torch.where(win, action, 0).sum(dim=2),
            torch.where(win, attr[:, None, :], 0).sum(dim=2),
            has,
        ))
    per_def = [torch.cat(parts) for parts in zip(*out)]
    # Slot p inherits from the (cs[p] - 1)-th defined slot; none when cs[p] == 0.
    cs = torch.cumsum(defined.to(torch.int32), dim=1)
    src = (cs - 1).clamp(min=0, max=cand - 1).long()
    has_src = cs > 0
    fills = (-1, -1, 0, 0, False)
    return tuple(
        torch.where(has_src, torch.gather(x, 1, src), fill) for x, fill in zip(per_def, fills)
    )


def compact_mark_records(written, during, changed, vis, obj_len, span_cap: int,
                         cand_def: Optional[torch.Tensor] = None, cand_cap: int = 0):
    """Run tables of mark patches (``kernels.compact_mark_records``) from
    [R, M, D] planes, one row per mark op, ``obj_len`` [R, M].  A patch
    opens at every written DURING slot whose effective marks change and
    ends at the next written slot's visibleIndex (or ``obj_len``); the
    finishPartialPatch filters (peritext.ts:269-281) leave a lane at (0, 0).

    Without ``cand_def`` each row's whole slot axis is searched (the per-op
    loop's records sit on per-instant slot axes).  With it ([R, D], the
    post-merge definedness; the sorted route's rows share that axis) only
    the replica's first ``cand_cap`` defined slots are candidates, since
    every written slot is defined.  Returns ``(run_start, run_end)``
    [R, M, span_cap] and ``count`` [R, M] int32, the true open-slot count
    (``span_cap + 1`` when the candidate axis itself overflowed), so the
    caller can tell when the cap cut a row."""
    r, m, two_c = written.shape
    dev = written.device
    if cand_def is None:
        d = two_c
        w_c, vis_c = written, vis
        open_c = written & during & changed
    else:
        d = min(cand_cap, two_c)
        cand_idx, cand_ok, cand_total = _first_k_set(cand_def, d)
        gi = cand_idx[:, None, :].expand(r, m, d)
        w_c = torch.gather(written, 2, gi) & cand_ok[:, None, :]
        open_c = w_c & torch.gather(during, 2, gi) & torch.gather(changed, 2, gi)
        vis_c = torch.gather(vis, 2, gi)
    k = min(span_cap, d)
    cs_open = torch.cumsum(open_c.to(torch.int64), dim=2)
    q = torch.arange(1, k + 1, device=dev).expand(r, m, k).contiguous()
    sel = torch.searchsorted(cs_open, q)
    lane_ok = q <= cs_open[..., -1:]
    sel_c = sel.clamp(max=d - 1)
    start = torch.gather(vis_c, 2, sel_c)
    cs_w = torch.cumsum(w_c.to(torch.int64), dim=2)
    nxt = torch.searchsorted(cs_w, (torch.gather(cs_w, 2, sel_c) + 1).contiguous())
    ol = obj_len[:, :, None]
    end_raw = torch.where(nxt < d, torch.gather(vis_c, 2, nxt.clamp(max=d - 1)), ol)
    ok = lane_ok & (end_raw > start) & (start < ol)
    run_start = torch.where(ok, start, 0).to(torch.int32)
    run_end = torch.where(ok, torch.minimum(end_raw, ol), 0).to(torch.int32)
    count = cs_open[..., -1]
    if cand_def is not None:
        count = torch.where(cand_total[:, None] > d, span_cap + 1, count)
    if span_cap > k:
        pad = torch.zeros((r, m, span_cap - k), dtype=torch.int32, device=dev)
        run_start = torch.cat([run_start, pad], dim=2)
        run_end = torch.cat([run_end, pad], dim=2)
    return run_start, run_end, count.to(torch.int32)


_COMPACT_FIELDS = ("index", "valid", "ins_mask", "mstart", "mend", "mcount")
_PLANE_FIELDS = ("written", "during", "changed", "vis")


def apply_ops_patched(
    states: DocState,
    ops: torch.Tensor,  # [R, L, OP_FIELDS] int32, unfused rows
    ranks: torch.Tensor,
    multi: torch.Tensor,
    readback: str = "planes",
    span_cap: int = 8,
):
    """Apply op rows in order and emit one patch record per row
    (``kernels.apply_ops_patched_batch``, the faithful incremental path).
    Returns ``(new_states, records)``.

    With ``readback="compact"`` the records are ``index``, ``valid``,
    ``ins_mask`` [R, L] / [R, L, W] and the mark run tables ``mstart`` /
    ``mend`` [R, L, span_cap] with ``mcount`` [R, L], built row by row
    inside the loop (JAX compacts after its scan; the rows are independent,
    so the tables are the same), on the states' device.  With ``"planes"``
    they are JAX's full record: ``kind``, ``index``, ``valid``, ``char``,
    ``obj_len``, ``ins_mask`` and the [R, L, 2C] planes ``written``,
    ``during``, ``changed`` and ``vis``, which are copied to host memory row
    by row as the loop goes, so [R, L, 2C] never lives on the device.

    Mark signals are computed only on rows where some replica has a mark,
    over the table's live columns only (M' = the batch's largest mark count,
    rounded up to 32).  Consecutive equal all-pad rows share one record."""
    if readback not in ("compact", "planes"):
        raise ValueError(f"readback must be 'compact' or 'planes', got {readback!r}")
    r, n_ops, _ = ops.shape
    c = states.capacity
    dev = ops.device
    words = states.bnd_mask.shape[-1]
    kinds = _op_kinds(ops)
    ops_np = ops.cpu().numpy()
    kinds_np = np.clip(ops_np[:, :, K_KIND], 0, 3)
    present = _rows_present(kinds_np)
    n_marks = int((kinds_np == KIND_MARK).sum(axis=1).max(initial=0))
    # Defined slots never outnumber the set bnd_def flags, and every mark
    # op sets at most its two anchor slots: a bound on the winner rows.
    head = torch.stack([states.bnd_def.sum(dim=1).max(), states.mark_count.max().long()])
    max_flags, max_count = (int(x) for x in head.cpu()) if r else (0, 0)
    cand = max(1, min(2 * c, max_flags + 2 * n_marks))
    mp = min(states.max_mark_ops, max(MASK_WORD_BITS, -(-(max_count + n_marks) // MASK_WORD_BITS) * MASK_WORD_BITS))

    def zeros(*shape, dtype=torch.int32, device=dev):
        return torch.zeros((r, n_ops) + shape, dtype=dtype, device=device)

    rec = {"index": zeros(), "valid": zeros(dtype=torch.bool), "ins_mask": zeros(words)}
    if readback == "compact":
        rec.update(mstart=zeros(span_cap), mend=zeros(span_cap), mcount=zeros())
    else:
        rec.update(kind=kinds.to(torch.int32), char=ops[:, :, K_PAYLOAD].clone(), obj_len=zeros())
        rec.update({f: zeros(2 * c, dtype=torch.bool, device="cpu") for f in _PLANE_FIELDS[:3]})
        rec["vis"] = zeros(2 * c, device="cpu")

    w = _begin_walk(states, int((kinds_np == KIND_INSERT).sum(axis=1).max(initial=0)))
    ar = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    rows = torch.arange(r, device=dev)
    for l in range(n_ops):
        if (l and not present[l, 1:].any() and not present[l - 1, 1:].any()
                and (ops_np[:, l] == ops_np[:, l - 1]).all()):
            for v in rec.values():  # pad rows change nothing: same record
                v[:, l] = v[:, l - 1]
            continue
        op = ops[:, l]
        kind = kinds[:, l]
        is_ins, is_del, is_mark = (kind == KIND_INSERT), (kind == KIND_DELETE), (kind == KIND_MARK)
        visible = (ar < w.length[:, None]) & ~w.dl
        defined = _defined(w)

        # Insert: visible position, and the marks it inherits from the
        # nearest defined boundary left of its gap (peritext.ts:328-330).
        t = _rga_insert_position(w.ec, w.ea, w.length, op, ranks)
        ins_index = (visible & (ar < t[:, None])).sum(dim=1)
        rec["ins_mask"][:, l] = _carry_rows(w, defined, 2 * t - 1)
        # Delete: visible position of the target; valid if not tombstoned.
        d_idx, d_found = _find_elem(w.ec, w.ea, w.length, op[:, K_REF_CTR], op[:, K_REF_ACT])
        del_valid = d_found & ~w.dl[rows, d_idx.long()]
        del_index = (visible & (ar < d_idx[:, None])).sum(dim=1)
        rec["index"][:, l] = torch.where(is_ins, ins_index, del_index)
        rec["valid"][:, l] = is_ins | (is_del & del_valid) | is_mark

        ctx = None
        if present[l, KIND_MARK] or readback == "planes":
            ctx = _mark_slot_context(w, op)
            written, during, vis, final_vis = _walk_signals(ctx, visible)
            if present[l, KIND_MARK]:
                wins = _group_winners(w, op, defined, ranks, multi, cand, mp)
                changed = _changed_vs_winner(op, _gather_clamped(ranks, op[:, K_ACT]), *wins)
                m = is_mark[:, None]
                written, during, changed = written & m, during & m, changed & m
            if readback == "compact":
                ms, me, mc = compact_mark_records(
                    written[:, None], during[:, None], changed[:, None], vis[:, None],
                    final_vis[:, None], span_cap,
                )
                rec["mstart"][:, l], rec["mend"][:, l], rec["mcount"][:, l] = ms[:, 0], me[:, 0], mc[:, 0]
            else:
                rec["obj_len"][:, l] = final_vis
                rec["vis"][:, l] = vis.cpu()
                if present[l, KIND_MARK]:
                    for f, plane in zip(_PLANE_FIELDS, (written, during, changed)):
                        rec[f][:, l] = plane.cpu()
        _apply_row(w, op, kind, ranks, present[l], t=t, ctx=ctx)
    return _finish_walk(w), rec


# ---------------------------------------------------------------------------
# Views: cursors and anchors
# ---------------------------------------------------------------------------


def visible_elem_ids(states: DocState, index: torch.Tensor, peek: bool = False):
    """Element ids of the ``index``-th visible elements (``kernels.
    visible_elem_id``, reference getListElementId, micromerge.ts:762-805):
    ``index`` is [R, K], one row of indices per replica.  Returns ``(ctr,
    act, found)`` [R, K]; an absent index reads element 0, as JAX's
    ``argmax`` over all-False does.

    With ``peek``, the anchor moves past the run of tombstones right after
    the target to the last of them that carries an after-boundary, so new
    characters land after a non-growing span end (test/micromerge.ts:
    520-566).  The k-th visible element is found by a binary search of the
    visible count, and the peek by a running max, so nothing is [R, K, C]."""
    r, c = states.elem_ctr.shape
    dev = states.elem_ctr.device
    ar = torch.arange(c, dtype=torch.int64, device=dev)[None, :]
    live = ar < states.length[:, None]
    visible = live & ~states.deleted
    vcum = torch.cumsum(visible.to(torch.int32), dim=1).to(torch.int32)
    index = index.to(torch.int32)
    found = (index >= 0) & (index < vcum[:, -1:])
    i0 = torch.searchsorted(vcum, (index + 1).contiguous())
    i0 = torch.where(found, i0, 0)
    i = i0
    if peek:
        # Last tombstone with a defined after-slot at or before each position.
        cand = live & states.deleted & states.bnd_def[:, 1::2]
        last = torch.cummax(torch.where(cand, ar, -1), dim=1).values
        nxt = torch.searchsorted(vcum, (torch.gather(vcum, 1, i0) + 1).contiguous())
        j = torch.gather(last, 1, (nxt - 1).clamp(min=0))
        j_peek = torch.where(j > i0, j, -1)
        i = torch.where(j_peek > 0, j_peek, i0)
    return torch.gather(states.elem_ctr, 1, i), torch.gather(states.elem_act, 1, i), found


def cursor_elems(states: DocState, index: torch.Tensor):
    """Element id of each replica's ``index`` [R]-th visible element, no
    peek (``kernels.cursor_elems_batch``; cursors use the plain form,
    micromerge.ts:465-472).  Returns ``(ctr, act, found)`` [R]."""
    ctr, act, found = visible_elem_ids(states, index[:, None])
    return ctr[:, 0], act[:, 0], found[:, 0]


def resolve_cursor_indices(states: DocState, ctr: torch.Tensor, act: torch.Tensor):
    """Visible index of element (ctr, act) [R] per replica: the visible
    elements before it, so a deleted target resolves to where it was
    (``kernels.resolve_cursor_indices_batch``, findListElement,
    micromerge.ts:731-755).  Returns ``(index, found)`` [R]."""
    c = states.elem_ctr.shape[1]
    ar = torch.arange(c, dtype=torch.int32, device=states.elem_ctr.device)[None, :]
    visible = (ar < states.length[:, None]) & ~states.deleted
    i, found = _find_elem(states.elem_ctr, states.elem_act, states.length, ctr, act)
    before = (visible & (ar < i[:, None])).sum(dim=1).to(torch.int32)
    return before, found


def visible_length(states: DocState) -> torch.Tensor:
    """Visible characters per replica [R] int32."""
    c = states.elem_ctr.shape[1]
    ar = torch.arange(c, device=states.elem_ctr.device)[None, :]
    return ((ar < states.length[:, None]) & ~states.deleted).sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Views: spans and digests
# ---------------------------------------------------------------------------


def flatten_sources(states: DocState):
    """Per-element effective boundary bitset (``kernels.flatten_sources``):
    element i's marks change at its "before" slot if defined, else at the
    previous element's "after" slot; otherwise they carry from the left.
    Returns (mask [R, C, W] int32, has_marks [R, C] bool)."""
    r, c = states.elem_ctr.shape
    dev = states.elem_ctr.device
    ar = torch.arange(c, dtype=torch.int64, device=dev)[None, :]
    live = ar < states.length[:, None]
    before_def = states.bnd_def[:, 0::2]
    after_def = states.bnd_def[:, 1::2]
    prev_after_def = torch.roll(after_def, 1, dims=1) & (ar > 0)
    d_slot = torch.where(before_def, 2 * ar, torch.where(prev_after_def, 2 * ar - 1, -1))
    has = (d_slot >= 0) & live
    src_elem = torch.cummax(torch.where(has, ar, -1), dim=1).values
    src_slot = torch.where(
        src_elem >= 0, torch.gather(d_slot, 1, src_elem.clamp(min=0)), -1
    )
    rows = torch.arange(r, device=dev)[:, None]
    mask = torch.where(
        (src_slot >= 0)[:, :, None], states.bnd_mask[rows, src_slot.clamp(min=0)], 0
    )
    return mask.to(torch.int32), src_slot >= 0


def expand_mask_bits(mask: torch.Tensor, max_mark_ops: int) -> torch.Tensor:
    """[*, W] int32 bitset rows -> [*, M] bool membership matrix."""
    m_idx = torch.arange(max_mark_ops, device=mask.device)
    words = mask[..., m_idx // MASK_WORD_BITS]
    return ((words >> (m_idx % MASK_WORD_BITS).to(torch.int32)) & 1).to(torch.bool)


def resolve_winners(
    states: DocState, present: torch.Tensor, ranks: torch.Tensor, multi: torch.Tensor
) -> torch.Tensor:
    """LWW/multiset resolution of mark-op sets (``kernels.resolve_winners``,
    reference opsToMarks).  ``present`` [R, C, M'] (M' <= M: the leading
    table columns).  Returns winners [R, C, M'] bool.

    Op m is dominated when a live op of its resolution group — same type
    for LWW marks, same (type, attr) for allowMultiple marks — with a
    greater (counter, actor rank) is present.  The JAX package counts
    dominators with a [M, M] matmul; dominance within a group is a total
    order on unique op ids, so here the winner is the present op whose key
    equals its group's maximum: a scatter-max over M' columns instead of
    an M'^2 product over every element, with the same result.  A column's
    group label is where its group key's run starts in the replica's
    sorted keys, so nothing here waits on the host."""
    mp = present.shape[-1]
    mtype = states.mark_type[:, :mp].long()
    attr = states.mark_attr[:, :mp].long()
    is_multi = multi.to(torch.bool)[mtype.clamp(0, multi.shape[0] - 1)]
    # attr >= -1 is int32, so (type, attr + 1) packs into one int64 key.
    gkey = (mtype << 32) + torch.where(is_multi, attr + 1, 0)
    skey, order = torch.sort(gkey, dim=1)
    pos = torch.arange(mp, device=present.device).expand_as(skey)
    run_start = torch.ones_like(skey, dtype=torch.bool)
    run_start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    start = torch.cummax(torch.where(run_start, pos, 0), dim=1).values
    group = torch.empty_like(order).scatter_(1, order, start)  # [R, M']
    n_groups = max(mp, 1)
    rank = _gather_clamped(ranks, states.mark_act[:, :mp].reshape(-1)).reshape(mtype.shape)
    key = states.mark_ctr[:, :mp].long() * (ranks.shape[0] + 1) + rank.long()
    m_live = torch.arange(mp, device=present.device)[None, :] < states.mark_count[:, None]
    cand = present & m_live[:, None, :]
    vals = torch.where(cand, key[:, None, :], -1)
    best = torch.full(present.shape[:2] + (n_groups,), -1, dtype=torch.int64, device=present.device)
    idx = group[:, None, :].expand_as(vals)
    best.scatter_reduce_(2, idx, vals, reduce="amax")
    return cand & (torch.gather(best, 2, idx) == key[:, None, :])


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors (or, for ``b``, Python ints)
    holding uint32 values, without int64 overflow.  A constant stays a
    Python int: a device tensor made from one would wait on the host."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def convergence_digest(
    states: DocState, ranks: torch.Tensor, multi: torch.Tensor, chunk_elems: int = 1 << 24,
    mark_cols: Optional[int] = None,
) -> torch.Tensor:
    """Order-sensitive checksum of each replica's visible text + resolved
    marks (``kernels.convergence_digest``), as uint32 values in an int64
    tensor [R].  uint32 wraparound is reproduced by computing in int64 and
    masking with ``& 0xFFFFFFFF`` after every product and sum.  Replicas
    go through in chunks of at most ``chunk_elems`` [C, M'] entries, and
    only the table's used columns are expanded: M' is ``mark_cols`` (any
    bound on every replica's ``mark_count`` the caller knows from its
    inputs; the digest is the same for every bound, and the call then
    never waits on the host), else the largest ``mark_count``, read back."""
    r, c = states.elem_ctr.shape
    dev = states.elem_ctr.device
    ar = torch.arange(c, device=dev)[None, :]
    live = ((ar < states.length[:, None]) & ~states.deleted).to(torch.int64)
    vis_rank = torch.cumsum(live, dim=1) - live  # 0-based visible index
    chars = states.chars.to(torch.int64) & _U32
    char_term = ((_mulmod32(chars, 2654435761) + vis_rank) & _U32) * live
    char_mix = char_term.sum(dim=1) & _U32

    if mark_cols is None:
        mark_cols = int(states.mark_count.max().item()) if r else 0
    mp = min(max(mark_cols, 1), states.max_mark_ops)
    mp = -(-mp // MASK_WORD_BITS) * MASK_WORD_BITS
    mark_value = (
        states.mark_type.to(torch.int64) * 1000003
        + (states.mark_attr.to(torch.int64) + 1) * 8191
        + 17
    ) & _U32
    mark_mix = torch.zeros(r, dtype=torch.int64, device=dev)
    step = max(1, chunk_elems // max(c * mp, 1))
    for lo in range(0, r, step):
        sub = map_state(lambda x: x[lo : lo + step], states)
        mask, _ = flatten_sources(sub)
        present = expand_mask_bits(mask[..., : mp // MASK_WORD_BITS], mp)
        winners = resolve_winners(sub, present, ranks, multi)
        adds = winners & (sub.mark_action[:, None, :mp] == 0)
        # sum_m adds * mark_value < M' * 2**32: exact in int64.
        per_elem = (adds.to(torch.int64) * mark_value[lo : lo + step, None, :mp]).sum(dim=2) & _U32
        factor = (vis_rank[lo : lo + step] * 31 + 7) & _U32
        term = _mulmod32(per_elem, factor) * live[lo : lo + step]
        mark_mix[lo : lo + step] = term.sum(dim=1) & _U32
    return (2166136261 ^ char_mix ^ _mulmod32(mark_mix, 31)) & _U32

