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

        # RGA position (kernels._rga_insert_position): after the reference
        # element, past the contiguous run of elements with a greater id.
        is_head = (op[:, K_REF_CTR] == 0) & (op[:, K_REF_ACT] == 0)
        idx = torch.where(is_head, -1, _first_match(match))
        ctr = op[:, K_CTR, None]
        op_rank = _gather_clamped(ranks, op[:, K_ACT])[:, None]
        elem_rank = _gather_clamped(ranks, ea.reshape(-1)).reshape(r, c)
        gt = (ec > ctr) | ((ec == ctr) & (elem_rank > op_rank))
        stop = (ar > idx[:, None]) & ~(live & gt)
        t = torch.where(stop, ar, c).amin(dim=1, keepdim=True)
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
    drop, as the JAX scatter's out-of-bounds writes do."""
    is_mark = mark_ops[:, :, K_KIND] == KIND_MARK  # [R, L]
    order = torch.cumsum(is_mark.to(torch.int32), dim=1) - 1
    idx = states.mark_count[:, None] + order
    ok = is_mark & (idx < states.max_mark_ops)
    rr, ll = ok.nonzero(as_tuple=True)
    cols = idx[rr, ll].long()
    updates = {}
    for name, field in _TABLE_FIELDS:
        col = getattr(states, name).clone()
        col[rr, cols] = mark_ops[rr, ll, field]
        updates[name] = col
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
    an M'^2 product, with the same result."""
    mp = present.shape[-1]
    mtype = states.mark_type[:, :mp].long()
    attr = states.mark_attr[:, :mp].long()
    is_multi = multi.to(torch.bool)[mtype.clamp(0, multi.shape[0] - 1)]
    n_attr = int(attr.max().item()) + 2 if attr.numel() else 1
    gkey = mtype * n_attr + torch.where(is_multi, attr + 1, 0)
    _, group = torch.unique(gkey, return_inverse=True)  # [R, M']
    n_groups = int(group.max().item()) + 1 if group.numel() else 1
    rank = _gather_clamped(ranks, states.mark_act[:, :mp].reshape(-1)).reshape(mtype.shape)
    key = states.mark_ctr[:, :mp].long() * (ranks.shape[0] + 1) + rank.long()
    m_live = torch.arange(mp, device=present.device)[None, :] < states.mark_count[:, None]
    cand = present & m_live[:, None, :]
    vals = torch.where(cand, key[:, None, :], -1)
    best = torch.full(present.shape[:2] + (n_groups,), -1, dtype=torch.int64, device=present.device)
    idx = group[:, None, :].expand_as(vals)
    best.scatter_reduce_(2, idx, vals, reduce="amax")
    return cand & (torch.gather(best, 2, idx) == key[:, None, :])


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors holding uint32 values, without
    int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def convergence_digest(
    states: DocState, ranks: torch.Tensor, multi: torch.Tensor, chunk_elems: int = 1 << 24
) -> torch.Tensor:
    """Order-sensitive checksum of each replica's visible text + resolved
    marks (``kernels.convergence_digest``), as uint32 values in an int64
    tensor [R].  uint32 wraparound is reproduced by computing in int64 and
    masking with ``& 0xFFFFFFFF`` after every product and sum.  Replicas
    go through in chunks of at most ``chunk_elems`` [C, M'] entries, and
    only the table's used columns (M' = max mark_count) are expanded."""
    r, c = states.elem_ctr.shape
    dev = states.elem_ctr.device
    ar = torch.arange(c, device=dev)[None, :]
    live = ((ar < states.length[:, None]) & ~states.deleted).to(torch.int64)
    vis_rank = torch.cumsum(live, dim=1) - live  # 0-based visible index
    chars = states.chars.to(torch.int64) & _U32
    char_term = ((_mulmod32(chars, torch.tensor(2654435761, device=dev)) + vis_rank) & _U32) * live
    char_mix = char_term.sum(dim=1) & _U32

    mp = min(max(int(states.mark_count.max().item()) if r else 0, 1), states.max_mark_ops)
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
    return (2166136261 ^ char_mix ^ _mulmod32(mark_mix, torch.tensor(31, device=dev))) & _U32

