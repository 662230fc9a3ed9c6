"""The JAX package's default merge as plain PyTorch: sort-based placement,
the batched mark phase and the frontier-bounded window.

Counterparts of ``peritext_tpu/ops/kernels.py``'s ``_place_round`` (with
its three ``PERITEXT_SPLICE`` modes, the default ``"sort"`` among them),
``place_text_batch``,
``_batched_anchor_slots``, ``_or_accumulate``, ``_apply_marks_batch``,
``_sorted_tail``, ``merge_step_sorted(_batch)``, ``_gather_window``,
``_scatter_window``, ``_window_ok`` and ``merge_step_sorted_windowed``.  No
TPU kernel lies on this path: JAX runs it as XLA, and here it is plain
torch on whatever device the states are on.

Every function takes the replica axis explicitly ([R, ...] tensors, the
JAX package's ``vmap`` written out).  Where JAX loops with ``fori_loop``
over a traced round count, this loops in Python over the host integer.
JAX fuses its [L, C], [L, L] and [M, 2C] intermediates under ``vmap``;
eager torch materializes them, so ``merge_step_sorted_batch`` and
``merge_step_sorted_windowed_batch`` run the replica axis in slices whose
transients stay under ``_CHUNK_ELEMS`` elements each, and the placement
and the window check reduce their [L, C] and [L, w_cap] predicates in op
chunks.  Replicas are independent, so the slicing changes no result.

State leaves every function in its JAX dtype: int32 planes, bool flags,
and the uint32 mask words as int32 bitcasts (``state.py``).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from peritext_tpu_torch.ops.encode import env_int
from peritext_tpu_torch.ops.kernels import (
    K_ACT,
    K_CTR,
    K_EACT,
    K_ECTR,
    K_EKIND,
    K_KIND,
    K_PAYLOAD,
    K_REF_ACT,
    K_REF_CTR,
    K_RUN_LEN,
    K_SACT,
    K_SCTR,
    K_SKIND,
    KIND_DELETE,
    KIND_INSERT,
    KIND_INSERT_RUN,
    KIND_MARK,
    _first_match,
    _gather_clamped,
    _slot_permutation,
    append_mark_table,
)
from peritext_tpu_torch.ops.state import FIELDS, MASK_WORD_BITS, DocState, map_state

# Elements of one [slice, ...] transient the sorted merge holds at once.
_CHUNK_ELEMS = 1 << 26

# The splice that materializes each placement round's output, as in
# ``kernels._place_round``: "sort" (the default) a stable argsort of the
# destinations and a gather per plane, "scatter" a scatter to them, "roll"
# binary rolls of the existing elements and a fill of the op blocks.  Read
# from PERITEXT_SPLICE at import; tests set the module global.
_SPLICE_MODE = os.environ.get("PERITEXT_SPLICE", "sort")
if _SPLICE_MODE not in ("sort", "scatter", "roll"):
    raise ValueError(
        f"PERITEXT_SPLICE={_SPLICE_MODE!r}: must be 'sort', 'scatter' or 'roll'"
    )
# Each plane's value where no element or block lands (ctr, act, deleted,
# chars, orig index).
_SPLICE_FILLS = (0, 0, 0, 0, -1)
_U32 = 0xFFFFFFFF


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bitcast."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[r, idx[r, n]]`` for [R, N, ...] tables and [R, K] indices."""
    r, k = idx.shape
    tail = table.shape[2:]
    return torch.gather(table, 1, idx.reshape(r, k, *([1] * len(tail))).expand(r, k, *tail))


# ---------------------------------------------------------------------------
# Sort-based text placement
# ---------------------------------------------------------------------------


def _place_round(carry, rnd: int, ops, round_of, ranks, char_buf, maxk: int):
    """Apply every round-``rnd`` text op at once (``kernels._place_round``):
    deletes tombstone every live match, each insert's block lands at its
    skip-run stop t, and blocks at one t go in descending op-id order.  The
    ``_SPLICE_MODE`` splice writes the output; under "sort" it is a stable
    sort of all destinations (dead slots and inactive lanes sort last)."""
    ec, ea, dl, ch, oi, length = carry
    r, c = ec.shape
    n_ops = ops.shape[1]
    dev = ec.device
    # The [L, C] planes hold int32: every id, rank and position fits.
    ar = torch.arange(c, dtype=torch.int32, device=dev)
    alive = ar[None, :] < length[:, None]

    kind = ops[..., K_KIND]
    active = round_of == rnd
    is_run = kind == KIND_INSERT_RUN
    is_ins = active & ((kind == KIND_INSERT) | is_run)
    is_del = active & (kind == KIND_DELETE)
    ref_ctr, ref_act = ops[..., K_REF_CTR], ops[..., K_REF_ACT]
    is_head = (ref_ctr == 0) & (ref_act == 0)
    ctr_i = ops[..., K_CTR]
    rank_i = _gather_clamped(ranks, ops[..., K_ACT].reshape(-1)).reshape(r, n_ops)
    elem_rank = _gather_clamped(ranks, ea.reshape(-1)).reshape(r, c)

    # [L, C] predicates, reduced in op chunks: deletes, the reference's
    # first live match (element 0 when absent, JAX's argmax over
    # all-False) and the skip-run stop t.
    t = torch.empty((r, n_ops), dtype=torch.int32, device=dev)
    hit = torch.zeros((r, c), dtype=torch.bool, device=dev)
    step = max(1, _CHUNK_ELEMS // max(r * c, 1))
    for lo in range(0, n_ops, step):
        sl = slice(lo, lo + step)
        match = (
            alive[:, None, :]
            & (ec[:, None, :] == ref_ctr[:, sl, None])
            & (ea[:, None, :] == ref_act[:, sl, None])
        )
        hit |= (match & is_del[:, sl, None]).any(dim=1)
        idx = torch.where(is_head[:, sl], -1, _first_match(match))
        cti = ctr_i[:, sl, None]
        gt = (ec[:, None, :] > cti) | (
            (ec[:, None, :] == cti) & (elem_rank[:, None, :] > rank_i[:, sl, None])
        )
        stop = (ar > idx[:, :, None]) & ~(alive[:, None, :] & gt)
        t[:, sl] = torch.where(stop, ar, c).amin(dim=2)
    deleted = dl | hit
    t = t.long()
    ctr_i, rank_i, ar = ctr_i.long(), rank_i.long(), ar.long()

    k = torch.where(is_run, ops[..., K_RUN_LEN], 1).long() * is_ins  # [R, L]
    # Final block starts: stable order (t, descending op id).
    id_gt = (ctr_i[:, None, :] > ctr_i[:, :, None]) | (
        (ctr_i[:, None, :] == ctr_i[:, :, None]) & (rank_i[:, None, :] > rank_i[:, :, None])
    )  # [R, i, j]: op j's id > op i's
    before = (t[:, None, :] < t[:, :, None]) | ((t[:, None, :] == t[:, :, None]) & id_gt)
    s = t + (k[:, None, :] * before).sum(dim=2)
    # Existing elements shift right by every block placed at or before
    # them: a histogram of k over t, summed up the positions.
    hist = torch.zeros((r, c + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, t, k)
    shifts = torch.cumsum(hist, dim=1)[:, :c]
    dest_exist = torch.where(alive, ar + shifts, c)

    off = torch.arange(maxk, device=dev)
    in_block = (off < k[:, :, None]) & is_ins[:, :, None]  # [R, L, maxk]
    dest_ops = torch.where(in_block, s[:, :, None] + off, c)
    buf_idx = (ops[..., K_PAYLOAD, None].long() + off).clamp(0, char_buf.shape[1] - 1)
    run_chars = torch.gather(char_buf, 1, buf_idx.reshape(r, -1)).reshape(r, n_ops, maxk)
    block_chars = torch.where(is_run[:, :, None], run_chars, ops[..., K_PAYLOAD, None])
    block_ctr = (ops[..., K_CTR, None] + off).to(torch.int32)
    block_act = ops[..., K_ACT, None].expand(r, n_ops, maxk)
    new_length = (length + k.sum(dim=1)).to(torch.int32)

    zeros = torch.zeros_like(block_ctr)
    if _SPLICE_MODE == "scatter":
        return _splice_scatter(
            (ec, ea, deleted.to(torch.int32), ch, oi),
            (block_ctr, block_act, zeros, block_chars, zeros - 1),
            dest_exist, dest_ops, new_length,
        )
    if _SPLICE_MODE == "roll":
        return _splice_roll(
            (ec, ea, deleted.to(torch.int32), ch, oi), shifts, n_ops * maxk, is_ins, s, k,
            ctr_i, ops[..., K_ACT], maxk, block_chars, new_length,
        )
    keys = torch.cat([dest_exist, dest_ops.reshape(r, -1)], dim=1)
    take = torch.argsort(keys, dim=1, stable=True)[:, :c]
    live_out = ar[None, :] < new_length[:, None]

    def plane(old, block, fill):
        both = torch.cat([old, block.reshape(r, -1).to(old.dtype)], dim=1)
        return torch.where(live_out, torch.gather(both, 1, take), fill)

    return (
        plane(ec, block_ctr, 0),
        plane(ea, block_act, 0),
        plane(deleted, zeros.bool(), False),
        plane(ch, block_chars, 0),
        plane(oi, zeros - 1, -1),
        new_length,
    )


def _splice_scatter(old, block, dest_exist, dest_ops, new_length):
    """The ``"scatter"`` splice: each element and block lane written to its
    destination, positions no one writes keeping the fill.  JAX's
    ``.at[dest].set(mode="drop")`` drops destinations >= C (dead slots,
    inactive lanes, a batch that overfills C); here they all land on a sink
    column C that is cut off.  Destinations below C are unique, so the
    result does not depend on the write order."""
    r, c = old[0].shape
    de = dest_exist.clamp(max=c)
    do = dest_ops.reshape(r, -1).clamp(max=c)
    outs = []
    for o, b, fill in zip(old, block, _SPLICE_FILLS):
        out = torch.full((r, c + 1), fill, dtype=o.dtype, device=o.device)
        out.scatter_(1, de, o)
        out.scatter_(1, do, b.reshape(r, -1).to(o.dtype))
        outs.append(out[:, :c].contiguous())
    return (*outs[:2], outs[2].bool(), *outs[3:], new_length)


def _splice_roll(planes, shifts, max_disp: int, is_ins, s, k, ctr_i, act_i, maxk: int,
                 block_chars, new_length):
    """The ``"roll"`` splice (``kernels._place_round``'s): existing
    elements move right by their displacement in MSB-first binary rolls over
    ``max_disp.bit_length()`` passes (stale copies marked -1 so they never
    move again; ``ar >= step`` guards the wrap), then each block position
    takes its owning op's id, actor and char.  JAX finds the owner through
    [L, C] and [L * maxk, C] one-hots; here the [L, C] block predicate runs
    in op chunks under ``_CHUNK_ELEMS`` and each position's char is
    gathered at its offset from the owner's block start ``s``."""
    r, c = planes[0].shape
    n_ops = s.shape[1]
    dev = s.device
    ar = torch.arange(c, device=dev)
    rem = shifts
    for b in reversed(range(max_disp.bit_length())):
        step = 1 << b
        moved = torch.roll(rem, step, dims=1)
        sel = (moved >= step) & (ar >= step)
        planes = [torch.where(sel, torch.roll(p, step, dims=1), p) for p in planes]
        rem = torch.where(sel, moved - step, torch.where(rem >= step, -1, rem))

    # Blocks are disjoint: each position has at most one owning op.
    owner = torch.full((r, c), -1, dtype=torch.long, device=dev)
    lanes = torch.arange(n_ops, device=dev)
    chunk = max(1, _CHUNK_ELEMS // max(r * c, 1))
    for lo in range(0, n_ops, chunk):
        sl = slice(lo, lo + chunk)
        in_blk = is_ins[:, sl, None] & (ar >= s[:, sl, None]) & (ar < (s + k)[:, sl, None])
        owner = torch.maximum(owner, torch.where(in_blk, lanes[sl, None], -1).amax(dim=1))
    blk_any = owner >= 0
    own = owner.clamp(min=0)
    off = ar - torch.gather(s, 1, own)
    lane = own * maxk + off.clamp(0, maxk - 1)
    blk_char = torch.where(
        off < maxk, torch.gather(block_chars.reshape(r, -1), 1, lane), -(2**31) + 1
    )
    blk = (
        (torch.gather(ctr_i - s, 1, own) + ar).to(torch.int32),
        torch.gather(act_i, 1, own),
        torch.zeros_like(planes[2]),
        blk_char,
        torch.full_like(planes[4], -1),
    )
    live_out = ar[None, :] < new_length[:, None]
    outs = [
        torch.where(live_out, torch.where(blk_any, b.to(p.dtype), p), fill)
        for p, b, fill in zip(planes, blk, _SPLICE_FILLS)
    ]
    return (*outs[:2], outs[2].bool(), *outs[3:], new_length)


def place_text_batch(ec, ea, dl, ch, length, text_ops, round_of, num_rounds: int,
                     ranks, char_buf, maxk: int):
    """Integrate a causally ordered text-op batch in ``num_rounds`` rounds
    (``kernels.place_text_batch``).  Returns the element planes, the
    orig-index permutation plane and the new length."""
    r, c = ec.shape
    oi = torch.arange(c, dtype=torch.int32, device=ec.device).expand(r, c).contiguous()
    carry = (ec, ea, dl, ch, oi, length)
    for rnd in range(num_rounds):
        carry = _place_round(carry, rnd, text_ops, round_of, ranks, char_buf, maxk)
    return carry


# ---------------------------------------------------------------------------
# Batched mark phase
# ---------------------------------------------------------------------------


def _batched_anchor_slots(mark_ops, ec, ea, length):
    """Anchor slots of a whole mark batch (``kernels._batched_anchor_slots``):
    first live match, slot 0 when absent; endOfText and an end on the
    start's slot become the sentinel 2C + 2.  Returns ``(valid, s_slot,
    e_slot)`` [R, M], the slots int64."""
    c = ec.shape[1]
    big = 2 * c + 2
    alive = torch.arange(c, device=ec.device)[None, :] < length[:, None]
    valid = mark_ops[..., K_KIND] == KIND_MARK

    def first(ctr_f, act_f):
        match = (
            alive[:, None, :]
            & (ec[:, None, :] == mark_ops[..., ctr_f, None])
            & (ea[:, None, :] == mark_ops[..., act_f, None])
        )
        return _first_match(match).long()

    s_slot = 2 * first(K_SCTR, K_SACT) + mark_ops[..., K_SKIND]
    ekind = mark_ops[..., K_EKIND]
    e_slot = torch.where(ekind == 2, big, 2 * first(K_ECTR, K_EACT) + ekind.clamp(max=1))
    e_slot = torch.where(e_slot == s_slot, big, e_slot)
    return valid, s_slot, e_slot


def _or_accumulate(sel: torch.Tensor, bit_rows: torch.Tensor) -> torch.Tensor:
    """OR of the selected one-bit rows (``kernels._or_accumulate``):
    [R, N, M] bool x [R, M, w] uint32 values (int64) -> [R, N, w] int64.

    Every row of ``bit_rows`` carries a distinct bit, so the sum equals the
    OR.  The sum runs as a float64 matmul: its terms are distinct powers of
    two below 2**32, so every partial sum is an integer below 2**53 and
    exact in any order.  float64 products never take the TF32 path, so the
    result does not depend on ``torch.backends.cuda.matmul.allow_tf32``."""
    out = torch.bmm(sel.to(torch.float64), bit_rows.to(torch.float64))
    return out.to(torch.int64)


def _apply_marks_batch(bnd_def, bnd_mask, mark_ops, ec, ea, length, mark_count, perm=None):
    """Apply a causally ordered mark batch to the boundary tables at once
    (``kernels._apply_marks_batch``), bit-exact with applying the rows in
    order.  Returns ``(bnd_def, bnd_mask)``.

    With ``perm`` (the text phase's orig-index plane) the post-splice
    boundary permutation is composed into this phase's reads, so the
    [R, 2C, W] plane is read once and written once.  The batch's new bits
    land in a word window of ``w_act`` words starting at ``w0``; only the
    pre-batch carry rows are full width.  Sequential dependence resolves by
    pointer doubling over the 2M write nodes (op m's start write and end
    write)."""
    r, m_ops = mark_ops.shape[:2]
    c = ec.shape[1]
    two_c = 2 * c
    w_words = bnd_mask.shape[2]
    dev = ec.device
    midx = torch.arange(m_ops, device=dev)
    slots = torch.arange(two_c, device=dev)

    if perm is not None:
        pvalid, pflat = _slot_permutation(perm)
        def_p = torch.gather(bnd_def, 1, pflat) & pvalid

        def old_rows(slot_idx):  # [R, N] post-splice slots -> [R, N, W]
            rows = _gather_rows(bnd_mask, torch.gather(pflat, 1, slot_idx))
            return torch.where(torch.gather(pvalid, 1, slot_idx)[:, :, None], rows, 0)
    else:
        def_p = bnd_def

        def old_rows(slot_idx):
            return _gather_rows(bnd_mask, slot_idx)

    valid, s_slot, e_slot = _batched_anchor_slots(mark_ops, ec, ea, length)

    # Bit rows: op m's table index is mark_count + its rank among valid rows.
    mpos = torch.cumsum(valid.long(), dim=1) - 1
    bit_idx = mark_count.long()[:, None] + mpos
    w_act = min((m_ops + MASK_WORD_BITS - 1) // MASK_WORD_BITS + 1, w_words)
    w0 = (mark_count.long() // MASK_WORD_BITS).clamp(0, w_words - w_act)
    bit_off = bit_idx - w0[:, None] * MASK_WORD_BITS
    word_ar = torch.arange(w_act, device=dev)
    bit = torch.ones_like(bit_off) << (bit_off % MASK_WORD_BITS)
    B = torch.where(
        valid[:, :, None] & (word_ar == (bit_off // MASK_WORD_BITS)[:, :, None]), bit[:, :, None], 0
    )  # [R, M, w_act] uint32 values

    d0 = def_p & (slots[None, :] < 2 * length[:, None])
    writes_s = valid & (s_slot < e_slot)
    writes_e = valid & (e_slot < two_c)
    w_any = (writes_s[:, :, None] & (slots == s_slot[:, :, None])) | (
        writes_e[:, :, None] & (slots == e_slot[:, :, None])
    )  # [R, M, 2C]
    written_any = w_any.any(dim=1)
    w_last = torch.where(w_any, midx[:, None], -1).amax(dim=1)
    f_first = torch.where(w_any, midx[:, None], m_ops).amin(dim=1)
    # First time each slot is defined: -1 pre-batch, m_ops + 1 never.
    def_time = torch.where(d0, -1, torch.where(written_any, f_first, m_ops + 1))
    in_range_t = (
        writes_s[:, :, None] & (slots > s_slot[:, :, None]) & (slots < e_slot[:, :, None])
    ).transpose(1, 2)  # [R, 2C, M]
    w_any_t = w_any.transpose(1, 2)
    rows = torch.arange(r, device=dev)[:, None]
    earlier = midx[None, :] < midx[:, None]  # [M(this op), M(other)]

    def carry_node(p):  # [R, M] target slots -> (q, prev, seg bits, root row)
        cand = (slots <= p[:, :, None]) & (def_time[:, None, :] < midx[None, :, None])
        q = torch.where(cand, slots, -1).amax(dim=2)  # nearest slot defined before this op
        qc = q.clamp(min=0)
        has_q = (q >= 0)[:, :, None]
        # Last batch op writing q before this one (-1: q's row is pre-batch).
        prev = torch.where(w_any_t[rows, qc] & has_q & earlier, midx, -1).amax(dim=2)
        # Bits ORed into q between prev and this op.
        seg = in_range_t[rows, qc] & has_q & (midx > prev[:, :, None]) & earlier
        seg_bits = _or_accumulate(seg, B)
        root = ((prev < 0) & (q >= 0)) & torch.gather(d0, 1, qc)
        root_row = torch.where(root[:, :, None], old_rows(qc), 0)
        return q, prev, seg_bits, root_row

    q_s, prev_s, seg_s, root_s = carry_node(s_slot)
    q_e, prev_e, seg_e, root_e = carry_node(e_slot.clamp(max=two_c - 1))

    def parent_node(prev, q):  # prev's S node if its start slot is q, else its E node
        is_s = torch.gather(s_slot, 1, prev.clamp(min=0)) == q
        return torch.where(prev < 0, -1, torch.where(is_s, prev, prev + m_ops))

    acc_win = torch.cat([seg_s | B, seg_e], dim=1)  # [R, 2M, w_act]
    acc_root = torch.cat([root_s, root_e], dim=1)  # [R, 2M, W] int32
    ptr = torch.cat([parent_node(prev_s, q_s), parent_node(prev_e, q_e)], dim=1)
    for _ in range(max(1, (2 * m_ops - 1).bit_length())):
        pc = ptr.clamp(min=0)
        chained = (ptr >= 0)[:, :, None]
        acc_win = acc_win | torch.where(chained, _gather_rows(acc_win, pc), 0)
        acc_root = acc_root | torch.where(chained, _gather_rows(acc_root, pc), 0)
        ptr = torch.where(ptr >= 0, torch.gather(ptr, 1, pc), ptr)

    # Written slots are rebased to their last writer's root row; the rest
    # keep their old rows.  The batch's new bits OR into the window words.
    wl = w_last.clamp(min=0)
    node_at = torch.where(torch.gather(s_slot, 1, wl) == slots, wl, wl + m_ops)
    written_col = written_any[:, :, None]
    base_full = torch.where(
        written_col, _gather_rows(acc_root, node_at), old_rows(slots.expand(r, two_c))
    )
    start_time = torch.where(written_any, w_last, -1)
    tail_w = _or_accumulate(in_range_t & (midx > start_time[:, :, None]), B)  # [R, 2C, w_act]
    delta = torch.where(written_col, _gather_rows(acc_win, node_at), 0) | torch.where(
        written_col | d0[:, :, None], tail_w, 0
    )
    words = (w0[:, None] + word_ar)[:, None, :].expand(r, two_c, w_act)
    new_mask = base_full.clone()
    new_mask.scatter_(2, words, _to_int32_bits(torch.gather(base_full, 2, words).long() & _U32 | delta))
    return def_p | written_any, new_mask


def _sorted_tail(states: DocState, ec, ea, dl, ch, oi, length, mark_ops) -> DocState:
    """Batched mark phase with the boundary permute composed in, then the
    table append (``kernels._sorted_tail``)."""
    bnd_def, bnd_mask = _apply_marks_batch(
        states.bnd_def, states.bnd_mask, mark_ops, ec, ea, length, states.mark_count, perm=oi
    )
    out = DocState(
        elem_ctr=ec, elem_act=ea, deleted=dl, chars=ch, bnd_def=bnd_def, bnd_mask=bnd_mask,
        mark_ctr=states.mark_ctr, mark_act=states.mark_act, mark_action=states.mark_action,
        mark_type=states.mark_type, mark_attr=states.mark_attr, length=length,
        mark_count=states.mark_count,
    )
    return append_mark_table(out, mark_ops)


def merge_step_sorted(states, text_ops, round_of, num_rounds: int, mark_ops, ranks,
                      char_buf, maxk: int) -> DocState:
    """Batched merge, both phases vectorized over the op batch
    (``kernels.merge_step_sorted``): O(reference depth) placement rounds and
    O(log marks) pointer-doubling steps.  State-equal to the per-op merge."""
    ec, ea, dl, ch, oi, length = place_text_batch(
        states.elem_ctr, states.elem_act, states.deleted, states.chars, states.length,
        text_ops, round_of, num_rounds, ranks, char_buf, maxk,
    )
    return _sorted_tail(states, ec, ea, dl, ch, oi, length, mark_ops)


def _replica_step(capacity: int, words: int, n_text: int, n_mark: int, maxk: int) -> int:
    """Replicas per slice so the largest per-replica transient of the
    sorted merge (the [L, C] and [L, L] placement planes, the splice keys,
    the [M, 2C] mark planes and the full mask plane) stays under
    ``_CHUNK_ELEMS`` elements."""
    per = max(
        n_text * n_text, capacity + n_text * maxk, 2 * n_mark * 2 * capacity,
        2 * capacity * words, n_mark * n_mark, 1,
    )
    return max(1, _CHUNK_ELEMS // per)


def merge_step_sorted_batch(states, text_ops, round_of, num_rounds: int, mark_ops, ranks,
                            char_buf, maxk: int, chunk: int | None = None) -> DocState:
    """The sorted merge over a replica batch (``kernels.
    merge_step_sorted_batch``).  ``chunk`` (or ``PERITEXT_SORTED_CHUNK``;
    0 = off) runs the replica axis in slices of that many, as JAX's memory
    valve does; independently of it, slices never exceed what keeps each
    transient under ``_CHUNK_ELEMS`` elements.  Every slicing gives the
    same state."""
    r = text_ops.shape[0]
    if chunk is None:
        chunk = env_int("PERITEXT_SORTED_CHUNK", "0", 0)
    step = _replica_step(
        states.capacity, states.bnd_mask.shape[-1], text_ops.shape[1], mark_ops.shape[1], maxk
    )
    if chunk:
        step = min(step, chunk)
    if step >= r:
        return merge_step_sorted(states, text_ops, round_of, num_rounds, mark_ops, ranks, char_buf, maxk)
    outs = []
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        outs.append(merge_step_sorted(
            map_state(lambda x: x[sl], states), text_ops[sl], round_of[sl], num_rounds,
            mark_ops[sl], ranks, char_buf[sl], maxk,
        ))
    return DocState(**{f: torch.cat([getattr(o, f) for o in outs]) for f in FIELDS})


# ---------------------------------------------------------------------------
# Frontier-bounded window merge
# ---------------------------------------------------------------------------


def _gather_window(states: DocState, starts, hull_lens, w_cap: int) -> DocState:
    """Each replica's element window [start, start + w_cap) as a DocState of
    capacity ``w_cap`` with length ``hull_lens`` (``kernels._gather_window``).
    Starts clamp into [0, C - w_cap], as ``lax.dynamic_slice`` clamps them;
    the mark table rides whole."""
    r, c = states.elem_ctr.shape
    s = starts.long().clamp(0, c - w_cap)[:, None]
    idx = s + torch.arange(w_cap, device=s.device)
    idx2 = 2 * s + torch.arange(2 * w_cap, device=s.device)

    def win(p):
        return torch.gather(p, 1, idx)

    return DocState(
        elem_ctr=win(states.elem_ctr), elem_act=win(states.elem_act),
        deleted=win(states.deleted), chars=win(states.chars),
        bnd_def=torch.gather(states.bnd_def, 1, idx2),
        bnd_mask=_gather_rows(states.bnd_mask, idx2),
        mark_ctr=states.mark_ctr, mark_act=states.mark_act, mark_action=states.mark_action,
        mark_type=states.mark_type, mark_attr=states.mark_attr,
        length=hull_lens.to(torch.int32), mark_count=states.mark_count,
    )


def _scatter_window(states: DocState, win: DocState, starts, hull_lens) -> DocState:
    """Splice merged windows back into the full-capacity states
    (``kernels._scatter_window``): elements before the start keep their
    rows, the window's follow, the pre-batch tail shifts right by the
    insert count, and slots past the new length take the dead-slot fills."""
    c = states.capacity
    w_cap = win.capacity
    dev = states.elem_ctr.device
    start = starts.long()[:, None]
    shift = (win.length.long() - hull_lens.long())[:, None]
    win_len = win.length.long()[:, None]
    new_n = states.length.long()[:, None] + shift

    def splice(old, winp, unit: int, fill):
        ar = torch.arange(unit * c, device=dev)[None, :]
        lo = unit * start
        in_win = (ar >= lo) & (ar < lo + unit * win_len)
        win_idx = (ar - lo).clamp(0, unit * w_cap - 1)
        old_idx = torch.where(ar < lo, ar, ar - unit * shift).clamp(0, unit * c - 1)
        if old.dim() == 3:
            v = torch.where(in_win[:, :, None], _gather_rows(winp, win_idx), _gather_rows(old, old_idx))
            return torch.where((ar < unit * new_n)[:, :, None], v, fill)
        v = torch.where(in_win, torch.gather(winp, 1, win_idx), torch.gather(old, 1, old_idx))
        return torch.where(ar < unit * new_n, v, fill)

    return DocState(
        elem_ctr=splice(states.elem_ctr, win.elem_ctr, 1, 0),
        elem_act=splice(states.elem_act, win.elem_act, 1, 0),
        deleted=splice(states.deleted, win.deleted, 1, False),
        chars=splice(states.chars, win.chars, 1, 0),
        bnd_def=splice(states.bnd_def, win.bnd_def, 2, False),
        bnd_mask=splice(states.bnd_mask, win.bnd_mask, 2, 0),
        mark_ctr=win.mark_ctr, mark_act=win.mark_act, mark_action=win.mark_action,
        mark_type=win.mark_type, mark_attr=win.mark_attr,
        length=new_n[:, 0].to(torch.int32), mark_count=win.mark_count,
    )


def _window_ok(win0: DocState, text_ops, mark_ops, w_cap: int) -> torch.Tensor:
    """Device check of the host census (``kernels._window_ok``), [R] bool:
    every text op's reference and every mark anchor is HEAD (inserts
    only), a live window element or an element the batch creates, and the
    window has room for the batch's inserts."""
    r = text_ops.shape[0]
    live = torch.arange(w_cap, device=win0.elem_ctr.device)[None, :] < win0.length[:, None]
    kind = text_ops[..., K_KIND]
    is_ins = (kind == KIND_INSERT) | (kind == KIND_INSERT_RUN)
    is_del = kind == KIND_DELETE
    k = torch.where(kind == KIND_INSERT_RUN, text_ops[..., K_RUN_LEN], 1) * is_ins
    first = text_ops[..., K_CTR]
    # The [Q, w_cap] and [Q, L] predicates reduce in query chunks.
    step = max(1, _CHUNK_ELEMS // max(r * max(w_cap, text_ops.shape[1]), 1))

    def found(qc, qa):
        out = []
        for lo in range(0, qc.shape[1], step):
            c_, a_ = qc[:, lo : lo + step, None], qa[:, lo : lo + step, None]
            in_win = (
                live[:, None, :] & (win0.elem_ctr[:, None, :] == c_) & (win0.elem_act[:, None, :] == a_)
            ).any(dim=2)
            in_batch = (
                is_ins[:, None, :]
                & (a_ == text_ops[:, None, :, K_ACT])
                & (c_ >= first[:, None, :])
                & (c_ < (first + k)[:, None, :])
            ).any(dim=2)
            out.append(in_win | in_batch)
        return torch.cat(out, dim=1) if out else torch.zeros_like(qc, dtype=torch.bool)

    ref_ctr, ref_act = text_ops[..., K_REF_CTR], text_ops[..., K_REF_ACT]
    is_head = (ref_ctr == 0) & (ref_act == 0)
    ref_ok = found(ref_ctr, ref_act)
    text_ok = (~(is_ins | is_del) | torch.where(is_ins, is_head | ref_ok, ref_ok)).all(dim=1)
    mvalid = mark_ops[..., K_KIND] == KIND_MARK
    s_ok = found(mark_ops[..., K_SCTR], mark_ops[..., K_SACT])
    e_ok = (mark_ops[..., K_EKIND] == 2) | found(mark_ops[..., K_ECTR], mark_ops[..., K_EACT])
    mark_ok = (~mvalid | (s_ok & e_ok)).all(dim=1)
    fit_ok = win0.length.long() + k.sum(dim=1) <= w_cap
    return text_ok & mark_ok & fit_ok


def merge_step_sorted_windowed_batch(
    states, starts, hull_lens, text_ops, round_of, num_rounds: int, mark_ops, ranks,
    char_buf, maxk: int, w_cap: int,
) -> Tuple[DocState, Dict[str, torch.Tensor]]:
    """The sorted merge over each replica's gathered window, scattered back
    (``kernels.merge_step_sorted_windowed_batch``).  Returns ``(new_states,
    wrec)``: ``wrec["wok"]`` [R] is the device census verdict, and
    ``w_ctr``/``w_act``/``w_del``/``w_def`` are the merged windows the
    universe splices into its host mirror.  Where ``wok`` is False the
    returned state is meaningless and must be discarded.

    The replica axis runs in slices, each taken whole through gather,
    check, merge and scatter, sized so that the window's transients and
    the scatter's full-capacity planes stay under ``_CHUNK_ELEMS``
    elements per slice."""
    r = text_ops.shape[0]
    words = states.bnd_mask.shape[-1]
    step = min(
        _replica_step(w_cap, words, text_ops.shape[1], mark_ops.shape[1], maxk),
        max(1, _CHUNK_ELEMS // (2 * states.capacity * words)),
    )
    outs, recs = [], []
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        st = states if step >= r else map_state(lambda x: x[sl], states)
        win0 = _gather_window(st, starts[sl], hull_lens[sl], w_cap)
        wok = _window_ok(win0, text_ops[sl], mark_ops[sl], w_cap)
        new_win = merge_step_sorted(
            win0, text_ops[sl], round_of[sl], num_rounds, mark_ops[sl], ranks, char_buf[sl], maxk
        )
        recs.append({
            "wok": wok,
            "w_ctr": new_win.elem_ctr,
            "w_act": new_win.elem_act,
            "w_del": new_win.deleted,
            "w_def": new_win.bnd_def,
        })
        outs.append(_scatter_window(st, new_win, starts[sl], hull_lens[sl]))
    if len(outs) == 1:
        return outs[0], recs[0]
    wrec = {key: torch.cat([rec[key] for rec in recs]) for key in recs[0]}
    return DocState(**{f: torch.cat([getattr(o, f) for o in outs]) for f in FIELDS}), wrec
