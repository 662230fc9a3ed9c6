"""The JAX package's default patch route as plain PyTorch: the sorted merge
that also emits per-op patch records, on the full table and inside the
frontier-bounded window.

Counterparts of ``peritext_tpu/ops/kernels.py``'s ``_sorted_text_records``,
``_sorted_def_first``, ``PATCH_GROUP_K``, ``_winner_cache_init``,
``_permute_wcache``, ``_group_topk_cols``, ``_winner_over_cand``,
``_delta_mark_scan``, ``merge_step_sorted_patched`` (its default
compact-delta mark scan; JAX's dense full-plane-carry scan gives the same
bytes and is not ported), ``merge_step_sorted_patched_batch``, ``_gather_wcache_window``,
``_scatter_wcache_window`` and ``merge_step_sorted_patched_windowed(_batch)``
(the compaction of their records is ``kernels.compact_mark_records``).  No TPU
kernel lies on this path: JAX runs it as XLA, and here it is plain torch on
whatever device the states are on.  Text placement and the window's
gather, check and scatter are ``sorted_merge``'s.

The text phase runs in O(reference depth) placement rounds; insert and
delete records follow from a timeline (each row's delivery instant, its
element's birth and death) by counting; only the batch's mark rows are
scanned, one Python step per row where JAX runs ``lax.scan``, each step
vectorized over the replica axis.  The per-slot per-type winner cache
([R, 2C, T, 4]: ctr, actor rank, action, attr; ctr = -1 empty) lets a
step resolve the op's group winner without expanding [2C, M] presence
bits; the universe threads it between ingests.

Every function takes the replica axis explicitly.  Masks are int32
bitcasts of the JAX package's uint32 words; every result is byte-equal to
the JAX function's on the same inputs, the winner cache included.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.kernels import (
    K_ACT,
    K_CTR,
    K_KIND,
    K_MATTR,
    K_MTYPE,
    K_REF_ACT,
    K_REF_CTR,
    K_RUN_LEN,
    KIND_DELETE,
    KIND_INSERT,
    KIND_INSERT_RUN,
    KIND_MARK,
    _NEG,
    _first_k_set,
    _first_match,
    _gather_clamped,
    _mask_bit,
    _slot_permutation,
    append_mark_table,
)
from peritext_tpu_torch.ops.sorted_merge import (
    _CHUNK_ELEMS,
    _batched_anchor_slots,
    _gather_rows,
    _gather_window,
    _scatter_window,
    _window_ok,
    place_text_batch,
)
from peritext_tpu_torch.ops.state import FIELDS, MASK_WORD_BITS, DocState, map_state

_TIME_BIG = 1 << 30

# Max columns of one allowMultiple resolution group (same (type, attr id):
# in practice the adds and removes of one comment id) the patched scan
# resolves exactly.  The universe checks group sizes on the host and takes
# the per-op loop when one is exceeded, so the cap never changes a result.
PATCH_GROUP_K = 32

_EMPTY_ENTRY = (-1, -1, 0, 0)


def _empty(device) -> torch.Tensor:
    return torch.tensor(_EMPTY_ENTRY, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Timeline records of the text rows
# ---------------------------------------------------------------------------


def _sorted_text_records(ec, ea, orig_idx, length, pre_deleted0, text_ops, text_time,
                         mark_time, mark_valid):
    """Per-text-row patch records from the final placement and the timeline
    (``kernels._sorted_text_records``).  Returns ``(born, died)`` [R, C],
    ``q`` (each row's target's final position), ``index0`` (the reference
    walk's visibleIndex at the row's instant), ``tvalid`` (delete
    idempotence) and ``tm`` (mark rows applied before the row's instant),
    each [R, L] int32 (``tvalid`` bool)."""
    r, c = ec.shape
    dev = ec.device
    ar = torch.arange(c, dtype=torch.int32, device=dev)
    live = ar[None, :] < length[:, None]
    pre = orig_idx >= 0
    pre_del = pre & torch.gather(pre_deleted0, 1, orig_idx.clamp(min=0).long())

    kind = text_ops[..., K_KIND]
    is_ins = (kind == KIND_INSERT) | (kind == KIND_INSERT_RUN)
    is_del = kind == KIND_DELETE
    ctr_l = text_ops[..., K_CTR]
    act_l = text_ops[..., K_ACT]
    k = torch.where(kind == KIND_INSERT_RUN, text_ops[..., K_RUN_LEN], 1) * is_ins
    t = text_time

    # born[p]: a batch-born element matches exactly one insert row; char j
    # of a run appeared at instant t + j.  Pre-batch elements: -BIG.
    e_ctr = ec[:, None, :]
    created = (
        is_ins[:, :, None]
        & (ea[:, None, :] == act_l[:, :, None])
        & (e_ctr >= ctr_l[:, :, None])
        & (e_ctr < (ctr_l + k)[:, :, None])
    )  # [R, L, C]
    born_batch = torch.where(created, t[:, :, None].long() + (e_ctr - ctr_l[:, :, None]), 0).sum(dim=1)
    born = torch.where(pre | ~created.any(dim=1), -_TIME_BIG, born_batch).to(torch.int32)

    # died[p]: first tombstoning instant (deletes are idempotent: min).
    del_match = (
        is_del[:, :, None]
        & (e_ctr == text_ops[..., K_REF_CTR, None])
        & (ea[:, None, :] == text_ops[..., K_REF_ACT, None])
    )
    died_batch = torch.where(del_match, t[:, :, None], _TIME_BIG).amin(dim=1)
    died = torch.where(pre_del, -_TIME_BIG, died_batch).to(torch.int32)

    tgt_ctr = torch.where(is_del, text_ops[..., K_REF_CTR], ctr_l)
    tgt_act = torch.where(is_del, text_ops[..., K_REF_ACT], act_l)
    tmatch = live[:, None, :] & (e_ctr == tgt_ctr[:, :, None]) & (ea[:, None, :] == tgt_act[:, :, None])
    exists = tmatch.any(dim=2)
    q = _first_match(tmatch)  # [R, L]

    # visibleIndex at the row's instant: elements final-ordered before the
    # target that had appeared and were not yet tombstoned.
    alive = live[:, None, :] & (born[:, None, :] < t[:, :, None]) & (died[:, None, :] > t[:, :, None])
    index0 = (alive & (ar[None, None, :] < q[:, :, None])).sum(dim=2).to(torch.int32)

    ql = q.long()
    tvalid = torch.where(
        is_del,
        exists & (torch.gather(born, 1, ql) < t) & (torch.gather(died, 1, ql) == t),
        is_ins,
    )
    tm = (mark_valid[:, None, :] & (mark_time[:, None, :] < t[:, :, None])).sum(dim=2).to(torch.int32)
    return born, died, q, index0, tvalid, tm


def _sorted_def_first(bnd_def0, mark_ops, ec, ea, length):
    """First-definition mark index per boundary slot
    (``kernels._sorted_def_first``): -1 for slots defined before the batch,
    else the first mark row anchoring the slot, else ``M + 1``.  [R, 2C]
    int32."""
    m_ops = mark_ops.shape[1]
    two_c = 2 * ec.shape[1]
    dev = ec.device
    midx = torch.arange(m_ops, device=dev)
    slots = torch.arange(two_c, device=dev)
    valid, s_slot, e_slot = _batched_anchor_slots(mark_ops, ec, ea, length)
    ws = (valid & (s_slot < e_slot))[:, :, None] & (slots == s_slot[:, :, None])
    we = (valid & (e_slot < two_c))[:, :, None] & (slots == e_slot[:, :, None])
    first = torch.where(ws | we, midx[None, :, None], m_ops + 1).amin(dim=1)
    return torch.where(bnd_def0, -1, first).to(torch.int32)


# ---------------------------------------------------------------------------
# Winner cache
# ---------------------------------------------------------------------------


def _winner_cache_init(bnd_mask0, mark_cols, ranks, n_types: int, multi, live_cols: int):
    """Per-slot per-type LWW winners of the boundary rows
    (``kernels._winner_cache_init``): [R, 2C, T, 4] (ctr, rank, action,
    attr; ``(-1, -1, 0, 0)`` where the slot holds no op of the type).
    Entries of allowMultiple types stay empty.

    A column wins at a slot when it is present, of a non-allowMultiple
    type, and no present column of its type has a greater (ctr, rank) key:
    one dominance product for all types, as JAX counts it.  Only the first
    ``live_cols`` columns (a multiple of 32 at least every replica's mark
    count) can carry a bit, so the product runs over those.  Its operands
    are 0/1 and its sums below 2**24, exact in float32 at any matmul
    precision, TF32 included.  The winner's column is recovered by an
    integer scatter-add of (column + 1), where JAX multiplies at
    ``Precision.HIGHEST``.  The replica axis runs in slices that keep the
    [2C, M'] presence and the [M', M'] dominance under ``_CHUNK_ELEMS``."""
    r, two_c, _ = bnd_mask0.shape
    step = max(1, _CHUNK_ELEMS // max(two_c * live_cols, live_cols * live_cols, 1))
    if step < r:
        return torch.cat([
            _winner_cache_init(bnd_mask0[lo : lo + step], tuple(c[lo : lo + step] for c in mark_cols),
                               ranks, n_types, multi, live_cols)
            for lo in range(0, r, step)
        ])
    mark_ctr, mark_act, mark_action, mark_type, mark_attr = (c[:, :live_cols] for c in mark_cols)
    dev = bnd_mask0.device
    present = K.expand_mask_bits(bnd_mask0[..., : live_cols // MASK_WORD_BITS], live_cols)
    rank = _gather_clamped(ranks, mark_act.reshape(-1)).reshape(r, live_cols)
    type_c = mark_type.clamp(0, n_types - 1).long()
    nm_col = ~multi[type_c]  # [R, M']

    same_type = mark_type[:, :, None] == mark_type[:, None, :]
    key_gt = (mark_ctr[:, None, :] > mark_ctr[:, :, None]) | (
        (mark_ctr[:, None, :] == mark_ctr[:, :, None]) & (rank[:, None, :] > rank[:, :, None])
    )  # [R, i, j]: j's key above i's
    dom = same_type & key_gt & nm_col[:, :, None] & nm_col[:, None, :]
    # dom_count[p, n] = present dominators of column n at slot p.
    dom_count = torch.bmm(present.to(torch.float32), dom.transpose(1, 2).to(torch.float32))
    win = present & nm_col[:, None, :] & (dom_count < 0.5)

    col_plus1 = torch.arange(1, live_cols + 1, device=dev)
    widx = torch.zeros((r, two_c, n_types), dtype=torch.int64, device=dev)
    widx.scatter_add_(
        2, type_c[:, None, :].expand(r, two_c, live_cols), win.long() * col_plus1
    )
    widx = widx - 1  # [R, 2C, T]: winner column, -1 when none
    has = widx >= 0
    wc = widx.clamp(min=0).reshape(r, -1)
    vals = torch.stack(
        [torch.gather(col, 1, wc).reshape(r, two_c, n_types) for col in (mark_ctr, rank, mark_action, mark_attr)],
        dim=-1,
    )
    return torch.where(has[..., None], vals, _empty(dev)).to(torch.int32)


def _permute_wcache(wcache, orig_idx):
    """Re-align a [R, 2C, T, 4] winner cache after a text phase
    (``kernels._permute_wcache``): batch-born elements' slots come up
    empty."""
    valid, flat_src = _slot_permutation(orig_idx)
    return torch.where(valid[:, :, None, None], _gather_rows(wcache, flat_src), _empty(wcache.device))


def _group_topk_cols(mark_type_col, mark_attr_col, op, k: int):
    """Up to ``k`` table columns of each replica's op's (type, attr) group
    (``kernels._group_topk_cols``), ascending, with validity.  JAX takes
    ``lax.top_k`` of the match flags, whose ties break to the lower index:
    the valid lanes are the same columns in the same order, and invalid
    lanes are masked by every consumer."""
    match = (mark_type_col == op[:, K_MTYPE, None]) & (mark_attr_col == op[:, K_MATTR, None])
    cols, ok, _ = _first_k_set(match, min(k, match.shape[1]))
    return cols, ok


def _winner_over_cand(cand, g_ctr, g_rank, g_action, g_attr):
    """LWW winner per row among candidate columns (``kernels.
    _winner_over_cand``): ``cand`` [R, N, K] with per-column values
    [R, K].  Returns ``(ctr, rank, action, attr, has)`` [R, N]."""
    ctrs = torch.where(cand, g_ctr[:, None, :], _NEG)
    max_ctr = ctrs.amax(dim=2)
    tie = cand & (g_ctr[:, None, :] == max_ctr[:, :, None])
    max_rank = torch.where(tie, g_rank[:, None, :], _NEG).amax(dim=2)
    win = tie & (g_rank[:, None, :] == max_rank[:, :, None])
    has = cand.any(dim=2)
    w_action = torch.where(win, g_action[:, None, :], 0).sum(dim=2).to(torch.int32)
    w_attr = torch.where(win, g_attr[:, None, :], 0).sum(dim=2).to(torch.int32)
    return torch.where(has, max_ctr, -1), torch.where(has, max_rank, -1), w_action, w_attr, has


def _cols_values(cols, mark_cols, rank_f):
    """Per-column (ctr, rank, action, attr) of the columns ``cols`` [R, K]."""
    mark_ctr, _, mark_action, _, mark_attr = mark_cols
    return tuple(torch.gather(c, 1, cols) for c in (mark_ctr, rank_f, mark_action, mark_attr))


def _lww(a, b):
    """Entrywise pick of ``b`` where it beats ``a`` on (ctr, rank)."""
    pick = (b[..., 0] > a[..., 0]) | ((b[..., 0] == a[..., 0]) & (b[..., 1] > a[..., 1]))
    return torch.where(pick[..., None], b, a)


def _walk_signals_batch(s_slots, e_slots, defined_all, visible_all):
    """``kernels._walk_signals`` over every mark row at once: written,
    during, visibleIndex [R, M, 2C] and the visible length [R, M]."""
    r, m, two_c = defined_all.shape
    out = K._walk_signals(
        (s_slots.reshape(-1), e_slots.reshape(-1), defined_all.reshape(r * m, two_c)),
        visible_all.reshape(r * m, -1),
    )
    return tuple(x.reshape(r, m, *x.shape[1:]) for x in out)


# ---------------------------------------------------------------------------
# The mark-row scans
# ---------------------------------------------------------------------------


def _delta_mark_scan(bnd_mask_base, wcache0, mark_ops, mark_time, mcols_final, ec, ea, length,
                     born, died, def_first, src_ok, src_c, tm, mark_count0, ranks, multi,
                     group_k: int, has_multi: bool, t_act: int, perm=None):
    """The compact-delta mark-row scan (``kernels._delta_mark_scan``, the
    default patched route).  Emits every mark row's records and the final
    planes, but carries only the batch's composition state:

    - ``root_src`` [R, 2C]: which slot's pre-batch row is the full-width
      base of each slot's current row (-1: a zero row);
    - ``win_bits`` [R, 2C, w_act]: the active word window of every row,
      the only words the batch's new bits land in;
    - ``bw`` [R, t_act, 2C]: the winning batch column per (type, slot)
      among the batch's non-allowMultiple ops so far (-1: none), composed
      against the untouched base cache by (ctr, rank) max;
    - ``acc_root`` / ``acc_win``: the insert rows' inherited rows, taken at
      their instants.

    The full [R, 2C, W] plane and [R, 2C, T, 4] cache are read through
    composed gathers and written once, after the scan.  With ``perm`` (the
    text phase's slot permutation) both are the raw pre-splice planes and
    the permutation composes into every read.  Returns ``(bnd_def,
    bnd_mask, ins_mask, mark records, wcache)``."""
    mark_ctr_f, mark_act_f, mark_action_f, mark_type_f, mark_attr_f = mcols_final
    r, c = ec.shape
    dev = ec.device
    two_c = 2 * c
    m_ops = mark_ops.shape[1]
    w_words = bnd_mask_base.shape[-1]
    n_lt = src_c.shape[1]
    mcap = mark_ctr_f.shape[1]
    rows_r = torch.arange(r, device=dev)
    slots = torch.arange(two_c, device=dev)
    empty = _empty(dev)
    type_ar = torch.arange(t_act, device=dev)
    rank_f = _gather_clamped(ranks, mark_act_f.reshape(-1)).reshape(r, mcap)

    valid, s_slots, e_slots = _batched_anchor_slots(mark_ops, ec, ea, length)
    m_idx0 = torch.arange(m_ops, device=dev)
    w_act = min((m_ops + MASK_WORD_BITS - 1) // MASK_WORD_BITS + 1, w_words)
    w0 = (mark_count0.long() // MASK_WORD_BITS).clamp(0, w_words - w_act)
    word_ar = torch.arange(w_act, device=dev)
    bit_off = mark_count0.long()[:, None] + m_idx0 - w0[:, None] * MASK_WORD_BITS  # [R, M]
    op_rank_v = _gather_clamped(ranks, mark_ops[..., K_ACT].reshape(-1)).reshape(r, m_ops)
    tau_v = mark_ops[..., K_MTYPE].clamp(0, t_act - 1).long()
    is_multi_v = multi[tau_v]

    if perm is not None:
        pvalid, pflat = perm

        def src_of(idx, ok):
            return torch.gather(pflat, 1, idx), ok & torch.gather(pvalid, 1, idx)
    else:

        def src_of(idx, ok):
            return idx, ok

    def base_rows(idx, ok):  # [R, N] slots -> full-width base rows [R, N, W]
        src, okc = src_of(idx, ok)
        return torch.where(okc[:, :, None], _gather_rows(bnd_mask_base, src), 0)

    def base_words(idx, ok, words):  # [R, N] slots x [R, K] words -> [R, N, K]
        src, okc = src_of(idx, ok)
        n, k = idx.shape[1], words.shape[1]
        flat_idx = (src[:, :, None] * w_words + words[:, None, :]).reshape(r, n * k)
        vals = torch.gather(bnd_mask_base.reshape(r, -1), 1, flat_idx).reshape(r, n, k)
        return torch.where(okc[:, :, None], vals, 0)

    def base_wc_rows(idx, ok):  # slots -> [R, N, T, 4] base cache rows
        src, okc = src_of(idx, ok)
        return torch.where(okc[:, :, None, None], _gather_rows(wcache0, src), empty)

    def base_wc_tau(idx, ok, tau):  # slots -> [R, N, 4] entries at type tau [R]
        src, okc = src_of(idx, ok)
        return torch.where(okc[:, :, None], _gather_rows(wcache0[rows_r, :, tau], src), empty)

    # Carry-independent signals, over the op axis at once.
    defined_all = def_first[:, None, :] < m_idx0[None, :, None]  # [R, M, 2C]
    live_c = torch.arange(c, device=dev)[None, :] < length[:, None]
    visible_all = (
        live_c[:, None, :]
        & (born[:, None, :] < mark_time[:, :, None])
        & (died[:, None, :] > mark_time[:, :, None])
    )
    written_all, during_all, vis_all, final_vis_all = _walk_signals_batch(
        s_slots, e_slots, defined_all, visible_all
    )
    src_q_all = torch.cummax(torch.where(defined_all, slots, -1), dim=2).values

    def compose_rows(root, win_rows):
        """(root pointer [R, N], window words [R, N, w_act]) -> full rows."""
        base = base_rows(root.clamp(min=0), root >= 0)
        words = (w0[:, None] + word_ar)[:, None, :].expand(r, root.shape[1], w_act)
        return base.scatter(2, words, win_rows)

    def bw_entry(colv):
        """Batch-winner columns -> (ctr, rank, action, attr) entries, empty
        where there is no batch winner."""
        shape = colv.shape
        ok = (colv >= 0).reshape(r, -1)
        cc = colv.clamp(0, mcap - 1).reshape(r, -1).long()
        parts = [
            torch.where(ok, torch.gather(col, 1, cc), fill)
            for col, fill in ((mark_ctr_f, -1), (rank_f, -1), (mark_action_f, 0), (mark_attr_f, 0))
        ]
        return torch.stack(parts, dim=-1).reshape(*shape, 4)

    root_src = slots.expand(r, two_c).clone()
    win_bits = base_words(root_src, torch.ones_like(root_src, dtype=torch.bool), w0[:, None] + word_ar)
    bw = torch.full((r, t_act, two_c), -1, dtype=torch.int32, device=dev)
    acc_root = torch.full((r, n_lt), -1, dtype=torch.int64, device=dev)
    acc_win = torch.zeros((r, n_lt, w_act), dtype=torch.int32, device=dev)
    k_group = min(group_k, mcap)
    changed_rows = []
    for m in range(m_ops):
        op = mark_ops[:, m]
        bo = bit_off[:, m]
        wb = bo // MASK_WORD_BITS
        bit_u = _mask_bit(bo)
        defined = defined_all[:, m]

        # Inserts whose instant lands at this plane version take their
        # inherited row before this mark writes.
        take = src_ok & (tm == m)
        acc_root = torch.where(take, torch.gather(root_src, 1, src_c), acc_root)
        acc_win = torch.where(take[:, :, None], _gather_rows(win_bits, src_c), acc_win)

        # `changed`: the op's group winner within the inherited set at each
        # slot's carry source: the base cache at the source's root, LWW'd
        # against the carried batch-winner column.
        src_q = src_q_all[:, m]
        q_ok = src_q >= 0
        qc = src_q.clamp(min=0)
        rootq = torch.where(q_ok, torch.gather(root_src, 1, qc), -1)
        rq_ok = rootq >= 0
        rqc = rootq.clamp(min=0)
        tau = tau_v[:, m]
        bw_tau = bw[rows_r, tau]  # [R, 2C]
        wnm = _lww(
            base_wc_tau(rqc, rq_ok, tau),
            bw_entry(torch.where(q_ok, torch.gather(bw_tau, 1, qc), -1)),
        )
        w_ctr, w_rank, w_action, w_attr = wnm.unbind(-1)
        has_winner = w_ctr >= 0
        is_mop = is_multi_v[:, m]

        if has_multi:
            # allowMultiple groups resolve over their host-sized compacted
            # columns; presence composes window words from the carry with
            # the other words from the base plane at the row's root.
            cols, col_ok = _group_topk_cols(mark_type_f, mark_attr_f, op, k_group)
            words = cols // MASK_WORD_BITS
            bits = (cols % MASK_WORD_BITS).to(torch.int32)
            in_win = (words >= w0[:, None]) & (words < (w0 + w_act)[:, None])
            win_part = torch.gather(
                _gather_rows(win_bits, qc), 2,
                (words - w0[:, None]).clamp(0, w_act - 1)[:, None, :].expand(r, two_c, k_group),
            )
            word_val = torch.where(
                q_ok[:, :, None],
                torch.where(in_win[:, None, :], win_part, base_words(rqc, rq_ok, words)),
                0,
            )
            pres = ((word_val >> bits[:, None, :]) & 1).to(torch.bool)
            g = _winner_over_cand(pres & col_ok[:, None, :], *_cols_values(cols, mcols_final, rank_f))
            mop = is_mop[:, None]
            w_ctr, w_rank, w_action, w_attr, has_winner = (
                torch.where(mop, gv, wv)
                for gv, wv in zip(g, (w_ctr, w_rank, w_action, w_attr, has_winner))
            )

        op_rank = op_rank_v[:, m]
        changed = K._changed_vs_winner(op, op_rank, w_ctr, w_rank, w_action, w_attr, has_winner)

        # Apply the op to the carry; every write value reads the carry as
        # it was at the step's start.
        s_sl, e_sl, val = s_slots[:, m], e_slots[:, m], valid[:, m]
        write_s = val & (s_sl < e_sl)
        write_e = val & (e_sl < two_c)
        e_cl = e_sl.clamp(max=two_c - 1)
        q_s = torch.gather(src_q, 1, s_sl[:, None])[:, 0]
        q_e = torch.gather(src_q, 1, e_cl[:, None])[:, 0]
        qs_c, qe_c = q_s.clamp(min=0), q_e.clamp(min=0)
        root_s_v = torch.where(q_s >= 0, root_src[rows_r, qs_c], -1)
        root_e_v = torch.where(q_e >= 0, root_src[rows_r, qe_c], -1)
        win_row_s = torch.where((q_s >= 0)[:, None], win_bits[rows_r, qs_c], 0)
        win_row_e = torch.where((q_e >= 0)[:, None], win_bits[rows_r, qe_c], 0)
        col_s = torch.where((q_s >= 0)[:, None], bw[rows_r, :, qs_c], -1)  # [R, t_act]
        col_e = torch.where((q_e >= 0)[:, None], bw[rows_r, :, qe_c], -1)
        one_s = (slots == s_sl[:, None]) & write_s[:, None]
        one_e = (slots == e_cl[:, None]) & write_e[:, None]
        inr_def = during_all[:, m] & defined & val[:, None]

        # Window words: the in-range bit OR, then the two anchor rebases.
        bit_at = inr_def[:, :, None] & (word_ar == wb[:, None])[:, None, :]
        win_bits = torch.where(bit_at, win_bits | bit_u[:, None, None], win_bits)
        bit_row = torch.where(word_ar == wb[:, None], bit_u[:, None], 0)
        win_bits = torch.where(one_s[:, :, None], (win_row_s | bit_row)[:, None, :], win_bits)
        win_bits = torch.where(one_e[:, :, None], win_row_e[:, None, :], win_bits)
        root_src = torch.where(one_s, root_s_v[:, None], root_src)
        root_src = torch.where(one_e, root_e_v[:, None], root_src)

        # Batch-winner table: the op's column over in-range defined slots
        # where it beats the batch winner (non-allowMultiple only), then
        # the two anchor-column rebases.
        cur = bw_entry(bw_tau)
        op_ctr = op[:, K_CTR]
        beats = (bw_tau < 0) | (op_ctr[:, None] > cur[..., 0]) | (
            (op_ctr[:, None] == cur[..., 0]) & (op_rank[:, None] > cur[..., 1])
        )
        tau_oh = type_ar[None, :] == tau[:, None]  # [R, t_act]
        upd_inr = inr_def & ~is_mop[:, None] & beats
        op_col = (mark_count0 + m).to(torch.int32)
        bw = torch.where(upd_inr[:, None, :] & tau_oh[:, :, None], op_col[:, None, None], bw)
        cs_tau = torch.gather(col_s, 1, tau[:, None])[:, 0]
        cs = bw_entry(cs_tau[:, None])[:, 0]
        s_beats = (cs_tau < 0) | (op_ctr > cs[:, 0]) | ((op_ctr == cs[:, 0]) & (op_rank > cs[:, 1]))
        new_col = torch.where(~is_mop & s_beats, op_col, cs_tau)
        col_s = torch.where(tau_oh, new_col[:, None], col_s)
        bw = torch.where(one_s[:, None, :], col_s[:, :, None], bw)
        bw = torch.where(one_e[:, None, :], col_e[:, :, None], bw)
        changed_rows.append(changed & val[:, None])

    changed_all = (
        torch.stack(changed_rows, dim=1) if changed_rows
        else torch.zeros((r, 0, two_c), dtype=torch.bool, device=dev)
    )
    mrec = {
        "written": written_all & valid[:, :, None],
        "during": during_all & valid[:, :, None],
        "changed": changed_all,
        "vis": vis_all,
        "obj_len": final_vis_all,
    }
    # Inserts after every mark instant read the final composition.
    take_f = src_ok & (tm == m_ops)
    acc_root = torch.where(take_f, torch.gather(root_src, 1, src_c), acc_root)
    acc_win = torch.where(take_f[:, :, None], _gather_rows(win_bits, src_c), acc_win)
    ins_mask = compose_rows(acc_root, acc_win)

    new_mask = compose_rows(root_src, win_bits)
    new_def = def_first <= m_ops
    base_wc = base_wc_rows(root_src.clamp(min=0), root_src >= 0)
    bw_vals = bw_entry(bw).transpose(1, 2)  # [R, 2C, t_act, 4]
    wcache_f = torch.cat([_lww(base_wc[:, :, :t_act], bw_vals), base_wc[:, :, t_act:]], dim=2)
    return new_def, new_mask, ins_mask, mrec, wcache_f


# ---------------------------------------------------------------------------
# The patched sorted merge
# ---------------------------------------------------------------------------


def _finish_records(records, cand_def, readback: str, span_cap: int, cand_cap: int,
                    vis_base=None, vis_after=None):
    """Re-anchor window-local coordinates (``vis_base``/``vis_after``,
    before any compaction) and, for the compact readback, reduce the mark
    planes to run tables and drop what the host already holds."""
    if vis_base is not None:
        vb, va = vis_base.to(torch.int32), vis_after.to(torch.int32)
        records = dict(records)
        records["index0"] = records["index0"] + vb[:, None]
        records["vis"] = records["vis"] + vb[:, None, None]
        records["obj_len"] = records["obj_len"] + (vb + va)[:, None]
    if readback != "compact":
        return records
    written = records["written"]
    r, m_pad = written.shape[:2]
    if cand_def is None:
        # No mark rows anywhere: the run tables are empty.
        z = torch.zeros((r, m_pad, span_cap), dtype=torch.int32, device=written.device)
        run_start, run_end = z, z.clone()
        count = torch.zeros((r, m_pad), dtype=torch.int32, device=written.device)
    else:
        run_start, run_end, count = K.compact_mark_records(
            written, records["during"], records["changed"], records["vis"], records["obj_len"],
            span_cap, cand_def=cand_def, cand_cap=cand_cap,
        )
    out = {
        "tvalid": records["tvalid"], "index0": records["index0"], "ins_mask": records["ins_mask"],
        "mstart": run_start, "mend": run_end, "mcount": count,
    }
    if "wcache" in records:
        out["wcache"] = records["wcache"]
    return out


def merge_step_sorted_patched(states: DocState, text_ops, round_of, num_rounds: int, mark_ops,
                              ranks, char_buf, multi, text_time, mark_time, maxk: int,
                              has_marks: bool = True, wcache_in=None,
                              group_k: Optional[int] = None, has_multi: bool = True,
                              t_act: Optional[int] = None, readback: str = "planes",
                              span_cap: int = 8, cand_cap: int = 64, vis_base=None,
                              vis_after=None) -> Tuple[DocState, Dict[str, torch.Tensor]]:
    """The sorted merge with per-op patch records (``kernels.
    merge_step_sorted_patched``, one replica slice at a time): placement
    rounds for text, analytic insert/delete records, and a scan over the
    mark rows only.  ``text_time`` / ``mark_time`` [R, L] / [R, M] are
    each row's delivery-stream position (``TIME_PAD`` on padding).

    ``wcache_in`` ([R, 2C, T, 4], pre-placement coordinates) is the
    persisted winner cache; without it the marked path initializes one.
    The records carry ``wcache`` (post-batch coordinates) except on the
    cacheless mark-free path.  ``readback`` is ``"planes"`` (``kind``,
    ``tvalid``, ``index0``, ``ins_mask``, the [R, M, 2C] planes
    ``written``/``during``/``changed``/``vis`` and ``obj_len``) or
    ``"compact"`` (``tvalid``, ``index0``, ``ins_mask`` and the run tables
    ``mstart``/``mend``/``mcount``).  ``vis_base``/``vis_after`` [R]
    re-anchor window-local records to the document's coordinates.  Every
    output is freshly allocated."""
    r, c = states.elem_ctr.shape
    dev = states.elem_ctr.device
    ec, ea, dl, ch, oi, length = place_text_batch(
        states.elem_ctr, states.elem_act, states.deleted, states.chars, states.length,
        text_ops, round_of, num_rounds, ranks, char_buf, maxk,
    )
    pvalid, pflat = _slot_permutation(oi)
    bnd_def0 = torch.gather(states.bnd_def, 1, pflat) & pvalid
    delta_composed = has_marks and wcache_in is not None
    bnd_mask0 = (
        None if delta_composed
        else torch.where(pvalid[:, :, None], _gather_rows(states.bnd_mask, pflat), 0)
    )
    mark_valid = mark_ops[..., K_KIND] == KIND_MARK
    born, died, q, index0, tvalid, tm = _sorted_text_records(
        ec, ea, oi, length, states.deleted, text_ops, text_time, mark_time, mark_valid
    )

    # Inherited-marks source per insert row (getActiveMarksAtIndex,
    # peritext.ts:328-330): the nearest slot left of the insertion gap
    # defined at the row's instant.
    slots = torch.arange(2 * c, device=dev)
    def_first = _sorted_def_first(bnd_def0, mark_ops, ec, ea, length)
    kind_t = text_ops[..., K_KIND]
    is_ins = (kind_t == KIND_INSERT) | (kind_t == KIND_INSERT_RUN)
    src = torch.where(
        (def_first[:, None, :] < tm[:, :, None]) & (slots < 2 * q[:, :, None].long()), slots, -1
    ).amax(dim=2)
    src_ok = (src >= 0) & is_ins
    src_c = src.clamp(min=0)

    # The mark table is appended up front: the scan resolves winners
    # against the final columns.
    table = append_mark_table(states, mark_ops)
    mcols_final = (table.mark_ctr, table.mark_act, table.mark_action, table.mark_type, table.mark_attr)
    n_types = multi.shape[0]

    def new_state(bnd_def, bnd_mask):
        return DocState(
            elem_ctr=ec, elem_act=ea, deleted=dl, chars=ch, bnd_def=bnd_def, bnd_mask=bnd_mask,
            mark_ctr=table.mark_ctr, mark_act=table.mark_act, mark_action=table.mark_action,
            mark_type=table.mark_type, mark_attr=table.mark_attr, length=length,
            mark_count=table.mark_count,
        )

    finish = dict(readback=readback, span_cap=span_cap, cand_cap=cand_cap,
                  vis_base=vis_base, vis_after=vis_after)
    if not has_marks:
        # No mark row in the batch: the boundary planes never evolve, so
        # inserts inherit straight from the permuted planes.
        m_pad = mark_ops.shape[1]
        ins_mask = torch.where(src_ok[:, :, None], _gather_rows(bnd_mask0, src_c), 0)
        zeros = torch.zeros((r, m_pad, 2 * c), dtype=torch.bool, device=dev)
        records = {
            "kind": kind_t, "tvalid": tvalid, "index0": index0, "ins_mask": ins_mask,
            "written": zeros, "during": zeros.clone(), "changed": zeros.clone(),
            "vis": torch.zeros((r, m_pad, 2 * c), dtype=torch.int32, device=dev),
            "obj_len": torch.zeros((r, m_pad), dtype=torch.int32, device=dev),
        }
        if wcache_in is not None:
            records["wcache"] = _permute_wcache(wcache_in, oi)
        return new_state(bnd_def0, bnd_mask0), _finish_records(records, None, **finish)

    if delta_composed:
        wcache0 = wcache_in
    elif wcache_in is not None:
        wcache0 = _permute_wcache(wcache_in, oi)
    else:
        live_cols = min(
            states.max_mark_ops,
            -(-max(int(table.mark_count.max()), 1) // MASK_WORD_BITS) * MASK_WORD_BITS,
        )
        wcache0 = _winner_cache_init(bnd_mask0, mcols_final, ranks, n_types, multi, live_cols)

    bnd_def, bnd_mask, ins_mask, mrec, wcache_f = _delta_mark_scan(
        states.bnd_mask if delta_composed else bnd_mask0, wcache0, mark_ops, mark_time,
        mcols_final, ec, ea, length, born, died, def_first, src_ok, src_c, tm,
        states.mark_count, ranks, multi,
        group_k if group_k is not None else PATCH_GROUP_K, has_multi,
        t_act if t_act is not None else n_types,
        perm=(pvalid, pflat) if delta_composed else None,
    )
    records = {"kind": kind_t, "tvalid": tvalid, "index0": index0, "ins_mask": ins_mask,
               **mrec, "wcache": wcache_f}
    return new_state(bnd_def, bnd_mask), _finish_records(records, bnd_def, **finish)


def _patched_replica_step(capacity: int, words: int, n_types: int, n_text: int, n_mark: int,
                          maxk: int) -> int:
    """Replicas per slice so each per-replica transient of the patched
    merge (the sorted merge's, the [L, C] / [L, 2C] timeline planes, the
    [M, 2C] mark records and the [2C, T, 4] winner-cache gathers) stays
    under ``_CHUNK_ELEMS`` elements; the cold cache init slices itself."""
    per = max(
        n_text * n_text, capacity + n_text * maxk, 2 * capacity * words, n_mark * n_mark,
        2 * capacity * max(n_text, n_mark, 1), 2 * capacity * n_types * 4, 1,
    )
    return max(1, _CHUNK_ELEMS // per)


def patched_replica_step(states: DocState, text_ops, mark_ops, multi, maxk: int) -> int:
    """Replicas per slice of a full-table patched merge of this batch."""
    return _patched_replica_step(
        states.capacity, states.bnd_mask.shape[-1], multi.shape[0], text_ops.shape[1],
        mark_ops.shape[1], maxk,
    )


def _check_readback(readback: str) -> None:
    if readback not in ("planes", "compact"):
        raise ValueError(f"unknown patch readback format {readback!r}")


def _cat_records(recs):
    return {k: torch.cat([rec[k] for rec in recs]) for k in recs[0]}


def _cat_states(outs):
    return DocState(**{f: torch.cat([getattr(o, f) for o in outs]) for f in FIELDS})


def merge_step_sorted_patched_batch(states, text_ops, round_of, num_rounds: int, mark_ops, ranks,
                                    char_buf, multi, text_time, mark_time, maxk: int,
                                    has_marks: bool = True, wcache_in=None,
                                    group_k: Optional[int] = None, has_multi: bool = True,
                                    t_act: Optional[int] = None, readback: str = "planes",
                                    span_cap: int = 8, cand_cap: int = 64):
    """The patched sorted merge over a replica batch (``kernels.
    merge_step_sorted_patched_batch``): the replica axis runs in slices
    that keep every transient under ``_CHUNK_ELEMS`` elements; replicas
    are independent, so the slicing changes no result."""
    _check_readback(readback)
    r = text_ops.shape[0]
    step = patched_replica_step(states, text_ops, mark_ops, multi, maxk)
    kw = dict(has_marks=has_marks, group_k=group_k, has_multi=has_multi, t_act=t_act,
              readback=readback, span_cap=span_cap, cand_cap=cand_cap)
    if step >= r:
        return merge_step_sorted_patched(
            states, text_ops, round_of, num_rounds, mark_ops, ranks, char_buf, multi, text_time,
            mark_time, maxk, wcache_in=wcache_in, **kw,
        )
    outs, recs = [], []
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        st, rec = merge_step_sorted_patched(
            map_state(lambda x: x[sl], states), text_ops[sl], round_of[sl], num_rounds,
            mark_ops[sl], ranks, char_buf[sl], multi, text_time[sl], mark_time[sl], maxk,
            wcache_in=None if wcache_in is None else wcache_in[sl], **kw,
        )
        outs.append(st)
        recs.append(rec)
    return _cat_states(outs), _cat_records(recs)


# ---------------------------------------------------------------------------
# The windowed form
# ---------------------------------------------------------------------------


def _gather_wcache_window(wcache, starts, w_cap: int):
    """Each replica's window rows of the cache [R, 2 w_cap, T, 4]; the start
    clamps into range, as ``lax.dynamic_slice`` clamps it."""
    two_c = wcache.shape[1]
    s = (2 * starts.long()).clamp(0, two_c - 2 * w_cap)[:, None]
    return _gather_rows(wcache, s + torch.arange(2 * w_cap, device=wcache.device))


def _scatter_wcache_window(wcache, win_rows, starts, hull_len, win_len, old_len):
    """Splice updated window rows back into the full cache
    (``kernels._scatter_wcache_window``): the shift rule of
    ``_scatter_window``, and rows at or past the new length empty."""
    two_c = wcache.shape[1]
    w2 = win_rows.shape[1]
    dev = wcache.device
    start = starts.long()[:, None]
    shift = (win_len.long() - hull_len.long())[:, None]
    new_n2 = 2 * (old_len.long()[:, None] + shift)
    ar2 = torch.arange(two_c, device=dev)[None, :]
    in_win = (ar2 >= 2 * start) & (ar2 < 2 * start + 2 * win_len.long()[:, None])
    win_idx = (ar2 - 2 * start).clamp(0, w2 - 1)
    old_idx = torch.where(ar2 < 2 * start, ar2, ar2 - 2 * shift).clamp(0, two_c - 1)
    v = torch.where(in_win[:, :, None, None], _gather_rows(win_rows, win_idx), _gather_rows(wcache, old_idx))
    return torch.where((ar2 < new_n2)[:, :, None, None], v, _empty(dev))


def merge_step_sorted_patched_windowed_batch(states, starts, hull_lens, vis_base, vis_after,
                                             text_ops, round_of, num_rounds: int, mark_ops, ranks,
                                             char_buf, multi, text_time, mark_time, maxk: int,
                                             w_cap: int, has_marks: bool = True, wcache_in=None,
                                             group_k: Optional[int] = None,
                                             has_multi: bool = True, t_act: Optional[int] = None,
                                             readback: str = "planes", span_cap: int = 8,
                                             cand_cap: int = 64):
    """The patched sorted merge over each replica's gathered window,
    scattered back (``kernels.merge_step_sorted_patched_windowed_batch``).
    Records come out in the document's visible coordinates; ``wcache_in``
    is the full persisted cache, whose window rows ride the merge and
    scatter back (a cold windowed merge returns no cache).  The records
    also carry ``wok`` [R] (the device census verdict; where it is False
    the result must be discarded) and the merged windows ``w_ctr``,
    ``w_act``, ``w_del``, ``w_def`` for the universe's mirror.

    The replica axis runs in slices, each taken whole through gather,
    check, merge and scatter, sized so the window's transients and the
    scatter's full-capacity planes stay under ``_CHUNK_ELEMS``."""
    _check_readback(readback)
    r = text_ops.shape[0]
    words = states.bnd_mask.shape[-1]
    n_types = multi.shape[0]
    # The scatter's full-capacity planes: the mask, and the cache when warm.
    full_width = max(words, 0 if wcache_in is None else n_types * 4)
    step = min(
        _patched_replica_step(w_cap, words, n_types, text_ops.shape[1], mark_ops.shape[1], maxk),
        max(1, _CHUNK_ELEMS // (2 * states.capacity * full_width)),
    )
    kw = dict(has_marks=has_marks, group_k=group_k, has_multi=has_multi, t_act=t_act,
              readback=readback, span_cap=span_cap, cand_cap=cand_cap)
    outs, recs = [], []
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        st = states if step >= r else map_state(lambda x: x[sl], states)
        wc_full = None if wcache_in is None else wcache_in[sl]
        win0 = _gather_window(st, starts[sl], hull_lens[sl], w_cap)
        wok = _window_ok(win0, text_ops[sl], mark_ops[sl], w_cap)
        wc_win = None if wc_full is None else _gather_wcache_window(wc_full, starts[sl], w_cap)
        new_win, rec = merge_step_sorted_patched(
            win0, text_ops[sl], round_of[sl], num_rounds, mark_ops[sl], ranks, char_buf[sl],
            multi, text_time[sl], mark_time[sl], maxk, wcache_in=wc_win,
            vis_base=vis_base[sl], vis_after=vis_after[sl], **kw,
        )
        outs.append(_scatter_window(st, new_win, starts[sl], hull_lens[sl]))
        wc = rec.pop("wcache", None)
        if wc_full is not None and wc is not None:
            rec["wcache"] = _scatter_wcache_window(
                wc_full, wc, starts[sl], hull_lens[sl], new_win.length, st.length
            )
        rec.update(wok=wok, w_ctr=new_win.elem_ctr, w_act=new_win.elem_act,
                   w_del=new_win.deleted, w_def=new_win.bnd_def)
        recs.append(rec)
    if len(outs) == 1:
        return outs[0], recs[0]
    return _cat_states(outs), _cat_records(recs)
