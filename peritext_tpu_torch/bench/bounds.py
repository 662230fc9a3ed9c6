"""The least time an NVIDIA H100 SXM could take for a kernel's work: the
larger of its bytes over the HBM3 rate and its operations over the
CUDA-core rate (data sheet figures; the kernels use no tensor cores).

Bytes count what the function must move on this input: each input it
needs read once, each output written once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from peritext_tpu_torch.ops import kernels as K

HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, ops: int) -> Tuple[float, str]:
    """``(ms, "bytes" or "operations")``, whichever bounds."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def text_phase_bytes(elem_ctr, elem_act, deleted, chars, length, text_ops, ranks,
                     char_buf=None) -> int:
    """Bytes the text phase must move: the four planes, ``length`` and the
    ranks in, the five planes and ``length`` out, and of each op row only
    the fields its kind reads -- a pad its kind (4 B); a delete its kind
    and target (12 B); an insert its kind, id, reference and char (24 B); a
    run that and its length (28 B) plus its chars from ``char_buf`` (up to
    MAX_RUN_LEN); without a ``char_buf`` a run row is a no-op (4 B)."""
    kind = text_ops[:, :, K.K_KIND]
    field_bytes = torch.full_like(kind, 4)
    field_bytes[kind == K.KIND_DELETE] = 12
    field_bytes[kind == K.KIND_INSERT] = 24
    if char_buf is not None:
        runs = kind == K.KIND_INSERT_RUN
        run_chars = text_ops[:, :, K.K_RUN_LEN].clamp(0, K.MAX_RUN_LEN)
        field_bytes = torch.where(runs, 28 + 4 * run_chars, field_bytes)
    planes = nbytes(elem_ctr, elem_act, deleted, chars)
    # Out: ec, ea, chars and orig_idx as int32, deleted as bool, length.
    out = nbytes(elem_ctr, elem_act, chars, elem_ctr, deleted, length)
    return planes + nbytes(length, ranks) + int(field_bytes.sum().item()) + out


def merge_step_full_bytes(st, text_ops, mark_ops, ranks, char_buf=None) -> int:
    """Bytes ``merge_step_full`` must move as one function: the state in
    once and out once, the op rows as :func:`text_phase_bytes` counts them
    and the mark rows in once -- the text kernel's bytes less its
    orig-index plane (it never leaves the function), ``bnd_def`` and
    ``bnd_mask`` in and out, and the five table columns and
    ``mark_count`` in and out."""
    text = text_phase_bytes(st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, text_ops, ranks,
                            char_buf) - nbytes(st.elem_ctr)
    planes = nbytes(st.bnd_def, st.bnd_mask)
    table = nbytes(st.mark_ctr, st.mark_act, st.mark_action, st.mark_type, st.mark_attr, st.mark_count)
    return text + 2 * planes + 2 * table + nbytes(mark_ops)


def mark_tail_bytes(st, elem_ctr, elem_act, orig_idx, length, mark_ops) -> int:
    """Bytes the merge's tail (``cuda_kernels.mark_tail``) must move: the
    boundary planes as they were before the text phase, its ``elem_ctr``,
    ``elem_act``, ``orig_idx`` and ``length``, the mark rows, the five table
    columns and ``mark_count`` in; both planes, the columns and
    ``mark_count`` out."""
    planes = nbytes(st.bnd_def, st.bnd_mask)
    table = nbytes(st.mark_ctr, st.mark_act, st.mark_action, st.mark_type, st.mark_attr, st.mark_count)
    return planes + nbytes(elem_ctr, elem_act, orig_idx, length, mark_ops) + table + planes + table


def merge_step_stage_bytes(st, text_ops, mark_ops, ranks, char_buf=None) -> int:
    """The bytes ``merge_step_full``'s two launches move as they run: the
    text kernel's (:func:`text_phase_bytes`, its orig-index plane out) and
    the tail's (:func:`mark_tail_bytes` on the text kernel's outputs).
    Above :func:`merge_step_full_bytes` by the orig-index plane out and in
    and the tail's reads of the new ``elem_ctr``, ``elem_act`` and
    ``length``."""
    text = text_phase_bytes(st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, text_ops, ranks,
                            char_buf)
    return text + mark_tail_bytes(st, st.elem_ctr, st.elem_act, st.elem_ctr, st.length, mark_ops)


def convergence_digest_bytes(st, ranks, multi) -> int:
    """Bytes the digest must read on this input, and its output: of each
    replica the tombstone and both definedness flags of every element below
    ``length`` and the chars of the live ones; per source slot (an element
    below ``length`` whose "before" slot, or whose left neighbour's "after"
    slot, is defined) the mask words that hold a live column; the live
    table columns (5 x 4 B each), ``length`` and ``mark_count``; the ranks
    and allowMultiple flags; 8 B of digest a replica out."""
    r, c = st.chars.shape
    ar = torch.arange(c, device=st.chars.device)[None, :]
    below = ar < st.length.clamp(0, c)[:, None]
    live = below & ~st.deleted
    after = st.bnd_def[:, 1::2]
    prev_after = torch.roll(after, 1, dims=1) & (ar > 0)
    sources = ((st.bnd_def[:, 0::2] | prev_after) & below).sum(dim=1)
    cols = st.mark_count.clamp(0, st.max_mark_ops).long()
    words = (cols + K.MASK_WORD_BITS - 1) // K.MASK_WORD_BITS
    per_replica = 3 * below.sum(dim=1) + 4 * live.sum(dim=1) + 4 * words * sources + 20 * cols
    return int(per_replica.sum().item()) + nbytes(st.length, st.mark_count, ranks, multi) + 8 * r
