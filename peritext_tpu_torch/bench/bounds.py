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
