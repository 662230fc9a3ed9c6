"""The merge's two hand-written CUDA kernels and their wrappers.

Counterpart of ``peritext_tpu/ops/pallas_kernels.py``:

- ``text_phase`` runs ``csrc/text_phase.cu`` (replaces ``_text_kernel``);
- ``mark_phase`` runs ``csrc/mark_phase.cu`` (replaces ``_mark_kernel``);
- ``merge_step_full`` is text kernel -> boundary permute -> mark kernel ->
  mark-table append (``merge_step_pallas_full``).

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain PyTorch version from ``kernels.py``, which the
kernels are held byte-for-byte against.  Nothing falls back from the card
to the plain version.  ``LAUNCHES`` counts the kernel launches of each
wrapper (only launches on the card count).  Both kernels hold C <= 16384
(a 10k-character document) in one block's shared memory; larger C raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from peritext_tpu_torch.ops import _build
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import DocState

# Shared memory one block may use on Hopper (sm_90).
MAX_SHARED_BYTES = 232448
_SCRATCH_INTS = 64

LAUNCHES: Dict[str, int] = {"text_phase": 0, "mark_phase": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _text_tile_rows(capacity: int) -> int:
    return 32 if capacity <= 4096 else 128


def text_phase_smem_bytes(capacity: int) -> int:
    """Id (8 B) and source word (4 B) per slot, two staged op tiles of 6
    int fields per row, a hash table of 4 * tile slots (12 B each) and two
    32-int reduction areas (``csrc/text_phase.cu``)."""
    return 12 * capacity + _text_tile_rows(capacity) * (2 * 6 * 4 + 4 * 12) + 2 * 32 * 4


def mark_phase_smem_bytes(capacity: int, words: int) -> int:
    """Element ids (8 B per element), definedness (one byte per slot, two
    slots per element), two carry rows and the reduction scratch."""
    return (2 * capacity + 2 * words + _SCRATCH_INTS) * 4 + 2 * capacity


def _largest_fitting(smem_bytes) -> int:
    c = 1
    while smem_bytes(2 * c) <= MAX_SHARED_BYTES:
        c *= 2
    return c


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}; pass CPU or CUDA tensors")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "pt_text_phase": [_P] * 6 + [_I, _P, _I, _P, _I] + [_P] * 6 + [_I, _I, _P],
    "pt_mark_phase": [_P] * 7 + [_I, _P, _P, _I, _I, _I, _P],
}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _fn(kernel: str, symbol: str) -> ctypes._CFuncPtr:
    """A kernel library's C function with its argument types set (once per
    process)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load(kernel), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        msg = _build.error_string(_build.load(kernel), err)
        raise RuntimeError(f"{kernel} kernel launch failed: {msg}")


def text_phase(
    elem_ctr: torch.Tensor,  # [R, C] int32
    elem_act: torch.Tensor,  # [R, C] int32
    deleted: torch.Tensor,  # [R, C] bool
    chars: torch.Tensor,  # [R, C] int32
    length: torch.Tensor,  # [R] int32
    text_ops: torch.Tensor,  # [R, L, OP_FIELDS] int32
    ranks: torch.Tensor,  # [A] int32
    char_buf: Optional[torch.Tensor] = None,  # [R, BUF] int32, BUF >= MAX_RUN_LEN
) -> Tuple[torch.Tensor, ...]:
    """Apply a batch's text ops; returns ``(elem_ctr, elem_act, deleted,
    chars, orig_idx, length)`` (see ``kernels.text_phase_plain``).  Run
    lengths must be >= 0, as the encoder emits them (1..MAX_RUN_LEN)."""
    if _on_cpu(elem_ctr, elem_act, deleted, chars, length, text_ops, ranks, char_buf):
        return K.text_phase_plain(
            elem_ctr, elem_act, deleted, chars, length, text_ops, ranks, char_buf
        )
    r, c = elem_ctr.shape
    num_ops = text_ops.shape[1]
    _check("elem_ctr", elem_ctr, torch.int32, (r, c))
    _check("elem_act", elem_act, torch.int32, (r, c))
    _check("deleted", deleted, torch.bool, (r, c))
    _check("chars", chars, torch.int32, (r, c))
    _check("length", length, torch.int32, (r,))
    _check("text_ops", text_ops, torch.int32, (r, num_ops, K.OP_FIELDS))
    if ranks.dim() != 1 or ranks.shape[0] < 1:
        raise ValueError(f"ranks: shape {tuple(ranks.shape)}, expected [A] with A >= 1")
    _check("ranks", ranks, torch.int32, (ranks.shape[0],))
    buf_len = 0
    if char_buf is not None:
        buf_len = char_buf.shape[1] if char_buf.dim() == 2 else -1
        _check("char_buf", char_buf, torch.int32, (r, buf_len))
        if buf_len < K.MAX_RUN_LEN:
            raise ValueError(f"char_buf: width {buf_len} < MAX_RUN_LEN={K.MAX_RUN_LEN}")
    smem = text_phase_smem_bytes(c)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"text_phase: capacity {c} needs {smem} bytes of shared memory, over the "
            f"{MAX_SHARED_BYTES}-byte limit of one block "
            f"(C <= {_largest_fitting(text_phase_smem_bytes)} fits)"
        )
    if c + K.MAX_RUN_LEN * num_ops >= 2**31:
        raise ValueError(f"text_phase: {num_ops} op rows at capacity {c} overflow a source word")
    ec = torch.empty_like(elem_ctr)
    ea = torch.empty_like(elem_act)
    dl = torch.empty_like(deleted)
    ch = torch.empty_like(chars)
    oi = torch.empty_like(elem_ctr)
    ln = torch.empty_like(length)
    err = _fn("text_phase", "pt_text_phase")(
        elem_ctr.data_ptr(), elem_act.data_ptr(), deleted.data_ptr(), chars.data_ptr(),
        length.data_ptr(), text_ops.data_ptr(), num_ops, ranks.data_ptr(), ranks.shape[0],
        char_buf.data_ptr() if char_buf is not None else None, buf_len,
        ec.data_ptr(), ea.data_ptr(), dl.data_ptr(), ch.data_ptr(), oi.data_ptr(), ln.data_ptr(),
        r, c, _stream(),
    )
    _raise_on_error("text_phase", err)
    LAUNCHES["text_phase"] += 1
    return ec, ea, dl, ch, oi, ln


def mark_phase(
    bnd_def: torch.Tensor,  # [R, 2C] bool
    bnd_mask: torch.Tensor,  # [R, 2C, W] int32
    elem_ctr: torch.Tensor,  # [R, C] int32
    elem_act: torch.Tensor,
    length: torch.Tensor,  # [R] int32
    mark_count: torch.Tensor,  # [R] int32
    mark_ops: torch.Tensor,  # [R, Lm, OP_FIELDS] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a batch's mark ops to the boundary bitsets; returns the new
    ``(bnd_def, bnd_mask)`` (see ``kernels.mark_phase_plain``)."""
    if _on_cpu(bnd_def, bnd_mask, elem_ctr, elem_act, length, mark_count, mark_ops):
        return K.mark_phase_plain(
            bnd_def, bnd_mask, elem_ctr, elem_act, length, mark_count, mark_ops
        )
    r, c = elem_ctr.shape
    words = bnd_mask.shape[-1]
    num_ops = mark_ops.shape[1]
    _check("bnd_def", bnd_def, torch.bool, (r, 2 * c))
    _check("bnd_mask", bnd_mask, torch.int32, (r, 2 * c, words))
    _check("elem_ctr", elem_ctr, torch.int32, (r, c))
    _check("elem_act", elem_act, torch.int32, (r, c))
    _check("length", length, torch.int32, (r,))
    _check("mark_count", mark_count, torch.int32, (r,))
    _check("mark_ops", mark_ops, torch.int32, (r, num_ops, K.OP_FIELDS))
    smem = mark_phase_smem_bytes(c, words)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"mark_phase: capacity {c} with {words} mask words needs {smem} bytes of "
            f"shared memory, over the {MAX_SHARED_BYTES}-byte limit of one block "
            f"(C <= {_largest_fitting(lambda cap: mark_phase_smem_bytes(cap, words))} fits)"
        )
    new_def = torch.empty_like(bnd_def)
    new_mask = torch.empty_like(bnd_mask)  # the kernel copies the input in
    err = _fn("mark_phase", "pt_mark_phase")(
        bnd_def.data_ptr(), bnd_mask.data_ptr(), elem_ctr.data_ptr(), elem_act.data_ptr(),
        length.data_ptr(), mark_count.data_ptr(), mark_ops.data_ptr(), num_ops,
        new_def.data_ptr(), new_mask.data_ptr(), r, c, words, _stream(),
    )
    _raise_on_error("mark_phase", err)
    LAUNCHES["mark_phase"] += 1
    return new_def, new_mask


def merge_step_full(
    states: DocState,
    text_ops: torch.Tensor,
    mark_ops: torch.Tensor,
    ranks: torch.Tensor,
    char_buf: Optional[torch.Tensor] = None,
) -> DocState:
    """The exact batched merge through both kernels: text kernel -> boundary
    permute (plain torch gather) -> mark kernel -> mark-table append.
    State-equivalent to ``kernels.merge_step_plain``."""
    ec, ea, dl, ch, oi, ln = text_phase(
        states.elem_ctr, states.elem_act, states.deleted, states.chars,
        states.length, text_ops, ranks, char_buf,
    )
    bnd_def, bnd_mask = K._permute_boundaries(states.bnd_def, states.bnd_mask, oi)
    bnd_def, bnd_mask = mark_phase(
        bnd_def, bnd_mask, ec, ea, ln, states.mark_count, mark_ops
    )
    out = dataclasses.replace(
        states, elem_ctr=ec, elem_act=ea, deleted=dl, chars=ch, length=ln,
        bnd_def=bnd_def, bnd_mask=bnd_mask,
    )
    return K.append_mark_table(out, mark_ops)
