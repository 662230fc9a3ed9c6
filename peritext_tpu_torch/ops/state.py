"""Dense per-replica document state as torch tensors (struct-of-arrays).

Counterpart of ``peritext_tpu/ops/state.py``: the same 13 fields with the
same shapes, so a state moves between the engines as numpy arrays
(``state_from_numpy`` / ``state_to_numpy``).

- RGA elements in document order: ``elem_ctr`` / ``elem_act`` (the op id
  that created each element), ``deleted`` (tombstones) and ``chars``
  (codepoints, kept for tombstones too).
- Boundary bitsets over the 2C gap slots: ``bnd_def`` (an explicit,
  possibly empty set is present) and ``bnd_mask`` [2C, W] words, bit m <=>
  mark op m is in the set.  The JAX package keeps the words as uint32; here
  they are int32 bitcasts of the same bits (torch has no uint32 shifts on
  the CPU, and the CUDA kernels shift on ``uint32_t`` and store back).
- The mark-op table [M] and the scalars ``length`` / ``mark_count``.

Every integer plane is int32 and the flags are bool.  A batched state has a
leading replica axis on every field.  The constructors put a state on
``device``; ``None`` (the default) is the GPU, and without one they raise
(``resolve_device``): pass ``device="cpu"`` for the CPU.  ``wcache_to_numpy`` /
``wcache_from_numpy`` carry the patched sorted route's winner cache across
the same bridge.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

MASK_WORD_BITS = 32

Device = Optional[str | torch.device]


def resolve_device(device: Device) -> torch.device:
    """``None`` means the GPU; without one that is an error, never a silent
    move to the CPU (pass ``device="cpu"`` for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class DocState:
    # RGA element arrays [C]
    elem_ctr: torch.Tensor  # int32; 0 in dead slots
    elem_act: torch.Tensor  # int32 interned actor ids
    deleted: torch.Tensor  # bool
    chars: torch.Tensor  # int32 codepoints (kept for tombstones too)
    # Boundary bitsets: [2C] definedness, [2C, W] int32-bitcast set words
    bnd_def: torch.Tensor
    bnd_mask: torch.Tensor
    # Mark-op table [M]
    mark_ctr: torch.Tensor
    mark_act: torch.Tensor
    mark_action: torch.Tensor  # 0 = addMark, 1 = removeMark
    mark_type: torch.Tensor  # schema MARK_TYPE_ID
    mark_attr: torch.Tensor  # interned attr id, -1 = none
    # Scalars
    length: torch.Tensor  # live element count (int32)
    mark_count: torch.Tensor  # live mark-op count (int32)

    @property
    def capacity(self) -> int:
        return self.elem_ctr.shape[-1]

    @property
    def max_mark_ops(self) -> int:
        return self.mark_ctr.shape[-1]


FIELDS = tuple(f.name for f in dataclasses.fields(DocState))
_BOOL_FIELDS = ("deleted", "bnd_def")


def map_state(fn, state: DocState) -> DocState:
    """Apply ``fn`` to every field tensor."""
    return DocState(**{name: fn(getattr(state, name)) for name in FIELDS})


def make_empty_state(capacity: int = 1024, max_mark_ops: int = 128, device: Device = None) -> DocState:
    """An empty state on ``device`` (``None``: the GPU, see ``resolve_device``)."""
    if max_mark_ops % MASK_WORD_BITS != 0:
        raise ValueError("max_mark_ops must be a multiple of 32")
    words = max_mark_ops // MASK_WORD_BITS
    device = resolve_device(device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DocState(
        elem_ctr=z(capacity),
        elem_act=z(capacity),
        deleted=z(capacity, dtype=torch.bool),
        chars=z(capacity),
        bnd_def=z(2 * capacity, dtype=torch.bool),
        bnd_mask=z(2 * capacity, words),
        mark_ctr=z(max_mark_ops),
        mark_act=z(max_mark_ops),
        mark_action=z(max_mark_ops),
        mark_type=z(max_mark_ops),
        mark_attr=torch.full((max_mark_ops,), -1, dtype=torch.int32, device=device),
        length=z(),
        mark_count=z(),
    )


def stack_states(states: List[DocState]) -> DocState:
    """Stack replica states into one batched [R, ...] state."""
    return DocState(
        **{name: torch.stack([getattr(s, name) for s in states]) for name in FIELDS}
    )


def index_state(batched: DocState, r: int) -> DocState:
    return map_state(lambda x: x[r], batched)


def grow_state(state: DocState, capacity: int | None = None, max_mark_ops: int | None = None) -> DocState:
    """Re-bucket a state (single or batched) into larger capacities."""
    old_c, old_m = state.capacity, state.max_mark_ops
    new_c = capacity or old_c
    new_m = max_mark_ops or old_m
    if new_c < old_c or new_m < old_m:
        raise ValueError("grow_state cannot shrink capacities")
    if new_m % MASK_WORD_BITS != 0:
        raise ValueError("max_mark_ops must be a multiple of 32")

    def pad_last(x: torch.Tensor, size: int, fill=0) -> torch.Tensor:
        return torch.nn.functional.pad(x, (0, size - x.shape[-1]), value=fill)

    mask = state.bnd_mask
    words = new_m // MASK_WORD_BITS
    mask = torch.nn.functional.pad(
        mask, (0, words - mask.shape[-1], 0, 2 * new_c - mask.shape[-2])
    )
    return dataclasses.replace(
        state,
        elem_ctr=pad_last(state.elem_ctr, new_c),
        elem_act=pad_last(state.elem_act, new_c),
        deleted=pad_last(state.deleted, new_c, False),
        chars=pad_last(state.chars, new_c),
        bnd_def=pad_last(state.bnd_def, 2 * new_c, False),
        bnd_mask=mask,
        mark_ctr=pad_last(state.mark_ctr, new_m),
        mark_act=pad_last(state.mark_act, new_m),
        mark_action=pad_last(state.mark_action, new_m),
        mark_type=pad_last(state.mark_type, new_m),
        mark_attr=pad_last(state.mark_attr, new_m, -1),
    )


def state_from_numpy(fields: Dict[str, np.ndarray], device: Device = None) -> DocState:
    """A state from the JAX package's field arrays (``jax.device_get`` of
    its DocState, as numpy) on ``device`` (``None``: the GPU): uint32 masks
    become int32 bitcasts."""
    device = resolve_device(device)
    out = {}
    for name in FIELDS:
        a = np.asarray(fields[name])
        if name in _BOOL_FIELDS:
            a = a.astype(bool)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        else:
            a = a.astype(np.int32)
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return DocState(**out)


def state_to_numpy(state: DocState) -> Dict[str, np.ndarray]:
    """Field arrays with the JAX package's exact dtypes (``bnd_mask`` as
    uint32), as its checkpoint payload and row digests expect."""
    out = {}
    for name in FIELDS:
        a = getattr(state, name).detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name == "bnd_mask" else a
    return out


def wcache_to_numpy(wcache: torch.Tensor) -> np.ndarray:
    """The patched sorted route's winner cache [R, 2C, T, 4] as the JAX
    universe holds its ``_wcaches`` (int32: ctr, actor rank, action, attr)."""
    return wcache.detach().cpu().numpy().astype(np.int32)


def wcache_from_numpy(wcache: np.ndarray, device: Device = None) -> torch.Tensor:
    """A winner cache from its numpy form, on ``device`` (``None``: the GPU)."""
    return torch.from_numpy(np.array(wcache, dtype=np.int32, order="C")).to(resolve_device(device))


def visible_text(state: DocState) -> str:
    """Decode one replica's visible document text on the host
    (``peritext_tpu/ops/state.py``'s); the state may lie on any device."""
    n = int(state.length)
    chars = state.chars[:n].cpu().tolist()
    deleted = state.deleted[:n].cpu().tolist()
    return "".join(chr(c) for c, d in zip(chars, deleted) if not d)
