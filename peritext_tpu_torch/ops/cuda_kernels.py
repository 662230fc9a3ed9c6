"""The port's three hand-written CUDA kernels and their wrappers.

The merge's two kernels are the counterparts of
``peritext_tpu/ops/pallas_kernels.py``:

- ``text_phase`` runs ``csrc/text_phase.cu`` (replaces ``_text_kernel``);
- ``mark_phase`` runs ``csrc/mark_phase.cu`` (replaces ``_mark_kernel``);
- ``mark_tail`` runs the same kernel as the merge's whole tail: it gathers
  the boundary planes through the text phase's ``orig_idx`` as it loads
  them, applies the marks and appends to the mark table (the boundary
  permute, ``_mark_kernel`` and ``_update_mark_table`` of
  ``merge_step_pallas_full``);
- ``merge_step_full`` is text kernel -> ``mark_tail``: two launches, no
  plain torch between or after them (``merge_step_pallas_full``);
- ``merge_step`` is text kernel -> boundary permute -> the per-op mark
  scan in plain torch -> mark-table append (``merge_step_pallas``, the
  latency composite whose mark phase JAX runs in XLA).

``convergence_digest`` runs ``csrc/digest.cu``, which has no Pallas
counterpart (JAX computes the digest in XLA): one launch a call, one block
a replica, at any capacity.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain PyTorch version from ``kernels.py``, which the
kernels are held byte-for-byte against.  Nothing falls back from the card
to the plain version.  ``LAUNCHES`` counts the kernel launches of each
kernel (only launches on the card count; ``mark_tail``'s under
``mark_phase``).  Both merge kernels hold C <= 16384
(a 10k-character document) in one block's shared memory; past that a
replica runs on a thread-block cluster of 2, 4 or 8 blocks, each holding
an equal slice (``cluster_size``), up to C = 131072.  A cluster launch
counts once in ``LAUNCHES`` and once in ``CLUSTER_LAUNCHES``; before the
first at a given shape the wrapper asks the card how many such clusters
it can hold at once (``ACTIVE_CLUSTERS``) and raises if none.  Larger C
raises.  ``kernel_capacity_limit`` gives that bound from the same
footprints, so a caller can route a larger capacity elsewhere before it
launches.

The text kernel takes one of three forms, fixed by C and the op rows L
alone (``text_form``): the plane form (``text_phase_kernel``, the planes
in one block's shared memory) at C <= 8192; past it, up to C = 16384, the
piece form (``text_phase_piece_kernel``: a piece table sized by L, at
least four replicas an SM) wherever its table fits a quarter of an SM's
shared memory, else the plane form; the cluster form past C = 16384.  A
piece launch counts once in ``LAUNCHES`` and once in ``PIECE_LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from peritext_tpu_torch.ops import _build
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops.state import DocState

# Shared memory one block may use on Hopper (sm_90).
MAX_SHARED_BYTES = 232448
# Blocks a replica may span as a thread-block cluster (the portable size).
MAX_CLUSTER = 8
_SCRATCH_INTS = 64
# A cluster's block: two areas of cluster-min slots, [MAX_CLUSTER][2] ints.
_CLUSTER_SLOT_INTS = 2 * 2 * MAX_CLUSTER
# The text kernel's piece form: past C = 8192 up to one block's 16384, where
# its shared memory leaves room for four blocks an SM.
_PIECE_CAPACITIES = (8192, 16384)  # (exclusive, inclusive)
PIECE_SMEM_LIMIT = MAX_SHARED_BYTES // 4
_PIECE_SCRATCH_INTS = 64

LAUNCHES: Dict[str, int] = {"text_phase": 0, "mark_phase": 0, "digest": 0}
# The launches of LAUNCHES that ran a kernel's cluster form.
CLUSTER_LAUNCHES: Dict[str, int] = {"text_phase": 0, "mark_phase": 0}
# The launches of LAUNCHES that ran the text kernel's piece form.
PIECE_LAUNCHES: Dict[str, int] = {"text_phase": 0}
# cudaOccupancyMaxActiveClusters of each cluster shape launched so far, by
# (kernel, blocks, shared bytes a block, device index).
ACTIVE_CLUSTERS: Dict[Tuple[str, int, int, int], int] = {}
# Scheduler threads of a sharded serving plane may launch concurrently.
_LAUNCHES_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CLUSTER_LAUNCHES, PIECE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _text_tile_rows(capacity: int) -> int:
    return 32 if capacity <= 4096 else 128


def text_phase_smem_bytes(capacity: int, blocks: int = 1) -> int:
    """Shared memory of one block holding ``capacity / blocks`` slots: id
    (8 B) and source word (4 B) per slot, two staged op tiles of 6 int
    fields per row, a hash table of 4 * tile slots (12 B each) and two
    32-int reduction areas; a cluster's block adds the halo (MAX_RUN_LEN
    slots of 12 B) and the cluster-min slots (``csrc/text_phase.cu``)."""
    cs = capacity // blocks
    extra = K.MAX_RUN_LEN * 12 + 4 * _CLUSTER_SLOT_INTS if blocks > 1 else 0
    return 12 * cs + _text_tile_rows(cs) * (2 * 6 * 4 + 4 * 12) + 2 * 32 * 4 + extra


def _piece_hash_slots(num_ops: int) -> int:
    slots = 32
    while slots < 2 * num_ops:
        slots *= 2
    return slots


def text_piece_smem_bytes(capacity: int, num_ops: int) -> int:
    """Shared memory of one block of the text kernel's piece form: 2L + 4
    pieces and max(L, 1) insert records (16 B each), a key table of twice
    the rows rounded up to a power of two (at least 32) plus one slot (8 B
    key, 4 B first input slot, 4 B last delete), a tombstone bit a slot
    plus a spare word, the pieces' starts (2L + 5 ints) and 64 scratch
    ints (``csrc/text_phase.cu``, ``piece_smem_bytes``)."""
    pieces = 2 * num_ops + 4
    return (16 * pieces + 16 * max(num_ops, 1) + 16 * (_piece_hash_slots(num_ops) + 1)
            + 4 * ((capacity + 31) // 32 + 1) + 4 * (pieces + 1) + 4 * _PIECE_SCRATCH_INTS)


def text_form(capacity: int, num_ops: int) -> str:
    """The text kernel's form at ``capacity`` and ``num_ops`` op rows:
    ``"plane"`` (the planes in one block), ``"piece"`` (8192 < C <= 16384
    and a piece table within ``PIECE_SMEM_LIMIT``) or ``"cluster"`` (past
    one block)."""
    if _text_blocks(capacity) != 1:
        return "cluster"
    low, high = _PIECE_CAPACITIES
    if low < capacity <= high and text_piece_smem_bytes(capacity, num_ops) <= PIECE_SMEM_LIMIT:
        return "piece"
    return "plane"


def mark_phase_smem_bytes(capacity: int, words: int, blocks: int = 1) -> int:
    """Shared memory of one block holding ``capacity / blocks`` elements:
    their ids (8 B each), definedness (one byte per slot, two slots per
    element), two carry rows and the reduction scratch; a cluster's block
    adds the cluster-min slots (``csrc/mark_phase.cu``)."""
    cs = capacity // blocks
    extra = _CLUSTER_SLOT_INTS if blocks > 1 else 0
    return (2 * cs + 2 * words + _SCRATCH_INTS + extra) * 4 + 2 * cs


def _fewest_blocks(capacity: int, smem_bytes, align: int) -> int:
    """The fewest blocks (1, or a cluster of 2, 4 or 8) that split
    ``capacity`` into equal slices of a multiple of ``align`` elements, each
    within one block's shared memory; 0 when there is none."""
    for blocks in (1, 2, 4, MAX_CLUSTER):
        split = blocks == 1 or capacity % (align * blocks) == 0
        if split and smem_bytes(capacity, blocks) <= MAX_SHARED_BYTES:
            return blocks
    return 0


def _text_blocks(capacity: int) -> int:
    # Slices of a multiple of four slots: the kernel's 16-byte moves.
    return _fewest_blocks(capacity, text_phase_smem_bytes, 4)


def _mark_blocks(capacity: int, words: int) -> int:
    return _fewest_blocks(capacity, lambda c, b: mark_phase_smem_bytes(c, words, b), 1)


def cluster_size(capacity: int, words: int) -> int:
    """Blocks per replica at ``capacity`` and ``words`` mask words: 1 where
    one block holds the replica, else the thread-block cluster of 2, 4 or 8
    blocks -- the larger of the two kernels' -- whose equal slices each fit
    one block's shared memory; 0 when either kernel cannot hold it."""
    text, mark = _text_blocks(capacity), _mark_blocks(capacity, words)
    return max(text, mark) if text and mark else 0


def _largest_held(blocks) -> int:
    c = 1
    while blocks(2 * c):
        c *= 2
    return c


def kernel_capacity_limit(words: int) -> int:
    """The largest capacity (a power of two) that both kernels hold, in one
    block or a cluster of at most MAX_CLUSTER blocks, at ``words`` mask
    words: 131072 at every width the universe uses."""
    return _largest_held(lambda cap: cluster_size(cap, words))


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
    "pt_text_phase": [_P] * 6 + [_I, _P, _I, _P, _I] + [_P] * 6 + [_I, _I, _I, _P],
    "pt_mark_phase": [_P] * 7 + [_I, _P, _P, _I, _I, _I, _I, _P],
    "pt_mark_tail": [_P] * 7 + [_I] + [_P] * 14 + [_I] * 5 + [_P],
    "pt_text_phase_max_clusters": [_I, _I, _P],
    "pt_text_phase_piece": [_P] * 6 + [_I, _P, _I, _P, _I] + [_P] * 6 + [_I, _I, _P],
    "pt_text_phase_piece_blocks_per_sm": [_I, _I, _P],
    "pt_mark_phase_max_clusters": [_I, _I, _I, _P],
    "pt_digest": [_P] * 12 + [_I, _P, _I, _P] + [_I] * 4 + [_P],
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


def _launch(kernel: str, symbol: str, device: torch.device, blocks: Optional[int], *args) -> None:
    """Call a kernel library's C entry point on ``device``'s current stream
    with ``device`` made current, so a launch never depends on the calling
    thread's current device (a shard's universe may sit on another card),
    and count it.  ``blocks`` (the blocks a replica spans; > 1 a cluster
    launch) goes to the entry point before the stream; None for a kernel
    without a cluster form."""
    extra = () if blocks is None else (blocks,)
    with torch.cuda.device(device):
        err = _fn(kernel, symbol)(*args, *extra, torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(kernel, err)
    with _LAUNCHES_LOCK:
        LAUNCHES[kernel] += 1
        if blocks is not None and blocks > 1:
            CLUSTER_LAUNCHES[kernel] += 1


def _check_clusters(kernel: str, device: torch.device, blocks: int, smem: int, *shape: int) -> None:
    """Before the first cluster launch of a shape on a device: ask the card
    how many clusters of ``blocks`` blocks of ``smem`` bytes it holds at
    once (``cudaOccupancyMaxActiveClusters``), and raise when none fits."""
    key = (kernel, blocks, smem, device.index if device.index is not None else torch.cuda.current_device())
    active = ACTIVE_CLUSTERS.get(key)
    if active is None:
        count = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _fn(kernel, f"pt_{kernel}_max_clusters")(*shape, blocks, ctypes.byref(count))
        _raise_on_error(kernel, err)
        active = ACTIVE_CLUSTERS[key] = count.value
    if active <= 0:
        raise ValueError(
            f"{kernel}: the card holds no cluster of {blocks} blocks with {smem} bytes of "
            f"shared memory each (cudaOccupancyMaxActiveClusters is {active})"
        )


def _refuse(kernel: str, capacity: int, smem_at_most: int, limit: int) -> ValueError:
    return ValueError(
        f"{kernel}: capacity {capacity} fits no thread-block cluster of at most "
        f"{MAX_CLUSTER} blocks: {smem_at_most} bytes of shared memory a block, over the "
        f"{MAX_SHARED_BYTES}-byte limit of one block, or slices that do not split it evenly "
        f"(C <= {limit} fits)"
    )


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
    blocks = _text_blocks(c)
    if not blocks:
        raise _refuse("text_phase", c, text_phase_smem_bytes(c, MAX_CLUSTER), _largest_held(_text_blocks))
    if c + K.MAX_RUN_LEN * num_ops >= 2**31:
        raise ValueError(f"text_phase: {num_ops} op rows at capacity {c} overflow a source word")
    ec = torch.empty_like(elem_ctr)
    ea = torch.empty_like(elem_act)
    dl = torch.empty_like(deleted)
    ch = torch.empty_like(chars)
    oi = torch.empty_like(elem_ctr)
    ln = torch.empty_like(length)
    args = (
        elem_ctr.data_ptr(), elem_act.data_ptr(), deleted.data_ptr(), chars.data_ptr(),
        length.data_ptr(), text_ops.data_ptr(), num_ops, ranks.data_ptr(), ranks.shape[0],
        char_buf.data_ptr() if char_buf is not None else None, buf_len,
        ec.data_ptr(), ea.data_ptr(), dl.data_ptr(), ch.data_ptr(), oi.data_ptr(), ln.data_ptr(),
        r, c,
    )
    if text_form(c, num_ops) == "piece":
        _launch("text_phase", "pt_text_phase_piece", elem_ctr.device, None, *args)
        with _LAUNCHES_LOCK:
            PIECE_LAUNCHES["text_phase"] += 1
        return ec, ea, dl, ch, oi, ln
    if blocks > 1:
        _check_clusters("text_phase", elem_ctr.device, blocks, text_phase_smem_bytes(c, blocks), c)
    _launch("text_phase", "pt_text_phase", elem_ctr.device, blocks, *args)
    return ec, ea, dl, ch, oi, ln


def text_piece_blocks_per_sm(capacity: int, num_ops: int, device: Optional[torch.device] = None) -> int:
    """Blocks of the text kernel's piece form an SM of the card holds at
    once at ``capacity`` and ``num_ops`` op rows
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device or torch.device("cuda")):
        err = _fn("text_phase", "pt_text_phase_piece_blocks_per_sm")(capacity, num_ops, ctypes.byref(count))
    _raise_on_error("text_phase", err)
    return count.value


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
    blocks = _mark_blocks(c, words)
    if not blocks:
        raise _refuse(
            f"mark_phase ({words} mask words)", c, mark_phase_smem_bytes(c, words, MAX_CLUSTER),
            _largest_held(lambda cap: _mark_blocks(cap, words)),
        )
    new_def = torch.empty_like(bnd_def)
    new_mask = torch.empty_like(bnd_mask)  # the kernel copies the input in
    if blocks > 1:
        _check_clusters("mark_phase", bnd_def.device, blocks,
                        mark_phase_smem_bytes(c, words, blocks), c, words)
    _launch(
        "mark_phase", "pt_mark_phase", bnd_def.device, blocks,
        bnd_def.data_ptr(), bnd_mask.data_ptr(), elem_ctr.data_ptr(), elem_act.data_ptr(),
        length.data_ptr(), mark_count.data_ptr(), mark_ops.data_ptr(), num_ops,
        new_def.data_ptr(), new_mask.data_ptr(), r, c, words,
    )
    return new_def, new_mask


def mark_tail(
    states: DocState,
    elem_ctr: torch.Tensor,  # [R, C] int32, the text phase's
    elem_act: torch.Tensor,
    orig_idx: torch.Tensor,  # [R, C] int32, the text phase's
    length: torch.Tensor,  # [R] int32, the text phase's
    mark_ops: torch.Tensor,  # [R, Lm, OP_FIELDS] int32
) -> DocState:
    """The merge's tail after its text phase in one launch of the mark
    kernel: the boundary planes of ``states`` (as they were before the text
    phase) gathered through ``orig_idx`` as they load, the mark rows
    applied on the text phase's ids and length, and appended to the mark
    table.  Returns ``states`` with ``bnd_def``, ``bnd_mask``, the five
    table columns and ``mark_count`` replaced, each a new tensor; the
    element fields are the caller's (see ``kernels.mark_tail_plain``).
    No host wait."""
    table = [getattr(states, name) for name, _ in K._TABLE_FIELDS]
    if _on_cpu(states.bnd_def, states.bnd_mask, elem_ctr, elem_act, orig_idx, length,
               states.mark_count, mark_ops, *table):
        return K.mark_tail_plain(states, elem_ctr, elem_act, orig_idx, length, mark_ops)
    r, c = elem_ctr.shape
    words = states.bnd_mask.shape[-1]
    m = states.max_mark_ops
    num_ops = mark_ops.shape[1]
    _check("bnd_def", states.bnd_def, torch.bool, (r, 2 * c))
    _check("bnd_mask", states.bnd_mask, torch.int32, (r, 2 * c, words))
    _check("elem_ctr", elem_ctr, torch.int32, (r, c))
    _check("elem_act", elem_act, torch.int32, (r, c))
    _check("orig_idx", orig_idx, torch.int32, (r, c))
    _check("length", length, torch.int32, (r,))
    _check("mark_count", states.mark_count, torch.int32, (r,))
    _check("mark_ops", mark_ops, torch.int32, (r, num_ops, K.OP_FIELDS))
    for (name, _), col in zip(K._TABLE_FIELDS, table):
        _check(name, col, torch.int32, (r, m))
    blocks = _mark_blocks(c, words)
    if not blocks:
        raise _refuse(
            f"mark_tail ({words} mask words)", c, mark_phase_smem_bytes(c, words, MAX_CLUSTER),
            _largest_held(lambda cap: _mark_blocks(cap, words)),
        )
    new_def, new_mask = torch.empty_like(states.bnd_def), torch.empty_like(states.bnd_mask)
    new_table = [torch.empty_like(col) for col in table]
    new_count = torch.empty_like(states.mark_count)
    if blocks > 1:
        _check_clusters("mark_phase", elem_ctr.device, blocks, mark_phase_smem_bytes(c, words, blocks), c, words)
    _launch(
        "mark_phase", "pt_mark_tail", elem_ctr.device, blocks,
        states.bnd_def.data_ptr(), states.bnd_mask.data_ptr(), elem_ctr.data_ptr(), elem_act.data_ptr(),
        length.data_ptr(), states.mark_count.data_ptr(), mark_ops.data_ptr(), num_ops, orig_idx.data_ptr(),
        *(col.data_ptr() for col in table), new_def.data_ptr(), new_mask.data_ptr(),
        *(col.data_ptr() for col in new_table), new_count.data_ptr(), r, c, words, m,
    )
    return dataclasses.replace(
        states, bnd_def=new_def, bnd_mask=new_mask, mark_count=new_count,
        **{name: col for (name, _), col in zip(K._TABLE_FIELDS, new_table)},
    )


def merge_step_full(
    states: DocState,
    text_ops: torch.Tensor,
    mark_ops: torch.Tensor,
    ranks: torch.Tensor,
    char_buf: Optional[torch.Tensor] = None,
) -> DocState:
    """The exact batched merge through both kernels: the text kernel, then
    the mark kernel as the whole tail (``mark_tail``: the boundary permute,
    the marks and the mark-table append).  State-equivalent to
    ``kernels.merge_step_plain``."""
    ec, ea, dl, ch, oi, ln = text_phase(
        states.elem_ctr, states.elem_act, states.deleted, states.chars,
        states.length, text_ops, ranks, char_buf,
    )
    out = mark_tail(states, ec, ea, oi, ln, mark_ops)
    return dataclasses.replace(out, elem_ctr=ec, elem_act=ea, deleted=dl, chars=ch, length=ln)


def merge_step(
    states: DocState,
    text_ops: torch.Tensor,
    mark_ops: torch.Tensor,
    ranks: torch.Tensor,
    char_buf: Optional[torch.Tensor] = None,
) -> DocState:
    """The counterpart of ``merge_step_pallas``: the text kernel, then the
    boundary permute and the mark phase as the per-op scan in plain torch
    (``kernels.mark_phase_plain``, the loop JAX runs as ``lax.scan`` of
    ``_apply_mark_fast``), then the mark-table append.  State-equivalent
    to ``merge_step_full`` and ``kernels.merge_step_plain``."""
    ec, ea, dl, ch, oi, ln = text_phase(
        states.elem_ctr, states.elem_act, states.deleted, states.chars,
        states.length, text_ops, ranks, char_buf,
    )
    bnd_def, bnd_mask = K._permute_boundaries(states.bnd_def, states.bnd_mask, oi)
    bnd_def, bnd_mask = K.mark_phase_plain(
        bnd_def, bnd_mask, ec, ea, ln, states.mark_count, mark_ops
    )
    out = dataclasses.replace(
        states, elem_ctr=ec, elem_act=ea, deleted=dl, chars=ch, length=ln,
        bnd_def=bnd_def, bnd_mask=bnd_mask,
    )
    return K.append_mark_table(out, mark_ops)


def convergence_digest(
    states: DocState,
    ranks: torch.Tensor,  # [A] int32
    multi: torch.Tensor,  # [T] bool, allowMultiple by mark type
) -> torch.Tensor:
    """Each replica's convergence digest, uint32 values in an int64 tensor
    [R] (see ``kernels.convergence_digest``).  On the card one launch of the
    digest kernel, with no host wait; its shared memory grows with the
    table alone, and ``pt_digest`` refuses a table past one block's."""
    table = [getattr(states, name) for name, _ in K._TABLE_FIELDS]
    if _on_cpu(states.chars, states.deleted, states.bnd_def, states.bnd_mask, states.length,
               states.mark_count, *table, ranks, multi):
        return K.convergence_digest(states, ranks, multi)
    r, c = states.chars.shape
    m = states.max_mark_ops
    words = states.bnd_mask.shape[-1]
    _check("chars", states.chars, torch.int32, (r, c))
    _check("deleted", states.deleted, torch.bool, (r, c))
    _check("bnd_def", states.bnd_def, torch.bool, (r, 2 * c))
    _check("bnd_mask", states.bnd_mask, torch.int32, (r, 2 * c, m // K.MASK_WORD_BITS))
    _check("length", states.length, torch.int32, (r,))
    _check("mark_count", states.mark_count, torch.int32, (r,))
    for (name, _), col in zip(K._TABLE_FIELDS, table):
        _check(name, col, torch.int32, (r, m))
    for name, t, dtype in (("ranks", ranks, torch.int32), ("multi", multi, torch.bool)):
        if t.dim() != 1 or t.shape[0] < 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected [N] with N >= 1")
        _check(name, t, dtype, (t.shape[0],))
    out = torch.empty(r, dtype=torch.int64, device=states.chars.device)
    _launch(
        "digest", "pt_digest", states.chars.device, None,
        states.chars.data_ptr(), states.deleted.data_ptr(), states.bnd_def.data_ptr(),
        states.bnd_mask.data_ptr(), states.length.data_ptr(), states.mark_count.data_ptr(),
        *(col.data_ptr() for col in table), ranks.data_ptr(), ranks.shape[0], multi.data_ptr(),
        multi.shape[0], out.data_ptr(), r, c, words, m,
    )
    return out
