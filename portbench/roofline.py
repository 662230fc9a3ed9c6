"""The yardstick of the merge kernels' roofline share: the least time one
NVIDIA H100 SXM could take for a merge, at the published HBM3 rate.

Frozen copy, at commit bdca3bf, of ``peritext_tpu_torch/bench/bounds.py``'s
``nbytes``, ``text_phase_bytes`` and ``merge_step_full_bytes`` and of the
op-row layout they read (``ops/kernels.py``: the kind column, the run
length column, ``MAX_RUN_LEN``).  The kernels use no tensor cores and their
operations bound nothing (67 TOP/s against a few per byte), so bytes decide.
A state is passed as anything with the 13 fields as tensors; ``meta``
tensors (shape and type, no storage) count the same as real ones.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, 700 W

K_KIND = 0
K_RUN_LEN = 6
KIND_INSERT = 1
KIND_DELETE = 2
KIND_INSERT_RUN = 4
MAX_RUN_LEN = 64


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def text_phase_bytes(elem_ctr, elem_act, deleted, chars, length, text_ops, ranks, char_buf=None) -> int:
    """The four planes, ``length`` and the ranks in, five planes and
    ``length`` out, and of each op row only the fields its kind reads: a pad
    4 B, a delete 12 B, an insert 24 B, a run 28 B and its characters."""
    import torch

    kind = text_ops[:, :, K_KIND]
    field_bytes = torch.full_like(kind, 4)
    field_bytes[kind == KIND_DELETE] = 12
    field_bytes[kind == KIND_INSERT] = 24
    if char_buf is not None:
        runs = kind == KIND_INSERT_RUN
        run_chars = text_ops[:, :, K_RUN_LEN].clamp(0, MAX_RUN_LEN)
        field_bytes = torch.where(runs, 28 + 4 * run_chars, field_bytes)
    planes = nbytes(elem_ctr, elem_act, deleted, chars)
    out = nbytes(elem_ctr, elem_act, chars, elem_ctr, deleted, length)
    return planes + nbytes(length, ranks) + int(field_bytes.sum().item()) + out


def merge_step_full_bytes(st, text_ops, mark_ops, ranks, char_buf=None) -> int:
    """The merge as one function: the state in once and out once, the op
    rows as ``text_phase_bytes`` counts them, the mark rows in once."""
    text = text_phase_bytes(st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length, text_ops, ranks,
                            char_buf) - nbytes(st.elem_ctr)
    planes = nbytes(st.bnd_def, st.bnd_mask)
    table = nbytes(st.mark_ctr, st.mark_act, st.mark_action, st.mark_type, st.mark_attr, st.mark_count)
    return text + 2 * planes + 2 * table + nbytes(mark_ops)


def bound_seconds(bytes_moved: int) -> float:
    return bytes_moved / HBM_BYTES_PER_S


class MergeSpy:
    """Wraps a module's ``merge_step_full`` while it is installed, keeping
    each call's op rows and the shape of its state (as ``meta`` tensors),
    so that the bytes are counted after the traced window, off the device's
    timeline."""

    FIELDS = ("elem_ctr", "elem_act", "deleted", "chars", "length", "bnd_def", "bnd_mask", "mark_ctr",
              "mark_act", "mark_action", "mark_type", "mark_attr", "mark_count")

    def __init__(self, *modules):
        self.modules = modules
        self.calls = []
        self._orig = []

    def __enter__(self) -> "MergeSpy":
        import types

        for mod in self.modules:
            orig = mod.merge_step_full
            self._orig.append((mod, orig))

            def spy(states, text_ops, mark_ops, ranks, char_buf=None, _orig=orig):
                st = types.SimpleNamespace(**{f: getattr(states, f).to("meta") for f in self.FIELDS})
                self.calls.append((st, text_ops, mark_ops, ranks, char_buf))
                return _orig(states, text_ops, mark_ops, ranks, char_buf)

            mod.merge_step_full = spy
        return self

    def __exit__(self, *exc) -> None:
        for mod, orig in self._orig:
            mod.merge_step_full = orig
        self._orig = []

    def bytes_moved(self) -> int:
        return sum(merge_step_full_bytes(*call) for call in self.calls)
