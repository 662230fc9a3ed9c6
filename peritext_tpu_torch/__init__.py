"""peritext_tpu_torch: the PyTorch/CUDA port of peritext_tpu.

A batch of rich-text CRDT replicas resident on an NVIDIA GPU.  The batched
exact merge runs through two hand-written CUDA kernels
(``ops/cuda_kernels.py``, sources in ``csrc/``), each held byte-for-byte
against a plain PyTorch version (``ops/kernels.py``) and, in the tests,
against the JAX package.  ``TorchUniverse.apply_changes`` runs that merge
by default; under ``PERITEXT_MERGE_PATH=sorted`` it runs the JAX package's
default merge (sort-based placement, the batched mark phase and the
frontier-bounded window; ``ops/sorted_merge.py``, ``ops/window.py``,
plain torch on the card) with the kernels' exact merge as its fallback.
``TorchUniverse.apply_changes_with_patches`` and ``TorchDoc`` emit the
reference patch stream through the exact per-op loop (``ops/kernels.py``)
by default, and under ``PERITEXT_MERGE_PATH=sorted`` through the JAX
package's default patch route, the patched sorted and windowed merges
(``ops/sorted_patched.py``).  A universe past the kernels' capacity merges
on the sorted route (``stats["capacity_routes"]``).
Every launch runs under the JAX universe's retry, breaker and degrade
policy; ``runtime/`` holds the serving plane (``ServePlane``), the fault,
health, SLO and telemetry planes, change logs and checkpoints.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from peritext_tpu_torch.ops.doc import TorchDoc
from peritext_tpu_torch.ops.state import (
    DocState,
    state_from_numpy,
    state_to_numpy,
    wcache_from_numpy,
    wcache_to_numpy,
)
from peritext_tpu_torch.ops.universe import TorchUniverse

__all__ = [
    "DocState",
    "TorchDoc",
    "TorchUniverse",
    "state_from_numpy",
    "state_to_numpy",
    "wcache_from_numpy",
    "wcache_to_numpy",
]
