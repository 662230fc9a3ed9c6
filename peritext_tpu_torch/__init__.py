"""peritext_tpu_torch: the PyTorch/CUDA port of peritext_tpu.

A batch of rich-text CRDT replicas resident on an NVIDIA GPU.  The batched
exact merge runs through two hand-written CUDA kernels
(``ops/cuda_kernels.py``, sources in ``csrc/``), each held byte-for-byte
against a plain PyTorch version (``ops/kernels.py``) and, in the tests,
against the JAX package.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
from peritext_tpu_torch.ops.state import DocState, state_from_numpy, state_to_numpy
from peritext_tpu_torch.ops.universe import TorchUniverse

__all__ = ["DocState", "TorchUniverse", "state_from_numpy", "state_to_numpy"]
