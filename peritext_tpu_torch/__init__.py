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
(``ops/sorted_patched.py``).  Past C = 16384 each replica runs on a
thread-block cluster of 2, 4 or 8 blocks; a universe past the kernels'
capacity (C = 131072) merges on the sorted route
(``stats["capacity_routes"]``).
Every launch runs under the JAX universe's retry, breaker and degrade
policy; ``runtime/`` holds the serving plane (``ServePlane``) and its
sharded tier (``ShardedServePlane`` with doc groups over pub/sub, live
migration and the autoscaler, the ``DocLifecycle`` evict/hydrate cache),
the fault, health, SLO and telemetry planes, change logs and checkpoints.
``parallel.stream_merge_sorted`` streams a replica population larger
than the card in cohorts through both kernels; ``testing``, ``replay``,
``bridge`` and ``fuzz`` are the JAX package's host-side drivers over the
port's engines.
``runtime.native_codec`` writes and reads change logs' op rows through
a C++ coder built with ``g++`` at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``devices=["cpu"]`` for the sharded plane); without a GPU they raise.
The package surface is the JAX package's (``__all__``), with
``TorchDoc`` and ``TorchUniverse`` for its engine classes.
"""
from peritext_tpu_torch.oracle import Doc, accumulate_patches
from peritext_tpu_torch.ops.doc import TorchDoc
from peritext_tpu_torch.ops.state import (
    DocState,
    state_from_numpy,
    state_to_numpy,
    wcache_from_numpy,
    wcache_to_numpy,
)
from peritext_tpu_torch.ops.universe import TorchUniverse
from peritext_tpu_torch.schema import MARK_SPEC, MARK_TYPE_ID, register_mark_type

_BRIDGE = (
    "Editor",
    "EditorNetwork",
    "RemoteChangeHighlighter",
    "editor_doc_from_spans",
    "editor_doc_text",
    "content_pos_from_editor_pos",
    "initialize_docs",
)


def __getattr__(name):
    # ALL_MARKS is rebound when mark types register; forward dynamically so
    # `peritext_tpu_torch.ALL_MARKS` is never stale.
    if name == "ALL_MARKS":
        from peritext_tpu_torch import schema

        return schema.ALL_MARKS
    # Observability facade: `peritext_tpu_torch.obs` IS the telemetry
    # module, loaded lazily (importing it arms the env-driven flusher).
    if name == "obs":
        from peritext_tpu_torch.runtime import telemetry

        return telemetry
    # Bridge surfaces load lazily (Editor pulls in the runtime package).
    if name in _BRIDGE:
        from peritext_tpu_torch import bridge

        return getattr(bridge, name)
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "Doc",
    "accumulate_patches",
    "ALL_MARKS",
    "register_mark_type",
    "MARK_SPEC",
    "MARK_TYPE_ID",
    "TorchDoc",
    "TorchUniverse",
    *_BRIDGE,
    "obs",
    "__version__",
    "DocState",
    "state_from_numpy",
    "state_to_numpy",
    "wcache_from_numpy",
    "wcache_to_numpy",
]
