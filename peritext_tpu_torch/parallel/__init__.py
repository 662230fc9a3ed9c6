"""Replica populations and long documents past one device: device meshes
and sharded replica state (``mesh``), the explicit sequence-parallel
kernels (``shard``), cohort streaming over a device or a mesh (``stream``)
and replica batches across processes (``multihost``).

A mesh lives in one process, as JAX's single-controller mesh does: a
``(replica, seq)`` grid of devices, entries repeating where one device
holds several logical shards.  ``multihost`` stacks the processes' meshes
along the replica axis over ``torch.distributed``; one H100 is a world of
one process.
"""
from peritext_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_slices,
    shard_states,
    sharded_apply,
    sharded_digest_reduce,
    state_sharding,
)
from peritext_tpu_torch.parallel.multihost import (
    assemble_global_states,
    global_mesh,
    initialize_distributed,
    local_replica_slice,
)
from peritext_tpu_torch.parallel.shard import flatten_sources_sp, merge_step_sorted_sp, place_text_sp
from peritext_tpu_torch.parallel.stream import (
    cohort_for_budget,
    state_bytes_per_replica,
    stream_merge_sorted,
    transient_bytes_per_replica,
)

__all__ = [
    "make_mesh",
    "mesh_slices",
    "shard_states",
    "sharded_apply",
    "sharded_digest_reduce",
    "state_sharding",
    "flatten_sources_sp",
    "place_text_sp",
    "merge_step_sorted_sp",
    "cohort_for_budget",
    "state_bytes_per_replica",
    "stream_merge_sorted",
    "transient_bytes_per_replica",
    "assemble_global_states",
    "global_mesh",
    "initialize_distributed",
    "local_replica_slice",
]
