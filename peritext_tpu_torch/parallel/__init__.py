"""Replica populations past one device's memory: cohort streaming
(``stream``).  The JAX package's mesh, sharding and multi-host modules
have no counterpart here yet."""
from peritext_tpu_torch.parallel.stream import (
    cohort_for_budget,
    state_bytes_per_replica,
    stream_merge_sorted,
    transient_bytes_per_replica,
)

__all__ = [
    "cohort_for_budget",
    "state_bytes_per_replica",
    "stream_merge_sorted",
    "transient_bytes_per_replica",
]
