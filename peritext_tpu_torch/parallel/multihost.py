"""Multi-process replica batches over ``torch.distributed``.

Counterpart of ``peritext_tpu/parallel/multihost.py``.  JAX spans hosts
with one program over a global mesh; here each process is one rank of a
``torch.distributed`` process group and holds a :class:`GlobalMesh`: its
own ``(replica, seq)`` grid of local devices (a ``parallel.mesh.Mesh``)
plus its place among the processes.  The global replica axis is the
processes' grids stacked in rank order, so each process's local devices
are contiguous on it, as in JAX's global mesh.  A process computes only
on its own replica rows and holds tensors only for them: the op rows it
passes to ``parallel.mesh.sharded_apply`` are its rows too
(``local_replica_slice``).  Replicas never exchange data during a merge,
so the one collective is the global digest's sum, an ``all_reduce`` of
the processes' int64 partial sums, masked to 32 bits after it (the
wrapping uint32 sum JAX's ``jnp.sum`` gives).  Per-replica digests stay
on their process; ``torch.distributed.all_gather`` collects them.

Processes, ranks and collectives belong to this module alone:
``parallel/mesh.py`` stays one process's layer, with one hook
(``Mesh.reduce_total``) that :class:`GlobalMesh` fills in.  The backend
is the caller's choice and is never switched: NCCL (the default) needs a
CUDA device, gloo runs on the CPU.  One H100 is a world of one process.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from peritext_tpu_torch.ops.state import FIELDS, DocState, state_from_numpy
from peritext_tpu_torch.parallel.mesh import Mesh, _cuda_devices, make_mesh, shard_states


def _world() -> tuple:
    """(process count, this process's index): 1 and 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """Join the process group (idempotent: a second call returns).

    With ``coordinator_address`` (``host:port``, rank 0 listening there)
    the group meets at ``tcp://`` with ``num_processes`` and
    ``process_id``; without it, torchrun's ``env://`` variables say
    everything (JAX's autodiscovery).  ``backend="nccl"`` needs CUDA and
    raises without it; pass ``backend="gloo"`` for a group on the CPU."""
    if dist.is_initialized():
        return
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            'backend="nccl" needs a CUDA device and none is available; pass '
            'backend="gloo" to join the process group on the CPU'
        )
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
        )


class GlobalMesh(Mesh):
    """This process's part of a ``(replica, seq)`` mesh over every
    process's devices.  ``devices`` and ``shape`` are the local grid (what
    the one-process layer lays state over); ``global_shape`` has the
    replica axis over every process; this process's groups are global
    groups ``[process_index * shape["replica"], (process_index + 1) *
    shape["replica"])``."""

    def __init__(self, devices: np.ndarray, process_index: int, process_count: int):
        super().__init__(devices)
        self.process_index = process_index
        self.process_count = process_count
        self.global_shape = {"replica": self.shape["replica"] * process_count, "seq": self.shape["seq"]}

    def reduce_total(self, total: torch.Tensor) -> torch.Tensor:
        """The int64 sum over every process (an ``all_reduce`` while a
        process group is up)."""
        if dist.is_available() and dist.is_initialized():
            total = total.to(torch.int64).clone()
            dist.all_reduce(total)
        return total

    def __repr__(self) -> str:
        return (f"GlobalMesh(process {self.process_index} of {self.process_count}, "
                f"global {self.global_shape}, local {self.devices.tolist()})")


def global_mesh(seq_axis: int = 1, devices: Optional[Sequence[Any]] = None) -> GlobalMesh:
    """The ``(replica, seq)`` mesh over every device of every process, as
    this process holds it: its local ``devices`` (``None``: every visible
    CUDA device, raising without one) grouped ``seq_axis`` to a replica
    group, and its rank's place on the replica axis."""
    local = make_mesh(list(devices) if devices is not None else _cuda_devices(), seq_axis=seq_axis)
    count, index = _world()
    return GlobalMesh(local.devices, index, count)


def local_replica_slice(num_replicas: int) -> slice:
    """The ``[start, stop)`` replica-batch rows this process owns.  The
    batch must divide evenly across processes; pad it otherwise."""
    n, index = _world()
    if num_replicas % n != 0:
        raise ValueError(
            f"replica batch of {num_replicas} must divide across {n} hosts; pad it"
        )
    per = num_replicas // n
    start = index * per
    return slice(start, start + per)


def _field(states: Any, name: str) -> Any:
    """Field ``name`` of a DocState-like object or a mapping of fields."""
    return states[name] if isinstance(states, Mapping) else getattr(states, name)


def assemble_global_states(local_states: Any, global_shape_states: Any, mesh: GlobalMesh) -> DocState:
    """Lay this process's ``[r_local, ...]`` rows into its part of the
    global batch: ``local_states`` (tensors, or numpy fields with uint32
    mask words as ``state_to_numpy`` gives them; a DocState or a mapping)
    over the local grid of ``mesh``, replica axis split and capacity whole
    (JAX's ``P("replica", None, ...)``).  ``global_shape_states`` gives
    each field's global shape (anything with a ``.shape`` a field); the
    rows must be one process's equal share of it, or this raises
    ``ValueError``."""
    count = getattr(mesh, "process_count", 1)
    for f in FIELDS:
        local, want = tuple(_field(local_states, f).shape), tuple(_field(global_shape_states, f).shape)
        if local[1:] != want[1:] or local[0] * count != want[0]:
            raise ValueError(
                f"{f}: local rows {local} are not one of {count} equal shares of the global {want}"
            )
    device = mesh.devices[0, 0]
    if all(isinstance(_field(local_states, f), torch.Tensor) for f in FIELDS):
        states = DocState(**{f: _field(local_states, f).to(device) for f in FIELDS})
    else:
        states = state_from_numpy({f: np.asarray(_field(local_states, f)) for f in FIELDS}, device=device)
    return shard_states(states, mesh, shard_seq=False)
