"""Device meshes and sharded replica state, in one process.

Counterpart of ``peritext_tpu/parallel/mesh.py``.  JAX's mesh layer is a
single controller: one process lays a ``(replica, seq)`` grid over its
devices, and GSPMD partitions each jitted step over it.  Here the same
grid is a ``Mesh`` of ``torch.device`` entries, and a sharded field is a
``ShardedTensor``: a grid of local tensors, block ``[i, j]`` on mesh
device ``[i, j]``, with the global shape and the placement spec.  Entries
may repeat (``8 x "cpu"`` in the tests, ``n x cuda:0`` on one card): each
entry is one logical shard.  Processes, and ``torch.distributed``, belong
to the multi-host layer (``parallel/multihost.py``): a mesh here holds one
process's devices, and its one hook, ``Mesh.reduce_total``, is where that
layer sums the global digest across processes.

Axes:

- ``replica``: the replica batch splits into groups.  Merges are
  replica-local, so a group merges on its own device with no exchange.
- ``seq``: the document capacity (C and 2C) optionally splits inside a
  group.  The mark table, ``length`` and ``mark_count`` are replicated
  within a group.

``sharded_apply`` runs the exact merge through the hand kernels once per
replica group (``cuda_kernels.merge_step_full``, then the digest kernel,
``cuda_kernels.convergence_digest``; their plain versions on the CPU).
There is no GSPMD to partition the per-op merge over ``seq``: a group's
seq shards are gathered onto the group's first device, merged whole and
split back, which is the explicit form of the collectives GSPMD inserts.
The global digest is the uint32 sum of the replicas' digests, wrapping as
JAX's ``jnp.sum`` of uint32 does.  ``parallel/shard.py`` has the explicit
sequence-parallel kernels.

A state can be built on the mesh (``empty_states``), so that no entry
ever holds the whole; ``select_rows`` and ``ShardedTensor.host_group``
read a group's rows entry by entry.  Under ``runtime.telemetry`` the mesh path counts what
it moves, by mesh position (so logical shards of one device count too):
``mesh.p2p_bytes``, bytes moved from one entry to another (a group's seq
shards joined or split, a replicated or plain input sent to a group other
than the first, the digest totals); ``mesh.gather_bytes``, bytes of a
whole tensor gathered onto one entry (``ShardedTensor.full``, so
``gather_states``).  A plain tensor, and a replicated input given as one
tensor, are taken to live on the first entry.  Spans: ``mesh.merge`` (one
merge's launches over every group) and ``mesh.digest`` (a digest over
every group, its reduction and its readback).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from peritext_tpu_torch.ops import cuda_kernels
from peritext_tpu_torch.ops.state import FIELDS, DocState, make_empty_state, resolve_device
from peritext_tpu_torch.runtime import telemetry

_U32 = 0xFFFFFFFF
AXES = ("replica", "seq")
Spec = Tuple[Optional[str], ...]


class Mesh:
    """A ``(replica, seq)`` grid of devices (JAX's ``Mesh``): ``devices``
    is an object array of ``torch.device``, ``shape`` maps each axis name
    to its size."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D device grid, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    def group_device(self, i: int) -> torch.device:
        """Where replica group ``i`` merges: its first seq shard's device."""
        return self.devices[i, 0]

    def reduce_total(self, total: torch.Tensor) -> torch.Tensor:
        """The global digest's int64 sum over every process holding part of
        the mesh: this process's own, since a mesh here is one process's
        (``parallel.multihost.GlobalMesh`` all-reduces it)."""
        return total

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def _cuda_devices() -> list:
    """Every visible CUDA device; without one, ``resolve_device``'s error
    (never a move to the CPU)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_slices(n_shards: int, devices: Optional[Sequence[Any]] = None) -> list:
    """Partition the devices into ``n_shards`` serving slices (JAX's
    ``mesh_slices``).  With shards <= devices each slice is a contiguous
    device group, the remainder devices on the leading slices; with more
    shards than devices, slices are singletons round-robin over the
    devices.  ``None`` means every visible CUDA device."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    devices = list(devices) if devices is not None else _cuda_devices()
    n_dev = len(devices)
    if n_shards >= n_dev:
        return [[devices[i % n_dev]] for i in range(n_shards)]
    base, extra = divmod(n_dev, n_shards)
    slices = []
    lo = 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < extra else 0)
        slices.append(devices[lo:hi])
        lo = hi
    return slices


def make_mesh(
    devices: Optional[Sequence[Any]] = None,
    replica_axis: Optional[int] = None,
    seq_axis: int = 1,
) -> Mesh:
    """Build a (replica, seq) mesh over ``devices`` (``None``: every
    visible CUDA device, raising without one)."""
    devices = [torch.device(d) for d in devices] if devices is not None else _cuda_devices()
    n = len(devices)
    if replica_axis is None:
        replica_axis = n // seq_axis
    if replica_axis * seq_axis != n:
        raise ValueError(f"mesh {replica_axis}x{seq_axis} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(replica_axis, seq_axis))


def _dim_of(spec: Spec, axis: str) -> Optional[int]:
    """The dimension ``spec`` splits over mesh axis ``axis``, if any."""
    return spec.index(axis) if axis in spec else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _moved(nbytes: int) -> None:
    """Count bytes moved from one mesh entry to another."""
    telemetry.counter("mesh.p2p_bytes", nbytes)


def _check_even(shape, mesh: Mesh, spec: Spec) -> None:
    for d, axis in enumerate(spec):
        if axis is not None and shape[d] % mesh.shape[axis]:
            raise ValueError(
                f"sharding {spec} over mesh {mesh.shape} implies that the global size of "
                f"dimension {d} should be divisible by {mesh.shape[axis]}, but it is equal "
                f"to {shape[d]} (full shape: {tuple(shape)})"
            )


class ShardedTensor:
    """A global tensor laid over a mesh.  ``spec[d]`` names the mesh axis
    dimension d splits over (``None``, or past the spec's end: whole), as
    JAX's ``PartitionSpec``; ``shards[i, j]`` is the block of mesh device
    ``[i, j]``, a copy of its group's block along an axis the spec does
    not name.  ``full()`` rebuilds the plain tensor byte for byte."""

    def __init__(self, mesh: Mesh, spec: Spec, shards: np.ndarray, shape: Tuple[int, ...]):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shards = shards
        self.shape = torch.Size(shape)

    @classmethod
    def split(cls, x: torch.Tensor, mesh: Mesh, spec: Spec) -> "ShardedTensor":
        """Lay a plain tensor over ``mesh``; an uneven split raises, as
        JAX's ``device_put`` under a ``NamedSharding`` does."""
        _check_even(x.shape, mesh, spec)
        r_dim = _dim_of(spec, "replica")
        if r_dim is None:
            groups = [x] * mesh.shape["replica"]
        else:
            n = x.shape[r_dim] // mesh.shape["replica"]
            groups = [x.narrow(r_dim, i * n, n) for i in range(mesh.shape["replica"])]
        if telemetry.enabled:
            _moved(sum(_nbytes(g) for g in groups[1:]))  # from the first entry to the other groups'
        return cls.from_groups(groups, mesh, spec)

    @classmethod
    def from_groups(cls, groups: Sequence[torch.Tensor], mesh: Mesh, spec: Spec) -> "ShardedTensor":
        """Lay each replica group's block (``groups[i]``, all of its seq
        extent, on the group's device) over the group's devices: split
        along the spec's ``seq`` dimension, else copied to each."""
        s_dim = _dim_of(spec, "seq")
        n_seq = mesh.shape["seq"]
        shards = np.empty((mesh.shape["replica"], n_seq), dtype=object)
        for i, g in enumerate(groups):
            for j in range(n_seq):
                piece = g
                if s_dim is not None:
                    n = g.shape[s_dim] // n_seq
                    piece = g.narrow(s_dim, j * n, n)
                if j and telemetry.enabled:
                    _moved(_nbytes(piece))
                shards[i, j] = piece.to(mesh.devices[i, j]).contiguous()
        shape = list(groups[0].shape)
        r_dim = _dim_of(spec, "replica")
        if r_dim is not None:
            shape[r_dim] *= mesh.shape["replica"]
        return cls(mesh, spec, shards, tuple(shape))

    def pieces(self, i: int) -> list:
        """Replica group ``i``'s distinct blocks: one a seq entry where the
        spec splits ``seq``, else the first entry's copy."""
        split = _dim_of(self.spec, "seq") is not None and self.shards.shape[1] > 1
        return list(self.shards[i] if split else self.shards[i, :1])

    def join(self, pieces: Sequence[torch.Tensor], device: Any) -> torch.Tensor:
        """``pieces`` of a group (as ``pieces`` gives them, or rows of them)
        joined on ``device``."""
        if len(pieces) == 1:
            return pieces[0].to(device)
        return torch.cat([p.to(device) for p in pieces], dim=_dim_of(self.spec, "seq"))

    def group(self, i: int, device: Optional[torch.device] = None) -> torch.Tensor:
        """Replica group ``i``'s block, its seq shards joined on ``device``
        (default: the group's device, the shards after the first counted
        as moved)."""
        pieces = self.pieces(i)
        if device is None:
            device = self.mesh.group_device(i)
            if telemetry.enabled:
                _moved(sum(_nbytes(p) for p in pieces[1:]))
        return self.join(pieces, device)

    def full(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The plain global tensor on ``device`` (default: the mesh's first),
        counted in ``mesh.gather_bytes``."""
        device = self.mesh.devices[0, 0] if device is None else device
        r_dim = _dim_of(self.spec, "replica")
        if r_dim is None:
            out = self.group(0, device)
        else:
            groups = [self.group(i, device) for i in range(self.mesh.shape["replica"])]
            out = torch.cat(groups, dim=r_dim)
        telemetry.counter("mesh.gather_bytes", _nbytes(out))
        return out

    def host_group(self, i: int, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
        """Rows [lo, hi) of replica group ``i``'s block (a tensor split over
        ``replica`` along its first dimension) on the host, each seq shard
        read from its own entry and joined there."""
        return self.join([p[lo:hi].cpu() for p in self.pieces(i)], "cpu")

    def tensors(self):
        """Every local block (for version tokens)."""
        return list(self.shards.flat)


def state_sharding(mesh: Mesh, shard_seq: bool = True) -> DocState:
    """A DocState of placement specs for batched [R, ...] state (JAX's
    ``state_sharding``): the replica axis splits over ``replica``, C and
    2C over ``seq`` when ``shard_seq``, and the mark table, ``length`` and
    ``mark_count`` are replicated within a replica group."""
    seq = "seq" if shard_seq else None
    table = ("replica", None)
    return DocState(
        elem_ctr=("replica", seq),
        elem_act=("replica", seq),
        deleted=("replica", seq),
        chars=("replica", seq),
        bnd_def=("replica", seq),
        bnd_mask=("replica", seq, None),
        mark_ctr=table,
        mark_act=table,
        mark_action=table,
        mark_type=table,
        mark_attr=table,
        length=("replica",),
        mark_count=("replica",),
    )


def is_sharded(states: DocState) -> bool:
    return isinstance(states.elem_ctr, ShardedTensor)


def gather_states(states: DocState, device: Optional[torch.device] = None) -> DocState:
    """The plain DocState of a sharded one (unchanged if plain)."""
    if not is_sharded(states):
        return states
    return DocState(**{f: getattr(states, f).full(device) for f in FIELDS})


def shard_states(states: DocState, mesh: Mesh, shard_seq: bool = True) -> DocState:
    """Lay a DocState over ``mesh`` (JAX's ``shard_states``).  A state
    already laid out so is returned as it is; one laid out otherwise is
    gathered and split again.  An uneven split (R % replica, or C %
    seq with ``shard_seq``) raises ``ValueError``."""
    specs = state_sharding(mesh, shard_seq)
    if is_sharded(states):
        if all(getattr(states, f).mesh is mesh and getattr(states, f).spec == getattr(specs, f) for f in FIELDS):
            return states
        states = gather_states(states)
    return DocState(**{f: ShardedTensor.split(getattr(states, f), mesh, getattr(specs, f)) for f in FIELDS})


def empty_states(
    n: int, capacity: int, max_mark_ops: int, mesh: Mesh, shard_seq: bool = True
) -> DocState:
    """``n`` empty replicas laid over ``mesh`` as ``shard_states`` lays
    them, each block made on its own entry: no entry holds more than its
    share.  An uneven split raises ``ValueError``."""
    specs = state_sharding(mesh, shard_seq)
    ones = {dev: make_empty_state(capacity, max_mark_ops, dev) for dev in set(mesh.devices.flat)}
    fields = {}
    for f in FIELDS:
        spec, s_dim = getattr(specs, f), _dim_of(getattr(specs, f), "seq")
        shape = (n,) + tuple(getattr(ones[mesh.devices[0, 0]], f).shape)
        _check_even(shape, mesh, spec)
        shards = np.empty(mesh.devices.shape, dtype=object)
        for (i, j), dev in np.ndenumerate(mesh.devices):
            x = getattr(ones[dev], f).unsqueeze(0)
            if s_dim is not None:
                k = shape[s_dim] // mesh.shape["seq"]
                x = x.narrow(s_dim, j * k, k)
            shards[i, j] = x.expand(n // mesh.shape["replica"], *x.shape[1:]).contiguous()
        fields[f] = ShardedTensor(mesh, spec, shards, shape)
    return DocState(**fields)


def group_state(states: DocState, i: int) -> DocState:
    """Replica group ``i``'s rows of a sharded state, whole, on its device."""
    return DocState(**{f: getattr(states, f).group(i) for f in FIELDS})


def from_group_states(groups: Sequence[DocState], mesh: Mesh, shard_seq: bool) -> DocState:
    """Split per-group states back over their groups' devices."""
    specs = state_sharding(mesh, shard_seq)
    return DocState(**{
        f: ShardedTensor.from_groups([getattr(g, f) for g in groups], mesh, getattr(specs, f)) for f in FIELDS
    })


def select_rows(states: DocState, i: int, rows: Sequence[int]) -> DocState:
    """Rows ``rows`` (indices within replica group ``i``) of a sharded
    state, on the group's device: each seq shard selects on its own entry
    and the selections are joined there."""
    mesh = states.elem_ctr.mesh
    idx = torch.as_tensor(list(rows), dtype=torch.long)
    out = {}
    for f in FIELDS:
        x = getattr(states, f)
        picked = [p.index_select(0, idx.to(p.device)) for p in x.pieces(i)]
        if telemetry.enabled:
            _moved(sum(_nbytes(p) for p in picked[1:]))
        out[f] = x.join(picked, mesh.group_device(i))
    return DocState(**out)


def group_rows(x: Any, mesh: Mesh, i: int) -> torch.Tensor:
    """Replica group ``i``'s rows of a per-replica [R, ...] input on its
    device: a sequence's ``i``-th entry (already there), a
    ``ShardedTensor``'s group, or a plain tensor's rows."""
    if isinstance(x, (list, tuple)):
        return x[i]
    if isinstance(x, ShardedTensor):
        return x.group(i)
    _check_even(x.shape, mesh, ("replica",))
    n = x.shape[0] // mesh.shape["replica"]
    rows = x[i * n : (i + 1) * n]
    if i and telemetry.enabled:
        _moved(_nbytes(rows))
    return rows.to(mesh.group_device(i))


def _replicated(x: Any, mesh: Mesh, i: int) -> torch.Tensor:
    """Group ``i``'s copy of an input every group reads whole: a sequence's
    ``i``-th entry (already there), or one tensor sent to the group."""
    if isinstance(x, (list, tuple)):
        return x[i]
    if i and telemetry.enabled:
        _moved(_nbytes(x))
    return x.to(mesh.group_device(i))


def sharded_merge_step(
    states: DocState,
    text_ops: Any,
    mark_ops: Any,
    ranks: torch.Tensor,
    char_buf: Any = None,
) -> DocState:
    """The exact merge of a sharded state: ``cuda_kernels.merge_step_full``
    (the text kernel, then the mark kernel as the tail) once per replica
    group on the group's device, each group's seq shards gathered before
    and split after.  The op rows are [R, ...] tensors, plain or sharded
    over ``replica``, or sequences of each group's rows already on its
    device; ``ranks`` is one tensor or each group's copy.  Every group's
    kernels are enqueued before anything waits on a card: given inputs on
    the groups' devices and one seq shard a group, nothing crosses
    between cards (span ``mesh.merge``)."""
    mesh = states.elem_ctr.mesh
    shard_seq = states.elem_ctr.spec[1] == "seq"
    outs = []
    with telemetry.span("mesh.merge"):
        for i in range(mesh.shape["replica"]):
            outs.append(cuda_kernels.merge_step_full(
                group_state(states, i),
                group_rows(text_ops, mesh, i),
                group_rows(mark_ops, mesh, i),
                _replicated(ranks, mesh, i),
                None if char_buf is None else group_rows(char_buf, mesh, i),
            ))
        return from_group_states(outs, mesh, shard_seq)


def group_digests(states: DocState, ranks: Any, multi: Any):
    """Each replica group's digests on its device, and their uint32 sum
    (wrapping) on the mesh's first device, summed over the processes the
    mesh spans (``Mesh.reduce_total``) before the wrap.  ``ranks`` and
    ``multi``: one tensor or each group's copy."""
    mesh = states.elem_ctr.mesh
    groups = [cuda_kernels.convergence_digest(group_state(states, i), _replicated(ranks, mesh, i),
                                              _replicated(multi, mesh, i))
              for i in range(mesh.shape["replica"])]
    first = mesh.devices[0, 0]
    sums = [g.sum() for g in groups]
    if telemetry.enabled:
        _moved(sum(_nbytes(t) for t in sums[1:]))
    total = mesh.reduce_total(sum(t.to(first) for t in sums)) & _U32
    return groups, total


def read_digests(states: DocState, ranks: Any, multi: Any) -> Tuple[np.ndarray, int]:
    """Every replica's digest (uint32, read from each group's device and
    joined on the host) and the global digest (span ``mesh.digest``)."""
    with telemetry.span("mesh.digest"):
        groups, total = group_digests(states, ranks, multi)
        return np.concatenate([g.cpu().numpy() for g in groups]).astype(np.uint32), int(total)


def _digests(states: DocState, ranks: torch.Tensor, multi: torch.Tensor):
    """Per-replica digests (sharded over ``replica``) and their global
    digest (``group_digests``)."""
    groups, total = group_digests(states, ranks, multi)
    return ShardedTensor.from_groups(groups, states.elem_ctr.mesh, ("replica",)), total


def sharded_apply(mesh: Mesh, shard_seq: bool = True) -> Callable:
    """The full sharded step (JAX's ``sharded_apply``): ``(states,
    text_ops, mark_ops, ranks, multi, char_buf=None) -> (states, digests,
    global_digest)``.  ``states`` is laid over ``mesh`` (a plain state is
    laid out first), ``digests`` [R] is sharded over ``replica``
    (``full()`` for the plain tensor) and ``global_digest`` is a 0-d int64
    tensor holding the wrapped uint32 sum.  ``char_buf`` carries fused
    insert runs' characters, as ``kernels.merge_step``'s does."""

    def step(states, text_ops, mark_ops, ranks, multi, char_buf=None):
        states = shard_states(states, mesh, shard_seq)
        new_states = sharded_merge_step(states, text_ops, mark_ops, ranks, char_buf)
        digests, total = _digests(new_states, ranks, multi)
        return new_states, digests, total

    return step


def sharded_digest_reduce(mesh: Mesh, shard_seq: bool = True) -> Callable:
    """Batched digests and their global reduce over ``mesh`` (JAX's
    ``sharded_digest_reduce``): ``(states, ranks, multi) -> (digests,
    global_digest)``."""

    def reduce(states, ranks, multi):
        return _digests(shard_states(states, mesh, shard_seq), ranks, multi)

    return reduce
