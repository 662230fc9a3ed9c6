"""The port's multi-host layer (peritext_tpu_torch/parallel/multihost.py)
against the JAX package's (tests/test_multihost.py): replica-slice
arithmetic at a world of one and under a monkeypatched world of four,
the global mesh over 8 x "cpu", state assembly field by field against
JAX's on its virtual 8-device mesh, the backends (gloo idempotent, NCCL
refused without CUDA), and a two-process gloo world whose ranks' rows,
gathered digests and all-reduced uint32 global digest equal JAX's
``sharded_apply`` on the whole batch.  Exact equality throughout."""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ops.state import make_empty_state as jax_empty_state
from peritext_tpu.ops.state import stack_states
from peritext_tpu.parallel import mesh as jmesh
from peritext_tpu.parallel import multihost as jmultihost
from peritext_tpu.schema import allow_multiple_array
from peritext_tpu_torch import state_to_numpy
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.parallel import multihost as M
from peritext_tpu_torch.parallel.mesh import gather_states, sharded_apply

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 60


def _np_fields(jax_state):
    return {f: np.asarray(jax.device_get(getattr(jax_state, f))) for f in FIELDS}


def _free_address() -> str:
    """A localhost port the OS just handed out (bound to 0, then freed)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _needs_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")


def test_local_replica_slice_single_process():
    assert not dist.is_initialized()
    assert M.local_replica_slice(16) == slice(0, 16) == jmultihost.local_replica_slice(16)


def test_local_replica_slice_multi_process(monkeypatch):
    """A world of 4 at rank 2: an even split, and JAX's error otherwise."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 2)
    assert M.local_replica_slice(16) == slice(8, 12)
    with pytest.raises(ValueError, match="must divide across 4 hosts; pad it"):
        M.local_replica_slice(17)


def test_global_mesh_covers_all_devices():
    """Axis names and coverage as JAX's global mesh; a world of one holds
    the whole replica axis, and ``devices=None`` needs a GPU."""
    _needs_8()
    mesh = M.global_mesh(seq_axis=2, devices=["cpu"] * 8)
    jm = jmultihost.global_mesh(seq_axis=2)
    assert mesh.axis_names == jm.axis_names == ("replica", "seq")
    assert mesh.devices.size == jm.devices.size == 8
    assert mesh.shape == dict(jm.shape) == mesh.global_shape == {"replica": 4, "seq": 2}
    assert (mesh.process_index, mesh.process_count) == (0, 1)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.global_mesh()


def test_assemble_global_states_matches_jax():
    """Host-local rows with distinct lengths assemble into JAX's global
    batch field by field, one replica a group of the 8-entry mesh."""
    _needs_8()
    states = stack_states([jax_empty_state(64, 32) for _ in range(8)])
    states = dataclasses.replace(states, length=jnp.arange(8, dtype=jnp.int32))
    sl = M.local_replica_slice(8)
    local = jax.tree.map(lambda x: np.asarray(x)[sl], states)
    want = jmultihost.assemble_global_states(local, states, jmultihost.global_mesh(seq_axis=1))
    mesh = M.global_mesh(devices=["cpu"] * 8)
    got = M.assemble_global_states(local, states, mesh)
    assert got.length.shards.shape == (8, 1) and got.length.shards[3, 0].tolist() == [3]
    got_np = state_to_numpy(gather_states(got))
    for f, ref in _np_fields(want).items():
        assert got_np[f].dtype == ref.dtype and (got_np[f] == ref).all(), f
    with pytest.raises(ValueError, match="equal shares"):
        M.assemble_global_states(jax.tree.map(lambda x: x[:3], local), states, mesh)


def test_initialize_distributed_is_idempotent_under_gloo():
    """A gloo world of one: a second call returns, the slice is the whole
    batch, and the global digest passes through the all_reduce unchanged."""
    address = _free_address()
    M.initialize_distributed(address, 1, 0, backend="gloo")
    try:
        M.initialize_distributed(address, 1, 0, backend="gloo")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert M.local_replica_slice(8) == slice(0, 8)
        mesh = M.global_mesh(devices=["cpu"] * 2)
        assert (mesh.process_index, mesh.process_count) == (0, 1)
        total = torch.tensor(2**33 + 5, dtype=torch.int64)
        assert int(mesh.reduce_total(total)) == 2**33 + 5
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_nccl_backend_needs_cuda_and_names_gloo():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        M.initialize_distributed(_free_address(), 1, 0)
    assert not dist.is_initialized()


def test_two_process_gloo_world_matches_jax_sharded_apply(tmp_path):
    """Two spawned ranks each merge their half of an 8-replica batch (3
    writers with marks, C = 64, M = 32) on a two-entry CPU mesh: each
    rank's rows, the all-gathered digests and the all-reduced global
    digest equal JAX's ``sharded_apply`` on the whole batch."""
    _needs_8()
    wl = make_merge_workload(doc_len=24, ops_per_merge=10, num_streams=3, with_marks=True, seed=11)
    b = build_device_batch(wl, 8, 64, 32)
    multi = allow_multiple_array()
    jm = jmesh.make_mesh(jax.devices()[:8], 4, 2)
    out, digests, total = jmesh.sharded_apply(jm)(
        jmesh.shard_states(b["states"], jm), jnp.asarray(b["text_ops"]), jnp.asarray(b["mark_ops"]),
        jnp.asarray(b["ranks"]), jnp.asarray(multi),
    )
    want = _np_fields(out)
    assert len(set(want["length"].tolist())) > 1 and want["mark_count"].max() > 0
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, text_ops=np.asarray(b["text_ops"]), mark_ops=np.asarray(b["mark_ops"]),
             ranks=np.asarray(b["ranks"]), multi=multi, **_np_fields(b["states"]))
    address = _free_address()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_multihost_worker.py"), address, str(rank),
                          "2", str(inputs), str(tmp_path / f"rank{rank}.npz")],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    ref_digests = np.asarray(digests).astype(np.int64)
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        rows = slice(4 * rank, 4 * rank + 4)
        for f in FIELDS:
            assert got[f].dtype == want[f].dtype and (got[f] == want[f][rows]).all(), (rank, f)
        assert (got["digests"] == ref_digests).all()
        assert int(got["total"]) == int(np.asarray(total)) == int(ref_digests.sum() & 0xFFFFFFFF)
        assert int(got["groups"]) == 4
