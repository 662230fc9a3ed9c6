"""The port's cohort stream over a mesh (``stream_merge_sorted(mesh=,
shard_seq=)``) against the JAX package's stream over its virtual 8-device
mesh and the resident merge (tests/test_stream.py's mesh cases), on
tests/test_torch_stream.py's seeded inputs: 10 replicas, C = 512, M = 64.
The port's mesh is 8 x "cpu", each entry one logical shard.  Byte-equal
throughout: all 13 DocState fields and the uint32 digests."""
import jax
import numpy as np
import pytest

from peritext_tpu.parallel import make_mesh as jax_make_mesh
from peritext_tpu.parallel import stream as jstream
from peritext_tpu_torch.parallel import make_mesh
from peritext_tpu_torch.parallel import stream as S
from test_torch_stream import _args, assert_states_equal, clean_planes, merge_inputs  # noqa: F401

SHAPE = (4, 2)


def _meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    return jax_make_mesh(jax.devices()[:8], *SHAPE), make_mesh(["cpu"] * 8, *SHAPE)


def _counted(monkeypatch):
    """Count the merges the stream runs (one per replica group a cohort)."""
    calls = []
    real = S.merge_step_full
    monkeypatch.setattr(S, "merge_step_full", lambda st, *a: calls.append(st.elem_ctr.shape) or real(st, *a))
    return calls


@pytest.mark.parametrize("shard_seq", [True, False])
def test_stream_over_mesh_matches_jax_stream_and_resident(merge_inputs, shard_seq, monkeypatch):
    """Cohorts of 4 over the 4x2 mesh, seq split or not: each group of one
    replica merges on its group device; states and digests equal JAX's
    stream over its 4x2 mesh and the resident merge."""
    inputs, resident, digests = merge_inputs
    jm, pm = _meshes()
    calls = _counted(monkeypatch)
    out, dg, stats = S.stream_merge_sorted(*_args(inputs), cohort=4, mesh=pm, shard_seq=shard_seq)
    j_out, j_dg, j_stats = jstream.stream_merge_sorted(*_args(inputs), cohort=4, mesh=jm, shard_seq=shard_seq)
    np.testing.assert_array_equal(dg, digests)
    np.testing.assert_array_equal(dg, j_dg)
    assert_states_equal(out, resident)
    assert_states_equal(out, j_out)
    assert {k: stats[k] for k in j_stats} == j_stats
    assert stats["route"] == "kernels" and stats["capacity_routes"] == 0
    assert calls == [(1, 512)] * (3 * SHAPE[0])


def test_mesh_rounds_cohort_to_replica_axis(merge_inputs):
    """A cohort of 3 rounds up to 4 over the replica axis, as JAX's does."""
    inputs, resident, digests = merge_inputs
    jm, pm = _meshes()
    out, dg, stats = S.stream_merge_sorted(*_args(inputs), cohort=3, mesh=pm)
    _, _, j_stats = jstream.stream_merge_sorted(*_args(inputs), cohort=3, mesh=jm)
    assert stats["cohort"] == j_stats["cohort"] == 4
    assert stats["n_cohorts"] == 3 and stats["padded_tail"]
    np.testing.assert_array_equal(dg, digests)
    assert_states_equal(out, resident)


def test_mesh_depth_one_and_no_digest(merge_inputs):
    """Depth 1 (each cohort drained before the next) and the completion
    token in place of the digest, on the mesh."""
    inputs, resident, digests = merge_inputs
    jm, pm = _meshes()
    out, dg, stats = S.stream_merge_sorted(*_args(inputs), cohort=8, mesh=pm, depth=1)
    np.testing.assert_array_equal(dg, digests)
    assert_states_equal(out, resident)
    assert stats["depth"] == 1 and stats["n_cohorts"] == 2
    out, tokens, _ = S.stream_merge_sorted(*_args(inputs), cohort=4, mesh=pm, compute_digest=False)
    _, j_tokens, _ = jstream.stream_merge_sorted(*_args(inputs), cohort=4, mesh=jm, compute_digest=False)
    np.testing.assert_array_equal(tokens, np.asarray(resident.length).astype(np.uint32))
    np.testing.assert_array_equal(tokens, j_tokens)
    assert_states_equal(out, resident)


def test_mesh_capacity_route_runs_per_group(merge_inputs, monkeypatch):
    """Past the kernels' limit each group takes the sorted merge, counted
    once a cohort; the bytes do not change."""
    inputs, resident, digests = merge_inputs
    _, pm = _meshes()
    monkeypatch.setattr(S, "kernel_capacity_limit", lambda words: 256)
    calls = _counted(monkeypatch)
    out, dg, stats = S.stream_merge_sorted(*_args(inputs), cohort=4, mesh=pm, readback_states=False)
    assert out is None and calls == []
    assert stats["route"] == "sorted" and stats["capacity_routes"] == stats["n_cohorts"] == 3
    np.testing.assert_array_equal(dg, digests)


def test_mesh_and_device_are_exclusive(merge_inputs):
    inputs, _, _ = merge_inputs
    _, pm = _meshes()
    with pytest.raises(ValueError, match="mesh or a device"):
        S.stream_merge_sorted(*_args(inputs), cohort=4, mesh=pm, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        S.stream_merge_sorted(*_args(inputs), cohort=4, mesh=make_mesh(["cpu"] * 6, 2, 3))
