"""The port's mesh layer (peritext_tpu_torch/parallel/mesh.py and
``TorchUniverse.shard``) against the JAX package's, byte for byte.

The JAX side runs on the virtual 8-device CPU mesh from conftest.py; the
port's mesh is 8 x "cpu", each entry one logical shard.  Both sides take
the same seeded numpy inputs (tests/test_sharding.py's own: the
``make_merge_workload(48, 12, 4, seed=3)`` batch at R = 16, C = 128,
M = 64, and its adversarial fleet at C = 64, 128 and 256).  Every
DocState field, digest, mask and ``has`` plane must be equal (tolerance
0), the global digest's uint32 wrap included, and the error cases raise
as JAX's do.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops.encode import prepare_sorted_batch
from peritext_tpu.ops.universe import TpuUniverse
from peritext_tpu.parallel import mesh as jmesh
from peritext_tpu.schema import allow_multiple_array
from peritext_tpu.testing import generate_docs
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops import sorted_merge
from peritext_tpu_torch.ops.state import FIELDS, state_from_numpy
from peritext_tpu_torch.parallel import mesh as M
from peritext_tpu_torch.parallel import shard as S
from test_sharding import _adversarial_states

MESHES = [(8, 1), (4, 2), (2, 4)]


def _np(x):
    return np.array(jax.device_get(x))


def _port_state(jax_state):
    return state_from_numpy({f: _np(getattr(jax_state, f)) for f in FIELDS}, device="cpu")


def _assert_state_equal(jax_state, port_state, context):
    got = state_to_numpy(M.gather_states(port_state))
    for f in FIELDS:
        ref = _np(getattr(jax_state, f))
        assert got[f].dtype == ref.dtype and got[f].shape == ref.shape, f"{context}: {f}"
        assert (got[f] == ref).all(), f"{context}: field {f} diverged"


def _meshes(shape):
    return jmesh.make_mesh(jax.devices()[:8], *shape), M.make_mesh(["cpu"] * 8, *shape)


@pytest.fixture(scope="module")
def batch():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    workload = make_merge_workload(doc_len=48, ops_per_merge=12, num_streams=4, seed=3)
    b = build_device_batch(workload, num_replicas=16, capacity=128, max_mark_ops=64)
    b["port"] = _port_state(b["states"])
    return b


@functools.lru_cache(maxsize=None)
def adversarial_fleet(capacity):
    """tests/test_sharding.py's 8-replica fleet (empty, exactly full, marks
    straddling every shard edge) and its port state."""
    states, ranks = _adversarial_states(capacity)
    return states, ranks, _port_state(states)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_apply_matches_jax(batch, mesh_shape, monkeypatch):
    """One full step: the merge once per replica group (counted through
    ``merge_step_full``), the digests and the wrapped uint32 sum."""
    jm, pm = _meshes(mesh_shape)
    multi = allow_multiple_array()
    out, digests, total = jmesh.sharded_apply(jm)(
        jmesh.shard_states(batch["states"], jm), jnp.asarray(batch["text_ops"]),
        jnp.asarray(batch["mark_ops"]), jnp.asarray(batch["ranks"]), jnp.asarray(multi),
    )
    calls = []
    real = M.cuda_kernels.merge_step_full
    monkeypatch.setattr(M.cuda_kernels, "merge_step_full", lambda *a: calls.append(a[0]) or real(*a))
    sharded = M.shard_states(batch["port"], pm)
    got, got_digests, got_total = M.sharded_apply(pm)(
        sharded, torch.from_numpy(np.asarray(batch["text_ops"])),
        torch.from_numpy(np.asarray(batch["mark_ops"])), torch.from_numpy(np.asarray(batch["ranks"])),
        torch.from_numpy(multi),
    )
    r, s = mesh_shape
    assert len(calls) == r and all(st.elem_ctr.shape == (16 // r, 128) for st in calls)
    assert got.elem_ctr.shards.shape == (r, s) and got.elem_ctr.shards[0, 0].shape == (16 // r, 128 // s)
    assert got.mark_ctr.shards[0, 0].shape == (16 // r, 64)
    _assert_state_equal(out, got, f"sharded_apply {mesh_shape}")
    ref = _np(digests)
    assert (got_digests.full().numpy() == ref.astype(np.int64)).all()
    assert ref.astype(np.int64).sum() > 2**32  # the sum wraps: the mask is exercised
    assert int(got_total) == int(_np(total)) == int(ref.astype(np.int64).sum() & 0xFFFFFFFF)


def test_sharded_digest_reduce_matches_jax(batch):
    jm, pm = _meshes((4, 2))
    multi = allow_multiple_array()
    digests, total = jmesh.sharded_digest_reduce(jm)(
        jmesh.shard_states(batch["states"], jm), jnp.asarray(batch["ranks"]), jnp.asarray(multi)
    )
    got, got_total = M.sharded_digest_reduce(pm)(
        M.shard_states(batch["port"], pm), torch.from_numpy(np.asarray(batch["ranks"])), torch.from_numpy(multi)
    )
    assert (got.full().numpy() == _np(digests).astype(np.int64)).all()
    assert int(got_total) == int(_np(total))


def test_sharded_digests_take_one_digest_call_per_group(batch, monkeypatch):
    """The sharded digest is one call of ``cuda_kernels.convergence_digest``
    (one launch of the digest kernel on the card) per replica group, on the
    group's gathered rows."""
    pm = M.make_mesh(["cpu"] * 8, 4, 2)
    calls = []
    real = M.cuda_kernels.convergence_digest
    monkeypatch.setattr(M.cuda_kernels, "convergence_digest", lambda *a: calls.append(a[0]) or real(*a))
    ranks, multi = torch.from_numpy(np.asarray(batch["ranks"])), torch.from_numpy(allow_multiple_array())
    got, _ = M.sharded_digest_reduce(pm)(M.shard_states(batch["port"], pm), ranks, multi)
    assert [st.chars.shape for st in calls] == [(4, 128)] * 4
    assert torch.equal(got.full(), K.convergence_digest(batch["port"], ranks, multi))


def test_sorted_merge_on_sharded_state_matches_jax(batch):
    """JAX's sorted merge on a (4, 2)-sharded state (GSPMD partitions it);
    the port's sorted route gathers the shards, merges and lays the result
    out again."""
    jm, pm = _meshes((4, 2))
    sp = prepare_sorted_batch([batch["text_ops"][r] for r in range(16)])
    args = (sp["text"], sp["rounds"], sp["num_rounds"], np.asarray(batch["mark_ops"]),
            np.asarray(batch["ranks"]), sp["bufs"], sp["maxk"])
    want = JK.merge_step_sorted_batch(
        jmesh.shard_states(batch["states"], jm),
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
    )
    sharded = M.shard_states(batch["port"], pm)
    got = M.shard_states(sorted_merge.merge_step_sorted_batch(
        M.gather_states(sharded), *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args),
    ), pm)
    _assert_state_equal(want, got, "sorted on (4, 2)")


@pytest.mark.parametrize("capacity", [64, 256])
@pytest.mark.parametrize("mesh_shape", [(1, 8), (4, 2), (8, 1)])
def test_flatten_and_digests_adversarial(capacity, mesh_shape):
    """Empty and exactly-full replicas, tombstones and marks straddling
    every shard edge: JAX's flatten and digests under mesh shardings
    against the port's sequence-parallel flatten and sharded digests."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    states, ranks, port = adversarial_fleet(capacity)
    jm, pm = _meshes(mesh_shape)
    multi = allow_multiple_array()
    sharded = jmesh.shard_states(states, jm)
    mask, has = jax.jit(jax.vmap(JK.flatten_sources), in_shardings=(jmesh.state_sharding(jm, True),))(sharded)
    digests = JK.convergence_digest_batch(sharded, ranks, jnp.asarray(multi))

    ps = M.shard_states(port, pm)
    got_mask, got_has = S.flatten_sources_sp(pm)(ps.deleted, ps.bnd_def, ps.bnd_mask, ps.length)
    assert (got_mask.full().numpy().view(np.uint32) == _np(mask)).all()
    assert (got_has.full().numpy() == _np(has)).all()
    assert _np(has).any() and not _np(has).all()
    got_digests, _ = M.sharded_digest_reduce(pm)(ps, torch.from_numpy(_np(ranks)), torch.from_numpy(multi))
    assert (got_digests.full().numpy() == _np(digests).astype(np.int64)).all()


def test_patched_path_on_replica_sharded_state_matches_jax(batch):
    """The per-op patch path on an (8, 1) replica-sharded state: JAX's
    under mesh shardings, the port's on the gathered shards; the state
    and every per-op record equal."""
    jm, pm = _meshes((8, 1))
    rows = np.concatenate([batch["text_ops"], batch["mark_ops"]], axis=1)
    multi = allow_multiple_array()
    rep = NamedSharding(jm, P())
    fn = jax.jit(
        jax.vmap(JK.apply_ops_patched, in_axes=(0, 0, None, None)),
        in_shardings=(jmesh.state_sharding(jm, False), NamedSharding(jm, P("replica", None, None)), rep, rep),
    )
    want_state, want = fn(jmesh.shard_states(batch["states"], jm, shard_seq=False), jnp.asarray(rows),
                          jnp.asarray(batch["ranks"]), jnp.asarray(multi))
    sharded = M.shard_states(batch["port"], pm, shard_seq=False)
    got_state, got = K.apply_ops_patched(
        M.gather_states(sharded), torch.from_numpy(rows), torch.from_numpy(np.asarray(batch["ranks"])),
        torch.from_numpy(multi), readback="planes",
    )
    _assert_state_equal(want_state, M.shard_states(got_state, pm, shard_seq=False), "patched (8, 1)")
    for name, ref in want.items():
        ref = _np(ref)
        g = got[name].numpy()
        if ref.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == ref.shape and (g == ref).all(), f"record {name} diverged"


def test_mesh_slices_match_jax():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    jdevs = jax.devices()[:8]
    pdevs = [torch.device("cpu", i) for i in range(8)]
    for n in range(1, 11):
        want = [[jdevs.index(d) for d in sl] for sl in jmesh.mesh_slices(n, jdevs)]
        got = [[d.index for d in sl] for sl in M.mesh_slices(n, pdevs)]
        assert got == want, n
    for bad in (0, -1):
        with pytest.raises(ValueError) as jerr:
            jmesh.mesh_slices(bad, jdevs)
        with pytest.raises(ValueError) as perr:
            M.mesh_slices(bad, pdevs)
        assert str(perr.value) == str(jerr.value)


def test_mesh_errors_raise_as_jax(batch):
    """A mesh shape that does not tile the devices, and uneven splits of
    the replica axis and of C, raise ``ValueError`` on both sides; with no
    CUDA device ``make_mesh()`` raises and never falls back to the CPU."""
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(jax.devices()[:8], 3, 2)
    with pytest.raises(ValueError) as perr:
        M.make_mesh(["cpu"] * 8, 3, 2)
    assert str(perr.value) == str(jerr.value) == "mesh 3x2 != 8 devices"
    for shape in [(3, 2), (2, 3)]:  # 16 % 3 replicas, 128 % 3 slots
        with pytest.raises(ValueError):
            jmesh.shard_states(batch["states"], jmesh.make_mesh(jax.devices()[:6], *shape))
        with pytest.raises(ValueError, match="divisible by 3"):
            M.shard_states(batch["port"], M.make_mesh(["cpu"] * 6, *shape))
    # Unsharded capacity splits evenly over any seq axis.
    M.shard_states(batch["port"], M.make_mesh(["cpu"] * 6, 2, 3), shard_seq=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.mesh_slices(2)


def test_universe_shard_then_add_replicas_matches_jax():
    """tests/test_sharding.py's elastic case: shard over (8, 1), add two
    replicas (the port drops the layout, JAX reshards), merge; texts and
    digests equal the JAX universe's."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    docs, _, genesis = generate_docs("sharded elastic")
    doc1, _ = docs
    names = [f"r{i}" for i in range(8)]
    c, _ = doc1.change([{"path": ["text"], "action": "insert", "index": 0, "values": list("hi ")}])
    batch = {n: [c] for n in names}
    batch["late0"] = [genesis, c]
    batch["late1"] = [genesis, c]

    jax_uni = TpuUniverse(names)
    jax_uni.apply_changes({n: [genesis] for n in names})
    jax_uni.shard(jmesh.make_mesh(jax.devices()[:8], 8, 1), shard_seq=False)
    jax_uni.add_replicas(["late0", "late1"])
    jax_uni.apply_changes(batch)

    uni = TorchUniverse(names, device="cpu")
    uni.apply_changes({n: [genesis] for n in names})
    uni.shard(M.make_mesh(["cpu"] * 8, 8, 1), shard_seq=False)
    assert M.is_sharded(uni._states)
    uni.add_replicas(["late0", "late1"])
    assert uni._layout is None and not M.is_sharded(uni._states)
    with pytest.raises(ValueError):  # 10 replicas do not split 8 ways
        uni.shard(M.make_mesh(["cpu"] * 8, 8, 1))
    assert uni._layout is None
    uni.apply_changes(batch)
    assert uni.texts() == jax_uni.texts()
    assert (uni.digests() == jax_uni.digests()).all()
    assert (uni.digests() == uni.digests()[0]).all()
    uni.shard(M.make_mesh(["cpu"] * 2, 2, 1))
    assert uni.text("late1") == jax_uni.text("r0")


def _writer_universe(names, wl, shape, rounds):
    uni = TorchUniverse(names, capacity=256, max_mark_ops=64, device="cpu")
    if shape is not None:
        uni.shard(M.make_mesh(["cpu"] * 8, *shape))
    uni.apply_changes({n: [wl["genesis"]] for n in names})
    for rnd in wl["rounds"][:rounds]:
        uni.apply_changes({n: rnd[i % 4] for i, n in enumerate(names)})
    return uni


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_universe_equals_unsharded(mesh_shape, monkeypatch):
    """A sharded universe's default route merges each replica group on the
    kernels' path and stays sharded between merges; texts, spans,
    digests, cursors and checkpoints equal an unsharded universe's; a write
    into a shard moves the states token, and one into the gathered view
    reaches the next merge on the shards; sorted-route and patched merges
    gather and are laid out again."""
    from peritext_tpu_torch.bench.workloads import make_writer_rounds
    from peritext_tpu_torch.runtime import checkpoint

    wl = make_writer_rounds(120, 16, 4, 5, True, seed=1)
    names = [f"r{i}" for i in range(16)]
    ref = _writer_universe(names, wl, None, 2)
    groups = []
    real = M.cuda_kernels.merge_step_full
    monkeypatch.setattr(M.cuda_kernels, "merge_step_full", lambda *a: groups.append(1) or real(*a))
    uni = _writer_universe(names, wl, mesh_shape, 2)
    assert len(groups) == 3 * mesh_shape[0] and M.is_sharded(uni._states)
    assert uni._gathered is None  # the default route never gathered
    assert uni.texts() == ref.texts() and (uni.digests() == ref.digests()).all()
    assert [uni.spans(r) for r in range(16)] == [ref.spans(r) for r in range(16)]
    cursors = ref.get_cursors([3] * 16)
    assert uni.get_cursors([3] * 16) == cursors
    assert uni.resolve_cursors(cursors) == ref.resolve_cursors(cursors)
    assert checkpoint.export_replica(uni, "r5")["digest"] == checkpoint.export_replica(ref, "r5")["digest"]

    token = uni._states_token()
    uni._states.chars.shards[-1, -1][0, 0] += 1
    assert uni._states_token() != token
    uni._states.chars.shards[-1, -1][0, 0] -= 1

    # A write into the gathered view reaches the next merge on the shards.
    for u in (ref, uni):
        u.states.chars[:, 0] += 1
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")
    for k, path in ((2, "scan"), (3, "sorted"), (4, "patched")):
        monkeypatch.setenv("PERITEXT_MERGE_PATH", "scan" if path == "patched" else path)
        batch = {n: wl["rounds"][k][i % 4] for i, n in enumerate(names)}
        if path == "patched":
            assert uni.apply_changes_with_patches(batch) == ref.apply_changes_with_patches(batch)
        else:
            for u in (ref, uni):
                u.apply_changes(batch)
        assert M.is_sharded(uni._states) and uni.stats["launches"] == ref.stats["launches"]
        for f in FIELDS:
            assert torch.equal(getattr(uni.states, f), getattr(ref.states, f)), f"{path}: {f}"
