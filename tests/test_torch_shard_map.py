"""The port's explicit sequence-parallel kernels
(peritext_tpu_torch/parallel/shard.py) against the JAX package's
``shard_map`` forms, byte for byte.

The JAX side runs on the virtual 8-device CPU mesh from conftest.py, the
port's on 8 x "cpu" logical shards, with tests/test_shard_map.py's and
tests/test_sharding.py's own seeded inputs: ``make_merge_workload`` seeds
5, 11 and 13 at C = 256, the adversarial fleet at C = 128, and a paste
wider than a shard.  Every mask, ``has`` plane, placement plane and
DocState field must be equal (tolerance 0), and equal to the port's
unsharded ``flatten_sources`` / ``place_text_batch`` /
``merge_step_sorted_batch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ids import ActorRegistry
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops.encode import AttrRegistry, encode_changes, prepare_sorted_batch, split_rows
from peritext_tpu.ops.state import make_empty_state, stack_states
from peritext_tpu.oracle import Doc
from peritext_tpu.parallel import mesh as jmesh
from peritext_tpu.parallel import shard as jshard
from peritext_tpu_torch import state_to_numpy
from peritext_tpu_torch.ops import kernels as K
from peritext_tpu_torch.ops import sorted_merge
from peritext_tpu_torch.ops.state import FIELDS, state_from_numpy
from peritext_tpu_torch.parallel import mesh as M
from peritext_tpu_torch.parallel import shard as S
from test_sharding import _adversarial_states

PLACEMENT = ["elem_ctr", "elem_act", "deleted", "chars", "orig_idx", "length"]


@pytest.fixture(autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")


def _np(x):
    return np.array(jax.device_get(x))


def _port_state(jax_state):
    return state_from_numpy({f: _np(getattr(jax_state, f)) for f in FIELDS}, device="cpu")


def _meshes(shape):
    return jmesh.make_mesh(jax.devices()[:8], *shape), M.make_mesh(["cpu"] * 8, *shape)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flatten_both(jax_states, port_states, seq):
    """JAX's and the port's flatten_sources_sp over a (8 / seq, seq) mesh,
    and the port's unsharded flatten."""
    jm, pm = _meshes((8 // seq, seq))
    js = jmesh.shard_states(jax_states, jm)
    mask, has = jshard.flatten_sources_sp(jm)(js.deleted, js.bnd_def, js.bnd_mask, js.length)
    ps = M.shard_states(port_states, pm)
    got_mask, got_has = S.flatten_sources_sp(pm)(ps.deleted, ps.bnd_def, ps.bnd_mask, ps.length)
    assert got_mask.shards.shape == (8 // seq, seq)
    assert got_mask.shards[0, 0].shape[1] == port_states.capacity // seq
    # The unsharded flatten agrees on live elements; past the length JAX's
    # sequence-parallel form may carry the last live after slot instead.
    ref_mask, ref_has = K.flatten_sources(port_states)
    live = torch.arange(port_states.capacity)[None, :] < port_states.length[:, None]
    assert torch.equal(got_mask.full() * live[..., None], ref_mask * live[..., None])
    assert torch.equal(got_has.full() & live, ref_has & live)
    assert (got_mask.full().numpy().view(np.uint32) == _np(mask)).all()
    assert (got_has.full().numpy() == _np(has)).all()
    return _np(has)


@pytest.fixture(scope="module")
def merged():
    """tests/test_shard_map.py's merged fleet (seed 5, C = 256)."""
    workload = make_merge_workload(doc_len=100, ops_per_merge=32, num_streams=4, seed=5)
    b = build_device_batch(workload, num_replicas=8, capacity=256, max_mark_ops=64)
    states = JK.merge_step_batch(
        b["states"], jnp.asarray(b["text_ops"]), jnp.asarray(b["mark_ops"]), jnp.asarray(b["ranks"])
    )
    return states, _port_state(states)


@pytest.mark.parametrize("seq", [2, 4, 8])
def test_flatten_sources_sp_matches_jax(merged, seq):
    has = _flatten_both(*merged, seq)
    assert has.any()


def test_flatten_sources_sp_past_length_follows_jax(merged):
    """Pinned: where the last live element's after slot is defined, JAX's
    sequence-parallel flatten lets the first dead element take that slot's
    row, while the unsharded flatten carries the last deciding live row.
    The port follows JAX's form; live elements agree either way."""
    states, _ = merged
    fields = {f: _np(getattr(states, f)) for f in FIELDS}
    n = int(fields["length"][0])
    fields["bnd_def"][0, 2 * n - 1] = True
    fields["bnd_mask"][0, 2 * n - 1] = 0
    fields["bnd_def"][0, 2 * n - 2] = True
    fields["bnd_mask"][0, 2 * n - 2] = 5
    jax_states = type(states)(**{f: jnp.asarray(a) for f, a in fields.items()})
    port = state_from_numpy(fields, device="cpu")
    _flatten_both(jax_states, port, 2)
    got_mask, _ = S.flatten_sources_sp(M.make_mesh(["cpu"] * 8, 4, 2))(
        port.deleted, port.bnd_def, port.bnd_mask, port.length
    )
    ref_mask, _ = K.flatten_sources(port)
    assert (ref_mask[0, n] == 5).all() and (got_mask.full()[0, n] == 0).all()


@pytest.mark.parametrize("seq", [2, 8])
def test_flatten_sources_sp_adversarial_matches_jax(seq):
    """Empty and exactly-full replicas, and marks and a deletion straddling
    every shard edge of an 8-way split (tests/test_sharding.py's fleet)."""
    states, _ = _adversarial_states(128)
    has = _flatten_both(states, _port_state(states), seq)
    assert has.any() and not has.all()


def _placement_inputs(seed):
    workload = make_merge_workload(doc_len=120, ops_per_merge=48, num_streams=4, with_marks=False, seed=seed)
    b = build_device_batch(workload, num_replicas=8, capacity=256, max_mark_ops=64)
    sp = prepare_sorted_batch([b["text_ops"][r] for r in range(8)])
    return b, sp


def _halo(sp):
    """The round's insert budget, bucketed to a power of two as a caller
    would (tests/test_shard_map.py's)."""
    total = int(
        (sp["text"][..., JK.K_KIND] == JK.KIND_INSERT).sum(axis=1).max()
        + (sp["text"][..., JK.K_RUN_LEN] * (sp["text"][..., JK.K_KIND] == JK.KIND_INSERT_RUN)).sum(axis=1).max()
    )
    halo = 1
    while halo < max(total, 8):
        halo *= 2
    return halo


def _place_both(states, sp, ranks, mesh_shape, halo):
    jm, pm = _meshes(mesh_shape)
    js = jmesh.shard_states(states, jm)
    want = jshard.place_text_sp(jm, halo=halo, maxk=sp["maxk"])(
        js.elem_ctr, js.elem_act, js.deleted, js.chars, js.length, jnp.asarray(sp["text"]),
        jnp.asarray(sp["rounds"]), jnp.int32(sp["num_rounds"]), jnp.asarray(ranks), jnp.asarray(sp["bufs"]),
    )
    port = _port_state(states)
    ps = M.shard_states(port, pm)
    got = S.place_text_sp(pm, halo=halo, maxk=sp["maxk"])(
        ps.elem_ctr, ps.elem_act, ps.deleted, ps.chars, ps.length, _t(sp["text"]), _t(sp["rounds"]),
        sp["num_rounds"], _t(ranks), _t(sp["bufs"]),
    )
    ref = sorted_merge.place_text_batch(
        port.elem_ctr, port.elem_act, port.deleted, port.chars, port.length, _t(sp["text"]),
        _t(sp["rounds"]), sp["num_rounds"], _t(ranks), _t(sp["bufs"]), sp["maxk"],
    )
    for name, w, g, r in zip(PLACEMENT, want, got, ref):
        g = g.full()
        assert torch.equal(g, r), f"{mesh_shape}: {name} differs from place_text_batch"
        assert g.numpy().dtype == _np(w).dtype and (g.numpy() == _np(w)).all(), f"{mesh_shape}: {name} diverged"
    return sp


@pytest.mark.parametrize("seq", [2, 4])
def test_place_text_sp_matches_jax(seq):
    """Pmin stops and halo splices equal JAX's and the unsharded placement,
    blocks straddling shard edges and multi-round chains included."""
    b, sp = _placement_inputs(11)
    assert sp["num_rounds"] > 1
    _place_both(b["states"], sp, b["ranks"], (8 // seq, seq), _halo(sp))


def test_place_text_sp_paste_spans_shards():
    """One 80-char KIND_INSERT_RUN block over 32-wide shards: the halo of
    128 pulls several whole shards and the block lands across them."""
    base = Doc("base")
    genesis, _ = base.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("abcdefgh")},
    ])
    w = Doc("w")
    w.apply_change(genesis)
    paste, _ = w.change([{"path": ["text"], "action": "insert", "index": 3, "values": list("XY" * 40)}])
    actors, attrs = ActorRegistry(), AttrRegistry()
    grows, _, _ = encode_changes([genesis], actors, attrs)
    rows, _, _ = encode_changes([paste], actors, attrs, text_obj=genesis["ops"][0]["opId"])
    ranks = np.zeros(8, np.int32)
    ranks[: len(actors.ranks())] = actors.ranks()
    st = JK.apply_ops_jit(make_empty_state(128, 32), jnp.asarray(grows), jnp.asarray(ranks))
    t_rows, _ = split_rows(rows)
    sp = prepare_sorted_batch([t_rows] * 4)
    assert sp["maxk"] >= 80
    _place_both(stack_states([st] * 4), sp, ranks, (2, 4), 128)


def test_merge_step_sorted_sp_matches_jax():
    """Placement plus the mark tail on each group's gathered rows equals
    JAX's explicit-SP merge and the unsharded sorted merge on every field."""
    workload = make_merge_workload(doc_len=120, ops_per_merge=48, num_streams=4, with_marks=True, seed=13)
    b = build_device_batch(workload, num_replicas=8, capacity=256, max_mark_ops=64)
    sp = prepare_sorted_batch([b["text_ops"][r] for r in range(8)])
    jm, pm = _meshes((4, 2))
    want = jshard.merge_step_sorted_sp(jm, halo=128, maxk=sp["maxk"])(
        jmesh.shard_states(b["states"], jm), jnp.asarray(sp["text"]), jnp.asarray(sp["rounds"]),
        jnp.int32(sp["num_rounds"]), jnp.asarray(b["mark_ops"]), jnp.asarray(b["ranks"]), jnp.asarray(sp["bufs"]),
    )
    port = _port_state(b["states"])
    args = (_t(sp["text"]), _t(sp["rounds"]), sp["num_rounds"], _t(b["mark_ops"]), _t(b["ranks"]),
            _t(sp["bufs"]))
    got = S.merge_step_sorted_sp(pm, halo=128, maxk=sp["maxk"])(M.shard_states(port, pm), *args)
    assert got.elem_ctr.shards.shape == (4, 2) and got.bnd_mask.shards[0, 0].shape == (2, 256, 2)
    ref = state_to_numpy(sorted_merge.merge_step_sorted_batch(port, *args, sp["maxk"]))
    got_np = state_to_numpy(M.gather_states(got))
    assert (_np(b["mark_ops"])[..., JK.K_KIND] == JK.KIND_MARK).any()
    for f in FIELDS:
        w = _np(getattr(want, f))
        assert (got_np[f] == ref[f]).all(), f"{f} differs from merge_step_sorted_batch"
        assert got_np[f].dtype == w.dtype and (got_np[f] == w).all(), f"field {f} diverged"
