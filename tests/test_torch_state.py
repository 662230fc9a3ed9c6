"""The port's DocState against the JAX package's: same fields, shapes and
dtypes, and an exact round trip through numpy (tolerance 0)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ops import state as JS
from peritext_tpu_torch.ops import state as S

FIELDS = [f.name for f in dataclasses.fields(JS.DocState)]


def _jax_numpy(state):
    got = jax.device_get(state)
    return {name: np.asarray(getattr(got, name)) for name in FIELDS}


def _assert_same(a, b):
    assert set(a) == set(b) == set(FIELDS)
    for name in FIELDS:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].shape == b[name].shape, name
        assert (a[name] == b[name]).all(), name


def test_field_list_matches_jax():
    assert list(S.FIELDS) == FIELDS


@pytest.mark.parametrize("seed", [0, 1])
def test_round_trip_of_a_jax_batch(seed):
    workload = make_merge_workload(doc_len=100, ops_per_merge=24, num_streams=4, seed=seed)
    batch = build_device_batch(workload, num_replicas=6, capacity=256, max_mark_ops=64)
    ref = _jax_numpy(batch["states"])
    st = S.state_from_numpy(ref, device="cpu")
    for name in FIELDS:
        t = getattr(st, name)
        want = torch.bool if name in ("deleted", "bnd_def") else torch.int32
        assert t.dtype == want, name
    _assert_same(ref, S.state_to_numpy(st))


@pytest.mark.parametrize("capacity,marks", [(128, 32), (256, 64)])
def test_empty_state_matches_jax(capacity, marks):
    _assert_same(
        _jax_numpy(JS.make_empty_state(capacity, marks)),
        S.state_to_numpy(S.make_empty_state(capacity, marks, device="cpu")),
    )


def test_grow_stack_index_match_jax():
    workload = make_merge_workload(doc_len=40, ops_per_merge=8, num_streams=2, seed=3)
    batch = build_device_batch(workload, num_replicas=2, capacity=64, max_mark_ops=32)
    fields = _jax_numpy(batch["states"])
    single = JS.index_state(batch["states"], 1)
    grown = JS.grow_state(single, capacity=256, max_mark_ops=96)
    port = S.state_from_numpy(fields, device="cpu")
    port_single = S.index_state(port, 1)
    _assert_same(_jax_numpy(single), S.state_to_numpy(port_single))
    _assert_same(_jax_numpy(grown), S.state_to_numpy(S.grow_state(port_single, 256, 96)))
    # Growing the batched state grows every replica the same way.
    grown_batch = S.grow_state(port, 256, 96)
    _assert_same(_jax_numpy(grown), S.state_to_numpy(S.index_state(grown_batch, 1)))
    restacked = S.stack_states([S.index_state(port, i) for i in range(2)])
    _assert_same(fields, S.state_to_numpy(restacked))


def test_grow_state_rejects_shrink_and_odd_mark_width():
    st = S.make_empty_state(64, 32, device="cpu")
    with pytest.raises(ValueError, match="shrink"):
        S.grow_state(st, capacity=32)
    with pytest.raises(ValueError, match="multiple of 32"):
        S.grow_state(st, max_mark_ops=40)
    with pytest.raises(ValueError, match="multiple of 32"):
        S.make_empty_state(64, 33, device="cpu")


def test_mask_words_with_the_top_bit_survive_the_round_trip():
    st = JS.make_empty_state(8, 64)
    mask = np.zeros((16, 2), np.uint32)
    mask[3, 1] = 0x80000001
    mask[5, 0] = 0xFFFFFFFF
    fields = _jax_numpy(dataclasses.replace(st, bnd_mask=jax.numpy.asarray(mask)))
    port = S.state_from_numpy(fields, device="cpu")
    assert port.bnd_mask[3, 1].item() == -(2**31) + 1
    assert port.bnd_mask[5, 0].item() == -1
    _assert_same(fields, S.state_to_numpy(port))


@pytest.mark.parametrize("entry", ["state_from_numpy", "make_empty_state", "wcache_from_numpy"])
def test_no_device_means_the_card_and_raises_without_one(monkeypatch, entry):
    """``device=None`` (the default) resolves to the GPU; without one it
    raises naming ``device="cpu"`` instead of moving to the CPU quietly."""
    fields = S.state_to_numpy(S.make_empty_state(8, 32, device="cpu"))
    calls = {
        "state_from_numpy": lambda **kw: S.state_from_numpy(fields, **kw),
        "make_empty_state": lambda **kw: S.make_empty_state(8, 32, **kw),
        "wcache_from_numpy": lambda **kw: S.wcache_from_numpy(np.zeros((1, 16, 1, 4), np.int32), **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    got = calls[entry](device="cpu")
    assert (got if isinstance(got, torch.Tensor) else got.elem_ctr).device.type == "cpu"
