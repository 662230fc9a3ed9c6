"""A universe laid out on a device mesh from its construction
(``TorchUniverse(..., mesh=...)``): built on the mesh, merged through the
genesis, writer rounds and the all-to-all with each replica group's op
rows uploaded to its own entry, and read back group by group, it equals
the reference's replay and an unsharded universe byte for byte, and never
gathers its state onto one entry (``mesh.gather_bytes``).  Without a mesh,
construction and upload are as they were: the same states and the same
``ingest.h2d_bytes``."""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.ops.state import FIELDS, make_empty_state, map_state
from peritext_tpu_torch.parallel import mesh as M
from peritext_tpu_torch.runtime import telemetry
from portbench.drivers.epochs import epoch_batches, expected
from portbench.gen.wire import wire_fuzz_rounds
from portbench.reference.digest import attr_numbers, digest

R, C, MARKS, WRITERS = 64, 256, 32, 4
CASES = [((4, 1), True), ((4, 1), False), ((2, 2), True), ((2, 2), False)]


@pytest.fixture
def counting():
    """Telemetry on for the test, pristine after it."""
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def workload():
    return wire_fuzz_rounds(120, 16, WRITERS, 2, seed=7)


def _counter(name: str) -> int:
    return telemetry.snapshot()["counters"].get(name, 0)


def _merged(wl, **kw) -> TorchUniverse:
    uni = TorchUniverse([f"r{i}" for i in range(R)], capacity=C, max_mark_ops=MARKS, device="cpu", **kw)
    for batch in epoch_batches(wl, R, WRITERS):
        uni.apply_changes(batch)
    return uni


@pytest.mark.parametrize("shape, shard_seq", CASES)
def test_resident_universe_matches_reference_and_unsharded(shape, shard_seq, workload, counting):
    mesh = M.make_mesh(["cpu"] * 4, *shape)
    uni = _merged(workload, mesh=mesh, shard_seq=shard_seq)
    assert M.is_sharded(uni._states) and uni._gathered is None
    want = expected(workload, WRITERS)
    numbers = attr_numbers([workload["genesis"]] + [c for rnd in workload["rounds"] for s in rnd for c in s])
    texts = uni.texts()
    sample = sorted({0, R - 1, R // 4, R // 4 - 1} | set(random.Random(3).sample(range(R), 12)))
    spans = [uni.spans(r) for r in sample]
    digests = uni.digests()
    assert _counter("mesh.gather_bytes") == 0

    assert texts == ["".join(s["text"] for s in want[r % WRITERS]) for r in range(R)]
    assert spans == [want[r % WRITERS] for r in sample]
    assert uni.spans_batch() == [want[r % WRITERS] for r in range(R)]
    assert uni.text(R - 1) == texts[-1]
    ref_digests = np.array([digest(want[k], numbers) for k in range(WRITERS)], np.uint32)
    assert (digests == ref_digests[np.arange(R) % WRITERS]).all()
    assert uni.global_digest == int(digests.astype(np.int64).sum()) & 0xFFFFFFFF
    assert _counter("mesh.gather_bytes") == 0

    plain = _merged(workload)
    gathered = M.gather_states(uni._states)
    for f in FIELDS:
        assert torch.equal(getattr(gathered, f), getattr(plain.states, f)), f
    assert (plain.digests() == digests).all()


@pytest.mark.parametrize("shape, shard_seq", CASES)
def test_resident_construction_lays_each_block_on_its_entry(shape, shard_seq, counting):
    """Each entry's blocks are its share of an empty fleet; nothing moved."""
    mesh = M.make_mesh(["cpu"] * 4, *shape)
    uni = TorchUniverse([f"r{i}" for i in range(R)], capacity=C, max_mark_ops=MARKS, mesh=mesh,
                        shard_seq=shard_seq)
    assert uni.device == torch.device("cpu") and uni._layout == (mesh, shard_seq)
    rows, seq = R // shape[0], (shape[1] if shard_seq else 1)
    assert tuple(uni._states.elem_ctr.shards[0, 0].shape) == (rows, C // seq)
    assert tuple(uni._states.bnd_mask.shards[-1, -1].shape) == (rows, 2 * C // seq, MARKS // 32)
    empty = map_state(lambda x: x.unsqueeze(0).expand(R, *x.shape), make_empty_state(C, MARKS, "cpu"))
    gathered = M.gather_states(uni._states)
    for f in FIELDS:
        assert torch.equal(getattr(gathered, f), getattr(empty, f)), f
    assert _counter("mesh.p2p_bytes") == 0


def test_resident_merge_moves_nothing_between_groups_on_4x1(workload, counting):
    """On a mesh of one seq entry a group, the merges move no byte between
    entries; only the digest's three partial sums reach the first entry."""
    uni = _merged(workload, mesh=M.make_mesh(["cpu"] * 4, 4, 1))
    assert _counter("mesh.p2p_bytes") == 0
    uni.digests()
    assert _counter("mesh.p2p_bytes") == 3 * 8
    assert telemetry.snapshot()["histograms"]["span.mesh.merge.seconds"]["count"] == len(workload["rounds"]) + 2


def test_resident_uneven_split_raises():
    with pytest.raises(ValueError):
        TorchUniverse([f"r{i}" for i in range(R + 2)], capacity=C, max_mark_ops=MARKS,
                      mesh=M.make_mesh(["cpu"] * 4, 4, 1))


def test_unsharded_construction_and_upload_as_before(workload, counting):
    """Without a mesh: the states of ``expand(n).contiguous()`` over an empty
    replica, and the host bytes of one copy a batch group plus 8 B a
    replica for the index, as before meshes could be given at construction."""
    uni = TorchUniverse([f"r{i}" for i in range(R)], capacity=C, max_mark_ops=MARKS, device="cpu")
    assert uni._layout is None
    empty = make_empty_state(C, MARKS, "cpu")
    for f in FIELDS:
        x = getattr(uni.states, f)
        assert x.is_contiguous() and torch.equal(x, getattr(empty, f).unsqueeze(0).expand(R, *x.shape[1:])), f
    sent = []
    for batch in epoch_batches(workload, R, WRITERS):
        before = _counter("ingest.h2d_bytes")
        uni.apply_changes(batch)
        sent.append(_counter("ingest.h2d_bytes") - before)
    assert sent == H2D_BYTES
    assert _counter("mesh.p2p_bytes") == 0 and _counter("mesh.gather_bytes") == 0


# ``ingest.h2d_bytes`` of each merge of ``test_unsharded_construction_and_upload_as_before``
# (genesis, two rounds, all-to-all), read before universes could be built on a mesh.
H2D_BYTES = [2496, 8320, 8320, 35200]
