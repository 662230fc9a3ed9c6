"""Fleet membership (``add_replicas``, ``rename_replica``, ``drop_replicas``)
against ``TpuUniverse`` on the same sequences, on the CPU.  After each
change of the replica axis the next round is a merge that the census
window takes on the sorted route (``PERITEXT_MERGE_WINDOW_MIN=64``), so a
mirror keyed to the old axis would show as a state that differs from the
JAX universe's.  All 13 fields, the control planes and the error cases
must agree exactly."""
import numpy as np
import pytest

from peritext_tpu.ops import TpuUniverse
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import make_writer_rounds
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.runtime.log import ChangeLog

WRITERS = 2


@pytest.fixture(params=["sorted", "scan"])
def route(request, monkeypatch):
    monkeypatch.setenv("PERITEXT_MERGE_PATH", request.param)
    monkeypatch.setenv("PERITEXT_MERGE_WINDOW_MIN", "64")
    return request.param


def same(port, ref):
    a = state_to_numpy(port.states)
    for f in FIELDS:
        b = np.asarray(getattr(ref.states, f))
        assert a[f].dtype == b.dtype and a[f].shape == b.shape, f
        assert (a[f] == b).all(), f"state differs at {f}"
    assert port.replica_ids == ref.replica_ids and port.index_of == ref.index_of
    assert port.clocks == ref.clocks and port.lengths == ref.lengths
    assert port.mark_counts == ref.mark_counts and port.text_objs == ref.text_objs
    assert port.store_versions == ref.store_versions
    assert (port.digests() == ref.digests()).all()


class Fleet:
    """Both universes, a change log and the writers' rounds; ``round(k)``
    gives every replica that has the genesis its writer's round k (replica
    i of the founders follows writer i % 2; ``catch_up`` names a writer for
    a new replica and replays that writer's history from the log)."""

    def __init__(self, names):
        self.wl = make_writer_rounds(200, 6, WRITERS, 5, True, seed=21, locality=16)
        self.log = ChangeLog()
        for c in [self.wl["genesis"]] + [c for rnd in self.wl["rounds"] for w in rnd for c in w]:
            self.log.record(c)
        self.unis = (TorchUniverse(names, capacity=512, device="cpu"), TpuUniverse(names, capacity=512))
        self.writer = {n: i % WRITERS for i, n in enumerate(names)}
        self.done = 0
        self.both(lambda u: u.apply_changes({n: [self.wl["genesis"]] for n in names}))

    def both(self, fn):
        for u in self.unis:
            fn(u)
        same(*self.unis)

    def round(self, k):
        port = self.unis[0]
        batch = {n: self.wl["rounds"][k][self.writer[n]] for n in port.replica_ids if n in self.writer}
        windowed = port.stats["windowed_launches"]
        self.both(lambda u: u.apply_changes(batch))
        self.done = k + 1
        return port.stats["windowed_launches"] - windowed

    def catch_up(self, writers):
        """Replay each named replica's writer's history from the log."""
        self.writer.update(writers)
        clocks = {w: {"base": 1, f"writer{w}": sum(len(r[w]) for r in self.wl["rounds"][: self.done])}
                  for w in set(writers.values())}
        self.both(lambda u: u.apply_changes({
            n: self.log.missing_changes(clocks[w], {}) for n, w in writers.items()
        }))


def test_add_then_windowed_merge_then_catch_up(route):
    fleet = Fleet(["a", "b", "c"])
    fleet.round(0)
    fleet.both(lambda u: u.add_replicas(["d", "e"]))
    port = fleet.unis[0]
    assert port._mirror is None and len(port.replica_ids) == 5
    windowed = fleet.round(1)
    if route == "sorted":
        assert windowed == 1
    # The new replicas catch up from the log through the causal gate.
    fleet.catch_up({"d": 1, "e": 0})
    fleet.round(2)
    assert port.text("d") == port.text("b") and port.text("e") == port.text("a")


def test_rename_then_windowed_merge(route):
    fleet = Fleet(["a", "b"])
    fleet.both(lambda u: u.add_replicas(["pad0", "pad1"]))
    fleet.round(0)
    fleet.both(lambda u: u.rename_replica("pad1", "joiner"))
    port = fleet.unis[0]
    assert port.index_of["joiner"] == 3 and "pad1" not in port.index_of
    windowed = fleet.round(1)
    if route == "sorted":
        assert windowed == 1
    fleet.catch_up({"joiner": 1})
    fleet.round(2)
    assert port.text("joiner") == port.text("b")


def test_drop_then_windowed_merge(route):
    fleet = Fleet(["a", "b", "c", "d"])
    fleet.round(0)
    fleet.round(1)
    fleet.both(lambda u: u.drop_replicas(["b", "c"]))
    port = fleet.unis[0]
    assert port.replica_ids == ["a", "d"] and port._mirror is None
    windowed = fleet.round(2)
    if route == "sorted":
        assert windowed == 1
    # Drop, then add back to the old count: rows keep their new meanings.
    fleet.both(lambda u: u.add_replicas(["b2", "c2"]))
    fleet.round(3)
    fleet.both(lambda u: u.drop_replicas(["a"]))
    fleet.round(4)


@pytest.mark.parametrize("call,err", [
    (lambda u: u.add_replicas(["a"]), ValueError),
    (lambda u: u.rename_replica("a", "z"), ValueError),
    (lambda u: u.rename_replica("nope", "z"), KeyError),
    (lambda u: u.rename_replica("b", "a"), ValueError),
    (lambda u: u.drop_replicas(["nope"]), KeyError),
    (lambda u: u.drop_replicas(["a", "b", "fresh"]), ValueError),
])
def test_membership_errors_match(call, err):
    """The same refusals as TpuUniverse, each leaving the fleet as it was."""
    fleet = Fleet(["a", "b"])
    fleet.both(lambda u: u.add_replicas(["fresh"]))
    for u in fleet.unis:
        with pytest.raises(err):
            call(u)
    same(*fleet.unis)


def test_add_nothing_is_a_no_op():
    fleet = Fleet(["a"])
    version = fleet.unis[0]._states_version
    fleet.both(lambda u: u.add_replicas([]))
    assert fleet.unis[0]._states_version == version
