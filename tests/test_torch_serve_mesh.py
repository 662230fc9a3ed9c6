"""The sharded serving tier's placement and ``mesh_within_shard`` in the
port (``peritext_tpu_torch.runtime.serve_shard``), against the JAX
package's plane (tests/test_serve_shard.py's mesh cases).

Shard i lives on the lead device of slice i of ``mesh_slices(shards,
devices)``, as in JAX.  With ``mesh_within_shard=True`` a shard whose
slice has two or more devices lays its universe's replica axis over them
whenever its width divides the slice, and every width change (a join, a
leave, the spare row taken over, a migration rolled back) re-judges it.
Patch streams stay byte-identical to direct ingest and to JAX's plane
with the flag (at JAX's exact widths)."""
import jax
import pytest

from peritext_tpu.parallel.mesh import mesh_slices as jax_mesh_slices
from peritext_tpu.runtime import faults as jax_faults
from peritext_tpu.runtime import health as jax_health
from peritext_tpu.runtime.serve_shard import ShardedServePlane as JaxShardedServePlane
from peritext_tpu_torch.parallel.mesh import is_sharded
from peritext_tpu_torch.runtime import elastic, faults, health
from peritext_tpu_torch.runtime.elastic import MigrationError, migrate_session
from peritext_tpu_torch.runtime.faults import FaultError
from peritext_tpu_torch.runtime.serve_shard import ShardedServePlane

from test_torch_serve import author_stream, direct_streams

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("PERITEXT_LAUNCH_BACKOFF", "0.001")
    for mod in (faults, health, jax_faults, jax_health):
        mod.reset()
    yield
    for mod in (faults, health, jax_faults, jax_health):
        mod.reset()


def _needs_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")


def sharded(plane):
    return [is_sharded(s.universe._states) for s in plane.shards]


def widths(plane):
    return [len(s.universe.replica_ids) for s in plane.shards]


@pytest.mark.parametrize("n_shards", [2, 3, 4, 12])
def test_shards_place_on_mesh_slices_as_jax(n_shards):
    """Over 8 devices each shard's slice, and the lead device its universe
    lives on, are JAX's ``mesh_slices``' (by device index): 2 shards put
    shard 1 on device 4, not on device 1."""
    _needs_8()
    plane = ShardedServePlane(n_shards, start=False, devices=[f"cpu:{k}" for k in range(8)])
    for i in range(n_shards):
        plane.session(f"s{i}", replica=f"r{i}", shard=i)
    want = [[d.id for d in s] for s in jax_mesh_slices(n_shards, jax.devices()[:8])]
    assert [[d.index for d in s.devices] for s in plane.shards] == want
    assert [s.device.index for s in plane.shards] == [s[0] for s in want]
    assert [s.universe.device for s in plane.shards] == [s.device for s in plane.shards]
    assert sharded(plane) == [False] * n_shards


def _served(plane, names, streams, shards=None, first=0):
    sessions = [plane.session(f"s{first + i}", replica=n, record_stream=True,
                              **({} if shards is None else {"shard": shards[i]}))
                for i, n in enumerate(names)]
    for s, stream in zip(sessions, streams):
        s.submit(stream)
    assert plane.drain() == 0
    return sessions


def test_mesh_within_shard_keeps_byte_identity():
    """tests/test_serve_shard.py's streams: 4 sessions on 2 shards of 4
    devices each, widths 2 (not a divisor of 4: left unsharded, as JAX's
    exact widths are); equal to direct ingest and to JAX's plane."""
    _needs_8()
    streams = [author_stream(f"msh_{i}", 4, seed=30 + i) for i in range(4)]
    names = [f"r{i}" for i in range(4)]
    port = ShardedServePlane(2, start=False, batch_target=8, mesh_within_shard=True, devices=CPU8)
    jplane = JaxShardedServePlane(2, start=False, batch_target=8, mesh_within_shard=True, bucket="exact")
    got = [list(s.patch_log) for s in _served(port, names, streams)]
    want = [list(s.patch_log) for s in _served(jplane, names, streams)]
    _, direct = direct_streams(names, streams)
    assert got == want == [direct[n] for n in names]
    assert all(len(s.devices) == 4 for s in port.shards)
    assert widths(port) == [2, 2] and sharded(port) == [False, False]


def test_width_dividing_the_slice_shards_and_joins_re_judge_it(monkeypatch):
    """8 sessions on 2 shards of 4 devices: each universe 4 wide, sharded
    4x1 as JAX's is.  A ninth session on shard 0 (width 5) unshards it;
    migrating it away (width 4) shards it again, and its new shard (width
    5) is unsharded; a migration into shard 0 that fails after the row was
    provisioned rolls back to width 4, sharded again.  Every stream equals
    direct ingest, and JAX's plane's for the first traffic."""
    _needs_8()
    streams = [author_stream(f"wd_{i}", 6, seed=50 + i) for i in range(9)]
    names = [f"r{i}" for i in range(9)]
    port = ShardedServePlane(2, start=False, batch_target=8, mesh_within_shard=True, devices=CPU8)
    jplane = JaxShardedServePlane(2, start=False, batch_target=8, mesh_within_shard=True, bucket="exact")
    first = [s[:4] for s in streams[:8]]
    sessions = _served(port, names[:8], first)
    jsessions = _served(jplane, names[:8], first)
    assert widths(port) == [4, 4] and sharded(port) == [True, True]
    for s in jplane.shards:
        leaf = jax.tree.leaves(s.universe.states)[0]
        assert len(leaf.sharding.device_set) == 4
    assert [list(s.patch_log) for s in sessions] == [list(s.patch_log) for s in jsessions]

    late = _served(port, names[8:], [streams[8][:4]], shards=[0], first=8)[0]
    assert widths(port) == [5, 4] and sharded(port) == [False, True]
    migrate_session(port, "s8", 1)
    assert widths(port) == [4, 5] and sharded(port) == [True, False]

    real_fire = elastic.faults.fire
    calls = {"n": 0}

    def fail_at_import(site, **kw):
        if site == "shard_migrate":
            calls["n"] += 1
            if calls["n"] == 4:  # step 4: the target row is provisioned
                raise FaultError(site, "induced after provisioning")
        return real_fire(site, **kw)

    monkeypatch.setattr(elastic.faults, "fire", fail_at_import)
    with pytest.raises(MigrationError):
        migrate_session(port, "s1", 0)
    monkeypatch.setattr(elastic.faults, "fire", real_fire)
    assert widths(port) == [4, 5] and sharded(port) == [True, False]

    for i, s in enumerate(sessions + [late]):
        s.submit(streams[i][4:])
    assert port.drain() == 0
    _, direct = direct_streams(names, streams)
    assert [list(s.patch_log) for s in sessions + [late]] == [direct[n] for n in names]


def test_spare_row_transitions_re_judge_the_slice():
    """4 shards of 2 devices: shard 3 at width 2 is sharded; one session
    leaving (width 1) unshards it; the last leaving leaves the spare row;
    a new session takes the spare over (width 1) and a second widens it to
    2, sharded again.  Streams equal direct ingest."""
    streams = [author_stream(f"sp_{i}", 4, seed=70 + i) for i in range(4)]
    names = [f"r{i}" for i in range(4)]
    plane = ShardedServePlane(4, start=False, batch_target=8, mesh_within_shard=True, devices=CPU8)

    def shard(k):
        s = plane.shards[k]
        return len(s.universe.replica_ids), is_sharded(s.universe._states)

    a, b = _served(plane, names[:2], [s[:2] for s in streams[:2]], shards=[3, 3])
    assert len(plane.shards[3].devices) == 2 and shard(3) == (2, True)
    migrate_session(plane, "s0", 0)
    assert shard(3) == (1, False) and shard(0) == (1, False)
    migrate_session(plane, "s1", 0)
    assert plane.shards[3].spare is not None and shard(3) == (1, False) and shard(0) == (2, True)
    c = plane.session("s2", replica=names[2], shard=3, record_stream=True)
    assert plane.shards[3].spare is None and shard(3) == (1, False)
    d = plane.session("s3", replica=names[3], shard=3, record_stream=True)
    assert shard(3) == (2, True)
    a.submit(streams[0][2:])
    b.submit(streams[1][2:])
    c.submit(streams[2])
    d.submit(streams[3])
    assert plane.drain() == 0
    _, direct = direct_streams(names, streams)
    assert [list(s.patch_log) for s in (a, b, c, d)] == [direct[n] for n in names]


def test_flag_off_and_factory_planes_never_shard():
    """Without the flag, or with a ``universe_factory`` owning placement,
    a width that divides the slice stays unsharded."""
    from peritext_tpu_torch import TorchUniverse

    off = ShardedServePlane(2, start=False, devices=CPU8)
    factory = ShardedServePlane(2, start=False, mesh_within_shard=True,
                                universe_factory=lambda ids, i: TorchUniverse(ids, device="cpu"))
    for plane in (off, factory):
        for i in range(8):
            plane.session(f"s{i}", replica=f"r{i}")
        assert widths(plane) == [4, 4] and sharded(plane) == [False, False]
    assert factory.shards[0].devices is None
