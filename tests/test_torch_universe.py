"""The slice as a whole: TorchUniverse(device="cpu") against TpuUniverse on
its exact per-op path (PERITEXT_MERGE_PATH=scan), byte for byte, and the
port's package rules (no JAX, no silent CPU fallback)."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from peritext_tpu.ops.state import DocState as JaxDocState
from peritext_tpu.ops.universe import TpuUniverse
from peritext_tpu_torch import TorchUniverse, state_to_numpy
from peritext_tpu_torch.bench.workloads import make_writer_rounds
from peritext_tpu_torch.oracle import Doc

REPO = Path(__file__).resolve().parent.parent
FIELDS = [f.name for f in dataclasses.fields(JaxDocState)]
STATS = ("launches", "ops_applied", "rows_padded", "capacity_growths",
         "changes_ingested", "duplicates_dropped")


def _assert_same(tpu, port):
    ref = jax.device_get(tpu.states)
    got = state_to_numpy(port.states)
    for f in FIELDS:
        a = np.asarray(getattr(ref, f))
        assert got[f].dtype == a.dtype, f
        assert got[f].shape == a.shape, f
        assert (got[f] == a).all(), f"field {f} diverged"
    assert port.texts() == tpu.texts()
    assert port.spans_batch() == tpu.spans_batch()
    d_port, d_tpu = port.digests(), tpu.digests()
    assert d_port.dtype == np.uint32 and (d_port == d_tpu).all()
    assert port.clocks == tpu.clocks
    assert port.lengths == tpu.lengths and port.mark_counts == tpu.mark_counts
    for k in STATS:
        assert port.stats[k] == tpu.stats[k], k


def _ingest_both(tpu, port, batch):
    tpu.apply_changes(batch)
    port.apply_changes(batch)
    _assert_same(tpu, port)


@pytest.mark.parametrize("seed,capacity", [(0, 256), (1, 32)])
def test_universe_matches_tpu_universe_scan_path(monkeypatch, seed, capacity):
    """Six replicas (not a multiple of 8) follow three writers for two
    chained rounds, then merge all to all; the small capacity forces a
    re-bucketing on the way."""
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "scan")
    wl = make_writer_rounds(doc_len=40, ops_per_round=12, num_writers=3, rounds=2, seed=seed)
    names = [f"r{i}" for i in range(6)]
    tpu = TpuUniverse(names, capacity=capacity, max_mark_ops=32)
    port = TorchUniverse(names, capacity=capacity, max_mark_ops=32, device="cpu")
    _ingest_both(tpu, port, [[wl["genesis"]]] * 6)
    for rnd in wl["rounds"]:
        _ingest_both(tpu, port, [rnd[i % 3] for i in range(6)])
    history = [[c for rnd in wl["rounds"] for c in rnd[w]] for w in range(3)]
    # All to all; a replica's own writer's changes come again and drop.
    _ingest_both(tpu, port, [history[(i + 1) % 3] + history[(i + 2) % 3] + history[i % 3][:1]
                             for i in range(6)])
    assert port.stats["duplicates_dropped"] == 6
    if capacity == 32:
        assert port.stats["capacity_growths"] > 0

    oracle = Doc("oracle")
    oracle.apply_change(wl["genesis"])
    for w in range(3):
        for c in history[w]:
            oracle.apply_change(c)
    expect = oracle.get_text_with_formatting(["text"])
    assert any(span["marks"] for span in expect)
    for r in range(6):
        assert port.spans(r) == expect
        assert port.text(f"r{r}") == "".join(s["text"] for s in expect)
    assert len(set(port.digests().tolist())) == 1


def test_universe_matches_tpu_universe_across_16384_growth(monkeypatch):
    """An 8300-char genesis re-buckets both universes from C = 8192 to
    16384 (the size the port's kernels now hold); two concurrent writers'
    rounds then merge across the two replicas."""
    monkeypatch.setenv("PERITEXT_MERGE_PATH", "scan")
    wl = make_writer_rounds(doc_len=8300, ops_per_round=16, num_writers=2, rounds=1, seed=7)
    (w0, w1), = wl["rounds"]
    tpu = TpuUniverse(["a", "b"], capacity=8192, max_mark_ops=32)
    port = TorchUniverse(["a", "b"], capacity=8192, max_mark_ops=32, device="cpu")
    _ingest_both(tpu, port, [[wl["genesis"]]] * 2)
    assert port.capacity == 16384 and port.stats["capacity_growths"] == 1
    assert max(port.lengths) > 8192
    _ingest_both(tpu, port, [w0, w1])
    _ingest_both(tpu, port, [w1, w0])
    assert len(set(port.digests().tolist())) == 1


def test_universe_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchUniverse(["a"])


def test_causally_unready_batch_commits_nothing():
    wl = make_writer_rounds(doc_len=10, ops_per_round=4, num_writers=1, rounds=2, seed=5)
    port = TorchUniverse(["a", "b"], device="cpu")
    port.apply_changes([[wl["genesis"]], [wl["genesis"]]])
    before = state_to_numpy(port.states)
    clocks = [dict(c) for c in port.clocks]
    with pytest.raises(ValueError, match="unsatisfiable"):
        port.apply_changes({"a": wl["rounds"][0][0], "b": wl["rounds"][1][0]})
    assert port.clocks == clocks
    after = state_to_numpy(port.states)
    assert all((before[f] == after[f]).all() for f in FIELDS)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax\b|jaxlib\b|peritext_tpu(\.|\s|$))", re.M)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """In a process where ``jax``, ``jaxlib`` and ``peritext_tpu`` cannot be
    imported (blocked in ``sys.modules``), every module of the port, the
    runtime copies included, and ``chip_smoke.py`` with its dependencies
    import; and no source of them names one of those packages."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'peritext_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import peritext_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(peritext_tpu_torch.__path__, 'peritext_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert {'peritext_tpu_torch.runtime.' + m for m in ('serve', 'checkpoint', 'pubsub', 'serve_shard', "
        "'elastic', 'lifecycle', 'sync')} <= set(mods)\n"
        "assert {'peritext_tpu_torch.' + m for m in ('parallel.stream', 'testing', 'replay', 'bridge', "
        "'fuzz', 'examples.fleet_demo')} <= set(mods)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'peritext_tpu') "
        "and sys.modules[m] is not None]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sources = sorted((REPO / "peritext_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        assert not _FORBIDDEN.search(path.read_text()), f"{path} imports JAX or peritext_tpu"
