"""The port's live status surface (peritext_tpu_torch/runtime/telemetry.py):
``status()`` has the JAX package's keys, section by section, on the same
seeded serving plane; ``dump_status`` writes the file ``scripts/ops_top.py``
renders; and ``PERITEXT_STATUS`` with ``PERITEXT_METRICS_INTERVAL`` arms the
periodic flusher and the exit dump, as in the JAX package."""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from peritext_tpu.ops import TpuUniverse
from peritext_tpu.runtime import health as jhealth, slo as jslo, telemetry as jtelemetry
from peritext_tpu.runtime.serve import ServePlane as JServePlane
from peritext_tpu_torch import TorchUniverse
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import ServePlane, ShardedServePlane, health, slo, telemetry

REPO = Path(__file__).resolve().parents[1]
OPS_TOP = str(REPO / "scripts" / "ops_top.py")


@pytest.fixture(autouse=True)
def clean_planes():
    planes = (telemetry, slo, health, jtelemetry, jslo, jhealth)
    for plane in planes:
        plane.reset()
    yield
    for plane in planes:
        plane.reset()


def author_stream(n: int = 6):
    doc = Doc("w")
    genesis, _ = doc.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("hello")},
    ])
    edits = [doc.change([{"path": ["text"], "action": "insert", "index": i, "values": ["x"]}])[0]
             for i in range(n)]
    return [genesis] + edits


def shape(x):
    """Keys all the way down (lists by their first element), values by type."""
    if isinstance(x, dict):
        return {k: shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [shape(x[0])] if x else []
    return type(x).__name__


def served_status(tel, slo_plane, health_plane, universe, plane_cls):
    tel.enable()
    slo_plane.install("ingest.launch:err_rate=0.5,window=32")
    health_plane.install("device_launch:threshold=99")
    plane = plane_cls(universe, start=False, batch_target=8)
    session = plane.session("s0", replica="r0")
    for change in author_stream():
        session.submit([change])
    assert plane.drain() == 0
    return tel.status(), plane


def test_status_keys_equal_the_jax_planes():
    port, _p = served_status(telemetry, slo, health, TorchUniverse(["r0"], device="cpu"), ServePlane)
    ref, _r = served_status(jtelemetry, jslo, jhealth, TpuUniverse(["r0"]), JServePlane)
    assert shape(port) == shape(ref)
    assert port["ingest"]["launches"] == ref["ingest"]["launches"] >= 1
    assert port["breakers"] == ref["breakers"]
    assert port["slo"]["ingest.launch"]["events"] == ref["slo"]["ingest.launch"]["events"]


def test_dump_status_renders_in_ops_top(tmp_path):
    _, plane = served_status(telemetry, slo, health, TorchUniverse(["r0"], device="cpu"), ServePlane)
    sharded = ShardedServePlane(2, start=False, devices=["cpu"], name="fleet")
    sharded.session("a", replica="ra")
    path = str(tmp_path / "status.json")
    assert telemetry.dump_status(path) == path
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    assert json.load(open(path))["pid"] == os.getpid()
    proc = subprocess.run([sys.executable, OPS_TOP, path, "--once"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "slo:" in proc.stdout and "serve plane" in proc.stdout and "shard 0" in proc.stdout
    assert telemetry.dump_status() is None  # no PERITEXT_STATUS path armed
    del plane, sharded


def test_flusher_writes_periodically_and_reset_stops_it(tmp_path):
    path = tmp_path / "live.json"
    telemetry.enable(status_path=str(path), metrics_interval=0.05)
    deadline = time.monotonic() + 10
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert json.loads(path.read_text())["pid"] == os.getpid()
    telemetry.reset()
    path.unlink()
    time.sleep(0.2)
    assert not path.exists()


def test_status_env_arms_the_flusher_and_the_exit_dump(tmp_path):
    """A process started with PERITEXT_STATUS and PERITEXT_METRICS_INTERVAL
    writes the status file while it runs and once more at exit; ops_top
    renders both."""
    live, metrics = tmp_path / "status.json", tmp_path / "metrics.json"
    code = textwrap.dedent(f"""
        import json, os, time
        from peritext_tpu_torch.runtime import telemetry
        telemetry.counter("ingest.launches", 3)
        deadline = time.monotonic() + 10
        while not os.path.exists({str(live)!r}) and time.monotonic() < deadline:
            time.sleep(0.02)
        print(json.load(open({str(live)!r}))["ingest"]["launches"])
        os.remove({str(live)!r})
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), PERITEXT_STATUS=str(live),
               PERITEXT_METRICS=str(metrics), PERITEXT_METRICS_INTERVAL="0.05")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["3"]
    assert live.exists() and metrics.exists()  # the exit dumps
    assert json.loads(metrics.read_text())["counters"]["ingest.launches"] == 3
    proc = subprocess.run([sys.executable, OPS_TOP, str(live), "--once"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
