"""Settings for the benchmark's own tests: small cells on the CPU.

Run them from the root of the repository with
``python -m pytest portbench/tests -q``; the card tests with
``python -m pytest portbench/tests -q -m cuda`` on a machine with a GPU.
"""
from __future__ import annotations

import json

import pytest

from portbench import core

# Each cell cut to a size the CPU runs in seconds: config, then traffic.
SMALL = {
    "fleet-c2k.merge": ({"replicas": 8, "doc_len": 120, "capacity": 512, "max_mark_ops": 256, "ops_per_round": 16,
                         "span_samples": 8}, {"rounds": 3, "structure_seeds": [1, 2]}),
    "essay-c16k.sweep": ({"population": 103, "doc_len": 300, "capacity": 512, "max_mark_ops": 128},
                         {"cohort": 16}),
    "fleet-c2k.serve": ({"replicas": 32, "doc_len": 120, "capacity": 512, "max_mark_ops": 256},
                        {"rate": 40, "warm_seconds": 1, "check_docs": 4, "structure_seeds": [1, 2, 3], "drain_timeout_s": 10}),
}

# The serve driver has no cell in BENCHMARK.json yet (PERF.md, Open questions),
# so its tests compose one: the traffic and metrics the cell will name.
SERVE = {
    "traffic": {"driver": "serve", "rate": 40, "ops_per_change": 8, "script_rounds": 2, "batch_target": 64,
                "deadline_ms": 25, "warm_seconds": 2, "trace_seconds": 1, "drain_timeout_s": 120, "check_docs": 32,
                "structure_seeds": [1, 2, 3, 4, 5, 6, 7, 8]},
    "end_to_end": [{"name": "admit_to_applied_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "patch_loop_ms_per_flush.serve", "unit": "ms"},
                  {"name": "patch_assemble_ms_per_flush.serve", "unit": "ms"},
                  {"name": "changes_per_flush.serve", "unit": "changes"},
                  {"name": "device_idle_pct.serve", "unit": "%"}],
}


def small_cell(name: str):
    if name == "fleet-c2k.serve":
        with open(core.HERE / "configs" / "fleet-c2k.json") as f:
            cell = {"name": name, "chips": 1, "config": json.load(f), **json.loads(json.dumps(SERVE))}
    else:
        cell = core.load_cell(name)
    cfg, tr = SMALL[name]
    cell["config"].update(cfg)
    cell["traffic"].update(tr)
    return cell


@pytest.fixture
def small():
    return small_cell
