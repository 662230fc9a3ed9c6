"""Every cell of BENCHMARK.json loads as data, and the file keeps to the
benchmark's contract."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import core

BENCH = core.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # 2 + 14 runs a cell, each run_seconds + 60 s, each cell 180 s to compile, 1200 s spare: 24 cells fit.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_as_data(name):
    cell = core.load_cell(name)
    assert cell["config"]["name"] == next(w for w in BENCH["workloads"] if w["name"] == name)["config"]
    importlib.import_module(f"portbench.drivers.{cell['traffic']['driver']}")
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(core.reader(m["name"]))
    for m in cell["per_layer"]:
        assert m["moves"] in e2e


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert all(c in CELLS for c in m["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    assert four_card_cells_fit(BENCH["workloads"])


def four_card_cells_fit(workloads) -> bool:
    """At most a quarter of the cells, rounded down, and always one, ask
    for four cards."""
    return sum(w["chips"] == 4 for w in workloads) <= max(1, len(workloads) // 4)


@pytest.mark.parametrize("cells, four, fits", [(3, 1, True), (4, 2, False), (8, 2, True), (1, 1, True),
                                               (2, 2, False), (7, 2, False), (12, 3, True), (12, 4, False)])
def test_four_card_cells_per_benchmark(cells, four, fits):
    workloads = [{"name": f"c{i}", "chips": 4 if i < four else 1} for i in range(cells)]
    assert four_card_cells_fit(workloads) is fits


def test_configs_are_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(core.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"]) and len(c["reduced"]) <= 16
