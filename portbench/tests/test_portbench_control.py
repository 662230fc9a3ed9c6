"""Sound runs are correct; the control and each planted fault are not.

Each cell runs on the CPU at a small size (``conftest.SMALL``) through the
whole harness but the look for a card.  The control puts the reference's
control in the program's place; the plants break the port underneath: a
merge that leaves its state unchanged, one that leaves out half of its
replicas, and one answer altered where it is produced.  One chip holds each
cell, so there is no exchange between chips to leave out.
"""
from __future__ import annotations

import pytest

from portbench.control import PLANTS, run_planted
from portbench.run import run_cell
from portbench.tests.conftest import SMALL


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name, small):
    line = run_cell(small(name), 2**32 + 3, 1.0, False, "cpu")["line"]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("plant", PLANTS)
@pytest.mark.parametrize("name", sorted(SMALL))
def test_plant_makes_the_run_incorrect(name, plant, small):
    line = run_planted(small(name), 77, 1.0, plant, "cpu")
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
def test_small_cells_on_the_card(small):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in sorted(SMALL):
        line = run_cell(small(name), 5, 1.0, True, "cuda")["line"]
        assert line["correct"], (name, line["checks"])
        assert line["device"]["busy_s"] > 0
