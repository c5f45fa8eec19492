"""Runs of both cells on the CPU at tiny sizes, the look for a card
skipped: a sound run passes its check, and each fault of ``faults.py``
planted under the timed path makes ``correct`` come out false."""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import faults  # noqa: E402
from benchmark.harness.cells import Cell  # noqa: E402
from benchmark.run import run_cell  # noqa: E402

SEED = 2 ** 31 + 2024


def tiny(name):
    """The cell at a size the CPU runs in seconds: 32 x 32 images and 64
    samples in batches of 16, or requests of 512 rows."""
    cell = Cell(name)
    if cell.traffic["driver"] == "train":
        cell.config = copy.deepcopy(cell.config)
        cell.config["encoders"][1]["image"] = [32, 32, 3]
        cell.traffic = dict(cell.traffic, samples=64, batch=16)
    else:
        cell.traffic = dict(cell.traffic, rows=512, warmup_requests=2,
                            checked_within=12, checked_requests=3)
    return cell


# The CPU's tiny training run reads gaps far above the card's at full size
# (BatchNorm over a 1 x 1 map of ~11 rows), so its sound run is held to
# these; each fault must still read far above them.
TINY_TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap_median": 1e-3,
                     "change_gap": 0.1}


def limits(cell):
    return TINY_TRAIN_LIMITS if cell.traffic["driver"] == "train" \
        else cell.limits


@pytest.mark.parametrize("name", ["cxr-resnet18-train-b64",
                                  "haim-score-b34537"])
def test_a_sound_run_is_correct(name):
    cell = tiny(name)
    cell.limits = limits(cell)
    result, checks = run_cell(cell, SEED, 0.2, False, "cpu")
    assert result["correct"], checks
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(cell.limits)
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name, driver in (("cxr-resnet18-train-b64", "train"),
                                       ("haim-score-b34537", "score"))
    for fault in faults.FAULTS[driver]])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny(name)
    cell.limits = limits(cell)
    with faults.planted(cell.traffic["driver"], fault):
        result, checks = run_cell(cell, SEED, 0.2, False, "cpu")
    assert not result["correct"], checks
    assert any(value > 3 * limit for _n, value, limit in checks), checks
