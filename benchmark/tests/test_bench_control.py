"""The control on the card: computed one precision below the
configurations' fp32 (TF32 products in cuBLAS and cuDNN), it has to come
out as not correct, while the program passes, at the cell's widths and a
size a test run holds. Skips without a CUDA device (decided inside each
test)."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.cells import Cell  # noqa: E402
from benchmark.run import run_cell  # noqa: E402

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read on the card")


def small(name):
    """Full widths (224 x 224 images, 34,537-row requests), fewer samples
    and chunks: three check steps and one epoch of three, or one chunk."""
    cell = Cell(name)
    if cell.traffic["driver"] == "train":
        cell.traffic = dict(cell.traffic, samples=3 * cell.traffic["batch"])
    else:
        cell.traffic = dict(cell.traffic, chunks=1, warmup_requests=2,
                            checked_within=4, checked_requests=2)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cxr-resnet18-train-b64",
                                  "haim-score-b34537"])
def test_the_program_is_correct_and_the_control_is_not(name):
    card()
    cell = small(name)
    result, checks = run_cell(cell, SEEDS[0], 0.5, False, "cuda")
    assert result["correct"], checks
    for seed in SEEDS:
        result, checks = run_cell(cell, seed, 0.5, False, "cuda",
                                  side="tf32")
        assert not result["correct"], checks
