"""The frozen counts: ResNet-18's published 1.81 GMAC per 224 x 224 image,
the MIMIC chain's 104,608 MAC per present row, and K1's bound at B = 65,536
with nothing missing (0.2046 ms, set by operations, as the port's own
smoke script computes it)."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.cells import load_json, load_module  # noqa: E402
from benchmark.reference import chain, resnet18  # noqa: E402

H100 = load_json("peaks.json")["NVIDIA H100"]


def config(name):
    return load_json("configs", name + ".json")


def counts(name):
    return load_module("counts", name + ".py")


def n_params(cfg):
    total = 0
    for _path, shape, _init in chain.leaves(cfg):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def test_resnet18_is_1_81_gmac_per_image():
    entry = config("mimic-cxr-resnet18")["encoders"][1]
    macs = resnet18.trunk_macs(entry)
    assert macs == 1_813_561_344
    assert round(macs / 1e9, 2) == 1.81


def test_mimic_chain_is_104608_mac_per_present_row():
    cfg = config("mimic-haim")
    rows = 1000
    macs = counts("mimic-haim").forward_macs(cfg, [rows] * 4, rows)
    assert macs == 104_608 * rows


def test_mimic_model_has_its_published_parameter_count():
    cfg = config("mimic-haim")
    assert n_params(cfg) == cfg["parameters"] == 83_742


def test_k1_bound_at_65536_rows_with_nothing_missing():
    cfg = config("mimic-haim")
    B = 65536
    seconds, by, flops, _bytes = counts("mimic-haim").k1_bound(
        cfg, [B] * 4, B, H100)
    assert by == "operations"
    assert flops == 2 * 104_608 * B
    assert round(seconds * 1e3, 4) == 0.2046


def test_absent_cells_are_not_counted():
    cfg = config("mimic-haim")
    c = counts("mimic-haim")
    full = c.forward_macs(cfg, [100] * 4, 100)
    one_absent = c.forward_macs(cfg, [100, 99, 100, 100], 100)
    assert full - one_absent == (1024 + 50) * 32 + 32 * 32 + 32 * 50
    bound_full = c.k1_bound(cfg, [100] * 4, 100, H100)[3]
    bound_less = c.k1_bound(cfg, [100, 99, 100, 100], 100, H100)[3]
    assert bound_full - bound_less == 4 * 1024


@pytest.mark.parametrize("present,gflop", [(1.0, 10.88), (0.7, 7.62)])
def test_training_flops_per_sample(present, gflop):
    cfg = config("mimic-cxr-resnet18")
    n = 1000
    rows = [int(present * n)] * 4
    flops = counts("mimic-cxr-resnet18").train_flops(cfg, rows, n)
    assert flops / n / 1e9 == pytest.approx(gflop, abs=0.01)
