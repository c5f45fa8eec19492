"""The plain reference against the program on the CPU at tiny sizes: the
same weights and inputs through both give the same states, answers, loss,
gradients and Adam step."""
import copy
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import weights as W  # noqa: E402
from benchmark.harness.cells import load_json  # noqa: E402
from benchmark.modules import build  # noqa: E402
from benchmark.reference import chain  # noqa: E402


def tiny_cxr(side=32):
    cfg = copy.deepcopy(load_json("configs", "mimic-cxr-resnet18.json"))
    cfg["encoders"][1]["image"] = [side, side, 3]
    return cfg


def inputs(cfg, rows, seed):
    return (W.modalities(cfg, rows, 0.3, seed, 1, "cpu"),
            W.targets(cfg, rows, seed, 2, "cpu"))


def test_weights_are_the_same_for_a_seed_and_differ_across_seeds():
    cfg = load_json("configs", "mimic-haim.json")
    specs = chain.leaves(cfg)
    a, b = W.make_tree(specs, 5, "cpu"), W.make_tree(specs, 5, "cpu")
    c = W.make_tree(specs, 6, "cpu")
    for path, _s, _i in specs:
        assert torch.equal(chain._get(a, path), chain._get(b, path))
    assert not torch.equal(a["encoders"][1]["layers"][0]["w"],
                           c["encoders"][1]["layers"][0]["w"])


def test_every_seed_has_the_same_number_of_missing_cells():
    cfg = load_json("configs", "mimic-haim.json")
    for seed in (1, 2 ** 31 + 7):
        xs = W.modalities(cfg, 1000, 0.3, seed, 1, "cpu")
        for x in xs:
            assert int(torch.isnan(x).any(dim=1).sum()) == 300


@pytest.mark.parametrize("config", ["mimic-haim", "mimic-cxr-resnet18"])
def test_the_program_holds_the_reference_weights(config):
    cfg = load_json("configs", config + ".json") if config == "mimic-haim" \
        else tiny_cxr()
    weights = W.make_tree(chain.leaves(cfg), 3, "cpu")
    model = build(cfg, weights, "cpu")
    assert model.params is weights


def test_scoring_states_and_answers_match_fused_forward():
    cfg = load_json("configs", "mimic-haim.json")
    weights = W.make_tree(chain.leaves(cfg), 4, "cpu")
    ref = W.clone(weights)
    model = build(cfg, weights, "cpu")
    xs, _y = inputs(cfg, 257, 4)
    states, outs = model.fused_forward(xs)
    rows = chain.states(ref, cfg, xs)
    assert torch.allclose(states, rows, rtol=1e-5, atol=1e-6)
    for got, want in zip(outs, chain.outputs(ref, cfg, rows)):
        assert got.shape == want.shape
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_a_missing_modality_keeps_the_state():
    cfg = load_json("configs", "mimic-haim.json")
    params = W.make_tree(chain.leaves(cfg), 4, "cpu")
    xs, _y = inputs(cfg, 64, 9)
    rows = chain.states(params, cfg, xs)
    absent = torch.isnan(xs[2]).any(dim=1)
    assert absent.any()
    assert torch.equal(rows[3][absent], rows[2][absent])
    assert not torch.equal(rows[3][~absent], rows[2][~absent])


def test_training_loss_gradients_and_adam_step_match_the_program():
    from multimodn_tpu_torch import Adam
    from multimodn_tpu_torch.data import ArrayLoader
    from benchmark.drivers.train import Arrays

    cfg = tiny_cxr(32)
    torch.manual_seed(0)
    weights = W.make_tree(chain.leaves(cfg), 8, "cpu")
    ref = W.clone(weights)
    model = build(cfg, weights, "cpu")
    xs, y = inputs(cfg, 16, 8)
    opt = Adam(1e-3)
    seen = []
    model.fit(ArrayLoader(Arrays([x.numpy() for x in xs], y.numpy()), 16),
              opt, "cross_entropy", epochs=1,
              on_epoch=lambda p: seen.append(p["train_loss"]))
    losses, grads, final = chain.train_steps(ref, cfg, [(xs, y)], 1e-3,
                                             (0.9, 0.999), 1e-8)
    assert seen[0] == pytest.approx(losses[0], rel=1e-6)
    # Train-mode BatchNorm over few rows makes single gradient elements
    # ill-conditioned (the fp32 reference differs from itself in fp64 by
    # a few percent of a leaf's largest element at 64 x 64), so leaves are
    # compared by their norms, as the benchmark's check compares them.
    paths = [p for p, _s, _i in chain.leaves(cfg)]
    ref_grad = [float(g.norm()) for g in grads]
    prog_grad = [float((chain._get(model.opt_state["m"], p) / 0.1).norm())
                 for p in paths]
    counted = [g > 0.0 for g in ref_grad]
    assert max(chain.leaf_norm_gaps(prog_grad, ref_grad, counted)) < 1e-3
    initial = W.make_tree(chain.leaves(cfg), 8, "cpu")
    ref_change = [float((f - chain._get(initial, p)).norm())
                  for p, f in zip(paths, final)]
    prog_change = [float((chain._get(model.params, p)
                          - chain._get(initial, p)).norm()) for p in paths]
    assert max(chain.leaf_norm_gaps(prog_change, ref_change, counted)) < 1e-3
