"""A training job: ``MultiModN.fit`` one epoch at a time over an
``ArrayLoader`` of the traffic's samples, reshuffled every epoch, until the
window ends.

Set-up builds the one model and optimizer, drives them through the first
``check_steps`` steps with the window's own call (``fit``) on loaders of
the same batch over rows that all differ, and hands them on to the window.
The check follows those steps with the plain reference from the same
weights and rows: each step's loss (the worst step), every leaf's first
gradient as the optimizer got it (Adam's first moment after one step over
``1 - beta1``; the median leaf's gap, since the worst leaf's is the
round-off of one small BatchNorm leaf) and every leaf's change over the
steps (the worst leaf)."""
import sys
import time

import numpy as np
import torch

from benchmark.harness import weights as W
from benchmark.harness.runner import exact_math, tf32_math
from benchmark.modules import build
from benchmark.reference import chain

# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone (BatchNorm's stored statistics, which
# training never reads, have none at all): it is left out of the gaps.
ZERO_GRAD_SHARE = 1e-3


class Arrays:
    """A dataset of whole arrays (the loader's ``arrays()`` protocol)."""

    def __init__(self, xs, y):
        self.xs, self.y = xs, y

    def arrays(self):
        return self.xs, self.y, None

    def __len__(self):
        return len(self.y)


def _optimizer(spec):
    from multimodn_tpu_torch import optim
    return getattr(optim, spec["name"])(spec["lr"], tuple(spec["betas"]),
                                        spec["eps"])


def _norms(tree, paths):
    return [float(torch.linalg.vector_norm(chain._get(tree, p).float()))
            for p in paths]


def setup(run):
    from multimodn_tpu_torch.data import ArrayLoader

    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    n, B = tr["samples"], tr["batch"]
    specs = chain.leaves(cfg)
    paths = [p for p, _s, _i in specs]
    weights = W.make_tree(specs, run.seed, dev)
    initial = W.clone(weights)
    xs = W.modalities(cfg, n, tr["missing"], run.seed, 1, dev)
    y = W.targets(cfg, n, run.seed, 2, dev)
    order = torch.randperm(n, generator=W.generator(run.seed, dev, 3),
                           device=dev)
    rows = [order[k * B:(k + 1) * B] for k in range(tr["check_steps"])]
    check_batches = [([x[r] for x in xs], y[r]) for r in rows]
    present = [int((~torch.isnan(x.reshape(n, -1)).any(dim=1)).sum())
               for x in xs]
    host_x = [x.cpu().numpy() for x in xs]
    host_y = y.cpu().numpy()
    del xs, y
    model = build(cfg, weights, dev)
    opt = _optimizer(tr["optimizer"])
    if run.side == "tf32":
        tf32_math()
    losses, first_grad = [], None
    for k, r in enumerate(rows):
        r = r.cpu().numpy()
        step = ArrayLoader(Arrays([h[r] for h in host_x], host_y[r]), B)
        model.fit(step, opt, tr["loss"], epochs=1,
                  on_epoch=lambda p: losses.append(p["train_loss"]))
        if k == 0:
            b1 = tr["optimizer"]["betas"][0]
            first_grad = [g / (1.0 - b1)
                          for g in _norms(model.opt_state["m"], paths)]
    run.sync()
    change = [float(torch.linalg.vector_norm(chain._get(model.params, p)
                                             - chain._get(initial, p)))
              for p in paths]
    exact_math()
    loader = ArrayLoader(Arrays(host_x, host_y), B, shuffle=tr["shuffle"],
                         seed=run.seed)
    return {"model": model, "opt": opt, "loader": loader,
            "initial": initial, "check_batches": check_batches,
            "program": {"losses": losses, "grad": first_grad,
                        "change": change},
            "present": present, "paths": paths}


def traced_slice(traffic) -> dict:
    return {"epochs": traffic["trace_epochs"]}


def window(state, run, seconds=None, epochs=None):
    """Whole epochs until ``seconds`` have passed (or ``epochs`` ran)."""
    tr = run.cell.traffic
    model, opt, loader = state["model"], state["opt"], state["loader"]
    done = 0
    run.sync()
    start = time.perf_counter()
    while True:
        with run.span("train.epoch"):
            model.fit(loader, opt, tr["loss"], epochs=1)
        done += 1
        if (epochs is not None and done >= epochs) or \
                (epochs is None and time.perf_counter() - start >= seconds):
            break
    run.sync()
    steps = done * loader.n_batches
    ends = [end for name, _s, end, _t in run.spans if name == "train.epoch"]
    print("epoch ends (s into the window): "
          + " ".join(f"{end - start:.3f}" for end in ends[-done:]),
          file=sys.stderr)
    return {"window_s": time.perf_counter() - start, "epochs": done, "steps": steps,
            "samples": done * loader.n_samples}


def results(state, stats):
    finite = all(bool(torch.isfinite(t).all()) for t in
                 _leaves(state["model"].params))
    return ({"train_samples_per_s": stats["samples"] / stats["window_s"]},
            stats["steps"], 0 if finite else stats["steps"])


def counts(run, state, stats):
    cfg, tr = run.cell.config, run.cell.traffic
    flops = stats["epochs"] * run.cell.counts.train_flops(
        cfg, state["present"], tr["samples"])
    return {"steps": stats["steps"], "useful_flops": flops,
            "peak_flops": "fp32_flops"}


def release(state):
    for key in ("model", "opt", "loader"):
        state.pop(key, None)


def check(state, run):
    """The reference's three steps from the same weights and rows, and the
    gaps to the program's (each against ``limits``)."""
    cfg, tr = run.cell.config, run.cell.traffic
    o = tr["optimizer"]
    losses, grads, final = chain.train_steps(
        W.clone(state["initial"]), cfg, state["check_batches"], o["lr"],
        o["betas"], o["eps"])
    paths = state["paths"]
    ref_grad = [float(torch.linalg.vector_norm(g)) for g in grads]
    ref_change = [float(torch.linalg.vector_norm(
        f - chain._get(state["initial"], p))) for f, p in zip(final, paths)]
    median = float(np.median(ref_grad))
    counted = [g >= ZERO_GRAD_SHARE * median for g in ref_grad]
    prog = state["program"]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                       losses))
    if len(prog["losses"]) != len(losses):
        loss_gap = float("inf")
    grad_gaps = chain.leaf_norm_gaps(prog["grad"], ref_grad, counted)
    return [("loss_gap", loss_gap),
            ("grad_gap_median", float(np.median(grad_gaps))),
            ("change_gap", max(chain.leaf_norm_gaps(prog["change"],
                                                    ref_change, counted)))]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
