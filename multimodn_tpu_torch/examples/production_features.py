"""Production-path tour (the port of ``examples/production_features.py``):
preemption-safe training, an ahead-of-time serving artifact, and a whole
k-fold experiment in one call.

On the card: ``python -m multimodn_tpu_torch.examples.production_features``;
on the CPU: ``python -m multimodn_tpu_torch.examples.production_features
--device cpu``.
"""
import argparse
import os
import tempfile

import numpy as np

from multimodn_tpu_torch import (Adam, MultiModN, export_compiled,
                                 load_compiled)
from multimodn_tpu_torch.checkpoint import fit_best_resumable
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
from multimodn_tpu_torch.decoders import LogisticDecoder
from multimodn_tpu_torch.encoders import MLPEncoder
from multimodn_tpu_torch.experiments import kfold_fit_best


def build(seed=0, device=None):
    return MultiModN(4, [MLPEncoder(4, 4, (8,)), MLPEncoder(4, 2, (8,))],
                     [LogisticDecoder(4)], 0.7, 0.3, seed=seed,
                     device=device)


def main(device=None) -> dict:
    """Run the three parts on ``device`` (CUDA unless named); returns what
    each part produced: the resumable fit's result, the artifact's outputs
    at batch 1 and 32, and the k-fold results."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(120, 6)).astype(np.float32)
    y = (X @ rng.normal(size=6) > 0).astype(np.int64)[:, None]
    ds = PartitionDataset(X, y, [4, 2])
    tr, va, _ = ds.random_split((0.7, 0.3, 0), seed=0)
    out = {}

    with tempfile.TemporaryDirectory() as tmp:
        # 1. Preemption-safe best-checkpoint training: kill this process at
        #    any point and re-run; it resumes from the last atomic
        #    checkpoint and ends bit-identical to an uninterrupted run.
        model = build(device=device)
        res = fit_best_resumable(
            model, ArrayLoader(tr, 16), Adam(0.01), "cross_entropy",
            epochs=20, chunk_epochs=5, val_loader=ArrayLoader(va, 16),
            checkpoint_dir=os.path.join(tmp, "ckpt"))
        print(f"resumable fit_best: best epoch {res['best_epoch']} "
              f"score {res['best_score']:.4f} ({res['epochs_run']} epochs)")
        out["resumable"] = res

        # 2. Ahead-of-time serving artifact: the whole forward with the
        #    parameters inside and a symbolic batch dimension, traced on the
        #    CPU. The serving side needs no model code and no params file.
        path = export_compiled(model, os.path.join(tmp, "model.pt2"))
        run = load_compiled(path, device=device)
        out["served"] = {}
        for batch in (1, 32):
            probs = run(X[:batch, :4], X[:batch, 4:])[0]   # (E+1, b, 2)
            out["served"][batch] = probs
            print(f"AOT artifact @batch {batch}: final-step p(+) = "
                  f"{probs[-1, :3, 1].cpu().numpy().round(3)}")

    # 3. A whole cross-validation experiment in one call: every fold trains
    #    through fit_best, fold after fold.
    folds = []
    for k in range(2):
        ftr, fva, _ = ds.random_split((0.7, 0.3, 0), seed=k)
        folds.append((ArrayLoader(ftr, 16), ArrayLoader(fva, 16)))
    results = kfold_fit_best(lambda s: build(s, device), folds, Adam(0.01),
                             "cross_entropy", epochs=5)
    for f, r in enumerate(results):
        print(f"fold {f}: best epoch {r['best_epoch']} "
              f"score {r['best_score']:.4f}")
    out["kfold"] = results
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    main(parser.parse_args().device)
