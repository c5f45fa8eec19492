"""The k-fold experiment (PyTorch twin of ``kfold_fit_best`` in
``multimodn_tpu/experiments.py``).

The JAX package trains every fold of a k-fold protocol at once in one
vmapped program, padding folds to a common batch count with empty batches
that are gated off exactly; it is documented bit-identical to training the
folds one after another. Here the folds run one after another through
``MultiModN.fit_best``, with the same arguments and the same per-fold
results. Streaming fold loaders (``data.streaming``, ``data.disk``; the JAX
package's ``experiments_stream.kfold_fit_best_streamed``) take the same path:
each fold runs ``fit_best`` over its streamed batches. The encoder orders
reach every fold through its model (``MultiModN._resolve_order``): loaders
with one or per-batch sequences, and ``shuffle_mode`` on a chain that
shuffles per batch, where each fold draws the stream a fresh model of its
seed would.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from multimodn_tpu_torch.optim import Optimizer


def _stack_sums(per_epoch: List[dict]) -> dict:
    """Per-epoch grid-sum dicts -> one dict of (epochs, ...) arrays."""
    return {k: np.stack([s[k].numpy() for s in per_epoch])
            for k in per_epoch[0]}


def kfold_fit_best(
    model_factory: Callable[[int], "MultiModN"],
    folds: Sequence[Tuple],            # [(train_loader, val_loader), ...]
    optimizer: Optimizer,
    criterion=None,
    epochs: int = 1,
    seeds: Optional[Sequence[int]] = None,
    mesh=None,
    fold_axis: str = "fold",
    patience: Optional[int] = None,
    on_epoch: Optional[Callable] = None,
) -> List[dict]:
    """Train one model per fold with best-epoch selection on validation
    AUROC + balanced accuracy.

    Args:
        model_factory: seed -> MultiModN; one fresh model per fold.
        folds: per-fold ``(train_loader, val_loader)`` pairs.
        optimizer: shared by the folds; each fold's model keeps its own
            state.
        seeds: per-fold init seeds (default 0..F-1, the reference's per-fold
            seed increment).
        patience: per-fold early stopping, ``fit_best``'s semantics.
        mesh, fold_axis, on_epoch: not ported (fold sharding across GPUs,
            ROADMAP.md Queue A item 20; progress callbacks, item 6); they
            raise ``NotImplementedError``. So does ``shuffle_mode`` on an
            explicit ``chain_mode='unrolled'``, as in the JAX package: its
            per-call order would be frozen for every epoch.

    Streaming folds: every loader streams or none does; no loader may be
    shuffled (``fit_best_streaming``'s rule) and each needs sized geometry
    (``n_batches``), as in the JAX package.

    Returns:
        Per-fold dicts: {model (best parameters restored, cycle, epoch
        counter and the fold's optimizer state advanced as by training),
        best_epoch, best_score, scores, epochs_ran, train_sums, val_sums,
        n_train_batches, n_val_batches}; scores and sums cover exactly the
        executed epochs.
    """
    folds = list(folds)
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: sharding the fold axis across GPUs is not ported yet "
            "(ROADMAP.md Queue A item 20)")
    if on_epoch is not None:
        raise NotImplementedError(
            "on_epoch progress callbacks are not ported yet (ROADMAP.md "
            "Queue A item 6)")
    loaders = [ldr for pair in folds for ldr in pair]
    streaming = [hasattr(ldr, "iter_batches") for ldr in loaders]
    if any(streaming):
        from multimodn_tpu_torch.data.streaming import SHUFFLED_SELECTION
        if not all(streaming):
            raise ValueError(
                "mixed fold loaders: every train and val loader must be "
                "streaming (iter_batches) or every one an ArrayLoader")
        for ldr in loaders:
            if getattr(ldr, "n_batches", None) is None:
                raise NotImplementedError(
                    "streamed k-fold needs sized fold geometry (n_batches); "
                    "this loader wraps an unsized iterable dataset")
            if getattr(ldr, "shuffle", False):
                raise NotImplementedError(SHUFFLED_SELECTION)
    if patience is not None and patience < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    shuffles = [bool(getattr(f[0], "shuffle", False)) for f in folds]
    if any(shuffles) and not all(shuffles):
        raise ValueError(
            "all fold train loaders must agree on shuffle=, as in the JAX "
            "package's one program over every fold.")
    seeds = list(seeds) if seeds is not None else list(range(len(folds)))
    if len(seeds) != len(folds):
        raise ValueError(f"{len(seeds)} seeds for {len(folds)} folds")
    models = [model_factory(s) for s in seeds]
    if models and models[0].shuffle_mode and not models[0]._chain_plan()[1]:
        raise NotImplementedError(
            "kfold_fit_best supports shuffle_mode only for chains that "
            "shuffle per batch (homogeneous 'scan' or 'switch' chains); "
            "the unrolled chain's per-call shuffle cannot vary per epoch.")
    results = []
    for model, (train_loader, val_loader) in zip(models, folds):
        info, train_sums, val_sums = model._fit_best(
            train_loader, optimizer, criterion, epochs, val_loader,
            history=None, val_tag="val", restore_best=True,
            patience=patience)
        results.append({
            "model": model,
            "best_epoch": info["best_epoch"],
            "best_score": info["best_score"],
            "scores": info["scores"],
            "epochs_ran": info["epochs_ran"],
            "train_sums": _stack_sums(train_sums),
            "val_sums": _stack_sums(val_sums),
            "n_train_batches": train_loader.n_batches,
            "n_val_batches": val_loader.n_batches,
        })
    return results
