"""The k-fold and seed-sweep experiments (PyTorch twin of
``multimodn_tpu/experiments.py``).

The JAX package trains every fold of a k-fold protocol, or every seed of a
sweep, at once in one vmapped program, padding folds to a common batch
count with empty batches that are gated off exactly; it is documented
bit-identical to training them one after another. Here the folds and seeds
run one after another through ``MultiModN.fit_best``, with the same
arguments and the same per-fold results. Streaming loaders
(``data.streaming``, ``data.disk``) take the same path through
``experiments_stream``. The encoder orders reach every fold through its
model (``MultiModN._resolve_order``): loaders with one or per-batch
sequences, and ``shuffle_mode`` on a chain that shuffles per batch, where
each fold draws the stream a fresh model of its seed would.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodn_tpu_torch.checkpoint import _loader_state, _restore_loader
from multimodn_tpu_torch.interop import adapt_loader, adapt_optimizer
from multimodn_tpu_torch.optim import Optimizer

MESH_NOT_PORTED = ("mesh=: sharding the {axis} axis across GPUs is not "
                   "ported yet (ROADMAP.md Queue A item 20)")


def _stack_sums(per_epoch: List[dict]) -> dict:
    """Per-epoch grid-sum dicts -> one dict of (epochs, ...) arrays."""
    return {k: np.stack([s[k].numpy() for s in per_epoch])
            for k in per_epoch[0]}


def _streams(loader) -> bool:
    return hasattr(loader, "iter_batches")


def _check_shuffle_mode(model, name: str):
    """The unrolled chain's per-call shuffle would freeze one order for
    every epoch (the JAX package's rule)."""
    if model.shuffle_mode and not model._chain_plan()[1]:
        raise NotImplementedError(
            f"{name} supports shuffle_mode only for chains that shuffle per "
            "batch (homogeneous 'scan' or 'switch' chains); the unrolled "
            "chain's per-call shuffle cannot vary per epoch.")


def _check_binary(model, name: str):
    if not any(d.n_classes == 2 for d in model.decoders):
        raise ValueError(
            f"{name} requires at least one binary (n_classes==2) decoder: "
            "the AUROC+BAC selection score is undefined otherwise (same "
            "contract as MultiModN.fit_best).")


def _fit_one(model, train_loader, val_loader, optimizer, criterion,
             epochs, patience, on_epoch) -> dict:
    """``model.fit_best`` (best parameters restored) as one fold's or one
    seed's result dict."""
    info, train_sums, val_sums = model._fit_best(
        train_loader, optimizer, criterion, epochs, val_loader,
        history=None, val_tag="val", restore_best=True, patience=patience,
        on_epoch=on_epoch)
    return {
        "model": model,
        "best_epoch": info["best_epoch"],
        "best_score": info["best_score"],
        "scores": info["scores"],
        "epochs_ran": info["epochs_ran"],
        "train_sums": _stack_sums(train_sums),
        "val_sums": _stack_sums(val_sums),
        "n_train_batches": train_loader.n_batches,
        "n_val_batches": val_loader.n_batches,
    }


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
        folds: per-fold ``(train_loader, val_loader)`` pairs; a torch
            ``DataLoader`` is mapped onto an ``ArrayLoader`` (``interop``).
        optimizer: shared by the folds; each fold's model keeps its own
            state. A torch optimizer is mapped onto the port's.
        seeds: per-fold init seeds (default 0..F-1, the reference's per-fold
            seed increment).
        patience: per-fold early stopping, ``fit_best``'s semantics.
        on_epoch: called once per fold per executed epoch with
            ``fit_best``'s payload ``{"epoch", "train_loss", "val_loss",
            "score"}``, fold after fold, all before the call returns. A
            fold's losses divide by its own batch counts, as its
            ``fit_best`` does (the JAX package's vmapped program divides a
            shorter fold's by the longest fold's).
        mesh, fold_axis: not ported (fold sharding across GPUs, ROADMAP.md
            Queue A item 20); ``mesh`` raises ``NotImplementedError``. So
            does ``shuffle_mode`` on an explicit ``chain_mode='unrolled'``,
            as in the JAX package: its per-call order would be frozen for
            every epoch.

    Streaming folds (``experiments_stream``): every loader streams or none
    does; no loader may be shuffled and each needs sized geometry, as in
    the JAX package.

    Returns:
        Per-fold dicts: {model (best parameters restored, cycle, epoch
        counter and the fold's optimizer state advanced as by training),
        best_epoch, best_score, scores, epochs_ran, train_sums, val_sums,
        n_train_batches, n_val_batches}; scores and sums cover exactly the
        executed epochs.
    """
    folds = [(adapt_loader(t), adapt_loader(v)) for t, v in folds]
    optimizer = adapt_optimizer(optimizer)
    streaming = [_streams(ldr) for pair in folds for ldr in pair]
    if any(streaming):
        if not all(streaming):
            raise ValueError(
                "mixed fold loaders: every fold's train AND val loader must "
                "be streaming (iter_batches) or every one an ArrayLoader.")
        from multimodn_tpu_torch.experiments_stream import \
            kfold_fit_best_streamed
        return kfold_fit_best_streamed(
            model_factory, folds, optimizer, criterion, epochs=epochs,
            seeds=seeds, mesh=mesh, patience=patience, on_epoch=on_epoch)
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED.format(axis="fold"))
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
    if models:
        _check_binary(models[0], "kfold_fit_best")
        _check_shuffle_mode(models[0], "kfold_fit_best")
    return [_fit_one(model, tr, va, optimizer, criterion, epochs, patience,
                     on_epoch)
            for model, (tr, va) in zip(models, folds)]


def sweep_fit_best(
    model_factory: Callable[[int], "MultiModN"],
    train_loader,
    val_loader,
    optimizer: Optimizer,
    criterion=None,
    epochs: int = 1,
    seeds: Sequence[int] = (0,),
    mesh=None,
    sweep_axis: str = "fold",
    patience: Optional[int] = None,
    on_epoch: Optional[Callable] = None,
) -> List[dict]:
    """Seed sweep: one fresh model per seed trained by ``fit_best`` on the
    same ``(train_loader, val_loader)``, seed after seed. Each seed's
    result equals ``model_factory(seed).fit_best`` on these loaders as they
    stand when the call starts: a shuffled train loader is put back to that
    state before every seed, so no seed sees the shuffles of the seeds
    before it, and it is left as the last seed left it.

    ``patience`` and ``on_epoch`` are ``kfold_fit_best``'s (payloads seed
    after seed). ``mesh`` / ``sweep_axis`` (sharding the seed axis across
    GPUs, ROADMAP.md Queue A item 20) raise ``NotImplementedError``.
    ``Adam8bit`` updates through its fused kernel on a CUDA model, as in
    ``fit_best`` (the JAX package asks for its vmap-safe mode here).

    Returns per-seed dicts shaped like ``kfold_fit_best``'s.
    """
    train_loader = adapt_loader(train_loader)
    val_loader = adapt_loader(val_loader)
    optimizer = adapt_optimizer(optimizer)
    if _streams(train_loader) or _streams(val_loader):
        if not (_streams(train_loader) and _streams(val_loader)):
            raise ValueError(
                "mixed loaders: train and val must both be streaming "
                "(iter_batches) or both ArrayLoaders.")
        from multimodn_tpu_torch.experiments_stream import \
            kfold_fit_best_streamed
        return kfold_fit_best_streamed(
            model_factory, [(train_loader, val_loader)], optimizer,
            criterion, epochs=epochs, seeds=list(seeds), mesh=mesh,
            patience=patience, on_epoch=on_epoch, _shared_loaders=True)
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED.format(axis="seed"))
    if patience is not None and patience < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    start = _loader_state(train_loader)
    models = [model_factory(s) for s in seeds]
    if models:
        _check_binary(models[0], "sweep_fit_best")
        _check_shuffle_mode(models[0], "sweep_fit_best")
    results = []
    for model in models:
        _restore_loader(train_loader, start)
        results.append(_fit_one(model, train_loader, val_loader, optimizer,
                                criterion, epochs, patience, on_epoch))
    return results


def fold_history(result: dict, targets: List[str],
                 ones_initialized_counts: bool = True):
    """Rebuild a ``MultiModNHistory`` (train and "val" rows of every
    executed epoch) from a ``kfold_fit_best`` or ``sweep_fit_best``
    result's sums."""
    from multimodn_tpu_torch.core.history import MultiModNHistory
    from multimodn_tpu_torch.core.step import epoch_reduction

    def stats(sums, e, n_batches):
        return {k: v.numpy() for k, v in epoch_reduction(
            {k: torch.as_tensor(v[e]) for k, v in sums.items()}, n_batches,
            ones_initialized_counts).items()}

    history = MultiModNHistory(targets)
    for e in range(result["scores"].shape[0]):
        train = stats(result["train_sums"], e, result["n_train_batches"])
        history.append_epoch("train", train,
                             state_change=train["state_change_loss"])
        history.append_epoch("val", stats(result["val_sums"], e,
                                          result["n_val_batches"]))
    return history
