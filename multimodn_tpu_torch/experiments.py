"""The k-fold and seed-sweep experiments (PyTorch twin of
``multimodn_tpu/experiments.py``).

The JAX package trains every fold of a k-fold protocol, or every seed of a
sweep, at once in one vmapped program, padding folds to a common batch
count with empty batches that are gated off exactly; it is documented
bit-identical to training them one after another. Here the folds and seeds
run one after another through ``MultiModN.fit_best``, with the same
arguments and the same per-fold results. Streaming loaders
(``data.streaming``, ``data.disk``) take the same path through
``experiments_stream``.

``mesh=`` with a ``fold`` axis (``sweep_axis`` / ``fold_axis``) spreads the
folds or seeds over the ranks of that axis: fold (or seed) ``i`` trains on
rank ``i mod n``, and every rank gets every result, in fold or seed order,
with its model on the rank's device (``_spread``). The JAX package pads the
fold axis to a multiple of the mesh and drops the padding; round-robin
needs no padding. A model-owned mesh (``model_factory`` building
``MultiModN(mesh=...)``) trains each fold data-parallel instead, and the
two are exclusive, as in the JAX package.

The encoder orders reach every fold through its
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


def _fold_group(mesh, axis: str):
    """The mesh's ``axis`` group (JAX ``experiments.py:346-351``)."""
    names = tuple(getattr(mesh, "axis_names", ()))
    if axis not in names:
        raise ValueError(f"mesh has no '{axis}' axis (axes: {names})")
    return mesh.axis(axis)


OWNED_MESH = {
    "fold": ("fold-axis sharding and a model-owned mesh are mutually "
             "exclusive: model_factory must build mesh-free models (the fold "
             "axis is the parallel axis here; batch/TP sharding would nest "
             "meshes). Drop mesh= from the factory or from kfold_fit_best."),
    "seed": ("seed-axis sharding and a model-owned mesh are mutually "
             "exclusive (same rule as kfold_fit_best): model_factory must "
             "build mesh-free models.")}


def _fold_template(model_factory, seeds, what: str):
    """The first run's model, built on every rank before any other (a
    model that owns a mesh builds collectively), checked: a fold or seed
    mesh excludes models that own a mesh (JAX ``experiments.py:177-182``,
    ``:356-361``)."""
    template = model_factory(seeds[0])
    if template.dp_engine == "shard_map":
        raise ValueError(
            "fold/seed-axis sharding (mesh=) and dp_engine='shard_map' "
            "models are mutually exclusive: the template's data mesh "
            "carries the explicit collectives; the fold axis is vmapped "
            "over it. Drop mesh= or build auto-engine models.")
    if template.mesh is not None:
        raise ValueError(OWNED_MESH[what])
    return template


def _portable(result: dict) -> dict:
    """A result as it travels to the other ranks: the model pickles with
    whole numpy parameters; its optimizer state rides beside it."""
    from multimodn_tpu_torch.checkpoint import _to_numpy
    model = result["model"]
    return dict(result, opt_state=None if model.opt_state is None
                else _to_numpy(model.opt_state))


def _arrived(result: dict, device, optimizer) -> dict:
    """Another rank's result on this rank's ``device``, its optimizer state
    bound to ``optimizer`` as training left it."""
    from multimodn_tpu_torch.checkpoint import opt_state_from_numpy
    from multimodn_tpu_torch.core.tree import tree_map
    result = dict(result)
    model, state = result.pop("model"), result.pop("opt_state")
    model.device = torch.device(device)
    model.params = tree_map(lambda t: t.to(model.device), model.params)
    model.init_state.to(model.device)
    if state is not None:
        model.opt_state = opt_state_from_numpy(optimizer, state,
                                               model.params)
        model._opt = optimizer
    result["model"] = model
    return result


def _build(model_factory, seeds, group, template=None) -> dict:
    """``{i: model_factory(seeds[i])}`` for the runs this rank trains (all
    of them without a fold group), built before any of them trains; run 0
    reuses ``template`` when given."""
    return {i: template if i == 0 and template is not None
            else model_factory(s) for i, s in enumerate(seeds)
            if group is None or i % group.size == group.index}


def _spread(group, n_runs: int, run, optimizer) -> List[dict]:
    """``run(i)`` for the runs ``i`` with ``i mod n == rank`` of the fold
    ``group``; every rank gets all ``n_runs`` results in order, models on
    its device."""
    mine = {i: run(i) for i in range(n_runs) if i % group.size == group.index}
    if group.size == 1:
        return [mine[i] for i in range(n_runs)]
    parts = group.all_gather_object(
        {i: _portable(r) for i, r in mine.items()})
    device = next(iter(mine.values()))["model"].device if mine else None
    out = []
    for i in range(n_runs):
        if i in mine:
            out.append(mine[i])
        else:
            r = parts[i % group.size][i]
            out.append(_arrived(r, device or r["model"].device, optimizer))
    return out


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
        mesh, fold_axis: spread the folds over the ranks of the mesh's
            ``fold_axis`` (module docstring); the factory must build
            mesh-free models. ``shuffle_mode`` on an explicit
            ``chain_mode='unrolled'`` raises ``NotImplementedError``, as in
            the JAX package: its per-call order would be frozen for every
            epoch.

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
    if patience is not None and patience < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    group = None if mesh is None else _fold_group(mesh, fold_axis)
    shuffles = [bool(getattr(f[0], "shuffle", False)) for f in folds]
    if any(shuffles) and not all(shuffles):
        raise ValueError(
            "all fold train loaders must agree on shuffle=, as in the JAX "
            "package's one program over every fold.")
    seeds = list(seeds) if seeds is not None else list(range(len(folds)))
    if len(seeds) != len(folds):
        raise ValueError(f"{len(seeds)} seeds for {len(folds)} folds")
    if not folds:
        return []
    template = None if group is None else \
        _fold_template(model_factory, seeds, "fold")
    models = _build(model_factory, seeds, group, template)
    template = models.get(0, template) or next(iter(models.values()))
    _check_binary(template, "kfold_fit_best")
    _check_shuffle_mode(template, "kfold_fit_best")

    def run(i):
        return _fit_one(models[i], *folds[i], optimizer, criterion, epochs,
                        patience, on_epoch)

    if group is None:
        return [run(i) for i in range(len(folds))]
    return _spread(group, len(folds), run, optimizer)


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
    after seed). ``mesh`` / ``sweep_axis``: spread the seeds over the ranks
    of the mesh's ``sweep_axis`` (module docstring); each rank puts a
    shuffled train loader back before each of its seeds, so each seed's
    result is the same, and leaves it as its last seed left it.
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
    if patience is not None and patience < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    group = None if mesh is None else _fold_group(mesh, sweep_axis)
    seeds = list(seeds)
    if not seeds:
        return []
    start = _loader_state(train_loader)
    template = None if group is None else \
        _fold_template(model_factory, seeds, "seed")
    models = _build(model_factory, seeds, group, template)
    template = models.get(0, template) or next(iter(models.values()))
    _check_binary(template, "sweep_fit_best")
    _check_shuffle_mode(template, "sweep_fit_best")

    def run(i):
        _restore_loader(train_loader, start)
        return _fit_one(models[i], train_loader, val_loader, optimizer,
                        criterion, epochs, patience, on_epoch)

    if group is None:
        return [run(i) for i in range(len(seeds))]
    return _spread(group, len(seeds), run, optimizer)


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
