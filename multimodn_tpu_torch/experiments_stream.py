"""Streamed experiments (PyTorch twin of ``multimodn_tpu/
experiments_stream.py``): ``kfold_fit_best`` and ``sweep_fit_best`` over
streaming loaders (``data.streaming``, ``data.disk``), for folds whose
epoch stacks need not sit on the device.

The JAX package vmaps the fold or seed axis over batches streamed in
lockstep, padding shorter folds with empty batches. Here each fold or seed
runs ``MultiModN.fit_best`` over its own streamed batches, one after
another, which is what the JAX package's streamed programs are
documented bit-equal to; the guards are the JAX package's. Models built
with a mesh train each fold data-parallel; a fold mesh is refused.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from multimodn_tpu_torch.experiments import _check_binary, \
    _check_shuffle_mode, _fit_one


def is_streaming_loader(ldr) -> bool:
    """A streaming loader yields host batches from ``iter_batches()`` and
    keeps no epoch stacks (an ``ArrayLoader`` has ``host_stacks``)."""
    return hasattr(ldr, "iter_batches")


def _require_sized(ldr, role: str):
    if getattr(ldr, "n_batches", None) is None or \
            getattr(ldr, "n_samples", None) is None:
        raise NotImplementedError(
            f"streamed experiments need sized {role} geometry "
            f"(n_batches/n_samples); this loader wraps an unsized iterable "
            f"dataset. Use a sized loader.")


def _check_engine(template):
    """The JAX package's engine guard (``experiments_stream.py:60-65``).
    Models that own a mesh on the auto engine train each fold
    data-parallel, every rank copying only its rows of a batch
    (``data.streaming.device_batches``)."""
    if template.dp_engine == "shard_map":
        raise NotImplementedError(
            "streamed kfold/sweep supports the auto (GSPMD) engine only: "
            "fold-vmapping the explicit shard_map per-batch step adds no "
            "collective the auto partition lacks here. Build auto-engine "
            "models (equality across engines is pinned for the non-vmapped "
            "streamed paths in tests/test_streaming.py).")


def _validate_streamed(loaders, mesh, patience):
    """The JAX package's guards for streamed experiments
    (``experiments_stream.py:66-98``)."""
    if mesh is not None:
        raise ValueError(
            "fold/seed-axis sharding (mesh=) is a fused-path feature; the "
            "streamed programs shard the BATCH axis via the model's own "
            "mesh instead (model_factory models may carry mesh=).")
    if patience is not None and patience < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    for ldr in loaders:
        if getattr(ldr, "shuffle", False):
            raise NotImplementedError(
                "streamed kfold/sweep cannot honour shuffle=True loaders "
                "(fit_best_streaming's contract: a shuffled stream cannot "
                "be replayed); pre-shuffle the data once or use "
                "ArrayLoaders.")
    sizes = {ldr.batch_size for ldr in loaders}
    if len(sizes) != 1:
        raise ValueError(
            f"all fold loaders must share one batch size, as in the JAX "
            f"package, got {sorted(sizes)}")


def kfold_fit_best_streamed(
    model_factory: Callable[[int], "MultiModN"],
    folds: Sequence[Tuple],
    optimizer,
    criterion=None,
    epochs: int = 1,
    seeds: Optional[Sequence[int]] = None,
    mesh=None,
    patience: Optional[int] = None,
    on_epoch: Optional[Callable] = None,
    _shared_loaders: bool = False,
) -> List[dict]:
    """``experiments.kfold_fit_best`` over streaming fold loaders (that
    entry point routes them here). ``_shared_loaders=True`` is the seed
    sweep: ``folds`` is one ``(train, val)`` pair that every seed of
    ``seeds`` trains on. Returns ``kfold_fit_best``'s per-fold dicts."""
    folds = list(folds)
    n_runs = len(seeds) if _shared_loaders else len(folds)
    seeds = list(seeds) if seeds is not None else list(range(n_runs))
    if not _shared_loaders and len(seeds) != len(folds):
        raise ValueError(f"{len(seeds)} seeds for {len(folds)} folds")
    loaders = [ldr for pair in folds for ldr in pair]
    for ldr in loaders:
        _require_sized(ldr, "fold")
    _validate_streamed(loaders, mesh, patience)
    models = [model_factory(s) for s in seeds]
    if models:
        _check_engine(models[0])
        _check_binary(models[0], "kfold_fit_best")
        _check_shuffle_mode(models[0], "streamed kfold/sweep")
    pairs = folds * n_runs if _shared_loaders else folds
    return [_fit_one(model, tr, va, optimizer, criterion, epochs, patience,
                     on_epoch)
            for model, (tr, va) in zip(models, pairs)]
