"""Torch objects at the model's entry points (PyTorch twin of
``multimodn_tpu/interop.py``).

The reference's pipeline bodies build ``torch.optim.Adam(list(
model.parameters()), lr)``, pass ``torch.nn.CrossEntropyLoss()`` and wrap
datasets in ``torch.utils.data.DataLoader`` (``titanic_mlp_pipeline.py:
63-76``). Each entry point of ``MultiModN`` maps those objects here onto the
port's own, so such a body trains unmodified:

- ``adapt_optimizer``: a torch ``Adam`` / ``AdamW`` / ``SGD`` -> the port's
  ``Adam`` / ``AdamW`` / ``SGD`` with the hyperparameters of its
  ``param_groups``. The torch object only carries hyperparameters: the
  update runs in the port's optimizer, never through torch.
- ``adapt_criterion``: a torch loss module -> the name of the port's
  mask-aware loss (``core.losses``).
- ``adapt_loader``: a ``DataLoader`` -> an ``ArrayLoader`` over the same
  rows with the same batch size, shuffled where the sampler shuffles.

Whatever cannot be mapped raises ``NotImplementedError``; nothing is
silently ignored. Optimizers and loaders are memoized per torch instance,
so a loop of ``train_epoch`` calls keeps one optimizer state and one set of
epoch stacks; an entry leaves its cache when its torch object dies.
"""
from __future__ import annotations

import weakref
from typing import Any

import torch
import torch.utils.data as tud

from multimodn_tpu_torch.core.losses import _torch_loss_name
from multimodn_tpu_torch.data.dataset import Subset
from multimodn_tpu_torch.data.loader import ArrayLoader
from multimodn_tpu_torch.optim import SGD, Adam, AdamW

# id(torch object) -> (weakref to it, adapted object). The weakref's callback
# evicts the entry when the torch object dies, and a hit checks the weakref's
# target, so a recycled id never aliases a dead key.
_OPT_CACHE: dict = {}
_LOADER_CACHE: dict = {}

# Param-group keys the port's optimizers cannot express, with the one value
# they compute as (torch's default). A key at another value, or a key that
# is neither here nor mapped by ``_build_optimizer``, is rejected.
_UNMAPPED_DEFAULTS = {"amsgrad": False, "maximize": False, "nesterov": False,
                      "dampening": 0, "weight_decay": 0, "foreach": None,
                      "fused": None, "capturable": False,
                      "differentiable": False}
# Keys torch's lr schedulers keep in a group for their own arithmetic; what
# they compute reaches the update through ``lr``, ``betas`` or ``momentum``.
_SCHEDULER_KEYS = ("initial_lr", "max_lr", "min_lr", "base_momentum",
                   "max_momentum")


def _cache_lookup(cache: dict, obj):
    entry = cache.get(id(obj))
    if entry is not None and entry[0]() is obj:
        return entry[1]
    return None


def _cache_store(cache: dict, obj, value):
    key = id(obj)
    cache[key] = (weakref.ref(obj, lambda _r, k=key, c=cache:
                              c.pop(k, None)), value)
    return value


def is_torch_optimizer(obj: Any) -> bool:
    return isinstance(obj, torch.optim.Optimizer)


def is_torch_loss(obj: Any) -> bool:
    return isinstance(obj, torch.nn.modules.loss._Loss)


def is_torch_dataloader(obj: Any) -> bool:
    """True for a ``torch.utils.data.DataLoader`` only, never for a
    ``Dataset``, ``Subset`` or ``Sampler``."""
    return isinstance(obj, tud.DataLoader)


def _torch_opt_hparams(opt) -> dict:
    """A torch optimizer's hyperparameters, read from ``param_groups``, which
    lr schedulers and manual edits change (``.defaults`` never changes). All
    groups must agree: one port optimizer updates the whole parameter
    tree."""
    groups = opt.param_groups
    keys = set().union(*(g.keys() for g in groups)) - {"params"}
    hp = {}
    for k in sorted(keys):
        vals = [g.get(k, opt.defaults.get(k)) for g in groups]
        if any(v != vals[0] for v in vals[1:]):
            raise NotImplementedError(
                f"torch optimizer with per-param-group '{k}' values "
                f"{vals!r} cannot be mapped onto the port's optimizer (one "
                "hyperparameter set updates the whole parameter tree); use a "
                "single param group or multimodn_tpu_torch.optim directly")
        hp[k] = tuple(vals[0]) if isinstance(vals[0], (list, tuple)) \
            else vals[0]
    return hp


def _reject(name: str, hp: dict, mapped) -> None:
    bad = [f"{k}={v!r} (supported: "
           + (f"{_UNMAPPED_DEFAULTS[k]!r})" if k in _UNMAPPED_DEFAULTS
              else "no mapping)")
           for k, v in hp.items() if k not in mapped
           and k not in _SCHEDULER_KEYS and
           (k not in _UNMAPPED_DEFAULTS or v != _UNMAPPED_DEFAULTS[k])]
    if bad:
        raise NotImplementedError(
            f"torch {name} with non-default options cannot be mapped onto "
            f"the port's optimizer: {', '.join(bad)}")


def _build_optimizer(opt, hp: dict):
    """The port's optimizer for torch optimizer ``opt`` with hyperparameters
    ``hp``. ``maximize=True`` (gradient ascent) is rejected like every knob
    the port's optimizers cannot express. ``AdamW`` is tested first: it is a
    subclass of ``Adam`` in recent torch, where ``Adam(decoupled_weight_decay
    =True)`` is ``AdamW`` too."""
    lr = float(hp["lr"])
    if isinstance(opt, torch.optim.AdamW) or (
            isinstance(opt, torch.optim.Adam)
            and hp.get("decoupled_weight_decay", False)):
        _reject("AdamW", hp, ("lr", "betas", "eps", "weight_decay",
                              "decoupled_weight_decay"))
        return AdamW(lr, betas=tuple(float(b) for b in hp["betas"]),
                     eps=float(hp["eps"]),
                     weight_decay=float(hp["weight_decay"]))
    if isinstance(opt, torch.optim.Adam):
        _reject("Adam", hp, ("lr", "betas", "eps", "decoupled_weight_decay"))
        return Adam(lr, betas=tuple(float(b) for b in hp["betas"]),
                    eps=float(hp["eps"]))
    if isinstance(opt, torch.optim.SGD):
        _reject("SGD", hp, ("lr", "momentum"))
        return SGD(lr, momentum=float(hp["momentum"]))
    raise NotImplementedError(
        f"no mapping for torch optimizer {type(opt).__name__}; use "
        "multimodn_tpu_torch.optim directly")


def adapt_optimizer(opt: Any):
    """The port's optimizer for a torch optimizer instance (anything else is
    returned as it is), memoized per instance.

    A changed hyperparameter (an lr scheduler's step, a manual
    ``param_groups`` edit) is written into the SAME port optimizer: the
    model keys its optimizer state on the optimizer's identity
    (``MultiModN._use_optimizer``), so the Adam moments and step counts carry
    across the change, as in torch. The port's optimizers read their
    hyperparameters at every update, so nothing is rebuilt; the JAX package
    memoizes one transformation per hyperparameter set instead, to spare XLA
    recompiles, which eager PyTorch does not have."""
    if not is_torch_optimizer(opt):
        return opt
    hp = _torch_opt_hparams(opt)
    cached = _cache_lookup(_OPT_CACHE, opt)
    if cached is None:
        return _cache_store(_OPT_CACHE, opt,
                            (_build_optimizer(opt, hp), hp))[0]
    ours, built_hp = cached
    if hp != built_hp:
        fresh = _build_optimizer(opt, hp)
        if type(fresh) is not type(ours) or \
                bool(getattr(fresh, "momentum", 0)) != \
                bool(getattr(ours, "momentum", 0)):
            raise NotImplementedError(
                "a torch optimizer whose hyperparameters change the port's "
                f"optimizer or its state ({built_hp} -> {hp}) cannot keep "
                "its state; build a new optimizer")
        vars(ours).update(vars(fresh))
        _cache_store(_OPT_CACHE, opt, (ours, hp))
    return ours


def adapt_criterion(criterion: Any):
    """The name of the port's loss for a torch loss module with default
    settings (``CrossEntropyLoss`` -> 'cross_entropy', ``BCELoss`` -> 'bce',
    ``MSELoss`` -> 'mse'), None for anything else; raises for a torch loss it
    cannot map. The mapping lives in ``core.losses``, which
    ``resolve_criterion`` applies at every entry point."""
    return _torch_loss_name(criterion)


def adapt_loader(loader: Any):
    """An ``ArrayLoader`` over a ``DataLoader``'s rows with its batch size
    (anything else is returned as it is), memoized per ``DataLoader``.

    The sampler decides which rows and whether they are shuffled:
    ``SequentialSampler`` (all rows in order), ``RandomSampler`` (all rows,
    reshuffled every epoch) or ``SubsetRandomSampler`` (its rows, reshuffled).
    A shuffled loader draws the JAX package's order, ``ArrayLoader(...,
    shuffle=True, seed=0)``, not torch's. ``drop_last=True``, a custom batch
    sampler, ``RandomSampler(replacement=True)`` or a custom ``num_samples``,
    and any other sampler raise."""
    if not is_torch_dataloader(loader):
        return loader
    cached = _cache_lookup(_LOADER_CACHE, loader)
    if cached is not None:
        return cached
    batches = loader.batch_sampler
    if batches is not None and type(batches) is not tud.BatchSampler:
        raise NotImplementedError(
            "custom torch batch_samplers are not supported; use the default "
            "sequential/random samplers")
    if getattr(batches, "drop_last", False):
        raise NotImplementedError(
            "torch DataLoader(drop_last=True) has no ArrayLoader equivalent "
            "(the padded-tail mask keeps the final short batch exact); use "
            "drop_last=False")
    sampler = batches.sampler if batches is not None else loader.sampler
    dataset = loader.dataset
    if type(sampler) is tud.SequentialSampler:
        shuffle = False
    elif type(sampler) is tud.SubsetRandomSampler:
        dataset = Subset(dataset, [int(i) for i in sampler.indices])
        shuffle = True
    elif type(sampler) is tud.RandomSampler:
        if sampler.replacement or sampler.num_samples != len(dataset):
            raise NotImplementedError(
                "torch RandomSampler with replacement=True or a custom "
                "num_samples has no ArrayLoader equivalent (epochs here are "
                "exact permutations); use the default RandomSampler")
        shuffle = True
    else:
        raise NotImplementedError(
            f"torch DataLoader sampler {type(sampler).__name__} is not "
            "supported (it selects rows an ArrayLoader would silently "
            "ignore); use shuffle=True/False, SubsetRandomSampler, or build "
            "an ArrayLoader over the intended subset directly")
    batch_size = (batches.batch_size if batches is not None else None) \
        or len(dataset)
    return _cache_store(_LOADER_CACHE, loader,
                        ArrayLoader(dataset, batch_size, shuffle=shuffle,
                                    seed=0))
