"""Mask-aware loss functions (PyTorch twin of
``multimodn_tpu/core/losses.py``).

The reference applies ``torch.nn.CrossEntropyLoss`` to the decoders'
sigmoid-activated outputs (quirk #4): the loss here is log-softmax over
whatever the decoder emitted. Every loss takes an optional per-sample mask,
so padded batch tails never reach the mean.
"""
from __future__ import annotations

import inspect
from typing import Optional

import torch
import torch.nn as nn


def _masked_mean(per_sample: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return per_sample.mean(dim=-1)
    m = mask.to(per_sample.dtype)
    return (per_sample * m).sum(dim=-1) / m.sum(dim=-1).clamp_min(1.0)


def cross_entropy_loss(outputs: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy with ``torch.nn.CrossEntropyLoss``'s semantics:
    ``outputs`` (..., B, C) scores, ``targets`` (..., B) class indices,
    ``mask`` (..., B) validity; returns the (...) means over valid samples."""
    logz = torch.logsumexp(outputs, dim=-1)
    picked = outputs.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    return _masked_mean(logz - picked, mask)


def bce_loss(outputs: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy over the positive-class column (column 1)."""
    p = outputs[..., 1].clamp(1e-7, 1.0 - 1e-7)
    t = targets.to(p.dtype)
    return _masked_mean(-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)),
                        mask)


def mse_loss(outputs: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error against one-hot targets."""
    onehot = torch.nn.functional.one_hot(
        targets.long(), outputs.shape[-1]).to(outputs.dtype)
    return _masked_mean(((outputs - onehot) ** 2).mean(dim=-1), mask)


LOSSES = {
    "cross_entropy": cross_entropy_loss,
    "ce": cross_entropy_loss,
    "bce": bce_loss,
    "mse": mse_loss,
}

for _fn in (cross_entropy_loss, bce_loss, mse_loss):
    _fn._accepts_mask = True


class CrossEntropyLoss:
    """Criterion object named like ``torch.nn.CrossEntropyLoss``, as the
    reference pipelines use it, with the mask argument."""

    _accepts_mask = True

    def __call__(self, outputs, targets, mask=None):
        return cross_entropy_loss(outputs, targets, mask)


def _torch_loss_name(criterion):
    """The loss name of a ``torch.nn`` loss module with default settings,
    else None."""
    if not isinstance(criterion, nn.modules.loss._Loss):
        return None
    if getattr(criterion, "reduction", "mean") != "mean":
        raise NotImplementedError(
            f"{type(criterion).__name__}(reduction="
            f"{criterion.reduction!r}) is not supported; use 'mean'")
    if isinstance(criterion, nn.CrossEntropyLoss):
        if criterion.weight is not None or criterion.ignore_index != -100 \
                or criterion.label_smoothing != 0.0:
            raise NotImplementedError(
                "CrossEntropyLoss with weight, ignore_index or "
                "label_smoothing is not supported")
        return "cross_entropy"
    if isinstance(criterion, nn.BCELoss) and criterion.weight is None:
        return "bce"
    if isinstance(criterion, nn.MSELoss):
        return "mse"
    raise NotImplementedError(
        f"no mapping for torch loss {type(criterion).__name__}; pass one of "
        f"{sorted(LOSSES)} or a callable")


def resolve_criterion(criterion):
    """A loss name, a ``torch.nn`` loss module (mapped to its mask-aware
    twin), a callable, or None (cross-entropy).

    A callable that takes ``(outputs, targets)`` is applied to each metric
    row on its own and cannot be corrected for padded tails; one whose third
    required parameter is named ``mask`` receives the per-sample validity."""
    if criterion is None:
        return cross_entropy_loss
    name = _torch_loss_name(criterion)
    if name is not None:
        return LOSSES[name]
    if isinstance(criterion, str):
        try:
            return LOSSES[criterion]
        except KeyError:
            raise ValueError(
                f"Unknown loss {criterion!r}; known: {sorted(LOSSES)}")
    if not callable(criterion):
        raise ValueError(f"criterion must be a name or a callable, got "
                         f"{criterion!r}")
    if getattr(criterion, "_accepts_mask", None) is not None:
        return criterion
    try:
        required = [p for p in inspect.signature(criterion).parameters
                    .values() if p.default is inspect.Parameter.empty
                    and p.kind in (p.POSITIONAL_ONLY,
                                   p.POSITIONAL_OR_KEYWORD)]
    except (ValueError, TypeError):
        required = [None, None]
    if len(required) >= 3 and (len(required) > 3 or required[2].name not in
                               ("mask", "sample_mask", "valid_mask",
                                "validity")):
        raise ValueError(
            f"criterion {getattr(criterion, '__name__', criterion)!r} "
            f"requires {len(required)} positional arguments; only (outputs, "
            "targets) or (outputs, targets, mask) criteria are supported")

    def wrapped(outputs, targets, mask=None, _base=criterion):
        return _base(outputs, targets, mask) if len(required) >= 3 \
            else _base(outputs, targets)

    wrapped._accepts_mask = len(required) >= 3
    return wrapped
