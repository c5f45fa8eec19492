"""Dense-layer primitives and the activation registry (PyTorch twin of
``multimodn_tpu/core/nn.py``).

Parameters are plain dicts of tensors. A dense layer keeps the JAX package's
``(in, out)`` weight layout, so application is ``x @ w`` and moving weights
between the two packages is a copy. Initialization follows
``torch.nn.Linear``'s distribution: weight and bias ~ U(-1/sqrt(fan_in),
+1/sqrt(fan_in)), drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a GPU the caller must ask for the CPU explicitly; the
    work is never moved to the CPU behind the caller's back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return torch.device("cuda")


def uniform_init(generator: torch.Generator, shape, bound: float,
                 device=None) -> torch.Tensor:
    """U(-bound, +bound) float32 of ``shape``, drawn on the CPU so a seed
    gives the same weights on every device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               device=None) -> dict:
    """Linear layer params with torch.nn.Linear's default init distribution,
    stored ``(in, out)``."""
    bound = 1.0 / (in_dim ** 0.5) if in_dim > 0 else 0.0
    return {"w": uniform_init(generator, (in_dim, out_dim), bound, device),
            "b": uniform_init(generator, (out_dim,), bound, device)}


def dense_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ w + b`` over any leading batch dims. The product accumulates
    in float32, is cast to the activation dtype, then the bias is added in
    that dtype (the JAX package's order)."""
    y = torch.matmul(x.float(), params["w"].float())
    return y.to(x.dtype) + params["b"].to(x.dtype)


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             device=None) -> list:
    """Params for a stack of dense layers with the given dims chain."""
    return [dense_init(generator, d_in, d_out, device)
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def dropout(x: torch.Tensor, rate: float, generator, train: bool
            ) -> torch.Tensor:
    """Inverted dropout with ``torch.nn.Dropout``'s semantics: the identity
    in evaluation or without a generator; in training each element is kept
    with probability ``1 - rate`` (a uniform draw below it) and scaled by
    ``1 / (1 - rate)``."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation; F.gelu defaults to erf.
    return F.gelu(x, approximate="tanh")


def softmax(x):
    return torch.softmax(x, dim=-1)


ACTIVATIONS = {
    "relu": relu,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "identity": identity,
    "none": identity,
    "gelu": gelu,
    "softmax": softmax,
}


def resolve_activation(act):
    """Registry name, registry function, None (identity) or any callable.

    A torch function (reference pipelines pass ``F.relu``,
    ``titanic_mlp_pipeline.py:69``) maps by its name to the registry
    function, as in the JAX package (``multimodn_tpu/core/nn.py:90-102``), so
    its model exports, pickles and runs in the fused chain. ``F.gelu`` thus
    becomes the registry's tanh-form ``gelu``, the JAX package's, not torch's
    erf default."""
    if act is None:
        return identity
    if callable(act):
        if (getattr(act, "__module__", "") or "").startswith("torch"):
            name = getattr(act, "__name__", type(act).__name__).lower()
            if name in ACTIVATIONS:
                return ACTIVATIONS[name]
            raise ValueError(
                f"torch activation {name!r} is not in the registry; known: "
                f"{sorted(ACTIVATIONS)}")
        return act
    try:
        return ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"Unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")


def activation_name(fn) -> str:
    """Registry name of an activation function (the first one registered,
    so identity persists as 'identity')."""
    for name, f in ACTIVATIONS.items():
        if f is fn:
            return name
    raise ValueError(
        f"activation {fn!r} is not in the registry; register it in "
        "multimodn_tpu_torch.core.nn.ACTIVATIONS")
