"""Dense-layer primitives and the activation registry (PyTorch twin of
``multimodn_tpu/core/nn.py``).

Parameters are plain dicts of tensors. A dense layer keeps the JAX package's
``(in, out)`` weight layout, so application is ``x @ w`` and moving weights
between the two packages is a copy. Initialization follows
``torch.nn.Linear``'s distribution: weight and bias ~ U(-1/sqrt(fan_in),
+1/sqrt(fan_in)), drawn from an explicit ``torch.Generator``.

Under a mesh's ``model`` axis a dense layer may hold a column piece of its
weight and bias (``parallel.sharding``); the step marks such a layer with
``"model_axis"`` (``parallel.dp_step.DataParallel.view``) and
``dense_apply`` runs it column-parallel, with Megatron's pair of autograd
functions: ``CopyToModelAxis`` (identity forward, all-reduce of the input
gradient backward) and ``GatherFromModelAxis`` (all-gather of the output
columns forward, the rank's own columns of the gradient backward). The
weight gradient ``x^T dL/dy_r`` stays local and ``dL/dx`` is whole. Any
other sharded leaf (a LayerNorm's or BatchNorm's vectors, a position
table, a recurrent layer's gate columns) is made whole once per forward by
``gather_leaf``, ``GatherFromModelAxis`` applied to a parameter.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a GPU the caller must ask for the CPU explicitly; the
    work is never moved to the CPU behind the caller's back.

    This is where the port's CUDA path starts, so a CUDA device also turns
    off cuBLAS's reduced-precision reductions for half-precision GEMMs
    (``exact_half_reductions``)."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        exact_half_reductions()
    return device


def exact_half_reductions():
    """A bf16 or fp16 GEMM on the card accumulates in fp32 and rounds once,
    as the JAX package's ``preferred_element_type=float32`` products do.
    PyTorch's default lets cuBLAS reduce split-K partial sums in the half
    type, which rounds more than once."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


HALF_DTYPES = (torch.bfloat16, torch.float16)


def resolve_dtype(dtype) -> Optional[torch.dtype]:
    """A model's ``compute_dtype`` as a torch dtype: None stays None (fp32
    everywhere, the reference's numerics); a dtype name (``'bfloat16'``,
    ``'float16'``, ``'float32'``), a torch dtype, or any object whose
    ``name`` or ``__name__`` is such a name (numpy and JAX dtypes) maps to
    the torch floating dtype of that name."""
    if dtype is None:
        return None
    out = dtype
    if not isinstance(dtype, torch.dtype):
        name = dtype if isinstance(dtype, str) else (
            getattr(dtype, "name", None) or getattr(dtype, "__name__", None))
        out = getattr(torch, str(name).removeprefix("torch."), None)
    if not isinstance(out, torch.dtype) or not out.is_floating_point:
        raise ValueError(f"compute_dtype must name a floating dtype, got "
                         f"{dtype!r}")
    return out


def dtype_name(dtype) -> Optional[str]:
    """``resolve_dtype(dtype)``'s name as the JAX package writes it into an
    export (``'bfloat16'``), or None."""
    dtype = resolve_dtype(dtype)
    return None if dtype is None else str(dtype).removeprefix("torch.")


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
    that dtype (the JAX package's order).

    A layer tagged ``"model_axis"`` holds the rank's columns and runs
    column-parallel (module docstring).

    On the card, bf16 or fp16 activations and weights of that dtype run a
    half-precision GEMM that accumulates in fp32 and rounds its output once
    (``exact_half_reductions``), which is the same product; elsewhere the
    operands are upcast and the fp32 product is cast."""
    w, axis = params["w"], params.get("model_axis")
    if axis is not None:
        x = CopyToModelAxis.apply(x, axis)
    if x.is_cuda and x.dtype in HALF_DTYPES and w.dtype == x.dtype:
        y = torch.matmul(x, w)
    else:
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    y = y + params["b"].to(x.dtype)
    return y if axis is None else GatherFromModelAxis.apply(y, axis)


class CopyToModelAxis(torch.autograd.Function):
    """Identity forward; backward, the input gradient summed over the model
    axis (each rank's columns contribute their part of ``dL/dx``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad, "sum"), None


class GatherFromModelAxis(torch.autograd.Function):
    """Forward, every rank's pieces along ``dim`` (the last by default)
    concatenated in model-axis order; backward, the rank's own piece of the
    gradient."""

    @staticmethod
    def forward(ctx, y, axis, dim=-1):
        ctx.axis, ctx.dim = axis, dim % y.dim()
        ctx.width = y.shape[ctx.dim]
        return axis.all_gather(y, dim=ctx.dim)

    @staticmethod
    def backward(ctx, grad):
        i, k = ctx.axis.index, ctx.width
        return grad.narrow(ctx.dim, i * k, k).contiguous(), None, None


def gather_leaf(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The whole parameter of which ``t`` is the rank's piece along ``dim``
    over the model ``axis``. Every rank of the axis computes the same graph
    from the whole leaf, so the rank's slice of the gradient is the whole
    true gradient of its piece."""
    return GatherFromModelAxis.apply(t, axis, dim)


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             device=None) -> list:
    """Params for a stack of dense layers with the given dims chain."""
    return [dense_init(generator, d_in, d_out, device)
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` from a training generator: a
    ``torch.Generator``, or a stream with ``rand(shape, device)`` (a mesh
    rank's ``parallel.dp_step.RowStream``)."""
    if hasattr(generator, "rand"):
        return generator.rand(shape, device)
    return torch.rand(shape, generator=generator, device=device)


def dropout(x: torch.Tensor, rate: float, generator, train: bool
            ) -> torch.Tensor:
    """Inverted dropout with ``torch.nn.Dropout``'s semantics: the identity
    in evaluation or without a generator; in training each element is kept
    with probability ``1 - rate`` (a uniform draw below it) and scaled by
    ``1 / (1 - rate)``."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = uniform(x.shape, generator, x.device) < keep
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
