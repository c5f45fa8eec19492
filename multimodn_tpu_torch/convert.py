"""Weight and optimizer-state transplant between the JAX package and this one.

Both packages keep one parameter tree ``{"init_state", "encoders",
"decoders"}`` with dense weights stored ``(in, out)``, so moving weights is
a copy. The JAX package may store encoder parameters scan-stacked: one dict
whose leaves carry a leading ``(E,)`` axis instead of a per-encoder list.
Those are unstacked here the way ``MultiModN.fused_forward`` of the JAX
package does it.
"""
from __future__ import annotations

import numpy as np
import torch

from multimodn_tpu_torch.core.nn import resolve_device
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map, \
    tree_unflatten


def unstack_encoders(stacked: dict) -> list:
    """Scan-stacked encoder storage -> per-encoder list of trees."""
    n = {np.shape(leaf)[0] for leaf in tree_leaves(stacked)}
    if len(n) != 1:
        raise ValueError(f"stacked encoder leaves disagree on the leading "
                         f"(E,) axis: {sorted(n)}")
    return [tree_map(lambda leaf, i=i: leaf[i], stacked)
            for i in range(n.pop())]


def stack_encoders(encoders: list) -> dict:
    """Per-encoder list of numpy trees -> the JAX package's scan-stacked
    storage (every leaf with a leading ``(E,)`` axis)."""
    groups = zip(*(tree_leaves(e) for e in encoders))
    return tree_unflatten(encoders[0], [np.stack(g) for g in groups])


def _per_encoder(tree: dict) -> dict:
    """A ``{"init_state", "encoders", "decoders"}`` tree with per-encoder
    storage, unstacking scan-stacked encoders."""
    encoders = tree["encoders"]
    if isinstance(encoders, dict):
        encoders = unstack_encoders(encoders)
    return {"init_state": tree.get("init_state", {}),
            "encoders": list(encoders),
            "decoders": list(tree["decoders"])}


# Dtypes numpy lacks, which cross as an unsigned view of their width: the
# only form both numpy and torch hold bit for bit. numpy sees the JAX
# package's arrays of them as ``ml_dtypes`` types of the same name.
VIEWED_DTYPES = {torch.float8_e4m3fn: np.uint8, torch.bfloat16: np.uint16}


def _tensor(leaf, device) -> torch.Tensor:
    """A numpy or JAX array as a tensor on ``device``; float8 codes and
    bfloat16 moments keep their type (``VIEWED_DTYPES``)."""
    a = np.asarray(leaf)
    name = str(a.dtype)
    if "float8" in name and name != "float8_e4m3fn":
        raise TypeError(f"unsupported 8-bit code type {a.dtype}")
    for dtype, view in VIEWED_DTYPES.items():
        if name == str(dtype).removeprefix("torch."):
            return torch.as_tensor(np.array(a).view(view),
                                   device=device).view(dtype)
    return torch.as_tensor(np.array(a), device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy copy; a dtype numpy lacks as its unsigned view
    (``VIEWED_DTYPES``), which ``from_numpy_like`` turns back."""
    t = t.detach()
    if t.dtype in VIEWED_DTYPES:
        t = t.view(getattr(torch, np.dtype(VIEWED_DTYPES[t.dtype]).name))
    return t.cpu().numpy().copy()


def from_numpy_like(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` (numpy, possibly ``to_numpy``'s unsigned view or the JAX
    package's ``ml_dtypes`` array) as a tensor on ``like``'s device, viewed
    back into ``like``'s dtype when that is one numpy lacks."""
    t = _tensor(a, like.device)
    view = VIEWED_DTYPES.get(like.dtype)
    if view is not None and t.dtype == getattr(torch, np.dtype(view).name):
        t = t.view(like.dtype)
    return t


def params_from_jax(tree: dict, device=None) -> dict:
    """The JAX package's ``model.state_dict()`` tree (numpy or JAX arrays)
    -> this package's parameters: float32 tensors on ``device`` (CUDA
    unless the caller names another)."""
    device = resolve_device(device)
    return tree_map(
        lambda leaf: torch.as_tensor(np.array(leaf, np.float32),
                                     device=device), _per_encoder(tree))


def haim_params_from_jax(tree: dict, device=None) -> dict:
    """A JAX ``HAIM.state_dict()`` tree (``{"layers": [{"w", "b"}, ...]}``,
    numpy or JAX arrays) -> this package's HAIM parameters: float32 tensors
    on ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    if set(tree) != {"layers"}:
        raise ValueError(f"a HAIM state holds only 'layers', got "
                         f"{sorted(tree)}")
    return tree_map(lambda leaf: torch.as_tensor(np.array(leaf, np.float32),
                                                 device=device), tree)


def params_to_numpy(params: dict) -> dict:
    """Parameters -> the same tree of numpy arrays (the JAX package's
    ``state_dict`` form). The arrays are copies: on a CPU model a view would
    change under later in-place training steps."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)


def _optax_fields(state) -> dict:
    """An optax chain state (nested tuples of ``NamedTuple`` states) -> its
    fields by name; empty states add none."""
    if hasattr(state, "_asdict"):
        return dict(state._asdict())
    out = {}
    for part in state:
        out.update(_optax_fields(part))
    return out


def opt_state_from_jax(state, device=None) -> dict:
    """A JAX optimizer state (``model.opt_state``, with per-encoder or
    scan-stacked storage) -> the state of this package's optimizer of the
    same name, on ``device``. ``Adam`` / ``Adam8bit``: the moment trees
    (``m``/``v`` or ``mq``/``ms``/``vq``/``vs``, codes keeping their 8-bit
    type), the step count ``t`` and the per-encoder counts ``t_enc``.
    ``SGD`` / ``AdamW`` (optax chains): optax's fields, ``trace`` or
    ``count``/``mu``/``nu``."""
    device = resolve_device(device)
    if not isinstance(state, dict):
        state = _optax_fields(state)
    out = {}
    for key, tree in state.items():
        if key in ("t", "count"):
            out[key] = _tensor(tree, device).float()
        elif key == "t_enc":
            counts = None if tree is None else \
                [_tensor(t, device).float().reshape(()) for t in
                 (tree if isinstance(tree, (list, tuple))
                  else np.asarray(tree))]
            out[key] = counts
        else:
            out[key] = tree_map(lambda leaf: _tensor(leaf, device),
                                _per_encoder(tree))
    return out
