"""Weight transplant between the JAX package and this one.

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


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def unstack_encoders(stacked: dict) -> list:
    """Scan-stacked encoder storage -> per-encoder list of trees."""
    n = {np.shape(leaf)[0] for leaf in _leaves(stacked)}
    if len(n) != 1:
        raise ValueError(f"stacked encoder leaves disagree on the leading "
                         f"(E,) axis: {sorted(n)}")
    return [_map_leaves(lambda leaf, i=i: leaf[i], stacked)
            for i in range(n.pop())]


def params_from_jax(tree: dict, device=None) -> dict:
    """The JAX package's ``model.state_dict()`` tree (numpy or JAX arrays)
    -> this package's parameters: float32 tensors on ``device`` (CUDA
    unless the caller names another)."""
    device = resolve_device(device)
    encoders = tree["encoders"]
    if isinstance(encoders, dict):
        encoders = unstack_encoders(encoders)
    out = {"init_state": tree.get("init_state", {}),
           "encoders": list(encoders),
           "decoders": list(tree["decoders"])}
    return _map_leaves(
        lambda leaf: torch.as_tensor(np.array(leaf, np.float32),
                                     device=device), out)


def params_to_numpy(params: dict) -> dict:
    """Parameters -> the same tree of numpy arrays (the JAX package's
    ``state_dict`` form)."""
    return _map_leaves(lambda t: t.detach().cpu().numpy(), params)
