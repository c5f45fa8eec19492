"""Architecture summaries, the ``display_arch`` table (PyTorch twin of
``multimodn_tpu/utils/summary.py``; the reference prints torchsummary tables,
``multimodn/multimodn.py:494-507``). The lines are the JAX package's for its
per-encoder parameter layout: leaf paths in sorted key order, as JAX walks
a tree."""
from __future__ import annotations

import math


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}/{k}"
                                          if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}/{i}"
                                          if prefix else str(i))
    else:
        yield prefix, tuple(tree.shape)


def _count_params(tree) -> int:
    return sum(math.prod(shape) for _path, shape in _leaves_with_paths(tree))


def _describe_tree(tree, indent: str = "    ") -> str:
    return "\n".join(f"{indent}{path}: {shape}"
                     for path, shape in _leaves_with_paths(tree))


def summarize_model(model) -> str:
    """Human-readable per-module parameter table for a MultiModN model."""
    params = model._whole_params()
    n = _count_params(params["init_state"])
    total = n
    out = [f"InitState ({type(model.init_state).__name__}): {n} params"]
    for i, enc in enumerate(model.encoders):
        p = params["encoders"][i]
        n = _count_params(p)
        total += n
        out.append(f"Encoder {i} ({type(enc).__name__}): {n} params")
        out.append(_describe_tree(p))
    for i, dec in enumerate(model.decoders):
        p = params["decoders"][i]
        n = _count_params(p)
        total += n
        out.append(f"Decoder {i} ({type(dec).__name__}, "
                   f"n_classes={dec.n_classes}): {n} params")
        out.append(_describe_tree(p))
    out.append(f"Total parameters: {total}")
    return "\n".join(out)
