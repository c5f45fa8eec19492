"""Nested dict/list trees of tensors: the parameter, gradient and optimizer
state layout shared with the JAX package (``{"init_state", "encoders",
"decoders"}`` with per-encoder lists)."""
from __future__ import annotations

from typing import Callable, Iterable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to aligned leaves of ``tree`` and ``rest``; dicts and
    lists (or tuples, returned as lists) are the inner nodes. Dicts are
    walked in sorted key order, as JAX walks them, so trees align whatever
    order their keys were inserted in."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """Leaves in ``tree_map`` order."""
    out: List = []
    _collect(tree, out)
    return out


def _collect(tree, out: List) -> None:
    # tree_map's walk without building the mapped tree: a step's optimizer
    # flattens several trees of every parameter leaf.
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out)
    else:
        out.append(tree)


def tree_unflatten(like, leaves: Iterable):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_map``
    order."""
    it = iter(leaves)
    return tree_map(lambda _leaf: next(it), like)
