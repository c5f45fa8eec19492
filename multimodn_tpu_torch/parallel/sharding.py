"""Placement rules (PyTorch twin of ``multimodn_tpu/parallel/sharding.py``).

A placement is a ``Placement(mesh, spec)`` record, the counterpart of JAX's
``NamedSharding(mesh, PartitionSpec(*spec))``: ``spec`` names, per leading
dimension, the mesh axis it is split over (None: not split). Tensors stay
plain local tensors on each rank's device (no ``DTensor``): the kernels take
local tensors, and a ``DTensor``'s dispatch would add host time to a step
that is already host-bound.

- Data parallel: epoch stacks ``(n_batches, B, ...)`` split B over ``data``
  (``batch_sharding``); parameters and optimizer state are replicated.
- Tensor parallel: JAX's rule, leaf for leaf (``leaf_spec``): a 2-D leaf
  whose output width divides the ``model`` axis keeps its column shard, so
  does a 1-D leaf whose length divides it; every other leaf is replicated.
  ``shard_params`` cuts the leaves, ``gather_params`` puts whole leaves back
  on every rank (what ``state_dict``, checkpoints, exports and the
  fused-chain kernel read).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from multimodn_tpu_torch.core.tree import tree_map

# Optimizer-state entries whose trees mirror the parameters leaf for leaf
# (Adam's moments, Adam8bit's codes, AdamW's and SGD's traces); every other
# entry (Adam8bit's per-row scales, the step counts) is replicated.
MIRRORED_STATE = ("m", "v", "mq", "vq", "mu", "nu", "trace")


class PartitionSpec:
    """The mesh axis each leading dimension is split over (None: whole),
    as JAX's ``PartitionSpec``; ``tuple(spec)`` compares with a JAX spec's
    ``tuple``. Not a tuple itself, so a tree of specs keeps one leaf per
    parameter under ``core.tree``."""

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"PartitionSpec{self.axes!r}"

    def split_dim(self) -> Optional[int]:
        """The dimension that is split, or None for a whole leaf."""
        for d, axis in enumerate(self.axes):
            if axis is not None:
                return d
        return None


P = PartitionSpec


class Placement(NamedTuple):
    mesh: object
    spec: PartitionSpec


def batch_sharding(mesh, data_axis: str = "data") -> Placement:
    """Placement of ``(n_batches, B, ...)`` epoch stacks: B split over the
    data axis, the batch axis whole."""
    return Placement(mesh, P(None, data_axis))


def replicate(mesh) -> Placement:
    return Placement(mesh, P())


def leaf_spec(shape, mesh, model_axis: str = "model") -> PartitionSpec:
    """JAX's rule (``sharding.py:81-89``) for one leaf of ``shape``:
    ``P(None, model_axis)``, ``P(model_axis)`` or ``P()``."""
    if model_axis not in mesh.axis_names:
        return P()
    n = mesh.shape[model_axis]
    if len(shape) == 2 and shape[1] % n == 0 and shape[1] >= n:
        return P(None, model_axis)
    if len(shape) == 1 and shape[0] % n == 0 and shape[0] >= n:
        return P(model_axis)
    return P()


def param_specs(params, mesh, model_axis: str = "model"):
    """The spec of every leaf of a tree of WHOLE leaves."""
    return tree_map(lambda t: None if t is None else
                    leaf_spec(tuple(t.shape), mesh, model_axis), params)


def local_piece(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The calling rank's piece of a whole leaf under ``spec``, a
    contiguous tensor of its own on the mesh's device."""
    d = spec.split_dim()
    t = t.to(mesh.device)
    if d is None:
        return t.clone()
    n, i = mesh.axis_size(spec[d]), mesh.axis_index(spec[d])
    k = t.shape[d] // n
    return t.narrow(d, i * k, k).contiguous()


def shard_params(params, mesh, model_axis: str = "model"):
    """Each rank's pieces of a tree of whole leaves under JAX's rule
    (``leaf_spec``), on the mesh's device. Without a ``model`` axis every
    leaf is replicated (a copy on each rank)."""
    return tree_map(lambda t: None if t is None else local_piece(
        t, leaf_spec(tuple(t.shape), mesh, model_axis), mesh), params)


def opt_state_specs(opt_state, specs):
    """The specs of an optimizer state on a mesh whose parameters have
    ``specs``: mirrored entries (``MIRRORED_STATE``) take the parameters'
    specs, every other leaf is replicated. The one placement rule of an
    optimizer state: ``shard_opt_state`` cuts by it and ``gather_params``
    joins by it."""
    if not isinstance(opt_state, dict):
        return tree_map(lambda _t: P(), opt_state)
    return {k: specs if k in MIRRORED_STATE and v is not None
            else tree_map(lambda _t: P(), v) for k, v in opt_state.items()}


def shard_opt_state(opt_state, mesh, model_axis: str = "model",
                    specs=None):
    """Place a RESTORED, mesh-free optimizer state (whole leaves) on a mesh:
    the elastic path, where a run on N ranks resumes on M. Placed by
    ``opt_state_specs``: moments and 8-bit codes shard as their parameters
    do (``specs``, by default JAX's rule on the whole shapes of the first
    mirrored entry, whose leaves are the parameters' shapes), and the
    per-row scales and step counts are replicated."""
    if specs is None:
        mirrored = [opt_state[k] for k in MIRRORED_STATE
                    if isinstance(opt_state, dict)
                    and opt_state.get(k) is not None]
        specs = param_specs(mirrored[0], mesh, model_axis) if mirrored \
            else None
    return tree_map(lambda t, spec: None if t is None else local_piece(
        t, spec, mesh), opt_state, opt_state_specs(opt_state, specs))


def gather_params(tree, mesh, specs):
    """Whole leaves on every rank from each rank's pieces (``specs`` from
    ``param_specs`` of the whole tree): the inverse of ``shard_params``.
    Replicated leaves are returned as they are."""
    def whole(t, spec):
        d = None if spec is None else spec.split_dim()
        if t is None or d is None:
            return t
        return mesh.axis(spec[d]).all_gather(t, dim=d)

    return tree_map(whole, tree, specs)
