"""Device meshes over ``torch.distributed`` (PyTorch twin of
``multimodn_tpu/parallel/mesh.py``).

The JAX package runs one controller over every device of a mesh. Here each
device is driven by its own process (one rank per device, the PyTorch
idiom), so a mesh is an arrangement of the default process group's ranks:

- ``data`` axis: the batch is sharded; every rank reads the global batch
  and keeps its own rows, and the reductions GSPMD derives in the JAX
  package are explicit collectives (``parallel.dp_step``);
- ``model`` axis: dense layers are column-sharded (``parallel.sharding``,
  ``core.nn.dense_apply``);
- any other axis name (``fold``) is free for the experiments, which spread
  folds or seeds over it (``experiments``).

The library never initializes a process group: the caller does
(``torch.distributed.init_process_group``, or ``parallel.dryrun.spawn``).
"""
from __future__ import annotations

import itertools
import math
import os
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodn_tpu_torch.parallel.collectives import AxisGroup, solo

NO_PROCESS_GROUP = (
    "make_mesh needs an initialized default process group: call "
    "torch.distributed.init_process_group (one process per device, e.g. "
    "through multimodn_tpu_torch.parallel.dryrun.spawn) first; the library "
    "never initializes one itself")


def rank_device(device=None) -> torch.device:
    """The calling rank's device: ``cuda:{local rank}`` by default (the
    ``LOCAL_RANK`` environment variable, else the global rank modulo the
    visible cards); a bare ``'cuda'`` gets the same index; any other device
    is taken as given. Without a GPU the caller must name the CPU."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to make_mesh to "
            "run the ranks on the CPU")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else \
            dist.get_rank() % max(torch.cuda.device_count(), 1)
        device = torch.device("cuda", index)
    return device


class Mesh:
    """Ranks of the default process group arranged in ``shape`` over
    ``axis_names``, with JAX's reading surface: ``shape`` is an ordered
    ``{axis: size}`` dict, ``axis_names`` a tuple, ``devices`` the array of
    global ranks, ``size`` the rank count. For the calling rank:
    ``coords`` (``{axis: index}``, None outside the mesh), ``device``, and
    ``axis(name)``, the ``AxisGroup`` of its line along an axis (a one-rank
    group for an axis the mesh lacks). ``everyone`` spans all the mesh's
    ranks."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device: torch.device):
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-D rank array for axes "
                             f"{tuple(axis_names)}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.device = device
        me = dist.get_rank()
        where = np.argwhere(ranks == me)
        self.coords = None if len(where) == 0 else dict(
            zip(self.axis_names, (int(i) for i in where[0])))
        self._axes = {a: self._axis_group(i) for i, a in
                      enumerate(self.axis_names)}
        self.everyone = self._group(ranks.reshape(-1).tolist(), me)

    @staticmethod
    def _group(ranks: list, me: int) -> AxisGroup:
        world = list(range(dist.get_world_size()))
        group = dist.group.WORLD if ranks == world else \
            dist.new_group(ranks=ranks)
        index = ranks.index(me) if me in ranks else 0
        return AxisGroup(group if me in ranks else None, ranks, index)

    def _axis_group(self, axis: int) -> AxisGroup:
        """Every rank creates every line's group, in one order (a
        ``new_group`` call must be made by all processes); the caller keeps
        its own line's."""
        me, mine = dist.get_rank(), None
        moved = np.moveaxis(self.devices, axis, -1)
        for idx in itertools.product(*(range(n) for n in moved.shape[:-1])):
            line = moved[idx].tolist()
            g = self._group(line, me)
            if me in line:
                mine = g
        return mine if mine is not None else solo()

    def axis(self, name: str) -> AxisGroup:
        return self._axes.get(name) or solo()

    def axis_size(self, name: str) -> int:
        return int(self.shape.get(name, 1))

    def axis_index(self, name: str) -> int:
        if self.coords is None:
            raise ValueError("this rank is not in the mesh")
        return self.coords.get(name, 0)

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, ranks={self.devices.tolist()}, "
                f"device={self.device})")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices=None, *, device=None) -> Mesh:
    """Build a ``Mesh`` over the default process group's ranks.

    ``make_mesh()`` -> every rank on one ``data`` axis.
    ``make_mesh((2, 2), ("data", "model"))`` -> 2-way DP x 2-way TP.
    ``devices``: the ranks to use, in order (default: all). ``device``: this
    rank's device (``rank_device``; ``'cpu'`` for ranks on the CPU)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(NO_PROCESS_GROUP)
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if shape is None:
        shape = (len(ranks),)
    n = math.prod(shape)
    if n > len(ranks):
        raise ValueError(f"Mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(ranks)}")
    return Mesh(np.array(ranks[:n]).reshape(shape), tuple(axis_names),
                rank_device(device))
