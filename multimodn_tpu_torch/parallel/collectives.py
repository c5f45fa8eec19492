"""Collectives over one axis of a device mesh (``parallel.mesh``).

The JAX package reduces across its mesh implicitly (GSPMD) or with
``psum`` / ``all_gather`` inside ``shard_map``. Here every such reduction is
an explicit ``torch.distributed`` call on the process group of one mesh
axis, through an ``AxisGroup``:

- ``all_reduce(t, op)``: SUM or MAX, into a new tensor;
- ``all_gather(t, dim)``: every rank's ``t``, concatenated along ``dim`` in
  the axis' rank order;
- ``broadcast(t)``: the axis' first rank's ``t`` to every rank.

Two autograd functions carry a collective through a training step's
backward: ``AxisSum`` (the SUM over the axis both ways: BatchNorm's global
moments, ``encoders.resnet``) and ``GatherRows`` (the ranks' row blocks
joined in rank order; backward, the gradient summed over the axis and cut
to the rank's rows: the recurrence over the global batch,
``encoders.recurrent``).

NCCL takes CUDA tensors and ``gloo`` takes CPU tensors. ``gloo`` also
accepts CUDA tensors for some collectives and not others (it has no CUDA
``all_gather``), so for the ``gloo`` backend a CUDA tensor is copied
through pinned host memory, the collective runs on the host copy, and the
result is copied back to the tensor's device. That is the transport of the
``gloo`` backend only (two ranks sharing one card, which NCCL refuses); the
work before and after stays on the card, and a collective that fails
raises.

Each call runs under ``utils.profiling.annotate("collective")``, a span,
so ``utils.profiling.trace`` shows the time spent in collectives.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from multimodn_tpu_torch.utils.profiling import annotate

OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
WIRE_DTYPES = {torch.float8_e4m3fn: torch.uint8, torch.bfloat16: torch.int16}


class AxisGroup:
    """The ranks of one mesh axis that share the caller's other
    coordinates: ``ranks`` (global ranks in axis order), the caller's
    ``index`` among them and the process ``group``. A group of one rank
    with no process group (an axis the mesh lacks) makes every collective
    the identity."""

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = int(index)
        self.gloo = group is not None and \
            dist.get_backend(group) == dist.Backend.GLOO
        # A process group orders its members by global rank; the axis may
        # not (make_mesh(devices=...)): a gathered list is put back in axis
        # order.
        ordered = sorted(self.ranks)
        self._axis_order = [ordered.index(r) for r in self.ranks]

    def _host(self, t: torch.Tensor) -> bool:
        return self.gloo and t.is_cuda

    @staticmethod
    def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise SUM or MAX of ``t`` over the axis, as a new
        tensor on ``t``'s device."""
        out = t.detach().clone().contiguous()
        if self.group is None:
            return out
        with annotate("collective"):
            if self._host(out):
                h = self._pinned_copy(out)
                dist.all_reduce(h, op=OPS[op], group=self.group)
                out.copy_(h)
            else:
                dist.all_reduce(out, op=OPS[op], group=self.group)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (all of one shape), concatenated along
        ``dim`` in axis order. A dtype the backends do not move (8-bit
        float codes, bfloat16) travels as the integers of its bits."""
        t = t.detach().contiguous()
        if self.group is None:
            return t.clone()
        wire = WIRE_DTYPES.get(t.dtype)
        src = t if wire is None else t.view(wire)
        with annotate("collective"):
            if self._host(src):
                src = self._pinned_copy(src)
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.cat([parts[j] for j in self._axis_order],
                            dim=dim).to(t.device)
        return out if wire is None else out.view(t.dtype)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The axis' first rank's ``t`` on every rank, in place."""
        if self.group is None:
            return t
        with annotate("collective"):
            if self._host(t):
                h = self._pinned_copy(t)
                dist.broadcast(h, src=self.ranks[0], group=self.group)
                t.copy_(h)
            else:
                dist.broadcast(t, src=self.ranks[0], group=self.group)
        return t

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in axis order."""
        if self.group is None:
            return [obj]
        out: list = [None] * self.size
        with annotate("collective"):
            dist.all_gather_object(out, obj, group=self.group)
        return [out[j] for j in self._axis_order]

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)


def solo() -> AxisGroup:
    """The one-rank group of an axis the mesh does not have."""
    return AxisGroup(None, (dist.get_rank() if dist.is_initialized()
                            else 0,), 0)


def flat_all_reduce(axis: AxisGroup, tensors: Sequence[torch.Tensor],
                    op: str = "sum") -> list:
    """``axis.all_reduce`` of several tensors of one dtype in one call:
    flattened into one buffer, reduced, and split back into their
    shapes."""
    tensors = list(tensors)
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = axis.all_reduce(flat, op)
    pieces = torch.split(flat, [t.numel() for t in tensors])
    return [p.reshape(t.shape) for p, t in zip(pieces, tensors)]


class AxisSum(torch.autograd.Function):
    """Forward, the SUM of ``t`` over ``axis``; backward, the SUM of the
    gradient over ``axis``: each rank's loss reads the global sum, so each
    rank's part of it receives every rank's gradient. Half-precision
    tensors are summed in float32 and rounded once."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return axis.all_reduce(t.float(), "sum").to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad.float(), "sum").to(grad.dtype), None


class GatherRows(torch.autograd.Function):
    """Forward, every rank's rows (one count on every rank) joined along
    dimension 0 in axis order; backward, the gradient summed over ``axis``
    (every rank's loss may read every row) and cut to the rank's rows."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis, ctx.rows = axis, t.shape[0]
        return axis.all_gather(t, dim=0)

    @staticmethod
    def backward(ctx, grad):
        whole = ctx.axis.all_reduce(grad.float(), "sum").to(grad.dtype)
        return whole.narrow(0, ctx.axis.index * ctx.rows,
                            ctx.rows).contiguous(), None
