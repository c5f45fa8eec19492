"""The data-parallel training and evaluation step over a mesh: the PyTorch
counterpart of ``multimodn_tpu/parallel/shard_map_step.py``.

The JAX package runs one program over every device and either lets GSPMD
place the collectives (``dp_engine='auto'``) or places ``psum``s by hand
inside ``shard_map`` (``'shard_map'``). Here one process drives each device,
so both engines are this one module, with every collective explicit:

- every rank reads the GLOBAL batch and keeps its own rows: the data axis
  splits B into blocks of ``ceil(B / n)`` rows, rank ``r`` taking rows
  ``r * c ..`` (the layout GSPMD uses), the last block zero-padded with mask
  0 so every rank holds ``c`` rows (``DataParallel.shard``);
- before the forward, ONE ``all_reduce(SUM)`` per batch carries the local
  valid-row count and, under ``nan_skip='batch'``, one any-NaN flag per
  modality (``batch_stats``). The NaN flags depend on the data and the mask
  only, never on the state, so this one collective per batch replaces the
  JAX engine's one ``psum`` per encoder step (``fusion.global_any``); every
  rank takes the same whole-batch skip decision;
- the loss is scaled by ``local_valid / global_valid`` (``global_scale``),
  so the sum over ranks of the scaled losses is the global masked mean,
  weighted by each rank's valid rows. ``DistributedDataParallel``'s
  averaging (a mean of shard means) would differ whenever shards of a batch
  hold different numbers of valid rows;
- after the backward, ONE ``all_reduce(SUM)`` of every gradient of the step
  in one flat buffer (and, under a model axis, one ``broadcast`` of the
  replicated leaves' gradients from the axis' first rank,
  ``replicated_from_first``); then ``gated_update`` with the global
  ``enc_gates`` (identical on every rank), skipped on every rank alike
  when the global batch holds no real row;
- the metric grids are summed across ranks once per epoch (``sum_grids``,
  the loss and state-change grids scaled like the loss);
- a ``StaticInitState`` serves bank rows by GLOBAL position: rank ``r``'s
  local row ``i`` is global row ``start + i`` (``local_offset``), and the
  cycle advances by the batch's global real rows;
- the selection score and ``test``'s metrics read the validation outputs
  gathered back into the global batch order (``gather_rows``).

Random draws are made at the global batch shape and sliced to the rank's
rows (``RowStream``), so encoder dropout and ``presence_dropout`` draw what
one rank drawing the whole batch would.

Under a ``model`` axis (tensor parallelism) the parameters are column
pieces (``parallel.sharding``): ``view`` marks each sharded dense layer so
``core.nn.dense_apply`` computes its columns and gathers them, and gathers
every other sharded leaf whole (LayerNorm and BatchNorm vectors, position
tables, recurrent gate columns, a sharded init state); ``Adam8bit``'s
per-row absmax of a sharded leaf is a MAX across the model axis
(``ops.fused_adam``, the cross-rank form).

Two encoder families read across the batch's rows, so under a data axis
``view`` hands them the axis: an ``unbatched_compat`` recurrent encoder
runs its one recurrence over the gathered global rows and keeps its own
(``encoders.recurrent``), and ResNet's BatchNorm takes global masked
moments in two summing ``all_reduce``s per layer (``encoders.resnet``).

With one rank every collective returns its input and the scale is 1.0, so
a one-rank mesh trains bit-equal to the mesh-free model.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multimodn_tpu_torch.core.fusion import sample_missing
from multimodn_tpu_torch.core.nn import gather_leaf
from multimodn_tpu_torch.core.step import GRID_KEYS, gated_update
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map, \
    tree_unflatten
from multimodn_tpu_torch.parallel.collectives import flat_all_reduce

class ShardBatch(NamedTuple):
    """A rank's rows of one global batch: ``data`` (modality tuple),
    ``targets`` and ``mask`` of ``c`` rows, the first global row ``start``,
    the padded global row count ``total`` (``n * c``) and the global batch
    size ``full``."""
    data: tuple
    targets: torch.Tensor
    mask: torch.Tensor
    start: int
    total: int
    full: int


class BatchStats(NamedTuple):
    """One batch's global quantities: the loss ``scale``, the per-modality
    whole-batch any-NaN flags ``nan_any`` (``nan_skip='batch'``; else None)
    and the data ``axis``, over which the presence penalty sums its
    counts."""
    scale: torch.Tensor
    nan_any: Optional[torch.Tensor]
    axis: object


class RowStream:
    """A training generator whose draws are made at the global batch's
    (padded) shape and sliced to the rank's rows: ``rand(shape, device)``
    draws ``(total,) + shape[1:]`` and returns rows ``start .. start +
    shape[0]`` (``core.nn.uniform``)."""

    def __init__(self, generator: torch.Generator, start: int, total: int):
        self.generator, self.start, self.total = generator, start, total

    def rand(self, shape, device) -> torch.Tensor:
        full = torch.rand((self.total,) + tuple(shape[1:]),
                          generator=self.generator, device=device)
        return full[self.start:self.start + shape[0]]


def global_scale(local_valid: torch.Tensor,
                 global_valid: torch.Tensor) -> torch.Tensor:
    """``local_valid / global_valid`` (0 for an empty global batch): turns
    a rank's masked mean into its share of the global masked mean."""
    return torch.where(global_valid > 0,
                       local_valid / global_valid.clamp_min(1.0),
                       torch.zeros_like(local_valid))


def scale_grids(aux: dict, scale: torch.Tensor) -> dict:
    """A batch's grids as this rank's share of the global ones: the loss
    and state-change grids (masked means) and the log scalars times
    ``scale``; the count grids as they are."""
    out = dict(aux)
    for k in ("err_loss", "state_change", "global_err", "global_sc"):
        out[k] = aux[k] * scale
    return out


def sum_grids(axis, sums: dict, batch_log=None):
    """The epoch's grid sums (and batch log) summed across ``axis`` in one
    ``all_reduce``."""
    keys = [k for k in GRID_KEYS if k in sums]
    tensors = [sums[k] for k in keys] + \
        ([] if batch_log is None else [batch_log])
    out = flat_all_reduce(axis, tensors)
    summed = dict(sums, **dict(zip(keys, out)))
    return summed if batch_log is None else (summed, out[-1])


def local_offset(offset: int, start: int) -> int:
    """The init-state cycle offset of a rank's first row: its global row
    (``shard_map_step.py:100-115``)."""
    return offset + start


class DataParallel:
    """One model's step over ``mesh`` (module docstring). ``specs``: the
    parameters' ``PartitionSpec`` tree; ``nan_skip``: the model's mode."""

    def __init__(self, mesh, specs, nan_skip: str,
                 data_axis: str = "data", model_axis: str = "model"):
        self.mesh = mesh
        self.data = mesh.axis(data_axis)
        self.model = mesh.axis(model_axis)
        self.specs = specs
        self.nan_skip = nan_skip
        self.split = tree_map(lambda s: s.split_dim() is not None, specs)

    # -- rows -----------------------------------------------------------
    def rows(self, full: int):
        """``(start, stop, c)``: the rank's global rows of a batch of
        ``full`` rows and the per-rank row count."""
        n, i = self.data.size, self.data.index
        c = -(-full // n)
        start = min(i * c, full)
        return start, min(start + c, full), c

    def _take(self, t, start, stop, c):
        piece = t[start:stop]
        if piece.shape[0] == c:
            return piece
        pad = (c - piece.shape[0],) + tuple(piece.shape[1:])
        if isinstance(piece, np.ndarray):
            return np.concatenate([piece, np.zeros(pad, piece.dtype)])
        return torch.cat([piece, piece.new_zeros(pad)])

    def host_rows(self, arrays, full: int):
        """The rank's rows of host arrays of a global batch (streamed
        batches copy only these to the device)."""
        start, stop, c = self.rows(full)
        return [self._take(a, start, stop, c) for a in arrays]

    def wrap(self, batch, full: int) -> ShardBatch:
        """A ShardBatch of a batch that already holds the rank's rows."""
        data, targets, mask = batch
        start, _, c = self.rows(full)
        return ShardBatch(tuple(data), targets, mask, start,
                          c * self.data.size, full)

    def shard(self, batch) -> ShardBatch:
        """The rank's rows of a global device batch."""
        data, targets, mask = batch
        full = mask.shape[0]
        start, stop, c = self.rows(full)
        return self.wrap((tuple(self._take(d, start, stop, c) for d in data),
                          self._take(targets, start, stop, c),
                          self._take(mask, start, stop, c)), full)

    # -- the step -------------------------------------------------------
    def sum_grids(self, sums: dict, batch_log=None):
        """An epoch's grid sums (and batch log) summed across the data
        axis."""
        return sum_grids(self.data, sums, batch_log)

    def batch_stats(self, batch: ShardBatch) -> BatchStats:
        """The batch's one pre-forward ``all_reduce`` (module docstring)."""
        local_valid = batch.mask.float().sum()
        parts = [local_valid.reshape(1)]
        if self.nan_skip == "batch":
            live = batch.mask > 0
            parts.append(torch.stack([(sample_missing(x) & live).any()
                                      for x in batch.data]).float())
        stats = self.data.all_reduce(torch.cat(parts))
        return BatchStats(global_scale(local_valid, stats[0]),
                          stats[1:] > 0 if self.nan_skip == "batch" else None,
                          self.data)

    def view(self, params):
        """``params`` as the loss reads them on the mesh. Under a model
        axis each column-sharded dense layer ``{"w", "b"}`` is tagged with
        the axis (``core.nn.dense_apply`` runs it column-parallel) and every
        other sharded leaf is made whole once (``core.nn.gather_leaf``).
        Under a data axis every encoder's tree is tagged ``"data_axis"``:
        the encoders that read across the batch (the recurrence over the
        batch's rows, BatchNorm's moments) reach the global batch through
        it."""
        if self.model.size == 1 and self.data.size == 1:
            return params

        def walk(node, spec):
            if isinstance(node, dict):
                w = spec.get("w")
                if torch.is_tensor(node.get("w")) and w is not None and \
                        w.split_dim() is not None:
                    return dict(node, model_axis=self.model)
                return {k: walk(node[k], spec[k]) for k in node}
            if isinstance(node, list):
                return [walk(v, s) for v, s in zip(node, spec)]
            d = None if spec is None else spec.split_dim()
            return node if d is None else gather_leaf(node, self.model, d)

        out = walk(params, self.specs)
        if self.data.size > 1:
            out["encoders"] = [dict(p, data_axis=self.data)
                               for p in out["encoders"]]
        return out

    def replicated_from_first(self, grads: list) -> list:
        """Under a model axis, the axis' first rank's gradient of every
        replicated leaf on every rank of the axis (one ``broadcast``).
        Every rank computes it from the same whole graph, but a
        nondeterministic backward (cuDNN's convolution weight gradients)
        can round it differently on each, and the replicas of a leaf must
        not drift apart."""
        if self.model.size == 1:
            return grads
        keep = [i for i, cut in enumerate(tree_leaves(self.split))
                if not cut]
        if not keep:
            return grads
        flat = self.model.broadcast(torch.cat([grads[i].reshape(-1)
                                               for i in keep]))
        grads = list(grads)
        for i, piece in zip(keep, torch.split(flat, [grads[i].numel()
                                                     for i in keep])):
            grads[i] = piece.reshape(grads[i].shape)
        return grads

    def cross_rank(self):
        """``gated_update``'s cross-rank argument: the sharded-leaf flags
        and the model axis, or None without a model axis."""
        return None if self.model.size == 1 else (self.split, self.model)

    def train_batch(self, loss_fn, optimizer, params, opt_state,
                    batch: ShardBatch, generator, offset: int, n_real: int,
                    seq=None, perm=None):
        """One training step (module docstring); returns ``(opt_state,
        aux)`` with the grids as this rank's shares."""
        stats = self.batch_stats(batch)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        gen = None if generator is None else \
            RowStream(generator, batch.start, batch.total)
        loss, aux = loss_fn(self.view(live), batch.data, batch.targets,
                            batch.mask, gen,
                            local_offset(offset, batch.start), True,
                            seq=seq, perm=perm, batch_stats=stats)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = flat_all_reduce(self.data, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        grads = tree_unflatten(params, self.replicated_from_first(grads))
        if n_real > 0:
            with torch.no_grad():
                opt_state = gated_update(optimizer, grads, opt_state, params,
                                         enc_gates=aux["enc_gates"],
                                         cross_rank=self.cross_rank())
        aux = tree_map(lambda t: None if t is None else t.detach(), aux)
        return opt_state, scale_grids(aux, stats.scale)

    @torch.no_grad()
    def eval_batch(self, loss_fn, params, batch: ShardBatch, offset: int,
                   seq=None) -> dict:
        """One evaluation batch; grids as this rank's shares, final-row
        outputs of the rank's rows."""
        stats = self.batch_stats(batch)
        _, aux = loss_fn(self.view(params), batch.data, batch.targets,
                         batch.mask, None, local_offset(offset, batch.start),
                         False, seq=seq, batch_stats=stats)
        return scale_grids(aux, stats.scale)

    def gather_rows(self, t: torch.Tensor, n_batches: int,
                    full: int) -> torch.Tensor:
        """Per-batch rank rows ``(n_batches * c, ...)`` -> the global rows
        ``(n_batches * full, ...)`` in the global batch order (the padding
        rows of the last rank dropped)."""
        g = self.data.all_gather(t, dim=0)
        n, rest = self.data.size, tuple(t.shape[1:])
        c = t.shape[0] // max(n_batches, 1)
        g = g.reshape((n, n_batches, c) + rest).transpose(0, 1)
        return g.reshape((n_batches, n * c) + rest)[:, :full].reshape(
            (n_batches * full,) + rest)
