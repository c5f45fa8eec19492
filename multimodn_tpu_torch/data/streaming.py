"""Streaming training: datasets whose epoch stacks should not live on the
device (PyTorch twin of ``multimodn_tpu/data/streaming.py``).

``ArrayLoader`` copies a whole epoch to the device at once. A streaming
loader keeps its data on the host (``StreamingLoader``), in a torch
``DataLoader`` (``TorchStreamingLoader``) or on disk (``data.disk``) and
yields one padded numpy batch at a time from ``iter_batches()``. The model
runs each batch through the same loss, update and selection code as an
``ArrayLoader``'s (``MultiModN._batches``), so a streamed run equals the
``ArrayLoader`` run on the same rows bit for bit on the CPU.

On a CUDA model the next batch is copied while the current one computes
(``device_batches``): each batch is written into a pinned host buffer and
copied with ``non_blocking=True`` on a side stream; the consumer stream
waits on that copy's event before it reads the batch, and a pinned buffer is
refilled only after the event of the copy that last read it has passed.
This is PyTorch's form of the JAX package's ``device_put`` ahead of use. On
a CPU model batches are wrapped without a copy and nothing is pinned.

The functions below keep the JAX package's names and arguments:
``train_epoch_streaming``, ``fit_streaming``, ``test_epoch_streaming``,
``fit_best_streaming`` (with its ``checkpoint_dir`` resume path) and
``predict_streaming`` / ``predict_proba_streaming``. There is no device
mesh here (multi-GPU is ROADMAP.md Queue A item 20).
"""
from __future__ import annotations

import math
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from multimodn_tpu_torch.data.loader import _materialize


class StreamingLoader:
    """Host-resident batches, yielded as numpy, with ``ArrayLoader``'s
    geometry (``batch_size``, ``shuffle``, ``reshuffle``, a zero-padded tail
    with mask 0, ``n_batches``) and no device-side epoch stacks. Targets are
    int64, as in ``ArrayLoader``."""

    def __init__(self, dataset, batch_size: int = 0, shuffle: bool = False,
                 seed: int = 0):
        xs, y, seq = _materialize(dataset)
        if y.shape[0] == 0:
            raise ValueError("StreamingLoader got an empty dataset")
        if seq is not None:
            raise NotImplementedError(
                "StreamingLoader does not carry encoding sequences; use "
                "ArrayLoader for sequence-carrying datasets.")
        if y.ndim == 1:
            y = y[:, None]
        self._xs = [np.asarray(x, np.float32) for x in xs]
        self._y = np.asarray(y, np.int64)
        self.n_samples = self._y.shape[0]
        self.batch_size = batch_size if batch_size > 0 else self.n_samples
        self.n_batches = max(1, math.ceil(self.n_samples / self.batch_size))
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.n_samples)

    @property
    def modality_widths(self) -> List[int]:
        return [int(np.prod(x.shape[1:])) if x.ndim > 1 else 1
                for x in self._xs]

    def __len__(self) -> int:
        return self.n_batches

    def reshuffle(self):
        if self.shuffle:
            self._rng.shuffle(self._order)

    def iter_batches(self) -> Iterator[Tuple[List[np.ndarray], np.ndarray,
                                             np.ndarray]]:
        """Yield ``(data list, targets, sample_mask)``, each padded to the
        batch size."""
        B = self.batch_size
        for b in range(self.n_batches):
            idx = self._order[b * B:(b + 1) * B]
            n = idx.shape[0]
            mask = np.zeros((B,), np.float32)
            mask[:n] = 1.0
            data = []
            for x in self._xs:
                buf = np.zeros((B,) + x.shape[1:], np.float32)
                buf[:n] = x[idx]
                data.append(buf)
            targets = np.zeros((B, self._y.shape[1]), np.int64)
            targets[:n] = self._y[idx]
            yield data, targets, mask


def _length(obj) -> Optional[int]:
    if obj is None:
        return None
    try:
        return len(obj)
    except TypeError:
        return None


class TorchStreamingLoader:
    """Batches pulled from a ``torch.utils.data.DataLoader`` on demand each
    epoch, never materialised, so map- or iterable-style torch datasets
    larger than memory drive every streaming entry point. The loader must
    yield the reference's ``([modality batch, ...], target batch)`` pairs
    (``multimodn/multimodn.py:132-135``); a short tail batch is padded to
    the batch size with an exact sample mask.

    ``shuffle`` reflects the sampler: anything other than a
    ``SequentialSampler`` marks the loader shuffled (torch samplers reshuffle
    themselves on every pass, so ``reshuffle()`` does nothing), and the
    selection and resume paths reject it. An iterable dataset owns its order
    and counts as unshuffled.

    Geometry: ``n_samples`` and ``n_batches`` come from the sampler and the
    ``DataLoader`` (``len(dataset)`` over-counts under a subset sampler), or
    from a standard ``BatchSampler``; unbatched loaders and custom batch
    samplers have no static batch shape and are rejected. An unsized
    iterable dataset leaves both None, and the epoch paths count batches
    and samples as they iterate.
    """

    def __init__(self, torch_loader):
        from multimodn_tpu_torch.interop import is_torch_dataloader
        if not is_torch_dataloader(torch_loader):
            raise TypeError(
                f"TorchStreamingLoader wraps a torch DataLoader, got "
                f"{type(torch_loader).__name__}")
        if getattr(torch_loader, "drop_last", False):
            raise NotImplementedError(
                "DataLoader(drop_last=True) has no equivalent here (the "
                "padded-tail mask keeps the final short batch exact); use "
                "drop_last=False")
        tud = torch.utils.data
        self._loader = torch_loader
        dataset = torch_loader.dataset
        self._iterable = isinstance(dataset, tud.IterableDataset)
        batch_sampler = getattr(torch_loader, "batch_sampler", None)
        if torch_loader.batch_size is not None:
            self.batch_size = torch_loader.batch_size
            if self._iterable:
                self.n_samples = _length(dataset)
            else:
                self.n_samples = _length(getattr(torch_loader, "sampler",
                                                 None))
                if self.n_samples is None:
                    self.n_samples = _length(dataset)
            self.n_batches = _length(torch_loader)
            if self.n_batches is None and self.n_samples is not None:
                self.n_batches = max(
                    1, math.ceil(self.n_samples / self.batch_size))
            sampler = getattr(torch_loader, "sampler", None)
        elif isinstance(batch_sampler, tud.BatchSampler):
            # DataLoader(batch_sampler=...): a standard BatchSampler's
            # geometry is exact without iterating it (which would consume a
            # random sampler's draw).
            if getattr(batch_sampler, "drop_last", False):
                raise NotImplementedError(
                    "BatchSampler(drop_last=True) has no equivalent here; "
                    "use drop_last=False")
            self.batch_size = batch_sampler.batch_size
            self.n_batches = _length(batch_sampler)
            self.n_samples = _length(getattr(batch_sampler, "sampler", None))
            if self.n_samples is None and self.n_batches is not None:
                self.n_samples = self.n_batches * self.batch_size
            sampler = batch_sampler.sampler
        else:
            raise NotImplementedError(
                "TorchStreamingLoader needs a DataLoader with automatic "
                "batching (batch_size=N) or a standard "
                "torch.utils.data.BatchSampler; unbatched loaders "
                "(batch_size=None) and custom batch samplers have no static "
                "batch shape.")
        self.shuffle = False if self._iterable else \
            not isinstance(sampler, tud.SequentialSampler)
        self._widths = None
        if not self._iterable:
            try:        # one item for the modality-width check
                item = dataset[0]
            except (TypeError, IndexError, KeyError):
                item = None
            if item is not None:
                _reject_sequences(item)
                self._widths = [int(np.prod(np.asarray(x).shape))
                                for x in item[0]]

    @property
    def modality_widths(self) -> Optional[List[int]]:
        return self._widths

    def __len__(self) -> int:
        if self.n_batches is None:
            raise TypeError(
                "this TorchStreamingLoader wraps an unsized iterable "
                "dataset; its batch count is only known after an epoch")
        return self.n_batches

    def reshuffle(self):
        pass        # torch's sampler reshuffles on every pass already

    @staticmethod
    def _np(t) -> np.ndarray:
        return t.detach().cpu().numpy() if torch.is_tensor(t) \
            else np.asarray(t)

    def iter_batches(self):
        B = self.batch_size
        for batch in self._loader:
            _reject_sequences(batch)
            xs, y = batch[0], self._np(batch[1])
            if y.ndim == 1:
                y = y[:, None]
            n = y.shape[0]
            if n > B:
                raise ValueError(
                    f"the torch loader yielded a batch of {n} rows, more "
                    f"than its batch_size {B}")
            mask = np.zeros((B,), np.float32)
            mask[:n] = 1.0
            data = []
            for x in xs:
                x = self._np(x).astype(np.float32).reshape(n, -1)
                buf = np.zeros((B,) + x.shape[1:], np.float32)
                buf[:n] = x
                data.append(buf)
            targets = np.zeros((B, y.shape[1]), np.int64)
            targets[:n] = y
            yield data, targets, mask


def _reject_sequences(item):
    if len(item) > 2 and item[2] is not None:
        raise NotImplementedError(
            "TorchStreamingLoader does not carry encoding sequences; use "
            "ArrayLoader for sequence-carrying datasets.")


class _HostToDevice:
    """Copies host batches to ``device``. On CUDA: through a ring of pinned
    host buffers and a side stream, one event per copy; on the CPU: no
    copy."""

    SLOTS = 2

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.slots: list = [None] * self.SLOTS
            self.count = 0

    def _pinned(self, arrays):
        """A free ring slot's pinned buffers for ``arrays``: the slot is
        reused only after the event of its last copy has passed."""
        slot = self.count % self.SLOTS
        self.count += 1
        held = self.slots[slot]
        if held is not None:
            held[1].synchronize()
            buffers = held[0]
            if [(b.shape, b.dtype) for b in buffers] == \
                    [(torch.Size(a.shape), torch.from_numpy(a).dtype)
                     for a in arrays]:
                return slot, buffers
        return slot, [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                  pin_memory=True) for a in arrays]

    def put(self, batch):
        """Start copying ``(data list, targets, mask)``; returns a pending
        item for ``take``, or None for None."""
        if batch is None:
            return None
        data, targets, mask = batch
        arrays = [np.ascontiguousarray(a) for a in (*data, targets, mask)]
        n_real = int(mask.sum())
        if not self.cuda:
            tensors = [torch.from_numpy(a) for a in arrays]
            return tensors, n_real, None
        slot, pinned = self._pinned(arrays)
        for buf, a in zip(pinned, arrays):
            buf.numpy()[...] = a
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            tensors = [buf.to(self.device, non_blocking=True)
                       for buf in pinned]
            event = torch.cuda.Event()
            event.record(self.stream)
        for t in tensors:
            # Allocated on the side stream, read and freed on the consumer.
            t.record_stream(consumer)
        self.slots[slot] = (pinned, event)
        return tensors, n_real, event

    def take(self, item):
        """``((data tuple, targets, mask), n_real)``, with the consumer
        stream waiting on the batch's copy."""
        tensors, n_real, event = item
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        return (tuple(tensors[:-2]), tensors[-2], tensors[-1]), n_real


def device_batches(loader, device):
    """``(batch, n_real)`` pairs of one pass over a streaming loader on
    ``device``, each batch's copy started before the previous batch is
    handed out (one ahead)."""
    copier = _HostToDevice(device)
    it = iter(loader.iter_batches())
    pending = copier.put(next(it, None))
    while pending is not None:
        current = pending
        pending = copier.put(next(it, None))
        yield copier.take(current)


def _require_streaming(*loaders):
    for ldr in loaders:
        if ldr is not None and not hasattr(ldr, "iter_batches"):
            raise TypeError(
                f"expected a streaming loader (iter_batches), got "
                f"{type(ldr).__name__}")


def train_epoch_streaming(model, loader, optimizer, criterion=None,
                          history=None) -> dict:
    """One training epoch over a streaming loader (``MultiModN.train_epoch``
    on its batches); returns the epoch's history metrics."""
    from multimodn_tpu_torch.core.losses import resolve_criterion
    _require_streaming(loader)
    return model._train_epoch(loader, optimizer,
                              resolve_criterion(criterion), history)


def fit_streaming(model, train_loader, optimizer, criterion=None, *,
                  epochs: int, history=None, val_loader=None,
                  val_tag: str = "val"):
    """``epochs`` of ``train_epoch_streaming``, each followed by
    ``test_epoch_streaming`` on ``val_loader`` when given, as the JAX
    package composes it: the history ``MultiModN.fit`` would write, and a
    model with the per-call shuffle cadence (``chain_mode='unrolled'``)
    draws its order for every epoch. Returns ``history``."""
    _require_streaming(train_loader, val_loader)
    for _ in range(epochs):
        train_epoch_streaming(model, train_loader, optimizer, criterion,
                              history)
        if val_loader is not None:
            test_epoch_streaming(model, val_loader, criterion,
                                 history=history, tag=val_tag)
    return history


def test_epoch_streaming(model, loader, criterion=None, history=None,
                         tag: str = "test") -> list:
    """``MultiModN.test`` over a streaming loader: one 15-tuple of
    performance metrics per decoder."""
    _require_streaming(loader)
    return model.test(loader, criterion, history=history, tag=tag)


SHUFFLED_SELECTION = (
    "fit_best_streaming cannot honour shuffle=True loaders: a shuffled "
    "stream's permutation lives in the host loader (or its torch sampler) "
    "and cannot be replayed on resume; stream with shuffle=False (or "
    "pre-shuffle the dataset once).")


def fit_best_streaming(model, train_loader, optimizer, criterion=None, *,
                       epochs: int, val_loader, restore_best: bool = True,
                       history=None, val_tag: str = "val", on_epoch=None,
                       checkpoint_dir: Optional[str] = None,
                       checkpoint_every: int = 10, on_chunk=None) -> dict:
    """``MultiModN.fit_best`` over streaming loaders: train, validate and
    keep the best epoch by validation AUROC + BAC, batches streamed.

    ``on_epoch({"epoch", "score"})`` runs after each epoch's selection.
    ``checkpoint_dir``: every ``checkpoint_every`` epochs and at the last
    epoch the whole state (parameters,
    optimizer state, the best carry, scores, the epoch counter the call
    started from, the init-state cycle, ``history``) is written atomically
    to ``resume_stream_latest.pkl``; a later call with the same directory
    resumes there. Each epoch's dropout generator follows from the absolute
    epoch, so a killed and resumed run equals the uninterrupted one bit for
    bit. ``on_chunk(epochs_done, epochs)`` runs after each checkpoint.

    Returns ``fit_best``'s dict (``best_epoch``, ``best_score``,
    ``best_params``, ``scores``, ``epochs_ran``)."""
    if val_loader is None:
        raise ValueError("fit_best_streaming requires a val_loader")
    _require_streaming(train_loader, val_loader)
    if train_loader.shuffle or val_loader.shuffle:
        raise NotImplementedError(SHUFFLED_SELECTION)
    # The per-call shuffle cadence would freeze one order for every epoch:
    # the model's fit_best guard (JAX data/streaming.py:645-648).
    model._validate_fused_shuffle()
    from multimodn_tpu_torch import checkpoint as ckpt

    state_path = None
    if checkpoint_dir is not None:
        ckpt._check_chunks(checkpoint_every, "checkpoint_every")
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_path = os.path.join(checkpoint_dir, "resume_stream_latest.pkl")
    return ckpt._fit_best_checkpointed(
        model, train_loader, optimizer, criterion, epochs, val_loader,
        history, val_tag, restore_best, state_path, checkpoint_every,
        on_chunk, on_epoch)[0]


def _predict_checks(loader):
    _require_streaming(loader)
    if loader.shuffle:
        raise ValueError(
            "streamed inference rejects shuffle=True loaders: the result "
            "rows could not be mapped back to input rows. Build the loader "
            "with shuffle=False.")


def predict_streaming(model, loader) -> np.ndarray:
    """``MultiModN.predict`` over a streaming loader: (E+1, D, N) argmax
    predictions, no NaN skip (quirk #9)."""
    _predict_checks(loader)
    return model.predict(loader)


def predict_proba_streaming(model, loader) -> List[np.ndarray]:
    """``MultiModN.predict_proba`` over a streaming loader: per decoder
    (E+1, N, C_d) raw outputs."""
    _predict_checks(loader)
    return model.predict_proba(loader)
