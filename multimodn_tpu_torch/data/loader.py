"""ArrayLoader: a dataset as padded epoch stacks on the model's device
(PyTorch twin of ``multimodn_tpu/data/loader.py``).

The whole epoch is laid out once as ``(n_batches, B, F_m)`` float32 tensors
per modality, ``(n_batches, B, D)`` int64 targets and a ``(n_batches, B)``
sample mask, and copied to the device in one go; the training loop then
slices batches without host work. The last short batch is padded with zero
rows whose mask is 0, and every loss and metric is mask-exact. NaNs are kept:
they mark missing modalities. A dataset may give every sample its encoder
order; ``batch_sequences`` checks that each batch shares one.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from multimodn_tpu_torch.data.dataset import Subset
from multimodn_tpu_torch.utils.profiling import span


def _materialize(dataset) -> Tuple[List[np.ndarray], np.ndarray,
                                   Optional[np.ndarray]]:
    """(list of (N, F_m) float32 arrays, (N, D) targets, optional (N, E)
    encoding sequences)."""
    if isinstance(dataset, Subset) and hasattr(dataset.dataset, "arrays"):
        xs, y, seq = dataset.dataset.arrays()
        idx = np.asarray(dataset.indices, dtype=np.int64)
        return ([np.asarray(x[idx], np.float32) for x in xs], np.asarray(y)[idx],
                seq[idx] if seq is not None else None)
    if hasattr(dataset, "arrays"):
        xs, y, seq = dataset.arrays()
        return [np.asarray(x, np.float32) for x in xs], np.asarray(y), seq
    first = dataset[0]
    has_seq = len(first) > 2
    cols: List[List[np.ndarray]] = [[] for _ in first[0]]
    ys, seqs = [], []
    for i in range(len(dataset)):
        item = dataset[i]
        for m, x in enumerate(item[0]):
            cols[m].append(np.asarray(x, dtype=np.float32).reshape(-1))
        ys.append(np.asarray(item[1]))
        if has_seq:
            seqs.append(np.asarray(item[2]))
    return ([np.stack(c) for c in cols], np.stack(ys),
            np.stack(seqs) if has_seq else None)


class ArrayLoader:
    """Epoch-stacked batches for the training and evaluation loops.

    Args:
        dataset: a dataset with the sample protocol (or a ``Subset``).
        batch_size: samples per batch; 0 means one batch of everything.
        shuffle: reshuffle the sample order at every ``reshuffle()``.
        seed: seed of the shuffle's ``numpy.random.Generator`` (the JAX
            package's loader shuffles the same way).
    """

    def __init__(self, dataset, batch_size: int = 0, shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        xs, y, seq = _materialize(dataset)
        self.n_samples = y.shape[0]
        if self.n_samples == 0:
            raise ValueError(
                "ArrayLoader got an empty dataset (0 samples) — check your "
                "split probabilities / subset indices.")
        self._xs = xs
        self._y = (y[:, None] if y.ndim == 1 else y).astype(np.int64)
        self._seq = seq.astype(np.int64) if seq is not None else None
        self.batch_size = batch_size if batch_size > 0 else self.n_samples
        self.n_batches = max(1, math.ceil(self.n_samples / self.batch_size))
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.n_samples)
        self._host = None
        self._stacks = {}
        self._batch_seq = None

    def __len__(self) -> int:
        return self.n_batches

    @property
    def modality_widths(self) -> List[int]:
        return [int(x.shape[1]) if x.ndim > 1 else 1 for x in self._xs]

    @property
    def encoding_sequence(self) -> Optional[np.ndarray]:
        """The dataset's encoder order when every sample shares one, else
        None."""
        if self._seq is None or not (self._seq == self._seq[0]).all():
            return None
        return self._seq[0]

    def has_per_batch_sequences(self) -> bool:
        return self._seq is not None and self.encoding_sequence is None

    def batch_sequences(self) -> Optional[np.ndarray]:
        """Per-batch encoder orders as an ``(n_batches, L)`` int64 array
        over each batch's real rows, or None when the dataset gives no
        sequence or one shared by every sample. Raises the reference's
        error (``multimodn.py:520-523``) when a batch mixes sequences:
        per-sample orders need batch size 1 or batches of equal orders."""
        if not self.has_per_batch_sequences():
            return None
        if self._batch_seq is None:
            seqs = self._pad_stack(self._seq)
            rows = []
            for b, n_real in enumerate(self.batch_counts()):
                real = seqs[b, :n_real]
                if not (real == real[0]).all():
                    raise ValueError(
                        "Encoder sequence has different values across the "
                        "batch. Hint: set batch size to 1 to avoid this "
                        "error.")
                rows.append(real[0])
            self._batch_seq = np.stack(rows)
        return self._batch_seq

    def batch_counts(self) -> List[int]:
        """Real (unpadded) samples in each batch; the padding is the tail."""
        return [min(self.batch_size, self.n_samples - b * self.batch_size)
                for b in range(self.n_batches)]

    def reshuffle(self):
        if self.shuffle:
            self._rng.shuffle(self._order)
            self._host = None
            self._stacks = {}
            self._batch_seq = None

    def _pad_stack(self, arr: np.ndarray) -> np.ndarray:
        """(N, ...) in the current order -> (n_batches, B, ...) with a
        zero-padded tail."""
        total = self.n_batches * self.batch_size
        ordered = arr[self._order]
        if total > self.n_samples:
            pad = np.zeros((total - self.n_samples,) + arr.shape[1:],
                           dtype=arr.dtype)
            ordered = np.concatenate([ordered, pad], axis=0)
        return ordered.reshape((self.n_batches, self.batch_size)
                               + arr.shape[1:])

    def host_stacks(self):
        """``(data tuple, targets, sample_mask)`` as numpy arrays, built
        once per order."""
        if self._host is None:
            with span("loader.order"):
                self._host = (tuple(self._pad_stack(x) for x in self._xs),
                              self._pad_stack(self._y),
                              self._pad_stack(np.ones(self.n_samples,
                                                      np.float32)))
        return self._host

    def stacks(self, device):
        """``(data tuple, targets, sample_mask)`` tensors on ``device``,
        built once per order and device."""
        device = torch.device(device)
        if device not in self._stacks:
            with span("loader.stacks"):
                data, targets, mask = self.host_stacks()
                with span("loader.to_device") as s:
                    s.set(bytes=sum(a.nbytes for a in (*data, targets,
                                                       mask)))
                    self._stacks[device] = (
                        tuple(torch.as_tensor(d, device=device)
                              for d in data),
                        torch.as_tensor(targets, device=device),
                        torch.as_tensor(mask, device=device))
        return self._stacks[device]


# The JAX package's drop-in-named alias (JAX ``data/loader.py:218``), for
# callers arriving from the reference's ``torch.utils.data.DataLoader``.
DataLoader = ArrayLoader
