"""Disk-backed streaming loaders (PyTorch twin of
``multimodn_tpu/data/disk.py``): batches read straight from disk, so host
memory stays one batch plus an index, whatever the dataset's size.

- ``CSVStreamingLoader``: a numeric CSV through the native reader
  (``native/csv.cpp`` via ``data/native.py``). One indexing pass records
  each row's byte offset (8 B per row); a batch of consecutive rows is one
  block read, any other batch one read per row. There is no pandas
  fallback: a file the native reader cannot take raises.
- ``NpyStreamingLoader``: a ``.npy`` matrix through a numpy memmap; the OS
  pages in the rows a batch touches.

Both have ``StreamingLoader``'s protocol (``iter_batches``, ``reshuffle``,
geometry, ``modality_widths``), so every streaming entry point and the
streamed k-fold take them, and training over the same rows equals a
``StreamingLoader``'s bit for bit.

Column layout: the first ``sum(widths)`` columns are the modalities'
features in order, the next ``n_targets`` columns integer class targets
(``export_streaming_matrix`` writes it). ``rows=`` makes a loader a view of
those source rows, in that order: one file and a row list per fold is the
k-fold workflow.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def export_streaming_matrix(dataset, path: str, chunk_rows: int = 8192):
    """Write a dataset as the ``[features | targets]`` float32 ``.npy``
    matrix the disk loaders stream, ``chunk_rows`` rows at a time through a
    memmap (the file is never held in memory; the dataset is read one
    sample at a time). Returns ``(path, widths, n_targets)``."""
    n = len(dataset)
    if n == 0:
        raise ValueError("cannot export an empty dataset")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    item0 = dataset[0]
    if len(item0) > 2 and item0[2] is not None:
        raise NotImplementedError(
            "the on-disk matrix carries no encoding sequences; exporting "
            "would drop this dataset's encoder order. Use ArrayLoader for "
            "sequence-carrying datasets.")
    widths = [int(np.asarray(x).reshape(-1).shape[0]) for x in item0[0]]
    n_feat = sum(widths)
    n_targets = np.asarray(item0[1]).reshape(-1).shape[0]
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(n, n_feat + n_targets))
    buf = np.empty((min(chunk_rows, n), n_feat + n_targets), np.float32)
    for at in range(0, n, chunk_rows):
        m = min(chunk_rows, n - at)
        for i in range(m):
            xs, y = dataset[at + i][:2]
            buf[i, :n_feat] = np.concatenate(
                [np.asarray(x, np.float32).reshape(-1) for x in xs])
            buf[i, n_feat:] = np.asarray(y, np.float32).reshape(-1)
        mm[at:at + m] = buf[:m]
    mm.flush()
    del mm
    return path, widths, n_targets


class _DiskLoaderBase:
    """Geometry and batches of the disk loaders. A subclass's ``_fetch(idx)``
    returns the source rows ``idx`` in that order (any index array)."""

    def __init__(self, n_rows: int, n_cols: int, widths: Sequence[int],
                 n_targets: int, batch_size: int, shuffle: bool, seed: int,
                 rows: Optional[Sequence[int]] = None):
        widths = [int(w) for w in widths]
        if any(w <= 0 for w in widths):
            raise ValueError(f"modality widths must be positive: {widths}")
        if n_targets < 1:
            raise ValueError(f"n_targets must be >= 1, got {n_targets}")
        n_used = sum(widths) + int(n_targets)
        if n_used > n_cols:
            raise ValueError(
                f"layout needs {sum(widths)} feature + {n_targets} target "
                f"columns = {n_used}, but the source has only {n_cols}")
        if rows is not None:
            rows = np.asarray(rows, np.int64)
            if rows.ndim != 1 or rows.size == 0:
                raise ValueError("rows must be a non-empty 1-D index list")
            if rows.min() < 0 or rows.max() >= n_rows:
                raise ValueError(
                    f"rows indices out of range [0, {n_rows}): "
                    f"[{rows.min()}, {rows.max()}]")
            n_rows = rows.size
        if n_rows == 0:
            raise ValueError("disk-backed loader got an empty dataset")
        self._rows = rows
        self._widths = widths
        self._n_targets = int(n_targets)
        self._n_cols = int(n_cols)
        self.n_samples = int(n_rows)
        self.batch_size = int(batch_size) if batch_size > 0 else self.n_samples
        self.n_batches = max(1, math.ceil(self.n_samples / self.batch_size))
        self.shuffle = bool(shuffle)
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.n_samples)

    @property
    def modality_widths(self) -> List[int]:
        return list(self._widths)

    def __len__(self) -> int:
        return self.n_batches

    def reshuffle(self):
        if self.shuffle:
            self._rng.shuffle(self._order)

    def _fetch(self, idx: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _assemble_batch(self, rows: np.ndarray):
        """(n, >= n_feat + n_targets) float32 rows -> ``(data list, targets,
        mask)`` padded to the batch size."""
        B, n = self.batch_size, rows.shape[0]
        n_feat = sum(self._widths)
        mask = np.zeros((B,), np.float32)
        mask[:n] = 1.0
        data = []
        for block in np.split(rows[:, :n_feat], np.cumsum(self._widths[:-1]),
                              axis=1):
            buf = np.zeros((B, block.shape[1]), np.float32)
            buf[:n] = block
            data.append(buf)
        tcols = rows[:, n_feat:n_feat + self._n_targets]
        if not np.isfinite(tcols).all():
            # A NaN target would cast to an integer garbage label under a
            # live mask; NaN only means "missing" in feature columns.
            raise ValueError(
                "non-finite target cell(s) in the disk-backed source: "
                "target columns must hold integer class labels; empty, NA "
                "or unparseable cells are valid in feature columns only")
        targets = np.zeros((B, self._n_targets), np.int64)
        targets[:n] = tcols
        return data, targets, mask

    def iter_batches(self) -> Iterator[Tuple[List[np.ndarray], np.ndarray,
                                             np.ndarray]]:
        """Yield ``(data list, targets, sample_mask)``, padded to the batch
        size: ``StreamingLoader``'s batches."""
        B = self.batch_size
        for b in range(self.n_batches):
            idx = self._order[b * B:(b + 1) * B]
            if self._rows is not None:
                idx = self._rows[idx]
            yield self._assemble_batch(
                np.asarray(self._fetch(idx), np.float32))


class CSVStreamingLoader(_DiskLoaderBase):
    """Batches straight from a numeric CSV with one header row (empty and
    NA cells read as NaN) through the native reader. ``strict=False`` reads
    an unparseable field as NaN; with ``strict=True`` it raises."""

    def __init__(self, path: str, widths: Sequence[int], n_targets: int = 1,
                 batch_size: int = 0, shuffle: bool = False, seed: int = 0,
                 strict: bool = True, rows: Optional[Sequence[int]] = None):
        from multimodn_tpu_torch.data import native
        self._path = path
        self._strict = bool(strict)
        n_rows, n_cols, self._offsets = native.csv_index(path)
        super().__init__(n_rows, n_cols, widths, n_targets, batch_size,
                         shuffle, seed, rows=rows)

    def _fetch(self, idx: np.ndarray) -> np.ndarray:
        from multimodn_tpu_torch.data import native
        off, n = self._offsets, idx.shape[0]
        if n > 0 and int(idx[-1]) - int(idx[0]) == n - 1 and \
                bool(np.all(np.diff(idx) == 1)):
            return native.csv_read_block(
                self._path, int(off[idx[0]]), int(off[idx[-1] + 1]), n,
                self._n_cols, self._strict)
        spans = np.stack([off[idx], off[idx + 1]], axis=1)
        return native.csv_read_rows(self._path, spans, self._n_cols,
                                    self._strict)


class NpyStreamingLoader(_DiskLoaderBase):
    """Batches from an ``.npy`` matrix through a numpy memmap (a path), or
    from an open memmap or array."""

    def __init__(self, matrix, widths: Sequence[int], n_targets: int = 1,
                 batch_size: int = 0, shuffle: bool = False, seed: int = 0,
                 rows: Optional[Sequence[int]] = None):
        if isinstance(matrix, (str, bytes)):
            matrix = np.load(matrix, mmap_mode="r")
        matrix = np.asanyarray(matrix)
        if matrix.ndim != 2:
            raise ValueError(
                f"NpyStreamingLoader needs a 2-D (rows, cols) matrix, got "
                f"shape {matrix.shape}")
        self._m = matrix
        super().__init__(matrix.shape[0], matrix.shape[1], widths,
                         n_targets, batch_size, shuffle, seed, rows=rows)

    def _fetch(self, idx: np.ndarray) -> np.ndarray:
        return self._m[idx]
