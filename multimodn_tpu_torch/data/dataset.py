"""Dataset protocol (copy of ``multimodn_tpu/data/dataset.py``, which is
numpy only): a sample is ``(list of per-modality arrays, targets[, encoding
sequence])``. ``PartitionDataset`` cuts feature columns into modality
blocks, ``FeatureWiseDataset`` makes one modality per column and
``JointDatasets`` zips datasets.

``random_split`` reproduces the reference's seeded, optionally
class-balanced split (``multimod_dataset.py:14-52``) exactly: a
``torch.randperm`` under ``manual_seed(seed)``, per-class grouping in
shuffled order when ``balanced_target_idx`` is given, and the remainder
joining split 0 (quirk #13). The JAX package draws the same permutation, so
split indices agree bit for bit at equal seeds.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from itertools import accumulate
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _seeded_permutation(n: int, seed: int) -> List[int]:
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen).tolist()


class Subset:
    """View over a dataset restricted to given indices (torch Subset analog)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


def _split_indices(shuffled, probabilities, label_of=None) -> List[List[int]]:
    """Proportional (optionally label-grouped) split of pre-shuffled indices:
    ``int(len * p / sum_p)`` per split, the remainder joining split 0
    (``multimod_dataset.py:45``)."""
    sum_p = sum(probabilities)
    if label_of is None:
        groups = {"Unbalanced": list(shuffled)}
    else:
        groups = {}
        for idx in shuffled:
            groups.setdefault(label_of(idx), []).append(idx)
    splitted: List[List[int]] = [[] for _ in probabilities]
    for indices in groups.values():
        lengths = [int(len(indices) * p / sum_p) for p in probabilities]
        lengths[0] += len(indices) - sum(lengths)
        for i, (offset, length) in enumerate(zip(accumulate(lengths), lengths)):
            splitted[i] = splitted[i] + indices[offset - length:offset]
    return splitted


class MultiModDataset(ABC):
    @abstractmethod
    def __len__(self) -> int:
        ...

    @abstractmethod
    def __getitem__(self, idx: int):
        ...

    def random_split(
        self,
        probabilities: Union[List[float], Tuple[float, ...]],
        seed: int,
        balanced_target_idx: Optional[int] = None,
    ) -> List[Subset]:
        shuffled = _seeded_permutation(len(self), seed)
        label_of = None if balanced_target_idx is None else \
            (lambda idx: self[idx][1][balanced_target_idx])
        return [Subset(self, idx)
                for idx in _split_indices(shuffled, probabilities, label_of)]


class PartitionDataset(MultiModDataset):
    """Tabular dataset whose feature columns are split into modality blocks
    (reference ``multimod_dataset.py:55-88``)."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 partitions: Optional[List[int]] = None):
        X = np.asarray(X, dtype=np.float32)
        self.partitions = list(partitions) if partitions is not None else [X.shape[1]]
        if sum(self.partitions) != X.shape[1]:
            raise ValueError(
                "Paritions sum doesn't match data dimension. Expected: {}, got: {}"
                .format(sum(self.partitions), X.shape[1])
            )
        self.n_partitions = len(self.partitions)
        offsets = list(accumulate(self.partitions[:-1]))
        self.X = np.split(X, offsets, axis=1)
        self.y = np.asarray(y)

    def __len__(self) -> int:
        return len(self.y)

    def __getitem__(self, idx: int):
        return [self.X[p][idx] for p in range(self.n_partitions)], self.y[idx]

    def arrays(self):
        """All modalities at once, for ``ArrayLoader``'s fast path."""
        return list(self.X), self.y, None


class FeatureWiseDataset(PartitionDataset):
    """One modality per feature column (reference ``multimod_dataset.py:91-95``)."""

    def __init__(self, X: np.ndarray, y: np.ndarray):
        super().__init__(X, y, [1] * np.asarray(X).shape[1])


class JointDatasets(MultiModDataset):
    """Zips aligned datasets; each dataset's modalities concatenate into one
    (reference ``multimod_dataset.py:98-114``)."""

    def __init__(self, datasets: List):
        if not all(len(d) == len(datasets[0]) for d in datasets):
            raise ValueError("Datasets must have the same length")
        self.datasets = datasets

    def __len__(self) -> int:
        return len(self.datasets[0])

    def __getitem__(self, idx: int):
        tensor_array = [
            np.concatenate([np.asarray(a).reshape(-1) for a in dataset[idx][0]])
            for dataset in self.datasets
        ]
        return tensor_array, self.datasets[0][idx][1]


def split_into_partition_datasets(X, y, partitions) -> List[PartitionDataset]:
    """One PartitionDataset per partition block (reference
    ``titanic_dataset.py:60-67`` / ``mimic_dataset.py`` split_dataset). The
    message's Expected/got operands are swapped, as in the reference."""
    if partitions is None:
        partitions = [X.shape[1]]
    if sum(partitions) != X.shape[1]:
        raise ValueError(
            "Paritions sum doesn't match data dimension. "
            "Expected: {}, got: {}".format(sum(partitions), X.shape[1]))
    X_split = np.split(X, list(accumulate(partitions[:-1])), axis=1)
    return [PartitionDataset(X_split[i], y, [p])
            for i, p in enumerate(partitions)]
