"""Titanic dataset with the reference's preprocessing (copy of
``multimodn_tpu/data/titanic.py`` on column tables, without pandas or
scikit-learn).

Mirrors ``datasets/titanic/titanic_dataset.py``: load the CSV ->
preprocessing (``Relatives = SibSp + Parch``; ``Sex`` one-hot with the first
level dropped, giving ``Sex_male``; ``Cabin_num``, each cabin's index among
the sorted distinct cabins; ``Embarked`` mapped ``{S: 0, C: 1, Q: 2}``) ->
optional dropna over the features, targets and ``dropna_columns`` ->
optional standardisation of the features (``data/kfold.py``'s
``StandardScaler``, NaN passed through) -> ``X`` float32 and ``y`` int64,
with ``partition_dataset`` / ``featurewise_dataset`` / ``split_dataset``.
``X`` is bit-equal to the JAX package's.

Data file: ``data/titanic/titanic.csv`` under the repository root, the
reference's ``get_data.sh`` location, read by ``data/table.py`` (quoted
names with commas included). Without it, the deterministic synthetic table
of ``data/synth.py`` stands in; ``allow_synthetic=False`` requires the file.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from multimodn_tpu_torch.data.dataset import (
    FeatureWiseDataset,
    PartitionDataset,
    split_into_partition_datasets,
)
from multimodn_tpu_torch.data.kfold import StandardScaler
from multimodn_tpu_torch.data.synth import synthetic_titanic
from multimodn_tpu_torch.data.table import get_dummies, missing, read_csv

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "../.."))
DEFAULT_DATA_PATH = os.path.join(_REPO_ROOT, "data", "titanic", "titanic.csv")


def _map(col: np.ndarray, mapping: dict) -> np.ndarray:
    """``Series.map(mapping)`` as float64: NaN where a value is missing or
    not in ``mapping``."""
    return np.array([mapping.get(v, np.nan) if not m else np.nan
                     for v, m in zip(col.tolist(), missing(col))],
                    dtype=np.float64)


def titanic_preprocessing(table: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """Reference feature engineering (``titanic_dataset.py:69-79``)."""
    aug = dict(table)
    aug["Relatives"] = aug["SibSp"] + aug["Parch"]
    aug = get_dummies(aug, ["Sex"], drop_first=True)
    cabin = aug["Cabin"]
    cabins = sorted(set(cabin[~missing(cabin)].tolist()))
    aug["Cabin_num"] = _map(cabin, {c: i for i, c in enumerate(cabins)})
    aug["Embarked"] = _map(aug["Embarked"], {"S": 0, "C": 1, "Q": 2})
    return aug


class TitanicDataset:
    def __init__(
        self,
        features: List[str],
        targets: List[str],
        dropna: bool = True,
        dropna_columns: Optional[List[str]] = None,
        std: bool = True,
        data_path: Optional[str] = None,
        allow_synthetic: bool = True,
    ):
        dropna_columns = dropna_columns or []
        path = data_path or DEFAULT_DATA_PATH
        if os.path.exists(path):
            table = read_csv(path)
        elif allow_synthetic:
            table = synthetic_titanic()
        else:
            raise FileNotFoundError(
                f"Titanic CSV not found at {path}; fetch it or pass "
                "allow_synthetic=True")
        table["id"] = table.pop("PassengerId")
        aug = titanic_preprocessing(table)
        keep = np.ones(len(aug["id"]), dtype=bool)
        if dropna:
            for c in set(features + targets + dropna_columns):
                keep &= ~missing(aug[c])
        X = np.column_stack([aug[f][keep].astype(np.float64)
                             for f in features])
        if std:
            # pandas hands scikit-learn a frame's values in column-major
            # order; the scaler's sums follow the memory order.
            X = StandardScaler().fit_transform(np.asfortranarray(X))
        self.X = X.astype(np.float32)
        self.y = np.column_stack([aug[t][keep] for t in targets]
                                 ).astype(np.int64)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, idx: int):
        return self.X[idx], self.y[idx]

    def partition_dataset(self, partitions: Optional[List[int]] = None
                          ) -> PartitionDataset:
        return PartitionDataset(self.X, self.y, partitions)

    def featurewise_dataset(self) -> FeatureWiseDataset:
        return FeatureWiseDataset(self.X, self.y)

    def split_dataset(self, partitions: Optional[List[int]] = None
                      ) -> List[PartitionDataset]:
        return split_into_partition_datasets(self.X, self.y, partitions)
