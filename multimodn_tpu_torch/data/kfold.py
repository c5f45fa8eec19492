"""Stratified k-fold, the stratified 50/50 split and standard scaling in
numpy: copies of the three scikit-learn pieces the MIMIC protocol uses
(``StratifiedKFold(shuffle=True).split``, ``train_test_split(...,
stratify=y)`` and ``StandardScaler().fit_transform``), pinned to
scikit-learn 1.9.0. Each draws from one ``numpy.random.RandomState`` in
scikit-learn's order, so the same seed gives the same indices, and each
reduces in scikit-learn's order, so the same array gives the same bits.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


class StratifiedKFold:
    """``sklearn.model_selection.StratifiedKFold``: each class's samples
    spread over the folds as evenly as the class counts allow.

    Classes are encoded in order of first appearance; each fold's share of
    every class comes from a ``bincount`` over the sorted encoded labels
    taken every ``n_splits``-th; with ``shuffle`` one ``RandomState`` shuffles
    each class's list of fold numbers, class by class."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False,
                 random_state=None):
        if n_splits < 2:
            raise ValueError(f"n_splits must be at least 2, got {n_splits}")
        if not shuffle and random_state is not None:
            raise ValueError("random_state has no effect unless shuffle=True")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def _test_folds(self, y: np.ndarray) -> np.ndarray:
        rng = np.random.RandomState(self.random_state)
        _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
        # Re-encode the sorted classes by order of first appearance.
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(
                "n_splits=%d cannot be greater than the number of members "
                "in each class." % self.n_splits)
        y_order = np.sort(y_encoded)
        allocation = np.asarray(
            [np.bincount(y_order[i::self.n_splits], minlength=n_classes)
             for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y) -> List[Tuple[np.ndarray, np.ndarray]]:
        """``[(train_index, test_index), ...]``, both ascending."""
        y = np.asarray(y).reshape(-1)
        if np.issubdtype(y.dtype, np.floating) and \
                np.any(y != y.astype(np.int64)):
            raise ValueError("Supported target types are binary and "
                             "multiclass; got continuous labels")
        n = len(X) if not hasattr(X, "shape") else X.shape[0]
        if n != len(y):
            raise ValueError(f"X has {n} samples, y has {len(y)}")
        if self.n_splits > n:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of samples: n_samples={n}.")
        test_folds = self._test_folds(y)
        indices = np.arange(n)
        return [(indices[test_folds != i], indices[test_folds == i])
                for i in range(self.n_splits)]


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's approximate mode of the multivariate hypergeometric:
    floored proportional counts, the remainder handed out by descending
    left-over share, ties broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def train_test_split(*arrays, test_size: float, stratify,
                     random_state=None) -> list:
    """``sklearn.model_selection.train_test_split(*arrays,
    test_size=test_size, stratify=stratify, random_state=random_state)``
    for a float ``test_size``: ``[a_train, a_test, b_train, b_test, ...]``
    (numpy arrays). That is one split of ``StratifiedShuffleSplit`` with
    ``ceil(test_size * n)`` test samples: per class, the approximate-mode
    counts and a permutation; then a permutation of train and of test."""
    if not arrays:
        raise ValueError("At least one array required as input")
    if stratify is None:
        raise NotImplementedError(
            "only the stratified split of the MIMIC protocol is ported")
    y = np.asarray(stratify).reshape(-1)
    n = len(y)
    if any(len(a) != n for a in arrays):
        raise ValueError("arrays and stratify must have the same length")
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         "(0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the "
                         "train set would be empty")
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is "
            "too few. The minimum number of groups for any class cannot be "
            "less than 2. Classes with too few members are: %s"
            % classes[class_counts < 2].tolist())
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(f"train size {n_train} and test size {n_test} must "
                         f"each reach the number of classes {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        permutation = rng.permutation(class_counts[i])
        perm_indices = class_indices[i].take(permutation, mode="clip")
        train.extend(perm_indices[:n_i[i]])
        test.extend(perm_indices[n_i[i]:n_i[i] + t_i[i]])
    train, test = rng.permutation(train), rng.permutation(test)
    out = []
    for a in arrays:
        a = np.asarray(a)
        out += [a[train], a[test]]
    return out


class StandardScaler:
    """``sklearn.preprocessing.StandardScaler`` (with mean and std) on a
    dense float array in one fit.

    The mean and the variance (ddof 0) are the first increment of
    scikit-learn's ``_incremental_mean_and_var`` in float64: NaNs are
    ignored (``nansum`` whenever the array holds one), the variance is the
    corrected two-pass sum. A feature whose variance lies within the
    two-pass algorithm's error bound of zero (``_is_constant_feature``) is
    scaled by 1. ``transform`` subtracts the mean and divides by the scale,
    passing NaN through. Column sums reduce in the array's own memory order,
    as numpy's do in scikit-learn."""

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X)
        if not np.issubdtype(X.dtype, np.floating):
            X = X.astype(np.float64)
        nan_mask = np.isnan(X)
        sum_op = np.nansum if nan_mask.any() else np.sum

        def acc(op, a):
            # scikit-learn accumulates float32 input in float64.
            return op(a, axis=0, dtype=np.float64) \
                if a.dtype != np.float64 else op(a, axis=0)

        new_sum = acc(sum_op, X)
        count = X.shape[0] - acc(sum_op, nan_mask.astype(X.dtype))
        with np.errstate(divide="ignore", invalid="ignore"):
            mean = (0.0 + new_sum) / count
            temp = X - new_sum / count
            correction = acc(sum_op, temp)
            temp **= 2
            var = acc(sum_op, temp)
            var -= correction ** 2 / count
            var = var / count
        n_seen = count[0] if count.max() == count.min() else count
        eps = np.finfo(np.float64).eps
        constant = var <= n_seen * eps * var + (n_seen * mean * eps) ** 2
        scale = np.sqrt(var)
        scale[constant] = 1.0
        self.mean_, self.var_, self.scale_ = mean, var, scale
        self.n_samples_seen_ = n_seen
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        X = np.array(X, copy=True, order="K")
        if not np.issubdtype(X.dtype, np.floating):
            X = X.astype(np.float64)
        X -= self.mean_.astype(X.dtype)
        X /= self.scale_.astype(X.dtype)
        return X

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)
