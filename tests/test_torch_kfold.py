"""The port's numpy copies of scikit-learn's stratified k-fold, stratified
50/50 split and standard scaler, held against scikit-learn (1.9.0) on the
CPU, and the port's ``patient_kfold_splits`` against the JAX pipeline's.

Tolerance: none. Fold and split indices must be equal element for element
(the same ``RandomState`` draws in the same order); the scaler's output
must be bit-equal (the same float64 reductions in the same memory order).
"""
import warnings

import numpy as np
import pytest
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold
from sklearn.model_selection import train_test_split as sk_train_test_split
from sklearn.preprocessing import StandardScaler as SkStandardScaler
from sklearn.utils.extmath import _approximate_mode as sk_approximate_mode

from multimodn_tpu_torch.data import kfold

LABELS = {
    "balanced": lambda rng: rng.integers(0, 2, 40),
    "imbalanced": lambda rng: (rng.random(37) < 0.2).astype(np.int64),
    "three_class": lambda rng: rng.integers(0, 3, 50),
    "unsorted_names": lambda rng: rng.choice([5, 2, 9], 31),
    "float_labels": lambda rng: rng.integers(0, 2, 33).astype(np.float64),
}
SEEDS = range(6)


@pytest.mark.parametrize("kind", sorted(LABELS))
@pytest.mark.parametrize("n_splits", [2, 3, 5])
def test_stratified_kfold_matches_sklearn(kind, n_splits):
    for seed in SEEDS:
        y = LABELS[kind](np.random.default_rng(seed))
        x = np.arange(len(y)) * 3 + 7
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = list(SkStratifiedKFold(n_splits, shuffle=True,
                                          random_state=seed).split(x, y))
        got = kfold.StratifiedKFold(n_splits, shuffle=True,
                                    random_state=seed).split(x, y)
        assert len(got) == n_splits
        for (tr, te), (wtr, wte) in zip(got, want):
            assert np.array_equal(tr, wtr) and np.array_equal(te, wte)


@pytest.mark.parametrize("kind", sorted(LABELS))
def test_train_test_split_matches_sklearn(kind):
    checked = 0
    for seed in SEEDS:
        for size in (9, 10, 17):
            y = LABELS[kind](np.random.default_rng(100 + seed))[:size]
            if np.unique(y, return_counts=True)[1].min() < 2:
                continue
            x = np.arange(size) + 1000
            try:
                want = sk_train_test_split(x, y, test_size=0.5, stratify=y,
                                           random_state=seed)
            except ValueError:
                continue
            got = kfold.train_test_split(x, y, test_size=0.5, stratify=y,
                                         random_state=seed)
            assert len(got) == 4
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            checked += 1
    assert checked >= 6


def test_approximate_mode_breaks_ties_with_the_same_draws():
    # Ties in the left-over shares: which class gets the extra draw comes
    # from rng.choice; the stream must be consumed in scikit-learn's order.
    for seed in range(20):
        counts = np.array([2, 2, 2, 1, 3, 3])
        want = sk_approximate_mode(counts, 5, np.random.RandomState(seed))
        got = kfold._approximate_mode(counts, 5, np.random.RandomState(seed))
        assert np.array_equal(got, want)


def test_split_errors_match_sklearn():
    with pytest.raises(ValueError, match="cannot be greater"):
        kfold.StratifiedKFold(5, shuffle=True, random_state=0).split(
            np.arange(7), np.arange(7))
    with pytest.raises(ValueError, match="only 1 member"):
        kfold.train_test_split(np.arange(5), test_size=0.5,
                               stratify=np.array([0, 0, 1, 1, 2]),
                               random_state=0)
    with pytest.raises(ValueError, match="continuous"):
        kfold.StratifiedKFold(2, shuffle=True, random_state=0).split(
            np.arange(4), np.array([0.5, 1.0, 0.5, 1.0]))


def _scaler_input(case):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 7)) * 3 + 5
    if case == "plain":
        return X
    if case == "nan":
        X[rng.random(X.shape) < 0.2] = np.nan
        X[:, 4] = np.nan                       # an all-NaN column
        X[0, 4] = 2.0
        return X
    if case == "constant":
        X[:, 1] = 7.3
        X[:, 2] = 0.0
        return X
    if case == "near_constant":
        X[:, 1] = 1e8 + rng.normal(size=60) * 1e-9
        X[:, 2] = 0.1 + rng.normal(size=60) * 1e-18
        X[::7, 3] = np.nan
        return X
    if case == "column_major":
        X[rng.random(X.shape) < 0.1] = np.nan
        return np.asfortranarray(X)
    if case == "float32":
        return X.astype(np.float32)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["plain", "nan", "constant",
                                  "near_constant", "column_major", "float32"])
def test_standard_scaler_matches_sklearn(case):
    X = _scaler_input(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = SkStandardScaler().fit(X)
        want = sk.transform(X)
    ours = kfold.StandardScaler().fit(X)
    got = ours.transform(X)
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = {np.float64: np.int64, np.float32: np.int32}[want.dtype.type]
    same = (got.view(bits) == want.view(bits)) | (np.isnan(got)
                                                  & np.isnan(want))
    assert same.all(), f"{(~same).sum()} elements differ"
    for name in ("mean_", "var_", "scale_"):
        a, b = getattr(ours, name), getattr(sk, name)
        assert np.array_equal(a, b, equal_nan=True), name
    assert np.array_equal(ours.n_samples_seen_, sk.n_samples_seen_)


@pytest.mark.parametrize("nfold", [2, 3, 5])
def test_patient_kfold_splits_match_jax(tmp_path, monkeypatch, nfold):
    """The port's folds over the port's dataset equal the JAX pipeline's
    over the JAX dataset, index for index, on the joint split table and on
    the dataset's own."""
    from multimodn_tpu.data import mimic as jmimic
    from multimodn_tpu_torch.data import mimic as tmimic
    from pipelines.mimic import common as jcommon
    from multimodn_tpu_torch.pipelines.mimic import common as tcommon

    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    root = str(tmp_path)
    sources, synth = ["de", "ts_ce"], {"n_patients": 40}
    targets = ["Enlarged Cardiomediastinum", "Cardiomegaly"]
    jmimic.build_mimic_cache(targets, sources, root, synth)
    jtable = jmimic.MIMICDataset(sources, targets, cache_root=root,
                                 synthetic_kwargs=synth).patient_split_table()
    for target in (["Cardiomegaly"], targets):
        jds = jmimic.MIMICDataset(sources, target, cache_root=root,
                                  synthetic_kwargs=synth)
        tds = tmimic.MIMICDataset(sources, target, cache_root=root,
                                  synthetic_kwargs=synth)
        ttable = tmimic.MIMICDataset(sources, targets, cache_root=root,
                                     synthetic_kwargs=synth
                                     ).patient_split_table()
        for seed in (0, 4):
            for jp, tp in ((jtable, ttable), (None, None)):
                want = list(jcommon.patient_kfold_splits(jds, nfold, seed,
                                                         patient=jp))
                got = list(tcommon.patient_kfold_splits(tds, nfold, seed,
                                                        patient=tp))
                assert len(got) == nfold
                for g, w in zip(got, want):
                    for a, b in zip(g, w):
                        assert np.array_equal(a, b)
