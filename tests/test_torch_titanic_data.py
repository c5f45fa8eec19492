"""The port's Titanic data layer against the JAX package on the CPU: the
synthetic table, the preprocessing, ``TitanicDataset`` for every Titanic
pipeline's configuration and with ``dropna=False``, ``dropna_columns`` and
``std=False``, the pipelines' splits, the real-CSV path, and the
``FeatureWise`` / ``Joint`` / split datasets (with ``MIMICDataset``'s two
converters).

Tolerances: none. The synthetic columns are equal (the same numpy stream),
``X`` is compared bit for bit (both standardise with scikit-learn's float64
sums in the same memory order; the port's scaler is bit-equal to
scikit-learn's, ``tests/test_torch_kfold.py``), ``y`` and split indices are
equal.
"""
import importlib

import numpy as np
import pytest

from multimodn_tpu.data import dataset as jdataset
from multimodn_tpu.data import mimic as jmimic
from multimodn_tpu.data import synth as jsynth
from multimodn_tpu.data import titanic as jtitanic
from multimodn_tpu_torch.data import dataset as tdataset
from multimodn_tpu_torch.data import mimic as tmimic
from multimodn_tpu_torch.data import synth as tsynth
from multimodn_tpu_torch.data import titanic as ttitanic
from multimodn_tpu_torch.pipelines.titanic import common as tcommon

PIPELINES = ("titanic_mlp", "titanic_partitioned", "titanic_featurewise",
             "titanic_missingness", "titanic_lstm", "titanic_rnn")


def _bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    assert same.all(), f"{(~same).sum()} elements differ"


def _same_values(a, b):
    """Two columns hold equal values, NaN where the other has NaN."""
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y or (x != x and y != y), (x, y)


@pytest.mark.parametrize("kwargs", [{}, {"n": 120, "seed": 3}])
def test_synthetic_table_equals_jax(kwargs):
    frame = jsynth.synthetic_titanic(**kwargs)
    table = tsynth.synthetic_titanic(**kwargs)
    assert list(frame.columns) == list(table)
    for name in frame.columns:
        _same_values(table[name].tolist(), frame[name].tolist())
        assert (table[name].dtype == object) == \
            (frame[name].dtype.kind in "OT")


def test_preprocessing_columns_equal_jax():
    frame = jtitanic.titanic_preprocessing(jsynth.synthetic_titanic())
    table = ttitanic.titanic_preprocessing(tsynth.synthetic_titanic())
    assert set(frame.columns) == set(table)
    for name in ("Relatives", "Sex_male", "Cabin_num", "Embarked"):
        _same_values(table[name].tolist(), frame[name].tolist())
    assert table["Sex_male"].dtype == bool


def _configs(name):
    jcfg = importlib.import_module(f"pipelines.titanic.{name}_pipeline").CONFIG
    tcfg = importlib.import_module(
        f"multimodn_tpu_torch.pipelines.titanic.{name}_pipeline").CONFIG
    return jcfg, tcfg


CASES = {name: None for name in PIPELINES}
CASES.update({
    "keep_nan": (["Fare", "Age", "Embarked", "Cabin_num"],
                 {"dropna": False}),
    "dropna_columns": (["Fare", "Pclass", "Age"],
                       {"dropna_columns": ["Cabin_num"]}),
    "unscaled": (["Fare", "Pclass", "Age", "Sex_male", "Relatives"],
                 {"dropna": False, "std": False}),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_bit_equal(case):
    if CASES[case] is None:
        jcfg, tcfg = _configs(case)
        assert tcfg.features == jcfg.features
        features, kw = jcfg.features, {"dropna": jcfg.dropna,
                                       "dropna_columns": jcfg.dropna_columns}
    else:
        features, kw = CASES[case]
    jds = jtitanic.TitanicDataset(features, ["Survived"], **kw)
    tds = ttitanic.TitanicDataset(features, ["Survived"], **kw)
    _bits_equal(tds.X, jds.X)
    assert tds.y.dtype == np.int64 and np.array_equal(tds.y, jds.y)
    assert len(tds) == len(jds)


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_splits_index_equal(name):
    """The pipeline's balanced split of its dataset, at two seeds."""
    jcfg, tcfg = _configs(name)
    jds = jtitanic.TitanicDataset(jcfg.features, jcfg.targets,
                                  dropna=jcfg.dropna,
                                  dropna_columns=jcfg.dropna_columns)
    base = jds.featurewise_dataset() if jcfg.featurewise \
        else jds.partition_dataset(jcfg.partitions)
    for seed in (0, 5):
        want = base.random_split(jcfg.datasplit, seed,
                                 jcfg.balance_target_idx)
        got = tcommon.split(tcfg, seed)
        assert [s.indices for s in got] == [s.indices for s in want]
        assert got[0].dataset.partitions == base.partitions


def test_real_csv_path(tmp_path):
    """A Titanic CSV written by pandas, with quoted names holding commas and
    quotes, read by both packages; the synthetic stand-in is never used."""
    frame = jsynth.synthetic_titanic(n=200, seed=11)
    frame.loc[3, "Name"] = 'Braund, Mr. Owen "Owen" Harris'
    frame.loc[4, "Name"] = "O'Brien, Mrs. Thomas (Johanna, \"Hannah\")"
    path = tmp_path / "titanic.csv"
    frame.to_csv(path, index=False)
    table = ttitanic.read_csv(str(path))
    assert table["Name"][3] == 'Braund, Mr. Owen "Owen" Harris'
    assert table["Age"].dtype == np.float64
    for features, kw in ((["Fare", "Pclass", "Age", "Sex_male", "Relatives",
                           "Embarked"], {}),
                         (["Fare", "Age", "Cabin_num"], {"dropna": False})):
        jds = jtitanic.TitanicDataset(features, ["Survived"],
                                      data_path=str(path), **kw)
        tds = ttitanic.TitanicDataset(features, ["Survived"],
                                      data_path=str(path),
                                      allow_synthetic=False, **kw)
        _bits_equal(tds.X, jds.X)
        assert np.array_equal(tds.y, jds.y)
    with pytest.raises(FileNotFoundError, match="allow_synthetic"):
        ttitanic.TitanicDataset(["Fare"], ["Survived"],
                                data_path=str(tmp_path / "missing.csv"),
                                allow_synthetic=False)


def _items_equal(got, want):
    assert len(got) == len(want)
    for i in (0, 1, len(want) - 1):
        (gx, gy), (wx, wy) = got[i], want[i]
        assert len(gx) == len(wx)
        for a, b in zip(gx, wx):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gy, wy)


def test_featurewise_joint_and_split_datasets_equal_jax():
    jds = jtitanic.TitanicDataset(["Fare", "Pclass", "Age", "Embarked"],
                                  ["Survived"])
    tds = ttitanic.TitanicDataset(["Fare", "Pclass", "Age", "Embarked"],
                                  ["Survived"])
    jfw, tfw = jds.featurewise_dataset(), tds.featurewise_dataset()
    assert tfw.partitions == jfw.partitions == [1, 1, 1, 1]
    _items_equal(tfw, jfw)
    jsplit, tsplit = jds.split_dataset([3, 1]), tds.split_dataset([3, 1])
    assert [d.partitions for d in tsplit] == [d.partitions for d in jsplit]
    for a, b in zip(tsplit, jsplit):
        _items_equal(a, b)
    _items_equal(tdataset.JointDatasets(tsplit),
                 jdataset.JointDatasets(jsplit))
    with pytest.raises(ValueError, match="same length"):
        tdataset.JointDatasets([tsplit[0], tdataset.Subset(tsplit[1], [0])])
    # The reference's message, operands swapped ("Expected" is the sum).
    with pytest.raises(ValueError) as want:
        jds.split_dataset([3, 3])
    with pytest.raises(ValueError) as got:
        tds.split_dataset([3, 3])
    assert str(got.value) == str(want.value) == \
        "Paritions sum doesn't match data dimension. Expected: 6, got: 4"


def test_mimic_featurewise_and_split_dataset(tmp_path, monkeypatch):
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    kw = dict(cache_root=str(tmp_path), synthetic_kwargs={"n_patients": 12})
    jds = jmimic.MIMICDataset(["de", "ts_ce"], ["Cardiomegaly"], **kw)
    tds = tmimic.MIMICDataset(["de", "ts_ce"], ["Cardiomegaly"], **kw)
    jfw, tfw = jds.featurewise_dataset(), tds.featurewise_dataset()
    assert tfw.partitions == jfw.partitions == [1] * tds.X.shape[1]
    _items_equal(tfw, jfw)
    for a, b in zip(tds.split_dataset(tds.partitions),
                    jds.split_dataset(jds.partitions)):
        assert a.partitions == b.partitions
        _items_equal(a, b)
