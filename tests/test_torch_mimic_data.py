"""The port's MIMIC data layer against the JAX package on the CPU: the
synthetic table, the on-disk cache (each package reads the other's),
``MIMICDataset`` with every option, ``random_split`` and the real-CSV path.

Tolerances: the synthetic columns are bit-equal (the same numpy stream).
The caches are byte-equal files, since both packages write each value's
shortest round-trip text. ``MIMICDataset.X`` is compared bit for bit after
the float32 cast: both parse the cache with correctly rounded float64 and
standardise with scikit-learn's float64 sums (the port's copy of the
scaler is bit-equal to scikit-learn's, ``tests/test_torch_kfold.py``). On
the real-CSV path the JAX package parses the raw file with pandas, whose float parser
can differ from a correctly rounded one by 1 float64 ulp; there X may
differ by at most 1 float32 ulp (and in this test's file it does not).

Each package reads a cache file through one of two readers: the JAX
package through its native reader or, where that fails, ``pd.read_csv``
(which reads a column of integers as int64); the port through its native
reader or its Python parse, which mirrors pandas. Every test that reads a
cache runs once per ``reader`` with both packages pinned to it: the JAX
package's ``read_csv_f64`` replaced by the port's binding of the same
``native/csv.cpp`` (so no test builds the JAX package's in-place library)
or made to raise, the port's ``native.get_lib`` left alone or made to
raise.
"""
import contextlib
import os
import warnings

import numpy as np
import pytest

from multimodn_tpu.data import mimic as jmimic
from multimodn_tpu.data import native as jnative
from multimodn_tpu.data import synth as jsynth
from multimodn_tpu_torch.data import mimic as tmimic
from multimodn_tpu_torch.data import native as tnative
from multimodn_tpu_torch.data import synth as tsynth
from multimodn_tpu_torch.data import table as ttable
from multimodn_tpu_torch.data.table import format_column, read_csv, write_csv

SOURCES = ["de", "vd", "ts_ce"]
SYNTH = {"n_patients": 40}
TARGETS = ["Enlarged Cardiomediastinum", "Cardiomegaly"]


@pytest.fixture(autouse=True)
def _synthetic_only(monkeypatch):
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)


READERS = ("native", "python")


def _refuse(path):
    raise RuntimeError("this test pins the JAX package to pd.read_csv")


def _no_library():
    raise OSError("this test pins the port to its Python parse")


@contextlib.contextmanager
def pinned(reader):
    """Both packages read cache files through ``reader``: ``native`` (the
    port's library, built at need; the case skips where it cannot be
    built) or ``python`` (pandas in the JAX package, the Python parse in
    the port)."""
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        if reader == "native":
            try:
                tnative.get_lib()
            except (OSError, RuntimeError) as exc:
                pytest.skip(f"the port's native library cannot be built "
                            f"here: {exc}")
            mp.setattr(jnative, "read_csv_f64", tnative.read_csv_f64)
        else:
            mp.setattr(jnative, "read_csv_f64", _refuse)
            mp.setattr(tnative, "get_lib", _no_library)
            warnings.filterwarnings("ignore", "reading the MIMIC cache",
                                    RuntimeWarning)
        mp.setattr(ttable, "READERS", {})
        yield
        took = "native" if reader == "native" else "python: the native"
        assert all(r.startswith(took) for r in ttable.READERS.values())


@pytest.fixture(scope="module", params=READERS)
def reader(request):
    return request.param


@pytest.fixture
def pin(reader):
    """The test's reads go through ``reader`` in both packages."""
    with pinned(reader):
        yield reader


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory, reader):
    """One cache root built by the JAX package through ``reader``, shared
    by the dataset tests of that reader."""
    root = str(tmp_path_factory.mktemp(f"jax_cache_{reader}"))
    with pinned(reader):
        for targets in (TARGETS, ["Cardiomegaly"]):
            jmimic.build_mimic_cache(targets, SOURCES, root, SYNTH)
    return root


def _bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    assert same.all(), f"{(~same).sum()} elements differ"


@pytest.mark.parametrize("kwargs", [
    {"n_patients": 40},
    {"n_patients": 25, "max_stays_per_patient": 5, "seed": 7,
     "targets": ["Cardiomegaly", "Edema"], "sources": ["ts_ce", "vd", "de"]},
], ids=["default", "custom"])
def test_synthetic_columns_bit_equal(kwargs):
    frame = jsynth.synthetic_mimic_embeddings(**kwargs)
    table = tsynth.synthetic_mimic_embeddings(**kwargs)
    assert list(frame.columns) == list(table)
    for name in frame.columns:
        want = frame[name].to_numpy()
        if name == "img_charttime":
            want = want.astype("datetime64[h]")
        got = table[name]
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


def test_synthetic_constants_match():
    assert tsynth.MIMIC_SOURCE_DICT == jsynth.MIMIC_SOURCE_DICT
    assert tsynth.MIMIC_SOURCE_NAMES == jsynth.MIMIC_SOURCE_NAMES
    assert tsynth.MIMIC_DEFAULT_TARGETS == jsynth.MIMIC_DEFAULT_TARGETS
    assert tsynth.SYNTH_MIMIC_VERSION == jsynth.SYNTH_MIMIC_VERSION


@pytest.mark.parametrize("targets", [TARGETS, ["Cardiomegaly"]],
                         ids=["joint", "single"])
def test_caches_are_byte_equal(tmp_path, pin, targets):
    """Built in separate roots, both packages write the same directory
    layout and the same bytes (a single-target cache derives from the joint
    one in both, through the reader pinned: the integer columns read by
    pandas and by the Python parse are written as integers)."""
    jdir = jmimic.build_mimic_cache(targets, SOURCES, str(tmp_path / "j"),
                                    SYNTH)
    tdir = tmimic.build_mimic_cache(targets, SOURCES, str(tmp_path / "t"),
                                    SYNTH)
    assert os.path.relpath(jdir, tmp_path / "j") == \
        os.path.relpath(tdir, tmp_path / "t")
    for name in ("data.csv", "how_to_split.csv"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    if len(targets) == 1:
        with open(os.path.join(tdir, "data.csv")) as f:
            last = f.readlines()[1].rstrip().rsplit(",", 2)[1:]
        assert all(("." in v) == (pin == "native") for v in last), last


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_of_one_package_serves_the_other(tmp_path, pin, writer):
    root = str(tmp_path)
    build = jmimic.build_mimic_cache if writer == "jax" \
        else tmimic.build_mimic_cache
    build(TARGETS, SOURCES, root, SYNTH)
    stamp = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            stamp[os.path.join(dirpath, f)] = os.stat(
                os.path.join(dirpath, f)).st_mtime_ns
    jds = jmimic.MIMICDataset(SOURCES, TARGETS, cache_root=root,
                              synthetic_kwargs=SYNTH)
    tds = tmimic.MIMICDataset(SOURCES, TARGETS, cache_root=root,
                              synthetic_kwargs=SYNTH)
    # Neither package rebuilt the other's files.
    for path, mtime in stamp.items():
        assert os.stat(path).st_mtime_ns == mtime, path
    _bits_equal(tds.X, jds.X)
    assert tds.y.dtype == jds.y.dtype and np.array_equal(tds.y, jds.y)
    assert tds.haim_ids().dtype == jds.haim_ids().dtype
    assert np.array_equal(tds.haim_ids(), jds.haim_ids())


DATASET_CASES = {
    "multi": dict(targets=TARGETS),
    "single": dict(targets=["Cardiomegaly"]),
    "nanfill": dict(targets=["Cardiomegaly"], nanfill=True),
    "no_std": dict(targets=TARGETS, std=False),
    "dropna": dict(targets=["Cardiomegaly"], dropna=True, put_none=True,
                   indices_to_nan=[1, 3, 5, 3], features_to_nan=["vd_0"]),
    "put_none_list": dict(targets=["Cardiomegaly"], put_none=True,
                          indices_to_nan=[0, 2, 7],
                          features_to_nan=[f"vd_{k}" for k in range(1024)]),
    "put_none_list_nanfill": dict(targets=["Cardiomegaly"], put_none=True,
                                  nanfill=True, indices_to_nan=[0, 2, 7],
                                  features_to_nan=["vd_0", "vd_5"]),
    "put_none_string": dict(targets=TARGETS, put_none=True,
                            indices_to_nan=[4, 9], features_to_nan="ts_ce_3"),
    "put_none_demo": dict(targets=TARGETS, put_none=True,
                          indices_to_nan=[1, 6], features_to_nan="demo"),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_mimic_dataset_matches_jax(jax_root, pin, case):
    kw = DATASET_CASES[case]
    jds = jmimic.MIMICDataset(SOURCES, cache_root=jax_root,
                              synthetic_kwargs=SYNTH, **kw)
    tds = tmimic.MIMICDataset(SOURCES, cache_root=jax_root,
                              synthetic_kwargs=SYNTH, **kw)
    _bits_equal(tds.X, jds.X)
    assert tds.y.dtype == jds.y.dtype and np.array_equal(tds.y, jds.y)
    assert tds.y.dtype == (np.float64 if pin == "native" else np.int64)
    assert tds.haim_ids().dtype == jds.haim_ids().dtype
    assert np.array_equal(tds.haim_ids(), jds.haim_ids())
    assert tds.partitions == jds.partitions == [10, 1024, 99]
    assert tds.features == jds.features
    assert tds.cache_dir == jds.cache_dir
    pds = tds.partition_dataset(tds.partitions)
    assert [x.shape[1] for x in pds.X] == [10, 1024, 99]
    assert len(tds) == len(jds) and np.array_equal(tds[3][0], jds[3][0])


def test_load_mimic_data_matches_jax(jax_root, pin):
    jd, jl, jf, jp = jmimic.load_mimic_data(TARGETS, SOURCES,
                                            cache_root=jax_root,
                                            synthetic_kwargs=SYNTH)
    td, tl, tf, tp = tmimic.load_mimic_data(TARGETS, SOURCES,
                                            cache_root=jax_root,
                                            synthetic_kwargs=SYNTH)
    assert np.array_equal(td, jd.to_numpy()) and np.array_equal(
        tl, jl.to_numpy())
    assert tf == jf and tp == jp


def test_patient_split_table_matches_jax(jax_root, pin):
    jds = jmimic.MIMICDataset(SOURCES, ["Cardiomegaly"], cache_root=jax_root,
                              synthetic_kwargs=SYNTH)
    tds = tmimic.MIMICDataset(SOURCES, ["Cardiomegaly"], cache_root=jax_root,
                              synthetic_kwargs=SYNTH)
    want = jds.patient_split_table()
    got = tds.patient_split_table()
    assert list(got) == list(want.columns)
    for name in want.columns:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name].to_numpy()), name


@pytest.mark.parametrize("features, match", [
    ("demo", "no demographic"),
    (["vd_0", "nope_1"], "unknown feature columns"),
])
def test_put_none_key_errors(jax_root, pin, features, match):
    sources = ["vd", "ts_ce"] if features == "demo" else SOURCES
    for mod in (jmimic, tmimic):
        with pytest.raises(KeyError, match=match):
            mod.MIMICDataset(sources, ["Cardiomegaly"], put_none=True,
                             indices_to_nan=[0], features_to_nan=features,
                             cache_root=jax_root, synthetic_kwargs=SYNTH)


@pytest.mark.parametrize("balanced", [None, 0])
def test_random_split_lists_equal(jax_root, pin, balanced):
    jds = jmimic.MIMICDataset(SOURCES, TARGETS, cache_root=jax_root,
                              synthetic_kwargs=SYNTH)
    tds = tmimic.MIMICDataset(SOURCES, TARGETS, cache_root=jax_root,
                              synthetic_kwargs=SYNTH)
    for seed in (0, 3):
        want = jds.random_split((0.6, 0.2, 0.2), seed, balanced)
        got = tds.random_split((0.6, 0.2, 0.2), seed, balanced)
        assert got == want and isinstance(got[0], list)


def _write_real_csv(path, rng):
    """A small HAIM-format file: de_1..de_5, ts_ce block, two targets
    (with -1 and empty labels to filter), a duplicated (img_id, time) row
    and a line with one field too many."""
    header = (["haim_id", "img_id", "img_charttime"]
              + [f"de_{j}" for j in range(1, 6)]
              + [f"ts_ce_{i}" for i in range(99)] + TARGETS)
    lines = [",".join(header)]
    for r in range(30):
        labels = [str(rng.integers(0, 2)), str(rng.integers(0, 2))]
        if r == 4:
            labels[0] = "-1.0"
        if r == 9:
            labels[1] = ""
        row = ([str(r // 2), str(500 + r), f"2150-03-0{1 + r % 5} 10:00:00"]
               + [str(rng.integers(0, 3)) for _ in range(5)]
               + [repr(float(v)) for v in rng.normal(size=99)] + labels)
        lines.append(",".join(row))
        if r == 6:
            lines.append(",".join(row))               # duplicate
        if r == 11:
            lines.append(",".join(row + ["extra"]))   # bad line
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_real_csv_path(tmp_path, monkeypatch, pin):
    csv_path = tmp_path / "embeddings.csv"
    _write_real_csv(csv_path, np.random.default_rng(0))
    monkeypatch.setenv("MULTIMODN_MIMIC_EMBED_PATH", str(csv_path))
    sources = ["de", "ts_ce"]
    for targets in (TARGETS, ["Cardiomegaly"]):
        jds = jmimic.MIMICDataset(sources, targets,
                                  cache_root=str(tmp_path / "j"))
        tds = tmimic.MIMICDataset(sources, targets,
                                  cache_root=str(tmp_path / "t"))
        # 31 data lines: the duplicate goes, the bad line is skipped, and
        # the -1 and empty labels are filtered out.
        assert len(jds) == len(tds) == 28
        ulps = np.abs(tds.X.view(np.int32).astype(np.int64)
                      - jds.X.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
        assert np.array_equal(tds.y, jds.y)
        assert np.array_equal(tds.haim_ids(), jds.haim_ids())
        assert tds.features == jds.features
        assert tds.partitions == jds.partitions == [10, 99]


@pytest.mark.parametrize("values", [
    np.array([0.1, 1 / 3, 1e-7, 123456.78, -0.0, 3e38, np.nan], np.float32),
    np.array([0.1, 1 / 3, 1e-7, 1e16, -0.0, 1e-5, np.nan]),
    np.arange(-3, 4),
    np.array([True, False, True]),
    np.array(["a b", "x,y", None, 'q"uote'], dtype=object),
], ids=["float32", "float64", "int", "bool", "object"])
def test_csv_text_is_pandas(tmp_path, values):
    import pandas as pd
    path = str(tmp_path / "t.csv")
    write_csv(path, {"c": values, "i": np.arange(len(values))})
    want = pd.DataFrame({"c": values, "i": np.arange(len(values))}) \
        .to_csv(index=False)
    with open(path) as f:
        assert f.read() == want
    assert format_column(values)[0] == want.splitlines()[1].rsplit(",", 1)[0]
    back = read_csv(path)
    frame = pd.read_csv(path)
    for name in ("c", "i"):
        assert back[name].dtype == frame[name].to_numpy().dtype
