"""The native read of numeric CSV files (``data/native.py::read_csv_f64``
over ``native/csv.cpp``) and ``data/table.py::read_numeric_csv``, which
takes it first and the Python parse where it refuses a file, on the CPU.

``read_csv_f64`` is held against the JAX package's binding of the same
function on the same files. The JAX binding runs on the port's build of
the same sources (``native/csv.cpp``, ``native/packer.cpp``), so this file
never builds the JAX package's in-place library, which its own tests build.

Tolerance: none. Both readers round every field correctly (the native one
exactly for <= 15 significant digits and through ``strtod`` beyond, Python
through ``float``), so every number must be bit-equal and every NaN a NaN.
A NaN's sign is not compared: the Python parse reads ``-nan`` with its
sign where numpy converts the whole file and without it where a NaN
spelling sends the file through ``float``; the native reader keeps it.
"""
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multimodn_tpu.data import native as jnative
from multimodn_tpu_torch.data import mimic as tmimic
from multimodn_tpu_torch.data import native, table

SOURCES = ["de", "vd", "ts_ce"]
SYNTH = {"n_patients": 30}
TARGETS = ["Enlarged Cardiomediastinum", "Cardiomegaly"]

FILES = {
    "floats": "a,b,c\n0.1,-2.5e-07,3.0000000000000004\n1e+300,-0.0,5\n",
    "ids": "haim_id,x\n9007199254740993,1\n123456789012345678,-7\n",
    "nan_spellings": "a,b,c,d\n,NA,na,NaN\nnan,None,null,-nan\n",
    "crlf_blank_line": "a,b\r\n1.5,2\r\n3,4.25\r\n\n",
    "quoted": 'a,b\n"1",2\n',
    "ragged": "a,b\n1,2\n3\n",
    "not_a_number": "a,b\n1,N/A\n",
}


def _write(tmp_path, text, name="f.csv"):
    path = str(tmp_path / name)
    with open(path, "w", newline="") as f:
        f.write(text)
    return path


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


def _same(a, b):
    """Bit-equal numbers, NaN where the other is NaN."""
    nan = np.isnan(a)
    return a.shape == b.shape and np.array_equal(nan, np.isnan(b)) and \
        np.array_equal(_bits(a)[~nan], _bits(b)[~nan])


@pytest.fixture(autouse=True)
def _fresh_memo():
    table._NUMERIC_CACHE.clear()
    yield
    table._NUMERIC_CACHE.clear()


@pytest.mark.parametrize("name", sorted(FILES))
def test_read_csv_f64_matches_the_jax_binding(tmp_path, monkeypatch, name):
    path = _write(tmp_path, FILES[name])
    monkeypatch.setattr(jnative, "get_lib", native.get_lib)
    got, want = native.read_csv_f64(path), jnative.read_csv_f64(path)
    if want is None:
        assert got is None
        assert name in ("quoted", "ragged", "not_a_number")
        return
    assert got[1] == want[1]
    assert got[0].shape == want[0].shape
    assert np.array_equal(_bits(got[0]), _bits(want[0]))


_NAN_TOKENS = ["", "NaN", "nan", "NA", "None", "null", "-nan"]
_field = st.one_of(
    st.floats(allow_nan=False, width=64).map(repr),
    st.floats(allow_nan=False, width=32).map(
        lambda v: str(np.float32(v))),
    st.floats(min_value=-1e6, max_value=1e6).map(lambda v: f"{v:.6g}"),
    st.integers(-2 ** 64, 2 ** 64).map(str),
    st.sampled_from(_NAN_TOKENS),
)


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(rows=st.integers(1, 5).flatmap(lambda n: st.lists(
    st.lists(_field, min_size=n, max_size=n), min_size=1, max_size=6)))
def test_read_numeric_csv_is_bit_equal_to_the_python_parse(tmp_path, rows):
    text = ",".join(f"c{i}" for i in range(len(rows[0]))) + "\n" \
        + "".join(",".join(r) + "\n" for r in rows)
    path = _write(tmp_path, text)
    table._NUMERIC_CACHE.clear()
    assert native.read_csv_f64(path) is not None     # the native path
    header, values, _ = table.read_numeric_csv(path)
    py_values, py_header, _ = table._parse_numeric(path)
    assert header == py_header
    assert _same(values, py_values.T)


def test_write_csv_files_read_bit_equal(tmp_path):
    """What the protocol writes: float64 reprs up to 17 digits, float32
    columns, ``haim_id`` integers, NaN as an empty field."""
    rng = np.random.default_rng(0)
    cols = {"haim_id": rng.integers(0, 2 ** 53, 200),
            "f64": rng.normal(size=200)
            * 10.0 ** rng.integers(-30, 30, 200),
            "f32": rng.normal(size=200).astype(np.float32),
            "holes": np.where(rng.random(200) < 0.3, np.nan,
                              rng.random(200))}
    path = str(tmp_path / "data.csv")
    table.write_csv(path, cols)
    header, values, _ = table.read_numeric_csv(path)
    assert header == list(cols)
    assert _same(values, table._parse_numeric(path)[0].T)
    assert np.array_equal(values[0], cols["haim_id"].astype(np.float64))
    assert np.array_equal(values[2].astype(np.float32), cols["f32"])


@pytest.mark.parametrize("name", ["quoted", "ragged", "not_a_number"])
def test_files_the_native_reader_refuses_take_the_python_parse(tmp_path,
                                                              name):
    path = _write(tmp_path, FILES[name])
    assert native.read_csv_f64(path) is None
    header, values, _ = table.read_numeric_csv(path)
    py_values, py_header, _ = table._parse_numeric(path)
    assert header == py_header == ["a", "b"]
    assert _same(values, py_values.T)
    if name == "not_a_number":           # N/A is one of pandas' NaNs
        assert np.isnan(values[1, 0])
    if name == "ragged":                 # the short row is padded
        assert np.isnan(values[1, 1])


def test_na_reads_as_nan_as_the_native_reader_decides(tmp_path):
    """``na`` is not one of pandas' NaN spellings, so the Python parse
    refuses it; the native reader, which decides in the JAX package too,
    reads it as NaN."""
    path = _write(tmp_path, "a,b\n1,na\n2,3\n")
    _header, values, _ = table.read_numeric_csv(path)
    assert np.isnan(values[1, 0]) and values[1, 1] == 3.0
    with pytest.raises(ValueError):
        table._parse_numeric(path)


def test_minus_nan_reads_as_nan_with_its_sign(tmp_path):
    """``-nan`` is a number to ``strtod``: the native reader takes the file
    and keeps the sign, as the JAX package's reader does."""
    path = _write(tmp_path, "a\n-nan\nnan\n")
    assert native.read_csv_f64(path) is not None
    _header, values, _ = table.read_numeric_csv(path)
    assert np.isnan(values).all()
    assert np.signbit(values[0, 0]) and not np.signbit(values[0, 1])
    assert _same(values, table._parse_numeric(path)[0].T)


def test_read_csv_f64_refuses_or_raises(tmp_path):
    with pytest.raises(ValueError, match="cannot be read"):
        native.read_csv_f64(str(tmp_path / "missing.csv"))
    path = _write(tmp_path, "a,b\n1,x\n")
    assert native.read_csv_f64(path) is None
    values, columns = native.read_csv_f64(path, strict=False)
    assert columns == ["a", "b"]
    assert values[0, 0] == 1.0 and np.isnan(values[0, 1])


def test_the_parse_is_kept_per_file(tmp_path, monkeypatch):
    path = _write(tmp_path, "a,b\n1,2\n")
    calls = []
    read = native.read_csv_f64
    monkeypatch.setattr(native, "read_csv_f64",
                        lambda p: calls.append(p) or read(p))
    first = table.read_numeric_csv(path)[1]
    assert table.read_numeric_csv(path)[1] is first
    assert not first.flags.writeable
    _write(tmp_path, "a,b\n1,2\n3,4\n")
    assert table.read_numeric_csv(path)[1].shape == (2, 2)
    assert calls == [path, path]


def test_the_parse_is_kept_per_reader(tmp_path, monkeypatch):
    """A file read natively and through the Python parse (the library
    unavailable) keeps both readings, and neither serves the other: only
    the Python parse returns the columns pandas reads as int64."""
    path = _write(tmp_path, "a,b,c\n1,2.5,-3\n4,,5\n")
    header, values, integers = table.read_numeric_csv(path)
    assert header == ["a", "b", "c"] and integers == {}
    monkeypatch.setattr(table, "READERS", {})
    monkeypatch.setattr(native, "get_lib", lambda: (_ for _ in ()).throw(
        OSError("no library")))
    with pytest.warns(RuntimeWarning, match="Python parser"):
        _h, py_values, py_integers = table.read_numeric_csv(path)
    assert sorted(py_integers) == ["a", "c"]
    assert py_integers["a"].dtype == np.int64
    assert np.array_equal(py_integers["c"], [-3, 5])
    assert _same(values, py_values) and py_values is not values
    monkeypatch.undo()
    assert table.read_numeric_csv(path)[1] is values
    assert len(table._NUMERIC_CACHE) == 2


def _python_only(monkeypatch):
    monkeypatch.setattr(native, "read_csv_f64", lambda path: None)


def test_mimic_cache_loads_bit_equal_to_the_python_parse(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    root = str(tmp_path / "cache")
    reads = []
    read = native.read_csv_f64
    monkeypatch.setattr(native, "read_csv_f64",
                        lambda p: reads.append(p) or read(p))
    fast = tmimic._load_mimic_full(TARGETS, SOURCES, cache_root=root,
                                   synthetic_kwargs=SYNTH)
    assert any(p.endswith("data.csv") for p in reads)
    assert all(read(p) is not None for p in reads)
    table._NUMERIC_CACHE.clear()
    _python_only(monkeypatch)
    slow = tmimic._load_mimic_full(TARGETS, SOURCES, cache_root=root,
                                   synthetic_kwargs=SYNTH)
    for a, b in zip(fast[:2], slow[:2]):
        assert _same(a, b)
    assert fast[2:4] == slow[2:4]
    assert _same(fast[4], slow[4])


def test_single_target_cache_is_byte_equal_either_way(tmp_path, monkeypatch):
    """The single-target cache is derived from the two-target one through
    ``read_numeric_csv``. Each reader writes what the JAX package's
    reader of its kind writes (``tests/test_torch_mimic_data.py`` holds
    the files byte for byte): the native read every column as float64, the
    Python parse the columns of integers as int64, as ``pd.read_csv``
    does. So the files hold the same numbers, and they are byte-equal once
    the Python parse's integer columns are written as floats."""
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    paths = []
    for name in ("native", "python"):
        if name == "python":
            table._NUMERIC_CACHE.clear()
            _python_only(monkeypatch)
        cache = tmimic.build_mimic_cache(["Cardiomegaly"], SOURCES,
                                         str(tmp_path / name), SYNTH)
        paths.append(os.path.join(cache, "data.csv"))
    fast, slow = table.read_csv(paths[0]), table.read_csv(paths[1])
    integers = [c for c, v in slow.items() if v.dtype.kind == "i"]
    assert {"Cardiomegaly", "haim_id", "de_1_1"} <= set(integers)
    assert all(fast[c].dtype == np.float64 for c in fast)
    as_floats = str(tmp_path / "as_floats.csv")
    table.write_csv(as_floats, {c: v.astype(np.float64) for c, v in
                                slow.items()})
    with open(paths[0]) as a, open(as_floats) as b:
        assert a.read() == b.read()


def test_cache_read_without_a_compiler(tmp_path, monkeypatch):
    """No ``g++`` and an empty build directory: the native library cannot
    be built, so the MIMIC cache files take the Python parse, with a
    warning and a record of which reader ran, and load as the native read
    loads them. ``data/disk.py`` still has no fallback."""
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    root = str(tmp_path / "cache")
    fast_readers = {}
    monkeypatch.setattr(table, "READERS", fast_readers, raising=False)
    fast = tmimic._load_mimic_full(TARGETS, SOURCES, cache_root=root,
                                   synthetic_kwargs=SYNTH)
    table._NUMERIC_CACHE.clear()
    monkeypatch.setattr(table, "READERS", {}, raising=False)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.warns(RuntimeWarning, match="Python parser"):
        slow = tmimic._load_mimic_full(TARGETS, SOURCES, cache_root=root,
                                       synthetic_kwargs=SYNTH)
    assert set(fast_readers.values()) == {"native"}
    assert table.READERS and all(
        r.startswith("python: the native library is unavailable")
        for r in table.READERS.values())
    for a, b in zip(fast[:2], slow[:2]):
        assert _same(a, b)
    assert fast[2:4] == slow[2:4]
    assert _same(fast[4], slow[4])
    with pytest.raises(OSError):
        native.get_lib()
