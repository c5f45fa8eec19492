"""The port's native bridge and disk-backed loaders on the CPU: the bridge
builds from ``native/*.cpp`` under ``build/native/`` (two processes at once
build one library and never touch ``native/build/``); the native CSV index
and reads against a numpy parse, ``strict``, shuffled ``rows=`` views; the
``.npy`` memmap loader; the export round trip; batches against the port's
``StreamingLoader`` and the JAX package's memmap loader, and training over
them bit-equal to a ``StreamingLoader``'s.

These tests build the port's own library only; they never load the JAX
package's native library.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import (CSVStreamingLoader, NpyStreamingLoader,
                                      PartitionDataset, StreamingLoader,
                                      Subset, export_streaming_matrix,
                                      train_epoch_streaming)
from multimodn_tpu_torch.data import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS, N_TARGETS = [3, 5, 2], 2
NAN_CELLS = {(4, 1), (17, 9), (30, 0)}


def _write_csv(path, X, y, nan_cells=(), bad_cells=()):
    """One header row; ``nan_cells`` empty, ``bad_cells`` unparseable."""
    cols = [f"f{i}" for i in range(X.shape[1])] + \
        [f"t{j}" for j in range(y.shape[1])]
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(X.shape[0]):
            cells = ["" if (i, j) in nan_cells else
                     "oops" if (i, j) in bad_cells else repr(float(v))
                     for j, v in enumerate(X[i])]
            f.write(",".join(cells + [str(int(t)) for t in y[i]]) + "\n")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(53, sum(WIDTHS))).astype(np.float32)
    y = rng.integers(0, 2, size=(53, N_TARGETS))
    Xn = X.copy()
    for i, j in NAN_CELLS:
        Xn[i, j] = np.nan
    return Xn, y


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory, data):
    X, y = data
    path = tmp_path_factory.mktemp("disk") / "data.csv"
    _write_csv(str(path), np.nan_to_num(X), y, nan_cells=NAN_CELLS)
    return str(path)


def _dataset(data):
    X, y = data
    return PartitionDataset(X, y, WIDTHS)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for (gd, gt, gm), (wd, wt, wm) in zip(got, want):
        assert len(gd) == len(wd)
        for a, b in zip(gd, wd):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gm, wm)


# --------------------------------------------------------------------------
# The bridge
# --------------------------------------------------------------------------

def test_bridge_builds_under_build_native():
    path = native.library_path()
    assert path.startswith(os.path.join(ROOT, "build", "native") + os.sep)
    jax_build = os.path.join(ROOT, "native", "build")
    before = sorted(os.listdir(jax_build)) if os.path.isdir(jax_build) \
        else None
    assert native.get_lib() is native.get_lib()
    assert os.path.exists(path)
    after = sorted(os.listdir(jax_build)) if os.path.isdir(jax_build) \
        else None
    assert after == before


def test_bridge_built_by_two_processes_at_once(tmp_path):
    """Two processes build into one fresh directory at once: the lock and
    the atomic move leave one library both load, and no temporary file."""
    script = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[2])
        from multimodn_tpu_torch.data import native
        native.BUILD_DIR = sys.argv[1]
        lib = native.get_lib()
        print(native.library_path())
    """)
    build = str(tmp_path / "native")
    procs = [subprocess.Popen([sys.executable, "-c", script, build, ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    (path,) = paths
    assert os.path.dirname(path) == build
    assert sorted(os.listdir(build)) == ["build.lock",
                                         os.path.basename(path)]


def test_bridge_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (str(bad),))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build_library()
    assert os.listdir(tmp_path / "b") == ["build.lock"]


# --------------------------------------------------------------------------
# Native CSV reads
# --------------------------------------------------------------------------

def test_csv_index_and_reads_match_a_numpy_parse(csv_path, data):
    X, y = data
    want = np.genfromtxt(csv_path, delimiter=",", skip_header=1)
    n_rows, n_cols, off = native.csv_index(csv_path)
    assert (n_rows, n_cols) == X.shape[:1] + (sum(WIDTHS) + N_TARGETS,)
    with open(csv_path, "rb") as f:
        raw = f.read()
    assert raw[off[0] - 1:off[0]] == b"\n" and off[-1] == len(raw)
    block = native.csv_read_block(csv_path, int(off[5]), int(off[12]), 7,
                                  n_cols)
    np.testing.assert_array_equal(block, want[5:12])
    idx = np.array([40, 3, 17, 17, 0])
    rows = native.csv_read_rows(csv_path, np.stack([off[idx],
                                                    off[idx + 1]], 1),
                                n_cols)
    np.testing.assert_array_equal(rows, want[idx])
    assert np.isnan(rows[2, 9])


def test_csv_strict_and_unreadable_files(tmp_path, data):
    X, y = data
    path = str(tmp_path / "bad.csv")
    _write_csv(path, np.nan_to_num(X[:10]), y[:10], bad_cells={(2, 4)})
    with pytest.raises(ValueError, match="does not parse"):
        list(CSVStreamingLoader(path, WIDTHS, N_TARGETS, 4).iter_batches())
    # strict=False maps the field to NaN; there is no pandas fallback that
    # could ignore the flag (as the JAX package's does).
    batches = list(CSVStreamingLoader(path, WIDTHS, N_TARGETS, 4,
                                      strict=False).iter_batches())
    modality = batches[0][0][1]          # columns 3-7 of rows 0-3
    assert np.isnan(modality[2, 1])
    assert np.isfinite(np.delete(modality, 2, axis=0)).all()
    quoted = tmp_path / "quoted.csv"
    quoted.write_text('a,b\n"1",2\n')
    with pytest.raises(ValueError, match="quoted"):
        CSVStreamingLoader(str(quoted), [1], 1)
    with pytest.raises(ValueError, match="cannot be read"):
        CSVStreamingLoader(str(tmp_path / "missing.csv"), [1], 1)


@pytest.mark.parametrize("batch", [16, 53, 7])
def test_csv_loader_batches_equal_streaming(csv_path, data, batch):
    _assert_batches_equal(
        CSVStreamingLoader(csv_path, WIDTHS, N_TARGETS, batch).iter_batches(),
        StreamingLoader(_dataset(data), batch).iter_batches())


def test_shuffled_row_views_equal_streaming_subsets(csv_path, data, tmp_path):
    """rows= makes a loader a view of those source rows; shuffled views
    reshuffle like a StreamingLoader of the same seed over those rows."""
    rows = np.random.default_rng(1).permutation(53)[:30]
    npy, *_ = export_streaming_matrix(_dataset(data), str(tmp_path / "m.npy"))
    loaders = [CSVStreamingLoader(csv_path, WIDTHS, N_TARGETS, 8,
                                  shuffle=True, seed=3, rows=rows),
               NpyStreamingLoader(npy, WIDTHS, N_TARGETS, 8, shuffle=True,
                                  seed=3, rows=rows)]
    ref = StreamingLoader(Subset(_dataset(data), rows), 8, shuffle=True,
                          seed=3)
    for _ in range(2):
        ref.reshuffle()
        want = list(ref.iter_batches())
        for ldr in loaders:
            ldr.reshuffle()
            _assert_batches_equal(ldr.iter_batches(), want)


# --------------------------------------------------------------------------
# Memmap loader and export
# --------------------------------------------------------------------------

def test_export_round_trip_and_npy_loader(data, tmp_path):
    ds = _dataset(data)
    path, widths, n_targets = export_streaming_matrix(
        ds, str(tmp_path / "m.npy"), chunk_rows=10)
    assert (widths, n_targets) == (WIDTHS, N_TARGETS)
    m = np.load(path, mmap_mode="r")
    assert isinstance(m, np.memmap) and m.dtype == np.float32
    X, y = data
    np.testing.assert_array_equal(m[:, :sum(WIDTHS)], X)
    np.testing.assert_array_equal(m[:, sum(WIDTHS):], y)
    for batch in (16, 0):
        _assert_batches_equal(
            NpyStreamingLoader(path, WIDTHS, N_TARGETS, batch).iter_batches(),
            StreamingLoader(ds, batch).iter_batches())
    with pytest.raises(ValueError, match="empty"):
        export_streaming_matrix(Subset(ds, []), str(tmp_path / "e.npy"))
    with pytest.raises(ValueError, match="chunk_rows"):
        export_streaming_matrix(ds, str(tmp_path / "c.npy"), chunk_rows=0)


@pytest.mark.parametrize("shuffle", [False, True])
def test_disk_batches_equal_jax_npy_loader(csv_path, data, tmp_path,
                                           shuffle):
    """The JAX package's memmap loader (no native build) over the same
    matrix and rows yields the same batches as both of the port's loaders
    (its targets int32, the port's int64)."""
    from multimodn_tpu.data.disk import NpyStreamingLoader as JNpy
    npy, *_ = export_streaming_matrix(_dataset(data), str(tmp_path / "m.npy"))
    rows = np.arange(53)[::2]
    kw = dict(shuffle=shuffle, seed=4, rows=rows)
    theirs = JNpy(npy, WIDTHS, N_TARGETS, 8, **kw)
    mine = [NpyStreamingLoader(npy, WIDTHS, N_TARGETS, 8, **kw),
            CSVStreamingLoader(csv_path, WIDTHS, N_TARGETS, 8, **kw)]
    for _ in range(2):
        theirs.reshuffle()
        want = list(theirs.iter_batches())
        for ldr in mine:
            ldr.reshuffle()
            _assert_batches_equal(ldr.iter_batches(), want)


def test_layout_guards(csv_path, data, tmp_path):
    with pytest.raises(ValueError, match="columns"):
        CSVStreamingLoader(csv_path, [3, 5, 5], N_TARGETS)
    with pytest.raises(ValueError, match="positive"):
        CSVStreamingLoader(csv_path, [3, 0], N_TARGETS)
    with pytest.raises(ValueError, match="n_targets"):
        CSVStreamingLoader(csv_path, WIDTHS, 0)
    with pytest.raises(ValueError, match="out of range"):
        CSVStreamingLoader(csv_path, WIDTHS, N_TARGETS, rows=[0, 53])
    with pytest.raises(ValueError, match="2-D"):
        NpyStreamingLoader(np.zeros(4, np.float32), [1], 1)
    X, y = data
    bad = np.concatenate([np.nan_to_num(X), y.astype(np.float32)], axis=1)
    bad[3, -1] = np.nan
    with pytest.raises(ValueError, match="non-finite target"):
        list(NpyStreamingLoader(bad, WIDTHS, N_TARGETS, 8).iter_batches())


def test_training_from_disk_equals_streaming(csv_path, data):
    """An epoch over the CSV rows trains bit-equal to a StreamingLoader
    over the same rows (NaN cells included)."""
    def model():
        return tmm.MultiModN(4, [tenc.MIMICMLPEncoder(4, w, (6,))
                                 for w in WIDTHS],
                             [tdec.MLPDecoder(4, (6,), 2)
                              for _ in range(N_TARGETS)], 1.0, 0.2,
                             device="cpu")

    a, b = model(), model()
    sa = train_epoch_streaming(a, StreamingLoader(_dataset(data), 16),
                               tmm.Adam8bit(1e-2))
    sb = train_epoch_streaming(b, CSVStreamingLoader(csv_path, WIDTHS,
                                                     N_TARGETS, 16),
                               tmm.Adam8bit(1e-2))
    np.testing.assert_array_equal(sa["loss"], sb["loss"])
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
