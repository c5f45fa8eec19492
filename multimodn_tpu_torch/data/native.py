"""ctypes bridge to the repository's framework-free C++ data sources,
``native/csv.cpp`` (the numeric CSV reader: whole files, and the
bounded-memory row reads) and ``native/packer.cpp``, for the MIMIC cache
files (``data/table.py::read_numeric_csv``) and the disk-backed loaders
(``data/disk.py``).

The library is built from those sources with ``g++`` at first use into
``<repo>/build/native/`` (listed in ``.gitignore``), named by a hash of the
sources and the flags so that an edited source rebuilds. The build runs
under an exclusive ``fcntl`` lock, writes a temporary file and moves it into
place with ``os.replace``, so processes that build at once never load a
half-written library. Nothing falls back: a missing compiler or a failed
build raises with the compiler's output, and a file the reader cannot take
raises with the reader's reason; only ``read_csv_f64`` returns None for
the files a general CSV parser must read instead.

``native/csv.cpp`` seeks through ``long``, which is 64-bit on the LP64
hosts this package runs on (x86-64 and aarch64 Linux), so offsets past
2 GiB are exact; the module refuses to load on a host where ``long`` is
narrower.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = (os.path.join(REPO, "native", "packer.cpp"),
           os.path.join(REPO, "native", "csv.cpp"))
BUILD_DIR = os.path.join(REPO, "build", "native")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

# csv_dims / csv_index / csv_read_*_f64 return codes (native/csv.cpp).
_REASONS = {1: "the file cannot be read", 2: "it holds a quoted field",
            3: "its rows have different numbers of fields",
            4: "a field does not parse as a number (strict=True; "
               "strict=False reads it as NaN)",
            5: "the row index overflowed", 6: "it holds fewer rows than "
                                              "indexed (the file changed)"}

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the sources build to: named by a hash of the sources, the flags
    and the host's architecture."""
    digest = hashlib.sha256(
        " ".join([CXX, platform.machine()] + CXX_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libmmn_native-{digest.hexdigest()[:16]}"
                                   f".so")


def build_library() -> str:
    """Compile the sources (once per content, one process at a time) and
    return the library's path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):        # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, *SOURCES],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{CXX} failed on {', '.join(SOURCES)}:\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            if ctypes.sizeof(ctypes.c_long) < 8:
                raise RuntimeError(
                    "native/csv.cpp seeks through long, which is narrower "
                    "than 64 bits on this host")
            lib = ctypes.CDLL(build_library())
            i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.csv_index.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i64]
            lib.csv_index.restype = i64
            lib.csv_read_block_f64.argtypes = [ctypes.c_char_p, i64, i64,
                                               i64, i64, f64p, i64]
            lib.csv_read_block_f64.restype = i64
            lib.csv_read_rows_f64.argtypes = [ctypes.c_char_p, i64p, i64,
                                              i64, f64p, i64]
            lib.csv_read_rows_f64.restype = i64
            lib.csv_dims.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
            lib.csv_dims.restype = i64
            lib.csv_read_f64.argtypes = [ctypes.c_char_p, f64p, i64, i64,
                                         ctypes.c_char_p, i64, i64]
            lib.csv_read_f64.restype = i64
            _lib = lib
    return _lib


def _check(rc: int, what: str, path: str):
    if rc != 0:
        raise ValueError(f"native CSV reader, {what} of {path}: "
                         f"{_REASONS.get(rc, f'error {rc}')}")


def csv_index(path: str):
    """Byte offsets of every data row of a numeric CSV with one header row,
    from one streaming pass with a 1 MiB buffer: ``(n_rows, n_cols,
    offsets)``, ``offsets`` (n_rows + 1,) int64, row i being bytes
    ``offsets[i]:offsets[i + 1]``."""
    lib = get_lib()
    n_rows, n_cols = ctypes.c_int64(0), ctypes.c_int64(0)
    _check(lib.csv_index(path.encode(), ctypes.byref(n_rows),
                         ctypes.byref(n_cols), None, 0), "index", path)
    offsets = np.empty(n_rows.value + 1, np.int64)
    _check(lib.csv_index(path.encode(), ctypes.byref(n_rows),
                         ctypes.byref(n_cols),
                         offsets.ctypes.data_as(
                             ctypes.POINTER(ctypes.c_int64)),
                         n_rows.value), "index", path)
    return n_rows.value, n_cols.value, offsets


def csv_read_block(path: str, byte_start: int, byte_end: int, n_rows: int,
                   n_cols: int, strict: bool = True) -> np.ndarray:
    """One contiguous block of ``n_rows`` rows as an (n_rows, n_cols)
    float64 matrix; empty and NA cells read as NaN."""
    out = np.empty((n_rows, n_cols), np.float64)
    _check(get_lib().csv_read_block_f64(
        path.encode(), byte_start, byte_end, n_rows, n_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(strict)),
        "a block read", path)
    return out


def csv_read_rows(path: str, spans: np.ndarray, n_cols: int,
                  strict: bool = True) -> np.ndarray:
    """Rows at the (k, 2) byte ``spans``, in their order, as a (k, n_cols)
    float64 matrix."""
    spans = np.ascontiguousarray(spans, np.int64)
    out = np.empty((spans.shape[0], n_cols), np.float64)
    _check(get_lib().csv_read_rows_f64(
        path.encode(), spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        spans.shape[0], n_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(strict)),
        "a row read", path)
    return out


# What read_csv_f64 leaves to a general parser: a quoted field, ragged
# rows, a field that is not a number.
_NOT_NUMERIC = (2, 3, 4)


def read_csv_f64(path: str, strict: bool = True):
    """A numeric CSV file with one header row, read whole in one pass
    (``csv_dims``, then ``csv_read_f64``): ``(matrix (n, f) float64,
    column names)``. Empty, ``NA``, ``na``, ``NaN``, ``nan``, ``None`` and
    ``null`` fields read as NaN; a field of at most 15 significant digits
    parses exactly, a longer one through the C library's ``strtod``, so
    every value is correctly rounded; integers up to 2**53 stay exact.

    Returns None where the file needs a general parser: a quoted field,
    ragged rows, or (under ``strict``) a field that is not a number. Any
    other failure raises."""
    lib = get_lib()
    i64 = ctypes.c_int64
    n_rows, n_cols, hlen = i64(0), i64(0), i64(0)
    rc = lib.csv_dims(path.encode(), ctypes.byref(n_rows),
                      ctypes.byref(n_cols), ctypes.byref(hlen))
    if rc in _NOT_NUMERIC:
        return None
    _check(rc, "a read", path)
    out = np.empty((n_rows.value, n_cols.value), np.float64)
    header = ctypes.create_string_buffer(hlen.value + 2)
    rc = lib.csv_read_f64(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows.value, n_cols.value, header, hlen.value + 2, int(strict))
    if rc in _NOT_NUMERIC:
        return None
    _check(rc, "a read", path)
    columns = [c.strip() for c in header.value.decode("utf-8").split(",")]
    if len(columns) != n_cols.value:
        raise ValueError(f"native CSV reader, a read of {path}: the header "
                         f"holds {len(columns)} names for {n_cols.value} "
                         f"columns")
    return out, columns
