"""Column tables and their CSV files without pandas.

A table is an ordered dict from column name to a 1-D numpy array. The CSV
text is pandas' (``DataFrame.to_csv(index=False)`` / ``read_csv``) for the
column types the MIMIC files hold, so a file written here or by the JAX
package reads back to the same values in either:

- writing: integers as digits, floats in numpy's shortest round-trip form
  for their own type (``0.1`` for a float32 0.1, ``1e-05``), NaN and None as
  an empty field, booleans as ``True``/``False``, anything else as ``str``;
  minimal quoting, ``\\n`` line ends, a header row;
- reading: each column becomes int64 when every field is an integer,
  float64 when every field is a number or one of pandas' default NaN
  spellings, bool for ``True``/``False``, else an object column of strings
  (NaN where missing); floats parse correctly rounded.
"""
from __future__ import annotations

import csv
import os
import re
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from multimodn_tpu_torch.data import native

# pandas' default na_values.
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def missing(col: np.ndarray) -> np.ndarray:
    """Where a column holds NaN or None (pandas' ``isna``)."""
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in col], dtype=bool)
    return np.zeros(col.shape, dtype=bool)


def get_dummies(table: Dict[str, np.ndarray], columns, drop_first: bool,
                dtype=bool) -> Dict[str, np.ndarray]:
    """``pd.get_dummies(df, columns=columns, drop_first=..., dtype=...)``:
    the listed columns leave their places, and one column per category
    (sorted, the first dropped when ``drop_first``) is appended per listed
    column, named ``<column>_<category>``; a missing value sets none."""
    out = {k: v for k, v in table.items() if k not in columns}
    for c in columns:
        col = table[c]
        present = col[~missing(col)]
        cats = np.unique(present) if col.dtype.kind != "O" else \
            np.array(sorted(set(present.tolist())), dtype=object)
        if drop_first:
            cats = cats[1:]
        for v in cats:
            out[f"{c}_{v}"] = (col == v).astype(dtype)
    return out


def format_value(v) -> str:
    """One value's CSV field, as pandas writes it in a column of the
    value's own type."""
    if v is None or (isinstance(v, (float, np.floating)) and v != v):
        return ""
    if isinstance(v, (bool, np.bool_)):
        return "True" if v else "False"
    return str(v)


def format_column(values) -> List[str]:
    """One column's CSV fields, as pandas writes them."""
    arr = np.asarray(values)
    if arr.dtype.kind in "iu":
        return arr.astype(str).tolist()
    if arr.dtype.kind == "f":
        text = arr.astype(str)
        text[np.isnan(arr)] = ""
        return text.tolist()
    return [format_value(v) for v in arr.tolist()]


def write_rows(f, header: Sequence[str], columns: Sequence) -> None:
    """Write ``header`` (None for no header) and the rows of ``columns``
    (sequences of pre-formatted fields) to an open text file."""
    writer = csv.writer(f, lineterminator="\n")
    if header is not None:
        writer.writerow(header)
    writer.writerows(zip(*columns))


def write_csv(path: str, table: Dict[str, np.ndarray]) -> None:
    """``pd.DataFrame(table).to_csv(path, index=False)``."""
    with open(path, "w", newline="") as f:
        write_rows(f, list(table), [format_column(v) for v in table.values()])


def _parse_column(fields: List[str]) -> np.ndarray:
    present = [t for t in fields if t not in NA_STRINGS]
    if len(present) == len(fields):
        try:
            return np.array([int(t) for t in fields], dtype=np.int64)
        except (ValueError, OverflowError):
            pass
        if present and all(t in ("True", "False") for t in present):
            return np.array([t == "True" for t in fields])
    try:
        return np.array([float("nan") if t in NA_STRINGS else float(t)
                         for t in fields], dtype=np.float64)
    except ValueError:
        return np.array([float("nan") if t in NA_STRINGS else t
                         for t in fields], dtype=object)


def read_rows(path: str, on_bad_lines: str = "error"
              ) -> Tuple[List[str], List[List[str]]]:
    """Header and data rows of a CSV file. A row with more fields than the
    header raises (``on_bad_lines='error'``) or is dropped (``'skip'``); a
    shorter row is padded with empty fields; blank lines are skipped."""
    if on_bad_lines not in ("error", "skip"):
        raise ValueError(f"on_bad_lines must be 'error' or 'skip', got "
                         f"{on_bad_lines!r}")
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        n = len(header)
        rows = []
        for line, row in enumerate(reader, start=2):
            if not row:
                continue
            if len(row) > n:
                if on_bad_lines == "skip":
                    continue
                raise ValueError(f"{path}: line {line} has {len(row)} "
                                 f"fields, the header {n}")
            if len(row) < n:
                row = row + [""] * (n - len(row))
            rows.append(row)
    return header, rows


def read_csv(path: str, on_bad_lines: str = "error") -> Dict[str, np.ndarray]:
    """``pd.read_csv(path, on_bad_lines=...)`` as a table, with the column
    types of the module docstring."""
    header, rows = read_rows(path, on_bad_lines)
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names")
    columns = list(zip(*rows)) if rows else [()] * len(header)
    return {name: _parse_column(list(col))
            for name, col in zip(header, columns)}


_NUMERIC_CACHE: Dict[tuple, Tuple[List[str], np.ndarray,
                                  Dict[str, np.ndarray]]] = {}

_INTEGER = re.compile(r"[+-]?[0-9]+\Z")
_INT64_MAX = float(2 ** 63)


def _integer_columns(header: List[str], rows: List[List[str]],
                     values: np.ndarray) -> Dict[str, np.ndarray]:
    """The columns pandas' ``read_csv`` reads as int64: every field an
    integer (digits, an optional sign) within int64, none missing. Each is
    parsed exactly, not through its float64 image."""
    out = {}
    if not rows:
        return out
    whole = np.isfinite(values).all(axis=0) & (values == np.trunc(values)) \
        .all(axis=0) & (np.abs(values) < _INT64_MAX).all(axis=0)
    for j in np.flatnonzero(whole):
        fields = [row[j] for row in rows]
        if all(_INTEGER.match(t) for t in fields):
            column = np.array([int(t) for t in fields], dtype=np.int64)
            column.flags.writeable = False
            out[header[j]] = column
    return out


def _parse_numeric(path: str) -> Tuple[np.ndarray, List[str],
                                       Dict[str, np.ndarray]]:
    """``((n_rows, n_columns) float64, columns, integer columns)`` of an
    all-numeric CSV file through the Python parser: the float64 matrix as
    ``native.read_csv_f64`` returns it (pandas' NaN spellings read as NaN),
    and, by name, the columns pandas would read as int64
    (``_integer_columns``)."""
    header, rows = read_rows(path)
    try:
        values = np.array(rows, dtype=np.float64)
    except ValueError:
        values = np.array([[float("nan") if t in NA_STRINGS else float(t)
                            for t in row] for row in rows], dtype=np.float64)
    values = values.reshape(len(rows), len(header))
    return values, header, _integer_columns(header, rows, values)


# Which reader parsed each cache file, by absolute path: "native", "python"
# (a file the native reader leaves to a general parser) or "python: the
# native library is unavailable (<reason>)". Read by the tests and by
# chip_smoke.py's protocol phase.
READERS: Dict[str, str] = {}


def _native_unavailable():
    """None where the native library loads (built at the first call), else
    the ``READERS`` entry that says why it cannot be built or loaded (no
    ``g++``, no writable ``build/native/``: the ``OSError`` or
    ``RuntimeError`` that ``native.get_lib`` raises, as the JAX package's
    ``data/mimic.py`` falls back on any failure)."""
    try:
        native.get_lib()
    except (OSError, RuntimeError) as exc:
        return f"python: the native library is unavailable ({exc})"
    return None


def _read_numeric(path: str, unavailable) -> Tuple[
        np.ndarray, List[str], Dict[str, np.ndarray]]:
    """The native reader, or the Python parser where the native reader
    leaves the file to a general parser or where its library is
    ``unavailable`` (``_native_unavailable``'s reason). The two mirror the
    JAX package's two readers: its native one reads every column as
    float64, and ``pd.read_csv``, which it takes otherwise, reads a column
    of integers as int64, so only the Python parse returns integer
    columns. The slow path is never silent: ``READERS`` records it, and a
    missing library warns."""
    key = os.path.abspath(path)
    if unavailable:
        if not any(r.startswith("python: the native") for r in
                   READERS.values()):
            warnings.warn(f"reading the MIMIC cache files with the Python "
                          f"parser: {unavailable}", RuntimeWarning,
                          stacklevel=4)
        READERS[key] = unavailable
        return _parse_numeric(path)
    result = native.read_csv_f64(path)
    READERS[key] = "python" if result is None else "native"
    return _parse_numeric(path) if result is None else (*result, {})


def read_numeric_csv(path: str) -> Tuple[List[str], np.ndarray,
                                         Dict[str, np.ndarray]]:
    """``(columns, values, integers)`` of an all-numeric CSV file:
    ``values`` is a read-only float64 array of shape ``(n_columns,
    n_rows)`` (one row per column, the layout pandas keeps a float frame
    in), and ``integers`` maps each column that the JAX package's reader
    of the same file reads as int64 to its read-only int64 values: none on
    the native path, each column of integers without a missing field on
    the Python one (``_read_numeric``). Empty fields and pandas' NaN
    spellings read as NaN.

    The file goes through the native reader (``native.read_csv_f64``, as
    the JAX package reads its cache files), which also reads ``na`` as NaN;
    where that reader leaves the file to a general parser (a quoted field,
    ragged rows, a field such as ``N/A`` that is not a number to it), or
    where its library cannot be built, the Python parser reads it
    (``READERS`` says which ran). The two give the same float64 bits on
    the files ``write_csv`` writes: both round every field correctly.

    The parse is kept per file (path, size and modification time) and per
    reader (whether the native library loads), so the many datasets a
    pipeline builds from one cache file parse it once, and a reading by
    one reader never serves the other."""
    unavailable = _native_unavailable()
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns,
           unavailable is None)
    hit = _NUMERIC_CACHE.get(key)
    if hit is not None:
        return hit
    values, header, integers = _read_numeric(path, unavailable)
    values = np.ascontiguousarray(values.T)
    values.flags.writeable = False
    if len(_NUMERIC_CACHE) >= 8:
        _NUMERIC_CACHE.pop(next(iter(_NUMERIC_CACHE)))
    _NUMERIC_CACHE[key] = (header, values, integers)
    return header, values, integers
