"""MIMIC (HAIM embeddings) dataset with its on-disk cache and MNAR injection
(copy of ``multimodn_tpu/data/mimic.py`` on numpy column tables, without
pandas or scikit-learn).

The cache is the JAX package's, file for file: under a root (default
``data/mimic/`` of the repository), ``<synthetic tag>/<targets>/<sources>/``
holds ``data.csv`` (features, targets, ``haim_id``) and the patient-level
``how_to_split.csv`` (``haim_id``, ``label_count``, ``label_ones``,
``label``, the majority vote of the aggregated label). A cache built by
either package serves the other.

Data source: the real embeddings CSV named by ``MULTIMODN_MIMIC_EMBED_PATH``
(quirk #12), read with bad lines skipped; otherwise the deterministic
synthetic table of ``data/synth.py``. ``random_split`` returns index lists,
not subsets (quirk #11).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union
from uuid import uuid4

import numpy as np

from multimodn_tpu_torch.data.dataset import (
    FeatureWiseDataset,
    PartitionDataset,
    _seeded_permutation,
    _split_indices,
    split_into_partition_datasets,
)
from multimodn_tpu_torch.data.kfold import StandardScaler
from multimodn_tpu_torch.data.synth import (
    MIMIC_DEFAULT_TARGETS,
    MIMIC_SOURCE_DICT,
    SYNTH_MIMIC_VERSION,
    synthetic_mimic_embeddings,
)
from multimodn_tpu_torch.data.table import (
    get_dummies,
    missing,
    read_csv,
    read_numeric_csv,
    write_csv,
)

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "../.."))
# Read at call time: a caller may point every default-rooted cache
# elsewhere by setting this attribute.
DEFAULT_CACHE_ROOT = os.path.join(_REPO_ROOT, "data", "mimic")

_DEMOGRAPHICS = ("de_1", "de_2", "de_3", "de_4", "de_5")


def _root(cache_root: Optional[str]) -> str:
    return DEFAULT_CACHE_ROOT if cache_root is None else cache_root


def _load_embeddings(targets, synthetic_kwargs=None) -> dict:
    path = os.environ.get("MULTIMODN_MIMIC_EMBED_PATH")
    if path:
        fname = path if path.endswith(".csv") else \
            os.path.join(path, "cxr_ic_fusion_1103.csv")
        return read_csv(fname, on_bad_lines="skip")
    kwargs = dict(synthetic_kwargs or {})
    kwargs.setdefault("targets", targets)
    return synthetic_mimic_embeddings(**kwargs)


def _source_features(columns, sources) -> Tuple[List[str], List[int]]:
    """Feature names and per-source partition widths, demographics one-hot
    expanded (reference mimic_dataset.py:44-55)."""
    features: List[str] = []
    partitions: List[int] = []
    for source in sources:
        if source.lower() == "de":
            demo = [c for c in columns
                    if c.startswith("de_") and c not in _DEMOGRAPHICS]
            features += demo
            partitions.append(len(demo))
        else:
            cols = [f"{source}_{i}"
                    for i in range(MIMIC_SOURCE_DICT[source])]
            features += cols
            partitions.append(len(cols))
    return features, partitions


def _resolve_cache_root(cache_root: str, synthetic_kwargs) -> str:
    """Synthetic caches are keyed by their generation config (and the
    generator's version), so differently sized synthetic datasets never
    alias; real-CSV caches use the root."""
    if os.environ.get("MULTIMODN_MIMIC_EMBED_PATH"):
        return cache_root
    kw = dict(synthetic_kwargs or {})
    tag = (f"synth_v{SYNTH_MIMIC_VERSION}"
           f"_p{kw.get('n_patients', 200)}"
           f"_s{kw.get('seed', 2023)}"
           f"_m{kw.get('max_stays_per_patient', 3)}")
    if kw.get("sources"):
        # The generated sources set the rng stream's order: joined unsorted.
        tag += "_src" + "-".join(kw["sources"])
    return os.path.join(cache_root, tag)


def _take(table: dict, rows) -> dict:
    return {k: v[rows] for k, v in table.items()}


def _drop_duplicates(table: dict, subset) -> dict:
    """Keep the first row of each distinct ``subset`` key (NaN equal to
    NaN, as pandas' ``drop_duplicates``)."""
    cols = [(table[c].tolist(), missing(table[c])) for c in subset]
    seen, keep = set(), []
    for i in range(len(table[subset[0]])):
        key = tuple(None if nan[i] else vals[i] for vals, nan in cols)
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return _take(table, np.asarray(keep, dtype=np.int64))


def _isin01(col: np.ndarray) -> np.ndarray:
    """``col.isin([0, 1])``: numbers equal to 0 or 1; strings never."""
    if col.dtype.kind in "iufb":
        return np.isin(col, [0, 1])
    return np.array([not isinstance(v, str) and v in (0, 1) for v in col],
                    dtype=bool)


def _patient_table(haim_id: np.ndarray, agg: np.ndarray) -> dict:
    """``df.groupby('haim_id').agg(label_count=('Agg', 'count'),
    label_ones=('Agg', 'sum'))`` with ``label = ones >= count / 2``, ids
    sorted, rows without an id dropped."""
    ok = ~missing(haim_id)
    ids, inverse = np.unique(haim_id[ok], return_inverse=True)
    counts = np.bincount(inverse, minlength=len(ids)).astype(np.int64)
    ones = np.zeros(len(ids), dtype=agg.dtype)
    np.add.at(ones, inverse, agg[ok])
    return {"haim_id": ids, "label_count": counts, "label_ones": ones,
            "label": (ones >= counts / 2).astype(np.int64)}


def build_mimic_cache(
    targets: List[str],
    sources: List[str],
    cache_root: Optional[str] = None,
    synthetic_kwargs=None,
) -> str:
    """Materialize (or reuse) the per-(targets, sources) cache directory
    with ``data.csv`` and patient-level ``how_to_split.csv``; returns its
    path. ``cache_root`` defaults to ``DEFAULT_CACHE_ROOT``."""
    orig_root = _root(cache_root)
    cache_root = _resolve_cache_root(orig_root, synthetic_kwargs)
    pathologies = "_".join(targets)
    source_spec = "_".join(sources)
    cache_dir = os.path.join(cache_root, pathologies, source_spec)
    data_path = os.path.join(cache_dir, "data.csv")
    split_path = os.path.join(cache_dir, "how_to_split.csv")
    # A cache is valid only when both files exist (each written through a
    # unique tmp name and an atomic rename, split table first).
    if os.path.exists(data_path) and os.path.exists(split_path):
        return cache_dir
    os.makedirs(cache_dir, exist_ok=True)

    # Single-target data derives from the canonical two-pathology cache, as
    # the reference's single-target loader reads it (mimic_dataset.py:96-99):
    # its rows are the jointly filtered ones.
    nips_src = os.path.join(cache_root, "_".join(MIMIC_DEFAULT_TARGETS),
                            source_spec, "data.csv")
    if len(targets) == 1 and targets[0] in MIMIC_DEFAULT_TARGETS:
        if not os.path.exists(nips_src):
            build_mimic_cache(list(MIMIC_DEFAULT_TARGETS), sources,
                              orig_root, synthetic_kwargs)
        columns, values = read_numeric_csv(nips_src)
        table = dict(zip(columns, values))
        table["Agg"] = table[targets[0]].astype(np.int64)
    else:
        table = _load_embeddings(targets, synthetic_kwargs)
        table = _drop_duplicates(table, ["img_id", "img_charttime"])
        for target in targets:
            table = _take(table, _isin01(table[target]))
        # Aggregated label: 1 when a row is positive for more than one
        # target (reference :42-44); for a single target the row label.
        if len(targets) > 1:
            total = sum(np.asarray(table[t], dtype=np.float64)
                        for t in targets)
            table["Agg"] = (total > 1).astype(np.int64)
        else:
            table["Agg"] = table[targets[0]].astype(np.int64)
        if "de" in [s.lower() for s in sources]:
            table = get_dummies(table, _DEMOGRAPHICS, drop_first=True,
                                dtype=np.int64)
    features, _ = _source_features(list(table), sources)
    data_full = {c: table[c] for c in features + list(targets) + ["haim_id"]}
    patient = _patient_table(table["haim_id"], table["Agg"])
    # Split table first, data.csv last, each through a per-process tmp
    # name and an atomic replace: a torn build is retried, never served.
    suffix = f".tmp.{os.getpid()}.{uuid4().hex[:8]}"
    write_csv(split_path + suffix, patient)
    os.replace(split_path + suffix, split_path)
    write_csv(data_path + suffix, data_full)
    os.replace(data_path + suffix, data_path)
    return cache_dir


def load_mimic_data(
    targets: List[str],
    sources: List[str],
    put_none: bool = False,
    indices_to_nan=(),
    features_to_nan=(),
    cache_root: Optional[str] = None,
    synthetic_kwargs=None,
):
    """``(data, labels, features, partitions)``: the (N, F) float64 feature
    matrix, the (N, T) float64 labels, the feature names and the
    per-source widths (the reference's mimic_get_*_data loaders,
    ``mimic_dataset.py:27-148``; the JAX package returns the first two as
    DataFrames)."""
    return _load_mimic_full(targets, sources, put_none, indices_to_nan,
                            features_to_nan, cache_root, synthetic_kwargs)[:4]


def _load_mimic_full(
    targets: List[str],
    sources: List[str],
    put_none: bool = False,
    indices_to_nan=(),
    features_to_nan=(),
    cache_root: Optional[str] = None,
    synthetic_kwargs=None,
):
    """load_mimic_data plus (haim_ids, cache_dir) from the same parse. The
    feature matrix is column-major, as pandas holds a float frame."""
    cache_dir = build_mimic_cache(targets, sources, cache_root,
                                  synthetic_kwargs)
    columns, values = read_numeric_csv(os.path.join(cache_dir, "data.csv"))
    position = {c: j for j, c in enumerate(columns)}
    features, partitions = _source_features(columns, sources)
    data = values[[position[c] for c in features]].T        # a copy
    labels = values[[position[t] for t in targets]].T.copy()
    haim_ids = values[position["haim_id"]].copy()
    if put_none:
        cols = features_to_nan
        if isinstance(cols, str):
            # 'demo' expands to the one-hot demographics block (reference
            # mimic_dataset.py:83-88); any other string names one feature.
            if cols == "demo":
                cols = [c for c in features if c.startswith("de_")]
                if not cols:
                    raise KeyError(
                        "features_to_nan='demo' but the selected sources "
                        "have no demographic (de_*) columns; include 'de' "
                        "in sources or name explicit feature columns")
            else:
                cols = [cols]
        feature_pos = {c: j for j, c in enumerate(features)}
        missing = [c for c in cols if c not in feature_pos]
        if missing:
            raise KeyError(
                f"features_to_nan names unknown feature columns: {missing}")
        rows = np.asarray(list(indices_to_nan), dtype=np.int64)
        data[np.ix_(rows, [feature_pos[c] for c in cols])] = np.nan
    return data, labels, features, partitions, haim_ids, cache_dir


class MIMICDataset:
    """The MIMIC feature matrix ``X`` (N, F) float32 and labels ``y`` (N, T)
    float64, with the reference's options: ``dropna`` drops rows holding a
    NaN, ``std`` standardises each feature (scikit-learn's
    ``StandardScaler``, NaN passed through), ``nanfill`` then zero-fills
    for the HAIM baseline (mimic_dataset.py:176-178), and ``put_none``
    sets ``features_to_nan`` of rows ``indices_to_nan`` to NaN first (MNAR
    injection). ``cache_root`` defaults to ``DEFAULT_CACHE_ROOT``."""

    def __init__(
        self,
        sources: List[str],
        targets: Optional[List[str]] = None,
        dropna: bool = False,
        nanfill: bool = False,
        std: bool = True,
        put_none: bool = False,
        indices_to_nan=(),
        features_to_nan=(),
        cache_root: Optional[str] = None,
        synthetic_kwargs=None,
    ):
        targets = list(targets or [])
        (data, labels, features, partitions, haim_ids,
         cache_dir) = _load_mimic_full(
            targets, sources, put_none, indices_to_nan, features_to_nan,
            cache_root, synthetic_kwargs)
        rows = np.arange(data.shape[0])
        if dropna:
            keep = ~np.isnan(data).any(axis=1)
            data = np.asfortranarray(data[keep])
            labels, rows = labels[keep], rows[keep]
        if std:
            data = StandardScaler().fit_transform(data)
        if nanfill:
            missing = np.isnan(data)
            print("Number of samples with missing values = ",
                  int(missing.any(axis=1).sum()))
            data[missing] = 0.0
        self.X = np.ascontiguousarray(data, dtype=np.float32)
        self.y = labels
        self.partitions = partitions
        self.features = features
        self.cache_dir = cache_dir
        # Per-row patient ids through the same row filtering as X/y.
        self._row_haim_ids = haim_ids[rows]

    def __len__(self):
        return len(self.y)

    def __getitem__(self, idx: int):
        return self.X[idx], self.y[idx]

    def patient_split_table(self) -> dict:
        """The patient-level ``how_to_split`` table as a dict of arrays
        (``haim_id``, ``label_count``, ``label_ones``, ``label``)."""
        return read_csv(os.path.join(self.cache_dir, "how_to_split.csv"))

    def haim_ids(self) -> np.ndarray:
        """Per-row patient id, aligned with X/y rows (after any dropna)."""
        return self._row_haim_ids

    def random_split(
        self,
        probabilities: Union[List[float], Tuple[float, ...]],
        seed: int,
        balanced_target_idx: Optional[int] = None,
    ) -> List[List[int]]:
        """Returns INDEX LISTS, not Subsets (reference quirk #11)."""
        shuffled = _seeded_permutation(len(self), seed)
        label_of = None if balanced_target_idx is None else \
            (lambda idx: self.y[idx][balanced_target_idx])
        return _split_indices(shuffled, probabilities, label_of)

    def partition_dataset(self, partitions: Optional[List[int]] = None
                          ) -> PartitionDataset:
        return PartitionDataset(self.X, self.y, partitions)

    def featurewise_dataset(self) -> FeatureWiseDataset:
        return FeatureWiseDataset(self.X, self.y)

    def split_dataset(self, partitions: Optional[List[int]] = None
                      ) -> List[PartitionDataset]:
        return split_into_partition_datasets(self.X, self.y, partitions)
