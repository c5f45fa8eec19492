"""Deterministic synthetic Titanic and MIMIC data (copy of
``multimodn_tpu/data/synth.py``, without pandas).

The Titanic CSV is fetched from the network and the HAIM embeddings file the
MIMIC pipelines read is private; these generators give schema-exact,
label-correlated stand-ins. Each draws from the same
``numpy.random.default_rng`` stream in the same order as the JAX package's
generator, so every column is equal to its frame's. The result is an ordered
column table: a dict from column name to a 1-D numpy array, in the frame's
column order, strings in object columns with NaN where a value is missing.
"""
from __future__ import annotations

import zlib

import numpy as np

# Exact HAIM source widths (reference mimic_dataset.py:19-22).
MIMIC_SOURCE_NAMES = ["de", "vd", "vmd", "ts_ce", "ts_le", "ts_pe",
                      "n_ecg", "n_ech", "n_rad"]
MIMIC_SOURCE_SIZE = [6, 1024, 1024, 99, 242, 110, 768, 768, 768]
MIMIC_SOURCE_DICT = dict(zip(MIMIC_SOURCE_NAMES, MIMIC_SOURCE_SIZE))

MIMIC_DEFAULT_TARGETS = ["Enlarged Cardiomediastinum", "Cardiomegaly"]

# Bump when synthetic_mimic_embeddings' distribution changes: it keys the
# MIMIC on-disk cache (data/mimic.py), shared with the JAX package.
SYNTH_MIMIC_VERSION = 2

# The post-ReLU neural-embedding blocks: non-negative, weakly informative.
_EMBED_BLOCKS = {"vd", "vmd", "n_ecg", "n_ech", "n_rad"}


def synthetic_titanic(n: int = 891, seed: int = 1912) -> dict:
    """Titanic-schema table with the real file's missingness (~20% of Age,
    ~77% of Cabin, 2 Embarked) and a learnable survival signal driven by
    sex, class, age and fare, as in the real data."""
    rng = np.random.default_rng(seed)
    pclass = rng.choice([1, 2, 3], size=n, p=[0.24, 0.21, 0.55])
    sex = rng.choice(["male", "female"], size=n, p=[0.65, 0.35])
    age = np.clip(rng.normal(29, 14, size=n), 0.4, 80).round(1)
    sibsp = rng.choice([0, 1, 2, 3, 4], size=n,
                       p=[0.68, 0.23, 0.05, 0.02, 0.02])
    parch = rng.choice([0, 1, 2, 3], size=n, p=[0.76, 0.13, 0.09, 0.02])
    fare = np.round(np.exp(rng.normal(2.5, 1.0, size=n)) * (4 - pclass), 4)
    embarked = rng.choice(["S", "C", "Q"], size=n,
                          p=[0.72, 0.19, 0.09]).astype(object)

    logit = (1.3 * (sex == "female") - 0.9 * (pclass - 2)
             - 0.02 * (age - 29) + 0.004 * np.minimum(fare, 100)
             - 0.2 * (sibsp + parch > 2) + rng.normal(0, 0.8, size=n))
    survived = (logit > 0).astype(np.int64)

    age = age.astype(object)
    age[rng.random(n) < 0.199] = np.nan
    # One draw of the deck, then one of the number, per row.
    cabin = np.array(
        ["%s%d" % (rng.choice(list("ABCDEFG")), rng.integers(1, 130))
         for _ in range(n)], dtype=object)
    cabin[rng.random(n) < 0.771] = np.nan
    embarked[rng.choice(n, size=2, replace=False)] = np.nan

    names = [f"Passenger, {'Mr.' if s == 'male' else 'Mrs.'} Synth {i}"
             for i, s in enumerate(sex)]
    tickets = [f"ST/{rng.integers(10000, 99999)}" for _ in range(n)]
    return {
        "PassengerId": np.arange(1, n + 1),
        "Survived": survived,
        "Pclass": pclass,
        "Name": np.array(names, dtype=object),
        "Sex": sex.astype(object),
        "Age": age,
        "SibSp": sibsp,
        "Parch": parch,
        "Ticket": np.array(tickets, dtype=object),
        "Fare": fare,
        "Cabin": cabin,
        "Embarked": embarked,
    }


def synthetic_mimic_embeddings(
    n_patients: int = 200,
    max_stays_per_patient: int = 3,
    targets=None,
    seed: int = 2023,
    sources=None,
) -> dict:
    """HAIM-embeddings-shaped table: one row per (stay, image), grouped by
    ``haim_id`` patient ids, with de_1..de_5 categorical demographics, the
    per-source embedding blocks at their exact widths (float32), and 0/1
    pathology target columns correlated with a low-rank latent.

    ``img_charttime`` is ``datetime64[h]``, the frame's timestamps to the
    hour."""
    targets = list(targets) if targets is not None else list(MIMIC_DEFAULT_TARGETS)
    sources = list(sources) if sources is not None else list(MIMIC_SOURCE_NAMES)
    rng = np.random.default_rng(seed)

    rows_per_patient = rng.integers(1, max_stays_per_patient + 1, size=n_patients)
    n_rows = int(rows_per_patient.sum())
    haim_id = np.repeat(np.arange(n_patients), rows_per_patient)

    # Patient-level latent drives both embeddings and labels.
    latent = rng.normal(size=(n_patients, 8))
    row_latent = latent[haim_id] + 0.3 * rng.normal(size=(n_rows, 8))

    hours = rng.integers(0, 10_000, size=n_rows)
    table = {
        "haim_id": haim_id,
        "img_id": np.arange(n_rows) + 10_000,
        "img_charttime": np.datetime64("2140-01-01T00", "h")
        + hours.astype("timedelta64[h]"),
    }
    for j in range(1, 6):
        table[f"de_{j}"] = rng.integers(0, 3, size=n_rows)

    for src in sources:
        if src == "de":
            continue
        width = MIMIC_SOURCE_DICT[src]
        proj = rng.normal(size=(8, width)) / np.sqrt(8)
        gain = 0.25 if src in _EMBED_BLOCKS else 1.0
        block = gain * (row_latent @ proj) \
            + 0.5 * rng.normal(size=(n_rows, width))
        if src in _EMBED_BLOCKS:
            block = np.maximum(
                block + rng.uniform(0.5, 1.5, size=width), 0.0)
        block = block.astype(np.float32)
        for i in range(width):
            table[f"{src}_{i}"] = block[:, i]

    for target in targets:
        # Seeded by the target's name, so a target's labels are the same
        # whether it is generated alone or with others.
        t_rng = np.random.default_rng(
            (seed * 1_000_003 + zlib.crc32(target.encode())) % 2**63)
        w = t_rng.normal(size=8)
        score = row_latent @ w + 1.6 * t_rng.normal(size=n_rows)
        table[target] = (score > np.median(score)).astype(np.int64)

    return table
