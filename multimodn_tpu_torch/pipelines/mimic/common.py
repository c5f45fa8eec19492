"""Shared MIMIC experiment harness (PyTorch twin of
``pipelines/mimic/common.py``).

The reference experiment protocol (``pipelines/mimic/
mimic_single_task_pipeline.py:44-246``): patient-level stratified k-fold
over ``haim_id`` and the aggregated label, each held-out fold split 50/50
into val and test, a fresh model per fold, best-epoch selection on
validation AUROC + BAC, the best parameters tested on the held-out test
rows, one hyper-parameter + metric row per (model, target, fold) appended
to a results CSV; then the HAIM parallel-fusion baseline on the same folds.

Models run on CUDA unless the caller passes ``device="cpu"``. The folds
train one after another (``experiments.kfold_fit_best``). Not ported yet,
and raising ``NotImplementedError``: ``stream_folds`` (ROADMAP.md Queue A
item 15) and ``resume_dir`` (item 13).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from multimodn_tpu_torch import Adam, MultiModN
from multimodn_tpu_torch.baselines.haim import HAIM, HAIMDecoder
from multimodn_tpu_torch.checkpoint import save_checkpoint
from multimodn_tpu_torch.core.metrics import performance_metrics
from multimodn_tpu_torch.data import ArrayLoader, MIMICDataset, Subset
from multimodn_tpu_torch.data.kfold import StratifiedKFold, train_test_split
from multimodn_tpu_torch.data.table import format_value, write_rows
from multimodn_tpu_torch.decoders import MLPDecoder
from multimodn_tpu_torch.encoders import MIMICMLPEncoder, TransformerEncoder

HYPERPARAMETERS = ["model", "target", "fold", "miss_perc", "seed",
                   "state_size", "batch_size", "encoder_hidd_units",
                   "decoder_hidd_units", "dropout", "epochs"]
SAVE_LOGS = HYPERPARAMETERS + performance_metrics


@dataclass
class MimicConfig:
    """The JAX package's ``MimicConfig``: the same fields and defaults."""
    sources: List[str] = field(default_factory=lambda: ["de", "vd", "n_ech", "ts_ce"])
    targets: List[str] = field(default_factory=lambda: ["Enlarged Cardiomediastinum",
                                                        "Cardiomegaly"])
    state_size: int = 50
    learning_rate: float = 1e-3
    epochs: int = 100
    decoder_hidd_units: int = 32
    encoder_hidd_units: int = 32
    err_penalty: float = 1.0
    state_change_penalty: float = 0.0
    dropout: float = 0.2
    batch_size: int = 16
    nfold: int = 5
    miss_perc: float = 0.0
    nan_skip: str = "sample"
    presence_penalty: float = 0.0
    # Synthetic data size when no real embeddings CSV is configured.
    synthetic_patients: int = 120
    # Kept so the JAX package's configs load: its folds train in one vmapped
    # program unless this is False; here every fold runs through
    # kfold_fit_best, one after another, and the field selects nothing.
    vmap_folds: bool = True
    stream_folds: bool = False
    encoder_type: str = "mimic_mlp"
    resume_dir: str = None
    transformer_embed: int = 128
    transformer_heads: int = 4
    transformer_layers: int = 2
    transformer_chunk: int = 64


def check_config(cfg: MimicConfig):
    """Raise ``NotImplementedError`` for the options not ported yet."""
    unported = [
        (cfg.stream_folds, "stream_folds=True (streaming fold loaders, "
                           "ROADMAP.md Queue A item 15)"),
        (cfg.resume_dir, "resume_dir (resumable fits, ROADMAP.md Queue A "
                         "item 13)"),
    ]
    for on, what in unported:
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def storage_root() -> str:
    """Root directory for pipeline artifacts (``nips/results`` CSVs, saved
    models): ``MULTIMODN_STORAGE``, else the repository root, where the
    published protocol CSVs live. The results files are append-only, so
    tests and smoke runs set ``MULTIMODN_STORAGE`` to a scratch directory."""
    return os.environ.get("MULTIMODN_STORAGE") or os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def _metric_scalars(metrics_tuple):
    """15-tuple -> CSV-writable values (curves become lists)."""
    out = []
    for v in metrics_tuple:
        arr = np.asarray(v)
        out.append(float(arr) if arr.ndim == 0 else arr.tolist())
    return out


def append_result_row(results_file_path: str, row: list, columns=None):
    """Append one row to the results CSV, with the header when the file is
    new: the bytes ``pd.DataFrame([row], columns=...).to_csv(...)`` writes."""
    columns = list(columns or SAVE_LOGS)
    if len(row) != len(columns):
        raise ValueError(f"{len(columns)} columns passed, passed data had "
                         f"{len(row)} columns")
    new = not os.path.isfile(results_file_path)
    with open(results_file_path, "w" if new else "a", newline="") as f:
        write_rows(f, columns if new else None, [[format_value(v)] for v in row])


def joint_split_table(cfg: MimicConfig) -> dict:
    """Patient split table (a dict of arrays) of the JOINT pathologies
    cache: every reference MIMIC pipeline stratifies its folds on the
    how_to_split table of the full experiment target list, even the
    per-target loops (``mimic_single_task_pipeline.py:88-94``)."""
    from multimodn_tpu_torch.data.mimic import build_mimic_cache
    from multimodn_tpu_torch.data.table import read_csv
    cache_dir = build_mimic_cache(
        list(cfg.targets), list(cfg.sources),
        synthetic_kwargs={"n_patients": cfg.synthetic_patients})
    return read_csv(os.path.join(cache_dir, "how_to_split.csv"))


def patient_kfold_splits(dataset: MIMICDataset, nfold: int, seed: int,
                         patient: dict = None):
    """Yield (train_ind, val_ind, test_ind) row-index arrays with
    patient-level stratified folds (reference
    ``mimic_single_task_pipeline.py:98-116``). ``patient``: the split table
    to stratify on (default: the dataset's own)."""
    if patient is None:
        patient = dataset.patient_split_table()
    haim_id = np.asarray(patient["haim_id"])
    labels = np.asarray(patient["label"])
    rows_haim = dataset.haim_ids()
    skf = StratifiedKFold(n_splits=nfold, shuffle=True, random_state=seed)
    for i, (id_train, id_test_val) in enumerate(skf.split(haim_id, labels)):
        train_patients = set(haim_id[id_train])
        test_val_patients = haim_id[id_test_val]
        labels_tv = labels[id_test_val]
        # Fold i's val/test split uses random_state = seed + i (the
        # reference increments its seed at the end of each fold body), and
        # the split's first half lands in id_test (reference quirk).
        id_test, id_val = train_test_split(
            test_val_patients, test_size=0.5, stratify=labels_tv,
            random_state=seed + i)[:2]
        val_p, test_p = set(id_val), set(id_test)
        train_ind = np.where(np.isin(rows_haim, list(train_patients)))[0]
        val_ind = np.where(np.isin(rows_haim, list(val_p)))[0]
        test_ind = np.where(np.isin(rows_haim, list(test_p)))[0]
        yield train_ind, val_ind, test_ind


def build_modn(cfg: MimicConfig, partitions: List[int], targets: List[str],
               seed: int, device=None) -> MultiModN:
    """The MIMIC MultiModN: one ``MIMICMLPEncoder`` (or, with
    ``encoder_type='transformer'``, one ``TransformerEncoder``) per
    partition, one ``MLPDecoder`` per target."""
    check_config(cfg)
    if cfg.encoder_type == "transformer":
        encoders = [TransformerEncoder(cfg.state_size, p,
                                       embed_dim=cfg.transformer_embed,
                                       n_heads=cfg.transformer_heads,
                                       n_layers=cfg.transformer_layers,
                                       chunk=min(cfg.transformer_chunk, p),
                                       dropout_rate=cfg.dropout)
                    for p in partitions]
    else:
        encoders = [MIMICMLPEncoder(cfg.state_size, p,
                                    (cfg.encoder_hidd_units,
                                     cfg.encoder_hidd_units),
                                    dropout=cfg.dropout)
                    for p in partitions]
    decoders = [MLPDecoder(cfg.state_size,
                           (cfg.decoder_hidd_units, cfg.decoder_hidd_units), 2)
                for _ in targets]
    return MultiModN(cfg.state_size, encoders, decoders, cfg.err_penalty,
                     cfg.state_change_penalty, nan_skip=cfg.nan_skip,
                     presence_penalty=cfg.presence_penalty, seed=seed,
                     device=device)


def _save_fold_checkpoint(artifacts_dir, fold_tag, model, info):
    """The fold's best checkpoint, ``modn_best_<fold_tag>.pkl``."""
    os.makedirs(artifacts_dir, exist_ok=True)
    save_checkpoint(os.path.join(artifacts_dir, f"modn_best_{fold_tag}.pkl"),
                    model, info["best_epoch"], info["best_score"])


def run_all_folds_modn(cfg: MimicConfig, dataset_modn, partitions, targets,
                       fold_indices, base_seed: int, device=None,
                       artifacts_dir=None):
    """Every fold of one target through ``kfold_fit_best``, seeds
    ``base_seed + i``; returns per-fold ``(model, info, test_metrics)``.
    With ``artifacts_dir``, each fold's best model is saved there as
    ``modn_best_fold<i>_seed<seed>.pkl``."""
    from multimodn_tpu_torch.experiments import kfold_fit_best

    check_config(cfg)
    folds = [(ArrayLoader(Subset(dataset_modn, tr), cfg.batch_size),
              ArrayLoader(Subset(dataset_modn, va), cfg.batch_size))
             for tr, va, _te in fold_indices]
    seeds = [base_seed + i for i in range(len(fold_indices))]
    results = kfold_fit_best(
        lambda s: build_modn(cfg, partitions, targets, s, device),
        folds, Adam(cfg.learning_rate), "cross_entropy",
        epochs=cfg.epochs, seeds=seeds)
    out = []
    for i, (res, (_tr, _va, te)) in enumerate(zip(results, fold_indices)):
        if artifacts_dir:
            _save_fold_checkpoint(artifacts_dir, f"fold{i}_seed{seeds[i]}",
                                  res["model"], res)
        test_loader = ArrayLoader(Subset(dataset_modn, te), cfg.batch_size)
        test_metrics = res["model"].test(test_loader, "cross_entropy")
        out.append((res["model"], res, test_metrics))
    return out


def run_fold_haim(cfg: MimicConfig, dataset_haim, train_ind, val_ind,
                  test_ind, seed, skip_last_val: bool = False, device=None):
    """Train the HAIM baseline on the same fold with the same best-epoch
    rule; return ``(model, test_metrics)``.

    ``dataset_haim``: a single-partition PartitionDataset over the
    zero-filled (nanfill) feature matrix (reference
    ``mimic_single_task_pipeline.py:200-204``). ``skip_last_val``: the MNAR
    pipeline's HAIM never scores its last epoch on val (``HAIM.fit_best``).
    """
    check_config(cfg)
    train_loader = ArrayLoader(Subset(dataset_haim, train_ind), cfg.batch_size)
    val_loader = ArrayLoader(Subset(dataset_haim, val_ind), cfg.batch_size)
    test_loader = ArrayLoader(Subset(dataset_haim, test_ind), cfg.batch_size)

    n_features = sum(dataset_haim.partitions)
    model = HAIM(HAIMDecoder(
        n_features, (cfg.decoder_hidd_units, cfg.decoder_hidd_units)),
        seed=seed, device=device)
    model.fit_best(train_loader, Adam(cfg.learning_rate), "cross_entropy",
                   epochs=cfg.epochs, val_loader=val_loader,
                   restore_best=True, skip_last_val=skip_last_val)
    return model, model.test(test_loader, "cross_entropy")
