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
train one after another, each through ``run_fold_modn``: ``stream_folds``
streams its batches to the device (``data.streaming``); ``resume_dir``
trains it through ``checkpoint.fit_best_resumable``
(``fit_best_streaming(checkpoint_dir=)`` when streamed), so a killed
protocol run resumes its unfinished folds.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import List

import numpy as np

from multimodn_tpu_torch import Adam, MultiModN, MultiModNHistory
from multimodn_tpu_torch.baselines.haim import HAIM, HAIMDecoder
from multimodn_tpu_torch.checkpoint import fit_best_resumable, save_checkpoint
from multimodn_tpu_torch.core.metrics import performance_metrics
from multimodn_tpu_torch.data import ArrayLoader, MIMICDataset, Subset
from multimodn_tpu_torch.data.streaming import (
    StreamingLoader,
    fit_best_streaming,
)
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
    # program unless this is False or resume_dir is set; here every fold
    # runs through run_fold_modn, one after another, and the field selects
    # nothing.
    vmap_folds: bool = True
    # Stream each fold's batches to the device (StreamingLoader) instead of
    # copying its epoch stacks at once; the same results.
    stream_folds: bool = False
    encoder_type: str = "mimic_mlp"
    # Train each fold through fit_best_resumable (fit_best_streaming with
    # checkpoint_dir when streamed) with resume checkpoints under this
    # directory; a rerun resumes unfinished folds.
    resume_dir: str = None
    transformer_embed: int = 128
    transformer_heads: int = 4
    transformer_layers: int = 2
    transformer_chunk: int = 64


REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", ".."))


def storage_root() -> str:
    """Root directory for pipeline artifacts (``nips/results`` CSVs, saved
    models): ``MULTIMODN_STORAGE``. Raises when the variable is unset or
    names the repository root, whose ``nips/results/`` holds the JAX
    package's protocol records (the results files are append-only). The
    MNAR protocol's ``results_dir`` reads the same rule."""
    storage = os.environ.get("MULTIMODN_STORAGE")
    if not storage:
        raise RuntimeError(
            "the MIMIC pipelines write under $MULTIMODN_STORAGE (nips/"
            "results, models); set MULTIMODN_STORAGE to a directory of its "
            "own")
    if os.path.realpath(storage) == os.path.realpath(REPO_ROOT):
        raise RuntimeError(
            f"MULTIMODN_STORAGE names the repository root ({storage}), whose "
            "nips/results/ holds the JAX package's protocol records; set it "
            "to a directory of its own")
    return storage


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


def _save_fold_artifacts(artifacts_dir, fold_tag, model, info, history):
    """The fold's best checkpoint, ``modn_best_<fold_tag>.pkl``, and its
    pickled history, ``modn_history_<fold_tag>.pkl``, for every fold path."""
    if not artifacts_dir:
        return
    os.makedirs(artifacts_dir, exist_ok=True)
    save_checkpoint(os.path.join(artifacts_dir, f"modn_best_{fold_tag}.pkl"),
                    model, info["best_epoch"], info["best_score"])
    with open(os.path.join(artifacts_dir,
                           f"modn_history_{fold_tag}.pkl"), "wb") as f:
        pickle.dump(history, f)


def _resume_dir(cfg: MimicConfig, targets, fold_tag: str) -> str:
    """The fold's checkpoint directory: ``<resume_dir>/<run key>/<fold_tag>``,
    the run key naming the targets and missingness, so two experiments
    never share one (payloads of one shape would load silently)."""
    if not fold_tag:
        raise ValueError(
            "resume_dir requires a unique fold_tag per (target, fold) run: "
            "checkpoint dirs must not collide across runs or a later run "
            "silently adopts an earlier run's completed checkpoint and "
            "trains zero epochs.")
    run_key = "_".join(t.replace(" ", "-") for t in targets)
    if cfg.miss_perc:
        run_key += f"_miss{cfg.miss_perc:g}"
    return os.path.join(cfg.resume_dir, run_key, fold_tag)


def run_fold_modn(cfg: MimicConfig, dataset_modn, partitions, targets,
                  train_ind, val_ind, test_ind, seed, artifacts_dir=None,
                  fold_tag="", device=None):
    """One fold: MultiModN with best-epoch selection, then tested. Under
    ``cfg.stream_folds`` the fold's batches stream (``fit_best_streaming``,
    resumable through its own checkpoints under ``<fold dir>_stream``);
    otherwise ``cfg.resume_dir`` trains through ``fit_best_resumable``.
    Returns ``(model, history, info, test_metrics)``."""
    ckpt_dir = _resume_dir(cfg, targets, fold_tag) if cfg.resume_dir \
        else None
    loader_cls = StreamingLoader if cfg.stream_folds else ArrayLoader
    train_loader, val_loader, test_loader = (
        loader_cls(Subset(dataset_modn, ind), cfg.batch_size)
        for ind in (train_ind, val_ind, test_ind))
    model = build_modn(cfg, partitions, targets, seed, device)
    history = MultiModNHistory(targets)
    optimizer, every = Adam(cfg.learning_rate), max(1, cfg.epochs // 10)
    if cfg.stream_folds:
        info = fit_best_streaming(
            model, train_loader, optimizer, "cross_entropy",
            epochs=cfg.epochs, val_loader=val_loader, history=history,
            checkpoint_dir=ckpt_dir and ckpt_dir + "_stream",
            checkpoint_every=every)
    elif ckpt_dir:
        info = fit_best_resumable(
            model, train_loader, optimizer, "cross_entropy",
            epochs=cfg.epochs, val_loader=val_loader, history=history,
            checkpoint_dir=ckpt_dir, chunk_epochs=every)
    else:
        info = model.fit_best(train_loader, optimizer, "cross_entropy",
                              epochs=cfg.epochs, val_loader=val_loader,
                              history=history, restore_best=True)
    _save_fold_artifacts(artifacts_dir, fold_tag, model, info, history)
    return model, history, info, model.test(test_loader, "cross_entropy")


def run_all_folds_modn(cfg: MimicConfig, dataset_modn, partitions, targets,
                       fold_indices, base_seed: int, device=None,
                       artifacts_dir=None):
    """Every fold of one target through ``run_fold_modn``, one after
    another, with seeds ``base_seed + i`` and fold tags
    ``fold<i>_seed<seed>`` (the names of the saved artifacts and resume
    directories); returns per-fold ``(model, info, test_metrics)``."""
    out = []
    for i, (tr, va, te) in enumerate(fold_indices):
        seed = base_seed + i
        model, _history, info, test_metrics = run_fold_modn(
            cfg, dataset_modn, partitions, targets, tr, va, te, seed,
            artifacts_dir, f"fold{i}_seed{seed}", device)
        out.append((model, info, test_metrics))
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
