"""The Titanic pipeline runner (PyTorch twin of
``pipelines/titanic/common.py``).

Each of the six Titanic pipelines is a config over this runner, which keeps
the reference's flow: dataset -> seeded balanced split -> loaders -> model ->
per-epoch training and validation (``fit``) -> pickled model and history,
plot PNG and results CSV, in ``models/``, ``plots/`` and ``results/`` next to
the pipeline's file. Models run on CUDA unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from multimodn_tpu_torch import Adam, MultiModN, MultiModNHistory
from multimodn_tpu_torch.data import ArrayLoader, TitanicDataset
from multimodn_tpu_torch.decoders import LogisticDecoder
from multimodn_tpu_torch.pipelines import utils


@dataclass
class TitanicConfig:
    features: List[str]
    make_encoders: Callable[[int, List[str]], list]
    targets: List[str] = field(default_factory=lambda: ["Survived"])
    datasplit: Tuple[float, float, float] = (0.8, 0.2, 0)
    balance_target_idx: int = 0
    batch_size: int = 32
    state_size: int = 1
    learning_rate: float = 0.01
    epochs: int = 300
    err_penalty: float = 0.7
    state_change_penalty: float = 0.3
    dropna: bool = True
    featurewise: bool = False
    partitions: Optional[List[int]] = None
    dropna_columns: List[str] = field(default_factory=list)
    # 'sample' removes the reference's batch_size=1 requirement for
    # missingness runs; 'batch' reproduces it exactly (quirk #2).
    nan_skip: str = "sample"


def build_model(cfg: TitanicConfig, seed: int, device=None) -> MultiModN:
    """The pipeline's model, as ``run`` builds it."""
    encoders = cfg.make_encoders(cfg.state_size, cfg.features)
    decoders = [LogisticDecoder(cfg.state_size) for _ in cfg.targets]
    return MultiModN(cfg.state_size, encoders, decoders, cfg.err_penalty,
                     cfg.state_change_penalty, nan_skip=cfg.nan_skip,
                     seed=seed, device=device)


def split(cfg: TitanicConfig, seed: int):
    """The pipeline's (train, val, test) subsets of its dataset."""
    dataset = TitanicDataset(cfg.features, cfg.targets, dropna=cfg.dropna,
                             dropna_columns=cfg.dropna_columns, std=True)
    base = (dataset.featurewise_dataset() if cfg.featurewise
            else dataset.partition_dataset(cfg.partitions))
    return base.random_split(cfg.datasplit, seed, cfg.balance_target_idx)


def loader(cfg: TitanicConfig, subset) -> ArrayLoader:
    """A subset in batches of ``cfg.batch_size`` (0: one batch)."""
    return ArrayLoader(subset, cfg.batch_size or len(subset))


def run(cfg: TitanicConfig, pipeline_file: str, argv=None, device=None):
    """Train and evaluate the pipeline with the reference's flags;
    returns ``(model, history)``."""
    name = utils.extract_pipeline_name(pipeline_file)
    print("Running {}...".format(utils.get_display_name(name)))
    args = utils.parse_args(argv=argv)
    epochs = args.epoch if args.epoch else cfg.epochs

    train_data, val_data, _test_data = split(cfg, args.seed)
    model = build_model(cfg, args.seed, device)
    history = MultiModNHistory(cfg.targets)
    model.fit(loader(cfg, train_data), Adam(cfg.learning_rate),
              "cross_entropy", epochs=epochs, history=history,
              val_loader=loader(cfg, val_data), val_tag="val")

    base_dir = os.path.dirname(os.path.realpath(pipeline_file))
    models_dir = os.path.join(base_dir, "models")
    for flag, suffix, obj in ((args.save_model, "_model.pkl", model),
                              (args.save_history, "_history.pkl", history)):
        if flag:
            os.makedirs(models_dir, exist_ok=True)
            with open(os.path.join(models_dir, name + suffix), "wb") as f:
                pickle.dump(obj, f)
    if args.save_plot:
        plots_dir = os.path.join(base_dir, "plots")
        os.makedirs(plots_dir, exist_ok=True)
        history.plot(os.path.join(plots_dir, name + ".png"), cfg.targets)
    if args.save_results:
        results_dir = os.path.join(base_dir, "results")
        os.makedirs(results_dir, exist_ok=True)
        history.print_results()
        history.save_results(os.path.join(results_dir, name + ".csv"))
    return model, history
