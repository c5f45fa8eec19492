"""MIMIC MNAR missingness pipeline (PyTorch twin of
``pipelines/mimic/mimic_single_task_mnar_missingness_pipeline.py``): the
catastrophic-failure experiment of the paper.

For ``--miss_perc`` percent of the class-1 train and val rows, the whole
``vd_*`` image-embedding block is set to NaN (missing not at random).
MultiModN trains on the NaNs (encoder skip); HAIM trains on zero-filled data
(``nanfill``). Each best model is tested twice: on clean data
(``both=False``) and on data degraded the same way but targeting the flipped
class (``both=True``).

    python -m multimodn_tpu_torch.pipelines.mimic.mimic_single_task_mnar_missingness_pipeline -p 50 -e 3

runs on the GPU; ``main(argv, cfg, device="cpu")`` runs on the CPU.
"""
import argparse
import os

from multimodn_tpu_torch.core.metrics import performance_metrics
from multimodn_tpu_torch.data import ArrayLoader, MIMICDataset, Subset
from multimodn_tpu_torch.pipelines import utils
from multimodn_tpu_torch.pipelines.mimic import common
from multimodn_tpu_torch.pipelines.mimic.common import (
    MimicConfig,
    _metric_scalars,
    append_result_row,
    patient_kfold_splits,
    storage_root,
)

HYPERPARAMETERS = ["model", "target", "both", "fold", "miss_perc", "seed",
                   "state_size", "batch_size", "encoder_hidd_units",
                   "decoder_hidd_units", "dropout", "epochs"]
SAVE_LOGS_MNAR = HYPERPARAMETERS + performance_metrics


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-p", "--miss_perc", type=float, default=0.0,
                   help="percentage of samples with systematic missingness")
    p.add_argument("-e", "--epoch", type=int, default=None)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("-m", "--save_model", type=utils.string_to_bool,
                   default=False)
    return p.parse_args(argv)


def _mnar_indices(dataset, row_indices, target, class_label, miss_perc):
    """First miss_perc% of the given rows whose target equals class_label
    (the reference relies on the fold shuffle for randomness)."""
    y = dataset.y[:, 0]
    same = [i for i in row_indices if y[i] == class_label]
    nan_size = round(miss_perc / 100 * len(same))
    return same[:nan_size]


def main(argv=None, cfg: MimicConfig = None, device=None):
    name = utils.extract_pipeline_name(__file__)
    args = parse_args(argv)
    cfg = cfg or MimicConfig()
    if args.epoch:
        cfg.epochs = args.epoch
    cfg.miss_perc = args.miss_perc
    put_none = cfg.miss_perc > 0
    class_label = 1
    vd_features = [f"vd_{k}" for k in range(1024)]
    synth = {"n_patients": cfg.synthetic_patients}

    results_dir = os.path.join(storage_root(), "nips", "results")
    os.makedirs(results_dir, exist_ok=True)
    results_file = os.path.join(results_dir, name + "_(auc + bac).csv")

    # One JOINT-pathologies split table for every target's folds.
    split_table = common.joint_split_table(cfg)

    all_results = []
    for target in cfg.targets:
        base = MIMICDataset(cfg.sources, targets=[target],
                            synthetic_kwargs=synth)
        partitions = base.partitions
        fold_indices = list(patient_kfold_splits(
            base, cfg.nfold, args.seed, patient=split_table))

        # Per-fold MNAR-degraded datasets (the injected rows depend on each
        # fold's train/val split).
        fold_datasets = []
        for tr, va, te in fold_indices:
            if put_none:
                idx = (_mnar_indices(base, tr, target, class_label,
                                     cfg.miss_perc)
                       + _mnar_indices(base, va, target, class_label,
                                       cfg.miss_perc))
            else:
                idx = []
            dataset_modn = MIMICDataset(
                cfg.sources, targets=[target], put_none=put_none,
                indices_to_nan=idx, features_to_nan=vd_features,
                synthetic_kwargs=synth).partition_dataset(partitions)
            dataset_haim = MIMICDataset(
                cfg.sources, targets=[target], put_none=put_none,
                nanfill=True, indices_to_nan=idx, features_to_nan=vd_features,
                synthetic_kwargs=synth).partition_dataset()
            fold_datasets.append((dataset_modn, dataset_haim))

        seed = args.seed
        for fold, (tr, va, te) in enumerate(fold_indices):
            dataset_modn, dataset_haim = fold_datasets[fold]
            # The fold's own degraded data (streamed under stream_folds,
            # resumable under resume_dir).
            model = common.run_fold_modn(
                cfg, dataset_modn, partitions, [target], tr, va, te, seed,
                fold_tag=f"fold{fold}_seed{seed}", device=device)[0]

            # Test twice: flipped-class degraded (both=True) and clean
            # (both=False), reference :218-242.
            for both in ([True, False] if put_none else [None]):
                if both:
                    test_idx = _mnar_indices(base, te, target,
                                             1 - class_label, cfg.miss_perc)
                    ds_test = MIMICDataset(
                        cfg.sources, targets=[target], put_none=True,
                        indices_to_nan=test_idx, features_to_nan=vd_features,
                        synthetic_kwargs=synth).partition_dataset(partitions)
                else:
                    ds_test = MIMICDataset(
                        cfg.sources, targets=[target],
                        synthetic_kwargs=synth).partition_dataset(partitions)
                test_loader = ArrayLoader(Subset(ds_test, te), cfg.batch_size)
                test_modn = model.test(test_loader, "cross_entropy")
                hp = [target, both, fold, cfg.miss_perc, seed, cfg.state_size,
                      cfg.batch_size, cfg.encoder_hidd_units,
                      cfg.decoder_hidd_units, cfg.dropout, cfg.epochs]
                append_result_row(results_file,
                                  ["modn"] + hp + _metric_scalars(test_modn[0]),
                                  columns=SAVE_LOGS_MNAR)
                all_results.append(("modn", target, fold, both,
                                    float(test_modn[0][1])))
                print(f"[mnar:{target}] fold {fold} both={both}: "
                      f"test auc {float(test_modn[0][1]):.4f}")

            # HAIM on the zero-filled data, same folds, same dual test; its
            # selection skips the last epoch's val score (the reference MNAR
            # script never computes it, mnar_missingness_pipeline.py:300-303).
            haim_model, _ = common.run_fold_haim(
                cfg, dataset_haim, tr, va, te, seed, skip_last_val=True,
                device=device)
            for both in ([True, False] if put_none else [None]):
                if both:
                    test_idx = _mnar_indices(base, te, target,
                                             1 - class_label, cfg.miss_perc)
                else:
                    test_idx = []
                ds_test = MIMICDataset(
                    cfg.sources, targets=[target], put_none=bool(both),
                    nanfill=True, indices_to_nan=test_idx,
                    features_to_nan=vd_features,
                    synthetic_kwargs=synth).partition_dataset()
                test_loader = ArrayLoader(Subset(ds_test, te), cfg.batch_size)
                test_haim = haim_model.test(test_loader, "cross_entropy")
                hp = [target, both, fold, cfg.miss_perc, seed, cfg.state_size,
                      cfg.batch_size, cfg.encoder_hidd_units,
                      cfg.decoder_hidd_units, cfg.dropout, cfg.epochs]
                append_result_row(results_file,
                                  ["haim"] + hp + _metric_scalars(test_haim),
                                  columns=SAVE_LOGS_MNAR)
                all_results.append(("haim", target, fold, both,
                                    float(test_haim[1])))
            seed += 1
    return all_results


if __name__ == "__main__":
    main()
