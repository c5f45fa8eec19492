"""MIMIC single-task pipeline (PyTorch twin of
``pipelines/mimic/mimic_single_task_pipeline.py``): per target, 5-fold
patient-level CV; per fold MultiModN (4 MIMIC-MLP encoders, state 50) with
best-epoch selection on val AUROC+BAC, tested at its best, one results-CSV
row; then the HAIM parallel-fusion baseline on the same folds.

    python -m multimodn_tpu_torch.pipelines.mimic.mimic_single_task_pipeline -e 3

runs on the GPU; ``main(argv, cfg, device="cpu")`` runs on the CPU.
"""
import os

from multimodn_tpu_torch.data import MIMICDataset
from multimodn_tpu_torch.pipelines import utils
from multimodn_tpu_torch.pipelines.mimic import common
from multimodn_tpu_torch.pipelines.mimic.common import (
    MimicConfig,
    _metric_scalars,
    append_result_row,
    patient_kfold_splits,
    storage_root,
)


def main(argv=None, cfg: MimicConfig = None, device=None):
    name = utils.extract_pipeline_name(__file__)
    args = utils.parse_args(argv=argv)
    cfg = cfg or MimicConfig()
    if args.epoch:
        cfg.epochs = args.epoch

    results_dir = os.path.join(storage_root(), "nips", "results")
    os.makedirs(results_dir, exist_ok=True)
    results_file = os.path.join(results_dir, name + "_(auc + bac).csv")

    # One JOINT-pathologies split table for every target's folds
    # (reference semantics, see joint_split_table).
    split_table = common.joint_split_table(cfg)

    all_results = []
    for target in cfg.targets:
        dataset_modn = MIMICDataset(
            cfg.sources, targets=[target],
            synthetic_kwargs={"n_patients": cfg.synthetic_patients})
        dataset_haim = MIMICDataset(
            cfg.sources, targets=[target], nanfill=True,
            synthetic_kwargs={"n_patients": cfg.synthetic_patients})
        partitions = dataset_modn.partitions
        part_modn = dataset_modn.partition_dataset(partitions)
        part_haim = dataset_haim.partition_dataset()

        fold_indices = list(
            patient_kfold_splits(dataset_modn, cfg.nfold, args.seed,
                                 patient=split_table))

        artifacts = None
        if args.save_model:
            artifacts = os.path.join(storage_root(), "models", target,
                                     "_".join(cfg.sources))
        fold_runs = common.run_all_folds_modn(
            cfg, part_modn, partitions, [target], fold_indices, args.seed,
            device, artifacts_dir=artifacts)

        seed = args.seed
        for fold, (tr, va, te) in enumerate(fold_indices):
            hp = [target, fold, cfg.miss_perc, seed, cfg.state_size,
                  cfg.batch_size, cfg.encoder_hidd_units,
                  cfg.decoder_hidd_units, cfg.dropout, cfg.epochs]
            _, info, test_modn = fold_runs[fold]
            print(f"[{target}] fold {fold}: best epoch "
                  f"{info['best_epoch']} score {info['best_score']:.4f} "
                  f"test auc {float(test_modn[0][1]):.4f}")
            row = ["modn"] + hp + _metric_scalars(test_modn[0])
            append_result_row(results_file, row)
            all_results.append(("modn", target, fold, float(test_modn[0][1])))

            _, test_haim = common.run_fold_haim(cfg, part_haim, tr, va, te,
                                                seed, device=device)
            row = ["haim"] + hp + _metric_scalars(test_haim)
            append_result_row(results_file, row)
            all_results.append(("haim", target, fold, float(test_haim[1])))
            seed += 1
    return all_results


if __name__ == "__main__":
    main()
