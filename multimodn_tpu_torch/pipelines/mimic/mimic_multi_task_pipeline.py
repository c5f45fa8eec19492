"""MIMIC multi-task pipeline (PyTorch twin of
``pipelines/mimic/mimic_multi_task_pipeline.py``): ONE model with a decoder
head per pathology, best-epoch selection on validation AUROC+BAC summed over
the targets, one results row per target; the HAIM baseline per target on the
same folds.

    python -m multimodn_tpu_torch.pipelines.mimic.mimic_multi_task_pipeline -e 3

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

    dataset_modn = MIMICDataset(
        cfg.sources, targets=cfg.targets,
        synthetic_kwargs={"n_patients": cfg.synthetic_patients})
    partitions = dataset_modn.partitions
    part_modn = dataset_modn.partition_dataset(partitions)

    fold_indices = list(
        patient_kfold_splits(dataset_modn, cfg.nfold, args.seed,
                             patient=common.joint_split_table(cfg)))
    artifacts = None
    if args.save_model:
        artifacts = os.path.join(storage_root(), "models", "multi_task",
                                 "_".join(cfg.sources))
    fold_runs = common.run_all_folds_modn(
        cfg, part_modn, partitions, cfg.targets, fold_indices, args.seed,
        device, artifacts_dir=artifacts)

    all_results = []
    seed = args.seed
    for fold, (tr, va, te) in enumerate(fold_indices):
        _, info, test_modn = fold_runs[fold]
        for t_idx, target in enumerate(cfg.targets):
            hp = [target, fold, cfg.miss_perc, seed, cfg.state_size,
                  cfg.batch_size, cfg.encoder_hidd_units,
                  cfg.decoder_hidd_units, cfg.dropout, cfg.epochs]
            row = ["modn"] + hp + _metric_scalars(test_modn[t_idx])
            append_result_row(results_file, row)
            all_results.append(("modn", target, fold,
                                float(test_modn[t_idx][1])))
            print(f"[multi:{target}] fold {fold}: best epoch "
                  f"{info['best_epoch']} test auc "
                  f"{float(test_modn[t_idx][1]):.4f}")

        # HAIM stays single-task: one baseline per target on the same folds.
        for target in cfg.targets:
            dataset_haim = MIMICDataset(
                cfg.sources, targets=[target], nanfill=True,
                synthetic_kwargs={"n_patients": cfg.synthetic_patients})
            part_haim = dataset_haim.partition_dataset()
            _, test_haim = common.run_fold_haim(cfg, part_haim, tr, va, te,
                                                seed, device=device)
            hp = [target, fold, cfg.miss_perc, seed, cfg.state_size,
                  cfg.batch_size, cfg.encoder_hidd_units,
                  cfg.decoder_hidd_units, cfg.dropout, cfg.epochs]
            row = ["haim"] + hp + _metric_scalars(test_haim)
            append_result_row(results_file, row)
            all_results.append(("haim", target, fold, float(test_haim[1])))
        seed += 1
    return all_results


if __name__ == "__main__":
    main()
