"""Every published MIMIC protocol CSV in one process (PyTorch twin of
``nips/run_all_protocols.py``), four stages at the published scale (300
synthetic patients, 100 epochs, 5 patient-stratified folds), each reusing
the pipeline or runner that computes it:

1. single-task: 2 targets x 5 folds, MultiModN against HAIM on the same
   folds, best epoch on val AUROC + BAC -> ``mimic_single_task_(auc +
   bac).csv``;
2. multi-task: the same protocol with 2 decoders ->
   ``mimic_multi_task_(auc + bac).csv``;
3. MNAR batch: the robustness grid (6 missingness levels, clean and
   flipped-class tests) with the batch-granular NaN skip ->
   ``mimic_single_task_mnar_missingness_(auc + bac).csv``,
   ``mnar_robustness_summary_batch.csv``, ``mnar_protocol_rows_batch.csv``;
4. MNAR sample: the per-sample skip; its pipeline rows go to a
   sub-directory of the storage root and are copied to
   ``mimic_single_task_mnar_missingness_(auc + bac)__nan_skip_sample.csv``,
   so the two variants' shared CSV never mixes.

Everything is written under ``$MULTIMODN_STORAGE`` (``common.
storage_root``, which refuses an unset variable and the repository root,
whose ``nips/results/`` holds the JAX package's records): the CSVs under
``nips/results/``, the saved models under ``models/``, the data cache under
``data/mimic/``. The results files are append-only, so the shared CSVs of
the stages that run are deleted first.

    MULTIMODN_STORAGE=<dir> python -m multimodn_tpu_torch.pipelines.mimic.all_protocols [patients epochs nfold]

runs on the GPU; ``main(..., device="cpu")`` runs on the CPU. ``stages``
selects stages (``--stages 3 4``), so that the full scale can run one
stage per process.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Dict, Sequence

import torch

from multimodn_tpu_torch.core.nn import resolve_device
from multimodn_tpu_torch.data import mimic as mimic_data
from multimodn_tpu_torch.pipelines.mimic import (
    mimic_multi_task_pipeline,
    mimic_single_task_pipeline,
    mnar_protocol,
)
from multimodn_tpu_torch.pipelines.mimic.common import MimicConfig, \
    storage_root

SHARED = [
    "mimic_single_task_(auc + bac).csv",
    "mimic_multi_task_(auc + bac).csv",
    "mimic_single_task_mnar_missingness_(auc + bac).csv",
]
SAMPLE_COPY = ("mimic_single_task_mnar_missingness_(auc + bac)"
               "__nan_skip_sample.csv")
STAGES = (1, 2, 3, 4)
STAGE_NAMES = {1: "single-task", 2: "multi-task", 3: "mnar batch",
               4: "mnar sample"}


def probe(device=None) -> torch.device:
    """A small matmul on ``device`` (CUDA unless named; raises without a
    GPU unless the CPU was asked for), so a card that cannot run surfaces
    before any stage."""
    device = resolve_device(device)
    t0 = time.time()
    x = torch.ones((8, 8), device=device)
    float((x @ x).sum())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[probe] {device} ({name}) matmul ok in {time.time() - t0:.1f}s",
          flush=True)
    return device


def main(patients: int = 300, epochs: int = 100, nfold: int = 5,
         device=None, stages: Sequence[int] = STAGES) -> Dict[str, float]:
    """Run ``stages`` in order; returns each stage's wall seconds by
    name."""
    stages = sorted(set(stages))
    if not set(stages) <= set(STAGES):
        raise ValueError(f"stages are among {STAGES}, got {stages}")
    storage = storage_root()
    results = os.path.join(storage, "nips", "results")
    device = probe(device)
    os.makedirs(results, exist_ok=True)
    for stage, name in zip(STAGES, SHARED):
        path = os.path.join(results, name)
        if stage in stages and os.path.isfile(path):
            os.remove(path)
            print(f"removed stale {name}")

    def cfg():
        return MimicConfig(epochs=epochs, nfold=nfold,
                           synthetic_patients=patients, nan_skip="batch")

    def mnar(nan_skip, **kw):
        mnar_protocol.main(patients=patients, epochs=epochs, nfold=nfold,
                           nan_skip=nan_skip, device=device, **kw)

    runs = {
        1: lambda: mimic_single_task_pipeline.main(["-s", "0"], cfg(),
                                                   device=device),
        2: lambda: mimic_multi_task_pipeline.main(["-s", "0"], cfg(),
                                                  device=device),
        3: lambda: mnar("batch"),
        4: lambda: _sample_stage(storage, results, mnar),
    }
    walls = {}
    cache_root = mimic_data.DEFAULT_CACHE_ROOT
    mimic_data.DEFAULT_CACHE_ROOT = os.path.join(storage, "data", "mimic")
    try:
        for stage in stages:
            t0 = time.time()
            runs[stage]()
            name = STAGE_NAMES[stage]
            walls[name] = time.time() - t0
            print(f"[{name}] done in {walls[name]:.1f}s", flush=True)
    finally:
        mimic_data.DEFAULT_CACHE_ROOT = cache_root
    print("all protocols regenerated", flush=True)
    return walls


def _sample_stage(storage, results, mnar):
    """Stage 4: the pipeline's rows to a fresh sub-directory of the storage
    root, the runner's summary and rows to ``results``; then the rows
    copied to ``SAMPLE_COPY`` and the sub-directory removed."""
    scratch = tempfile.mkdtemp(prefix="mnar_sample_storage_", dir=storage)
    saved = os.environ["MULTIMODN_STORAGE"]
    os.environ["MULTIMODN_STORAGE"] = scratch
    try:
        mnar("sample", out_dir=results)
    finally:
        os.environ["MULTIMODN_STORAGE"] = saved
    shutil.copy(os.path.join(scratch, "nips", "results", SHARED[2]),
                os.path.join(results, SAMPLE_COPY))
    shutil.rmtree(scratch)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("patients", type=int, nargs="?", default=300)
    p.add_argument("epochs", type=int, nargs="?", default=100)
    p.add_argument("nfold", type=int, nargs="?", default=5)
    p.add_argument("--stages", type=int, nargs="+", default=list(STAGES),
                   choices=STAGES)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.patients, args.epochs, args.nfold, args.device, args.stages)
