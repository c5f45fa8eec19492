"""The MNAR robustness protocol and its presence-penalty lambda sweep
(PyTorch twin of ``nips/run_mnar_protocol.py`` and
``nips/run_pp_lambda_sweep.py``), without pandas.

For each missingness level of ``MISS_PERCS`` the port's MNAR pipeline
(``mimic_single_task_mnar_missingness_pipeline``, ``-p <level> -s 0``) runs
2 targets x ``nfold`` folds of MultiModN and HAIM; every trained model is
tested on clean data (``both=False``) and, above 0%, on the flipped-class
degraded data (``both=True``). The test AUROCs are summarised by (model,
both, miss_perc) as mean, sample std and count, with pandas'
``groupby(...).agg(["mean", "std", "count"])`` arithmetic, and written as
``DataFrame.to_csv(index=False)`` text:

- ``mnar_robustness_summary_<tag>.csv``: the summary;
- ``mnar_protocol_rows_<tag>.csv``: one row per tested model.

``<tag>`` is the variant (``nan_skip``, or ``<nan_skip>_pp<lambda>`` with a
presence penalty), with ``_smoke`` appended below the published scale (300
patients, 100 epochs, 5 folds). The files go to
``$MULTIMODN_STORAGE/nips/results/``, beside the pipeline's own per-run CSV;
the protocol refuses to run when ``MULTIMODN_STORAGE`` is unset or names the
repository root, whose ``nips/results/`` holds the JAX package's records.

    python -m multimodn_tpu_torch.pipelines.mimic.mnar_protocol 300 100 5 sample 25
    python -m multimodn_tpu_torch.pipelines.mimic.mnar_protocol --lambdas 5 10 50 100

run on the GPU; ``main(..., device="cpu")`` and ``sweep(..., device="cpu")``
run on the CPU.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Sequence

import numpy as np

from multimodn_tpu_torch.data.table import write_csv
from multimodn_tpu_torch.pipelines.mimic import \
    mimic_single_task_mnar_missingness_pipeline as mnar_pipeline
# REPO_ROOT stays a name of this module: its tests point the storage rule
# at it.
from multimodn_tpu_torch.pipelines.mimic.common import REPO_ROOT, \
    MimicConfig, storage_root  # noqa: F401

MISS_PERCS = (0.0, 20.0, 40.0, 60.0, 80.0, 100.0)
ROW_COLUMNS = ("model", "target", "fold", "both", "miss_perc", "test_auc")
SUMMARY_COLUMNS = ("model", "both", "miss_perc", "mean", "std", "count")


def results_dir() -> str:
    """``$MULTIMODN_STORAGE/nips/results``, by ``common.storage_root``'s
    rule: raises when the variable is unset or names the repository
    root."""
    return os.path.join(storage_root(), "nips", "results")


def variant_name(nan_skip: str, presence_penalty: float) -> str:
    """``nan_skip``, or ``<nan_skip>_pp<lambda>`` with a presence penalty."""
    return nan_skip if not presence_penalty \
        else f"{nan_skip}_pp{presence_penalty:g}"


def variant_tag(nan_skip: str, presence_penalty: float, patients: int,
                epochs: int, nfold: int) -> str:
    """The files' tag: the variant, ``_smoke`` below the published scale."""
    variant = variant_name(nan_skip, presence_penalty)
    if patients >= 300 and epochs >= 100 and nfold >= 5:
        return variant
    return f"{variant}_smoke"


def _kahan_mean(values: Sequence[float]) -> float:
    """pandas' grouped mean: a compensated sum in row order."""
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / len(values)


def _welford_std(values: Sequence[float]) -> float:
    """pandas' grouped std (ddof 1): Welford's update in row order; NaN
    for a single value."""
    n, mean, m2 = 0, 0.0, 0.0
    for v in values:
        n += 1
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (n - 1)) if n > 1 else float("nan")


def summarize(rows: Dict[str, list]) -> Dict[str, np.ndarray]:
    """Mean, std and count of ``test_auc`` by (model, both, miss_perc), in
    ``groupby``'s sorted group order; ``both=None`` counts as False."""
    groups: Dict[tuple, List[float]] = {}
    for model, both, mp, auc in zip(rows["model"], rows["both"],
                                    rows["miss_perc"], rows["test_auc"]):
        groups.setdefault((model, bool(both), float(mp)), []).append(
            float(auc))
    keys = sorted(groups)
    return {
        "model": np.array([k[0] for k in keys], dtype=object),
        "both": np.array([k[1] for k in keys], dtype=bool),
        "miss_perc": np.array([k[2] for k in keys], dtype=np.float64),
        "mean": np.array([_kahan_mean(groups[k]) for k in keys]),
        "std": np.array([_welford_std(groups[k]) for k in keys]),
        "count": np.array([len(groups[k]) for k in keys], dtype=np.int64),
    }


def markdown_table(summary: Dict[str, np.ndarray], variant: str) -> str:
    """The flipped-class degraded-test AUROC per level (the clean test at
    0%), as the JAX script prints it."""
    lines = [f"### MNAR robustness, variant={variant} (flipped-class "
             "degraded test, mean AUROC over targets x folds)", "",
             "| model | " + " | ".join(f"{int(mp)}%" for mp in MISS_PERCS)
             + " |", "|---" * (len(MISS_PERCS) + 1) + "|"]
    for model in ("modn", "haim"):
        cells = []
        for mp in MISS_PERCS:
            sel = np.flatnonzero((summary["model"] == model)
                                 & (summary["miss_perc"] == mp)
                                 & (summary["both"] == (mp > 0)))
            cells.append(f"{float(summary['mean'][sel[0]]):.3f}"
                         if len(sel) else "—")
        lines.append(f"| {model} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(patients: int = 300, epochs: int = 100, nfold: int = 5,
         nan_skip: str = "batch", presence_penalty: float = 0.0,
         device=None) -> Dict[str, np.ndarray]:
    """Every level of ``MISS_PERCS`` through the MNAR pipeline; writes the
    summary and rows CSVs and prints the markdown table. Returns the
    summary as a dict of columns."""
    out_dir = results_dir()
    tag = variant_tag(nan_skip, presence_penalty, patients, epochs, nfold)
    rows: Dict[str, list] = {c: [] for c in ROW_COLUMNS}
    t_total = time.time()
    for mp in MISS_PERCS:
        cfg = MimicConfig(epochs=epochs, nfold=nfold,
                          synthetic_patients=patients, nan_skip=nan_skip,
                          presence_penalty=presence_penalty)
        t0 = time.time()
        res = mnar_pipeline.main(["-p", str(mp), "-s", "0"], cfg,
                                 device=device)
        for model, target, fold, both, auc in res:
            for c, v in zip(ROW_COLUMNS, (model, target, fold, bool(both),
                                          mp, auc)):
                rows[c].append(v)
        print(f"miss_perc={mp:5.1f}: {len(res)} rows in "
              f"{time.time() - t0:.1f}s", flush=True)
    print(f"protocol total: {time.time() - t_total:.1f}s")

    summary = summarize(rows)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"mnar_robustness_summary_{tag}.csv")
    write_csv(out, summary)
    print(f"wrote {out}")
    rows_out = os.path.join(out_dir, f"mnar_protocol_rows_{tag}.csv")
    write_csv(rows_out, {
        "model": np.array(rows["model"], dtype=object),
        "target": np.array(rows["target"], dtype=object),
        "fold": np.array(rows["fold"], dtype=np.int64),
        "both": np.array(rows["both"], dtype=bool),
        "miss_perc": np.array(rows["miss_perc"], dtype=np.float64),
        "test_auc": np.array(rows["test_auc"], dtype=np.float64)})
    print(f"wrote {rows_out}")
    print("\n" + markdown_table(summary,
                                 variant_name(nan_skip, presence_penalty)))
    print("\n(clean-test rows in the summary CSV under both=False)")
    return summary


def sweep(lambdas: Sequence[float] = (5.0, 10.0, 50.0, 100.0),
          patients: int = 300, epochs: int = 100, nfold: int = 5,
          device=None) -> Dict[float, Dict[str, np.ndarray]]:
    """The protocol under ``nan_skip='sample'`` for each presence-penalty
    lambda, each writing its own ``..._sample_pp<lambda>...`` files."""
    t0 = time.time()
    out = {}
    for lam in lambdas:
        t = time.time()
        print(f"=== lambda={lam:g} ===", flush=True)
        out[float(lam)] = main(patients=patients, epochs=epochs, nfold=nfold,
                               nan_skip="sample",
                               presence_penalty=float(lam), device=device)
        print(f"lambda={lam:g} done in {time.time() - t:.1f}s", flush=True)
    print(f"sweep total: {time.time() - t0:.1f}s")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("patients", type=int, nargs="?", default=300)
    p.add_argument("epochs", type=int, nargs="?", default=100)
    p.add_argument("nfold", type=int, nargs="?", default=5)
    p.add_argument("nan_skip", nargs="?", default="batch",
                   choices=("batch", "sample"))
    p.add_argument("presence_penalty", type=float, nargs="?", default=0.0)
    p.add_argument("--lambdas", type=float, nargs="*", default=None,
                   help="run the lambda sweep (nan_skip='sample') instead; "
                        "no values: 5 10 50 100")
    return p.parse_args(argv)


def cli(argv=None):
    args = parse_args(argv)
    if args.lambdas is not None:
        return sweep(tuple(args.lambdas) or (5.0, 10.0, 50.0, 100.0),
                     args.patients, args.epochs, args.nfold)
    return main(args.patients, args.epochs, args.nfold, args.nan_skip,
                args.presence_penalty)


if __name__ == "__main__":
    cli()
