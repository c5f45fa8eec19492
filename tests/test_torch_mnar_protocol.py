"""The port's MNAR robustness protocol runner
(``pipelines/mimic/mnar_protocol.py``) on the CPU: its summary against
pandas' ``groupby(...).agg(["mean", "std", "count"])`` on the same rows,
both CSV files byte-equal to ``DataFrame.to_csv(index=False)``, the file
tag, the storage guard, the CLI, the sweep, and a tiny run end to end.
"""
import os

import numpy as np
import pandas as pd
import pytest

from multimodn_tpu_torch.data import mimic as tmimic
from multimodn_tpu_torch.pipelines.mimic import mnar_protocol as proto


def _rows(seed):
    """Protocol-shaped rows: both models, both tests, some groups of one
    row (std NaN), AUROCs with ties and exact 0 and 1."""
    rng = np.random.default_rng(seed)
    rows = {c: [] for c in proto.ROW_COLUMNS}
    for mp in proto.MISS_PERCS[:4]:
        for model in ("modn", "haim"):
            for target in ("Cardiomegaly", "Enlarged Cardiomediastinum"):
                for fold in range(int(rng.integers(1, 4))):
                    for both in ([True, False] if mp > 0 else [None]):
                        auc = float(rng.choice([rng.random(), 0.0, 1.0, 0.5],
                                               p=[0.85, 0.05, 0.05, 0.05]))
                        for c, v in zip(proto.ROW_COLUMNS, (
                                model, target, fold, both, mp, auc)):
                            rows[c].append(v)
    # A group of one run: its std is NaN.
    for c, v in zip(proto.ROW_COLUMNS, ("modn", "Cardiomegaly", 0, True,
                                        100.0, float(rng.random()))):
        rows[c].append(v)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_and_csv_text_match_pandas(tmp_path, seed):
    rows = _rows(seed)
    df = pd.DataFrame(rows)
    df["both"] = df["both"].map({True: True, False: False, None: False})
    want = (df.groupby(["model", "both", "miss_perc"])["test_auc"]
            .agg(["mean", "std", "count"]).reset_index())
    got = proto.summarize(rows)
    assert list(got) == list(want.columns) == list(proto.SUMMARY_COLUMNS)
    for col in want.columns:
        np.testing.assert_array_equal(got[col], want[col].to_numpy())
    assert np.isnan(got["std"]).any()
    want.to_csv(tmp_path / "want.csv", index=False)
    proto.write_csv(str(tmp_path / "got.csv"), got)
    assert (tmp_path / "got.csv").read_bytes() == \
        (tmp_path / "want.csv").read_bytes()


def test_tag_rule_matches_the_jax_script():
    assert proto.variant_tag("batch", 0.0, 300, 100, 5) == "batch"
    assert proto.variant_tag("sample", 25.0, 300, 100, 5) == "sample_pp25"
    assert proto.variant_tag("sample", 2.5, 6485, 200, 10) == "sample_pp2.5"
    for cut in ((299, 100, 5), (300, 99, 5), (300, 100, 4)):
        assert proto.variant_tag("sample", 25.0, *cut) == "sample_pp25_smoke"
    assert proto.variant_tag("batch", 0.0, 120, 2, 2) == "batch_smoke"


def test_refuses_without_its_own_storage(monkeypatch):
    monkeypatch.delenv("MULTIMODN_STORAGE", raising=False)
    with pytest.raises(RuntimeError, match="set MULTIMODN_STORAGE"):
        proto.main(patients=10, epochs=1, nfold=2, device="cpu")
    monkeypatch.setenv("MULTIMODN_STORAGE", proto.REPO_ROOT + os.sep)
    with pytest.raises(RuntimeError, match="repository root"):
        proto.main(patients=10, epochs=1, nfold=2, device="cpu")


def test_cli_and_sweep_call_main_as_the_jax_scripts_do(monkeypatch):
    calls = []
    monkeypatch.setattr(proto, "main", lambda *a, **k: calls.append(
        (a, k)) or {})
    proto.cli(["120", "2", "3", "sample", "25"])
    assert calls[-1] == ((120, 2, 3, "sample", 25.0), {})
    proto.cli([])
    assert calls[-1] == ((300, 100, 5, "batch", 0.0), {})
    proto.cli(["--lambdas", "5", "50"])
    assert [c[1]["presence_penalty"] for c in calls[-2:]] == [5.0, 50.0]
    assert all(c[1]["nan_skip"] == "sample" and c[1]["patients"] == 300
               and c[1]["epochs"] == 100 for c in calls[-2:])
    del calls[:]
    out = proto.sweep(patients=40, epochs=1, nfold=2, device="cpu")
    assert [c[1]["presence_penalty"] for c in calls] == [5.0, 10.0, 50.0,
                                                         100.0]
    assert sorted(out) == [5.0, 10.0, 50.0, 100.0]


def test_tiny_run_end_to_end(tmp_path, monkeypatch, capsys):
    """Two levels, 30 patients, 2 folds, 1 epoch, sample + lambda 25: the
    rows (per level 2 targets x 2 folds x 2 models x (1 or 2 tests)), the
    files, the summary's shape and the markdown table."""
    monkeypatch.setattr(proto, "MISS_PERCS", (0.0, 50.0))
    monkeypatch.setenv("MULTIMODN_STORAGE", str(tmp_path / "store"))
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    monkeypatch.setattr(tmimic, "DEFAULT_CACHE_ROOT", str(tmp_path / "cache"))
    summary = proto.main(patients=30, epochs=1, nfold=2, nan_skip="sample",
                         presence_penalty=25.0, device="cpu")
    out = tmp_path / "store" / "nips" / "results"
    names = sorted(os.listdir(out))
    assert names == [
        "mimic_single_task_mnar_missingness_(auc + bac).csv",
        "mnar_protocol_rows_sample_pp25_smoke.csv",
        "mnar_robustness_summary_sample_pp25_smoke.csv"]
    rows = pd.read_csv(out / "mnar_protocol_rows_sample_pp25_smoke.csv",
                       float_precision="round_trip")
    assert len(rows) == 2 * 2 * 2 * (1 + 2)
    assert rows["both"].dtype == bool
    assert ((rows["test_auc"] >= 0) & (rows["test_auc"] <= 1)).all()
    # 2 models x (0%: clean; 50%: clean and flipped), 4 runs each.
    assert list(summary["model"]) == ["haim"] * 3 + ["modn"] * 3
    assert list(summary["both"]) == [False, False, True] * 2
    assert list(summary["count"]) == [4] * 6
    want = (rows.groupby(["model", "both", "miss_perc"])["test_auc"]
            .agg(["mean", "std", "count"]).reset_index())
    np.testing.assert_array_equal(summary["mean"], want["mean"].to_numpy())
    text = capsys.readouterr().out
    assert "### MNAR robustness, variant=sample_pp25 (flipped-class" in text
    assert "| model | 0% | 50% |" in text
    assert text.count("| modn | ") == text.count("| haim | ") == 1
