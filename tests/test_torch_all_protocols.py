"""The port's published-protocol runner (``multimodn_tpu_torch/pipelines/
mimic/all_protocols.py``) against the JAX package's
``nips/run_all_protocols.py`` on the CPU.

- Call-sequence parity: both scripts with their stage mains replaced by
  recorders make the same calls in the same order with the same
  arguments, delete the same stale files first and copy the same file
  last (the JAX script writing under a temporary ``RESULTS``).
- One real run at 40 patients, 1 epoch and 2 folds into a temporary
  ``MULTIMODN_STORAGE``: the eight CSVs the JAX script writes, by name and
  header, the data cache under the storage root and the repository's
  ``nips/results/`` untouched.
- The refusals: no ``MULTIMODN_STORAGE``, the repository root, no GPU.
"""
import csv
import dataclasses
import importlib
import importlib.util
import os
import sys

import pytest
import torch

from multimodn_tpu_torch.data import mimic as mimic_data
from multimodn_tpu_torch.pipelines.mimic import all_protocols, common, \
    mimic_multi_task_pipeline, mimic_single_task_pipeline, mnar_protocol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NIPS_RESULTS = os.path.join(ROOT, "nips", "results")
STALE = all_protocols.SHARED + [all_protocols.SAMPLE_COPY]


def _jax_script():
    if ROOT not in sys.path:
        sys.path.append(ROOT)
    spec = importlib.util.spec_from_file_location(
        "_jax_run_all_protocols", os.path.join(ROOT, "nips",
                                               "run_all_protocols.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seed_stale(results):
    os.makedirs(results, exist_ok=True)
    for name in STALE + ["keep.csv"]:
        with open(os.path.join(results, name), "w") as f:
            f.write("stale\n")


def _contents(results):
    out = {}
    for name in sorted(os.listdir(results)):
        with open(os.path.join(results, name)) as f:
            out[name] = f.read()
    return out


class Recorder:
    """Stand-ins for the stage mains: each records its stage, its
    arguments, where ``MULTIMODN_STORAGE`` points (unset, the run's
    storage, or a sub-directory) and which of the stale files remain, and
    writes the rows file its pipeline would write."""

    def __init__(self, results, storage=None):
        self.results, self.storage, self.calls = results, storage, []

    def _where(self):
        env = os.environ.get("MULTIMODN_STORAGE")
        if env is None or env == self.storage:
            return "results", self.results
        assert self.storage is None or os.path.dirname(env) == self.storage
        return "diverted", os.path.join(env, "nips", "results")

    def _record(self, stage, args, file):
        where, results = self._where()
        stale = sorted(n for n in STALE
                       if os.path.exists(os.path.join(self.results, n)))
        self.calls.append((stage, args, where, stale))
        os.makedirs(results, exist_ok=True)
        with open(os.path.join(results, file), "a") as f:
            f.write(f"{stage} {args}\n")

    def pipeline(self, stage, file):
        def main(argv, cfg, device=None):
            self._record(stage, (list(argv), dataclasses.asdict(cfg)), file)
            return []
        return main

    def mnar(self, patients, epochs, nfold, nan_skip="batch",
             presence_penalty=0.0, device=None, out_dir=None):
        self._record("mnar", dict(patients=patients, epochs=epochs,
                                  nfold=nfold, nan_skip=nan_skip,
                                  presence_penalty=presence_penalty),
                     all_protocols.SHARED[2])


def test_call_sequence_matches_the_jax_script(tmp_path, monkeypatch):
    jscript = _jax_script()
    import pipelines.mimic.mimic_multi_task_pipeline as jmulti
    import pipelines.mimic.mimic_single_task_pipeline as jsingle
    jmnar = importlib.import_module("nips.run_mnar_protocol")

    jresults = str(tmp_path / "jax" / "results")
    _seed_stale(jresults)
    jrec = Recorder(jresults)
    monkeypatch.setattr(jscript, "RESULTS", jresults)
    monkeypatch.setattr(jsingle, "main", jrec.pipeline(
        "single", all_protocols.SHARED[0]))
    monkeypatch.setattr(jmulti, "main", jrec.pipeline(
        "multi", all_protocols.SHARED[1]))
    monkeypatch.setattr(jmnar, "main", jrec.mnar)
    monkeypatch.delenv("MULTIMODN_STORAGE", raising=False)
    jscript.main(patients=40, epochs=3, nfold=2)

    storage = str(tmp_path / "port")
    tresults = os.path.join(storage, "nips", "results")
    _seed_stale(tresults)
    trec = Recorder(tresults, storage)
    monkeypatch.setattr(mimic_single_task_pipeline, "main", trec.pipeline(
        "single", all_protocols.SHARED[0]))
    monkeypatch.setattr(mimic_multi_task_pipeline, "main", trec.pipeline(
        "multi", all_protocols.SHARED[1]))
    monkeypatch.setattr(mnar_protocol, "main", trec.mnar)
    monkeypatch.setenv("MULTIMODN_STORAGE", storage)
    walls = all_protocols.main(patients=40, epochs=3, nfold=2, device="cpu")

    assert trec.calls == jrec.calls
    assert [c[0] for c in trec.calls] == ["single", "multi", "mnar", "mnar"]
    assert [c[2] for c in trec.calls] == ["results"] * 3 + ["diverted"]
    assert trec.calls[0][3] == [all_protocols.SAMPLE_COPY]
    assert trec.calls[0][1][1]["nan_skip"] == "batch"
    assert [c[1]["nan_skip"] for c in trec.calls[2:]] == ["batch", "sample"]
    assert _contents(tresults) == _contents(jresults)
    assert os.listdir(storage) == ["nips"]        # the sub-directory went
    assert list(walls) == ["single-task", "multi-task", "mnar batch",
                           "mnar sample"]


def test_stages_select_and_keep_the_other_stages_files(tmp_path,
                                                        monkeypatch):
    """``stages`` runs those stages in order and deletes only their shared
    files."""
    storage = str(tmp_path)
    results = os.path.join(storage, "nips", "results")
    _seed_stale(results)
    rec = Recorder(results, storage)
    monkeypatch.setattr(mimic_single_task_pipeline, "main", rec.pipeline(
        "single", all_protocols.SHARED[0]))
    monkeypatch.setattr(mnar_protocol, "main", rec.mnar)
    monkeypatch.setenv("MULTIMODN_STORAGE", storage)
    all_protocols.main(40, 1, 2, device="cpu", stages=(4, 1))
    assert [c[0] for c in rec.calls] == ["single", "mnar"]
    assert rec.calls[0][3] == sorted(all_protocols.SHARED[1:]
                                     + [all_protocols.SAMPLE_COPY])
    kept = _contents(results)
    assert kept[all_protocols.SHARED[1]] == kept[all_protocols.SHARED[2]] \
        == "stale\n"
    assert kept[all_protocols.SAMPLE_COPY].startswith("mnar ")
    with pytest.raises(ValueError, match="stages"):
        all_protocols.main(40, 1, 2, device="cpu", stages=(5,))


def _tree_stamp(top):
    out = {}
    for dirpath, _dirs, files in os.walk(top):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out[os.path.join(dirpath, f)] = (st.st_size, st.st_mtime_ns)
    return out


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_real_run_writes_the_jax_files(tmp_path, monkeypatch):
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    storage = str(tmp_path / "store")
    monkeypatch.setenv("MULTIMODN_STORAGE", storage)
    default_cache = str(tmp_path / "default_cache")
    monkeypatch.setattr(mimic_data, "DEFAULT_CACHE_ROOT", default_cache)
    watched = _tree_stamp(NIPS_RESULTS)
    with open(os.path.join(NIPS_RESULTS, all_protocols.SHARED[0]),
              "rb") as f:
        published = f.read()
    walls = all_protocols.main(patients=40, epochs=1, nfold=2, device="cpu")
    assert _tree_stamp(NIPS_RESULTS) == watched
    # The data cache went under the storage root, not the default root.
    assert mimic_data.DEFAULT_CACHE_ROOT == default_cache
    assert not os.path.exists(default_cache)
    assert os.listdir(os.path.join(storage, "data", "mimic"))
    with open(os.path.join(NIPS_RESULTS, all_protocols.SHARED[0]),
              "rb") as f:
        assert f.read() == published

    results = os.path.join(storage, "nips", "results")
    tagged = [f"mnar_{kind}_{variant}_smoke.csv"
              for variant in ("batch", "sample")
              for kind in ("robustness_summary", "protocol_rows")]
    assert sorted(os.listdir(results)) == sorted(
        all_protocols.SHARED + [all_protocols.SAMPLE_COPY] + tagged)
    for name in os.listdir(results):
        published_name = name.replace("_smoke", "")
        assert _header(os.path.join(results, name)) == _header(
            os.path.join(NIPS_RESULTS, published_name)), name
    assert sorted(os.listdir(storage)) == ["data", "models", "nips"]
    with open(os.path.join(results, all_protocols.SAMPLE_COPY)) as f:
        sample_rows = list(csv.DictReader(f))
    with open(os.path.join(results, all_protocols.SHARED[2])) as f:
        batch_rows = list(csv.DictReader(f))
    # 6 levels x 2 targets x 2 folds x (1 or 2 tests) x 2 models.
    assert len(sample_rows) == len(batch_rows) == 2 * 2 * 2 * 11
    for name in all_protocols.SHARED[:2]:
        with open(os.path.join(results, name)) as f:
            assert len(list(csv.DictReader(f))) == 8
    assert set(walls) == set(all_protocols.STAGE_NAMES.values())


@pytest.mark.parametrize("case", ["unset", "repo_root", "no_gpu"])
def test_refusals(tmp_path, monkeypatch, case):
    """Nothing runs and nothing is written: an unset ``MULTIMODN_STORAGE``
    or the repository root (whose ``nips/results/`` holds the JAX
    package's records), and, with no GPU, the default device."""
    ran = []
    monkeypatch.setattr(mimic_single_task_pipeline, "main",
                        lambda *a, **k: ran.append(a))
    device = "cpu"
    if case == "unset":
        monkeypatch.delenv("MULTIMODN_STORAGE", raising=False)
        match = "MULTIMODN_STORAGE"
    elif case == "repo_root":
        monkeypatch.setenv("MULTIMODN_STORAGE", common.REPO_ROOT)
        match = "repository root"
    else:
        monkeypatch.setenv("MULTIMODN_STORAGE", str(tmp_path))
        _seed_stale(os.path.join(str(tmp_path), "nips", "results"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        device, match = None, "device='cpu'"
    before = _tree_stamp(str(tmp_path)), _tree_stamp(NIPS_RESULTS)
    with pytest.raises(RuntimeError, match=match):
        all_protocols.main(40, 1, 2, device=device)
    assert not ran
    assert (_tree_stamp(str(tmp_path)), _tree_stamp(NIPS_RESULTS)) == before
