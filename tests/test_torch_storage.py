"""Where the port's MIMIC pipelines write: one rule for every pipeline and
the MNAR protocol (``pipelines/mimic/common.py::storage_root``). Without
``MULTIMODN_STORAGE``, or with it naming the repository root, they refuse
to run, so no row is ever appended to the JAX package's tracked
``nips/results/*.csv``. ``tests/conftest.py`` sets the variable for the
suite, so these tests unset it.
"""
import hashlib
import os

import pytest

from multimodn_tpu_torch.data import mimic as tmimic
from multimodn_tpu_torch.pipelines.mimic import common, mnar_protocol
from multimodn_tpu_torch.pipelines.mimic import \
    mimic_multi_task_pipeline as multi_task
from multimodn_tpu_torch.pipelines.mimic import \
    mimic_single_task_mnar_missingness_pipeline as mnar
from multimodn_tpu_torch.pipelines.mimic import \
    mimic_single_task_pipeline as single_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINES = {"single_task": single_task, "multi_task": multi_task,
             "mnar": mnar}


def _nips_files() -> dict:
    """Every file under the repository's ``nips/`` with its digest."""
    out = {}
    for root, _dirs, files in os.walk(os.path.join(REPO, "nips")):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipelines_leave_the_repository_alone(name, monkeypatch, tmp_path):
    """A tiny MIMIC run with the variable unset, then with it naming the
    repository root: each refuses, and no file under ``nips/`` changes."""
    monkeypatch.delenv("MULTIMODN_STORAGE", raising=False)
    monkeypatch.setattr(tmimic, "DEFAULT_CACHE_ROOT", str(tmp_path / "c"))
    before = _nips_files()
    cfg = common.MimicConfig(nfold=2, synthetic_patients=24)
    with pytest.raises(RuntimeError, match="set MULTIMODN_STORAGE"):
        PIPELINES[name].main(["-e", "1"], cfg, device="cpu")
    monkeypatch.setenv("MULTIMODN_STORAGE", REPO + os.sep)
    with pytest.raises(RuntimeError, match="repository root"):
        PIPELINES[name].main(["-e", "1"], cfg, device="cpu")
    assert _nips_files() == before


def test_one_rule_for_pipelines_and_the_mnar_protocol(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("MULTIMODN_STORAGE", str(tmp_path))
    assert common.storage_root() == str(tmp_path)
    assert mnar_protocol.results_dir() == os.path.join(
        str(tmp_path), "nips", "results")
    for value, match in ((None, "set MULTIMODN_STORAGE"),
                         ("", "set MULTIMODN_STORAGE"),
                         (REPO, "repository root")):
        if value is None:
            monkeypatch.delenv("MULTIMODN_STORAGE")
        else:
            monkeypatch.setenv("MULTIMODN_STORAGE", value)
        for fn in (common.storage_root, mnar_protocol.results_dir):
            with pytest.raises(RuntimeError, match=match):
                fn()
