"""The port's three MIMIC pipelines with ``resume_dir`` and with
``stream_folds`` on the CPU: each results CSV equals the default run's byte
for byte, a ``resume_dir`` run killed after a fold's first checkpoint and
re-invoked writes the default rows too, and the single-task pipeline with
``resume_dir`` and with ``stream_folds`` against the JAX script's CSV under
the same configuration.

Against JAX (transplanted weights, dropout 0): the hyper-parameter columns
and confusion counts must be equal and every AUROC within 1e-6 (a test
AUROC moves only if two test samples' scores swap order), as in
``test_torch_pipelines.py``.
"""
import csv
import importlib
import os

import pytest

from multimodn_tpu_torch import checkpoint as tckpt
from multimodn_tpu_torch.data import mimic as tmimic
from multimodn_tpu_torch.pipelines.mimic import common as tcommon

PIPELINES = {
    "single": ("mimic_single_task_pipeline", ["-e", "2"]),
    "multi": ("mimic_multi_task_pipeline", ["-e", "2"]),
    "mnar": ("mimic_single_task_mnar_missingness_pipeline",
             ["-e", "2", "-p", "50"]),
}
CONFIG = dict(sources=["de", "vd", "ts_ce"], nfold=2, synthetic_patients=24,
              dropout=0.0)


class Interrupt(Exception):
    pass


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    monkeypatch.setattr(tmimic, "DEFAULT_CACHE_ROOT", str(tmp_path / "cache"))
    return tmp_path


def _run(main, argv, storage, monkeypatch, **extra):
    """The pipeline's results CSV text, run under its own storage root."""
    monkeypatch.setenv("MULTIMODN_STORAGE", str(storage))
    main(argv, tcommon.MimicConfig(**CONFIG, **extra), device="cpu")
    results = storage / "nips" / "results"
    (name,) = os.listdir(results)
    with open(results / name) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_resume_and_stream_rows_equal_the_default_run(cache, monkeypatch,
                                                      name):
    module, argv = PIPELINES[name]
    main = importlib.import_module(
        f"multimodn_tpu_torch.pipelines.mimic.{module}").main
    want = _run(main, argv, cache / "default", monkeypatch)
    resume = str(cache / "resume")

    # Killed right after the third resume checkpoint lands (fold 0 done,
    # fold 1 one chunk in), then re-invoked: fold 0 is not retrained, fold
    # 1 resumes, and the rows are the default run's.
    write, writes = tckpt._write_resume_payload, []

    def write_then_die(*args, **kwargs):
        write(*args, **kwargs)
        writes.append(args[0])
        if len(writes) == 3:
            raise Interrupt

    monkeypatch.setattr(tckpt, "_write_resume_payload", write_then_die)
    with pytest.raises(Interrupt):
        _run(main, argv, cache / "killed", monkeypatch, resume_dir=resume)
    monkeypatch.setattr(tckpt, "_write_resume_payload", write)
    assert _run(main, argv, cache / "rerun", monkeypatch,
                resume_dir=resume) == want
    assert all(p.startswith(resume) for p in writes)
    assert _run(main, argv, cache / "stream", monkeypatch,
                stream_folds=True) == want
    assert _run(main, argv, cache / "stream_resume", monkeypatch,
                stream_folds=True, resume_dir=resume) == want
    streamed = [d for _, dirs, _ in os.walk(resume) for d in dirs
                if d.endswith("_stream")]
    assert len(streamed) == (2 if name == "multi" else 4)


def _rows(text):
    rows = list(csv.reader(text.splitlines()))
    return rows[0], rows[1:]


@pytest.mark.parametrize("option", ["resume_dir", "stream_folds"])
def test_single_task_rows_match_the_jax_script(cache, monkeypatch, option):
    from pipelines.mimic import common as jcommon
    from pipelines.mimic import mimic_single_task_pipeline as jscript
    from test_torch_pipelines import _transplant
    from multimodn_tpu_torch.pipelines.mimic import \
        mimic_single_task_pipeline as tscript

    module, argv = PIPELINES["single"]
    extra = {"resume_dir": str(cache / "jax_ck")} \
        if option == "resume_dir" else {"stream_folds": True}
    monkeypatch.setenv("MULTIMODN_STORAGE", str(cache / "jax"))
    jscript.main(argv, jcommon.MimicConfig(**CONFIG, **extra))
    results = cache / "jax" / "nips" / "results"
    with open(results / os.listdir(results)[0]) as f:
        jhead, jrows = _rows(f.read())
    _transplant(monkeypatch, jcommon.MimicConfig(**CONFIG))
    if option == "resume_dir":
        extra = {"resume_dir": str(cache / "port_ck")}
    thead, trows = _rows(_run(tscript.main, argv, cache / "port",
                              monkeypatch, **extra))
    assert thead == jhead and len(trows) == len(jrows) == 8
    n_hp = jhead.index("f1")
    auc = jhead.index("auc")
    counts = [jhead.index(k) for k in ("tn", "fp", "fn", "tp")]
    for t, j in zip(trows, jrows):
        assert t[:n_hp] == j[:n_hp]
        assert [t[i] for i in counts] == [j[i] for i in counts]
        assert float(t[auc]) == pytest.approx(float(j[auc]), abs=1e-6)
    if option == "resume_dir":
        def layout(root):
            return sorted(os.path.relpath(d, root)
                          for d, _, files in os.walk(root) if files)
        assert layout(cache / "port_ck") == layout(cache / "jax_ck")
