"""The port's six Titanic pipelines against the JAX package's on the CPU,
their artifacts, and a twin of ``pipelines/test_all_pipelines.sh`` for them.

Each port pipeline starts from the JAX pipeline's initial weights
(``load_state_dict`` of the JAX ``build_model``) and splits its data the same
way (``tests/test_torch_titanic_data.py``). Tolerance: XLA's and PyTorch's
CPU products sum in different orders (~1e-7 relative), which stays at
float32 rounding over 2 epochs of Adam at lr 0.01: every history row (loss,
accuracy, sensitivity, specificity, balanced accuracy, state change) and
every final state of ``get_states`` agree to atol 1e-5. The results CSV of
one history is byte-equal to the JAX package's pandas file.
"""
import importlib
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import multimodn_tpu as jmm
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu_torch.pipelines.titanic import common as tcommon

ATOL = 1e-5
PIPELINES = ("titanic_mlp", "titanic_partitioned", "titanic_featurewise",
             "titanic_missingness", "titanic_lstm", "titanic_rnn")
NO_ARTIFACTS = ["-m", "false", "-y", "false", "-p", "false", "-r", "false"]
FIELDS = ("loss", "accuracy", "sensitivity", "specificity",
          "balanced_accuracy")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules(name):
    return (importlib.import_module(f"pipelines.titanic.{name}_pipeline"),
            importlib.import_module(
                f"multimodn_tpu_torch.pipelines.titanic.{name}_pipeline"))


def _from_jax_weights(monkeypatch, jconfig):
    from pipelines.titanic import common as jcommon
    build = tcommon.build_model

    def build_from_jax(cfg, seed, device=None):
        model = build(cfg, seed, device)
        model.load_state_dict(jcommon.build_model(jconfig, seed).state_dict())
        return model

    monkeypatch.setattr(tcommon, "build_model", build_from_jax)


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_matches_jax(name, monkeypatch):
    jmod, tmod = _modules(name)
    _from_jax_weights(monkeypatch, jmod.CONFIG)
    jmodel, jhist = jmod.main(["-e", "2"] + NO_ARTIFACTS)
    tmodel, thist = tmod.main(["-e", "2"] + NO_ARTIFACTS, device="cpu")
    for field in FIELDS:
        for tag in ("train", "val"):
            got = np.stack(getattr(thist, field)[tag])
            assert got.shape[0] == 2
            np.testing.assert_allclose(
                got, np.stack(getattr(jhist, field)[tag]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.stack(thist.state_change_loss),
                               np.stack(jhist.state_change_loss), rtol=0,
                               atol=ATOL)
    _train, val, _test = tcommon.split(tmod.CONFIG, 0)
    want = jmodel.get_states(JLoader(val, 32))
    got = tmodel.get_states(tcommon.loader(tmod.CONFIG, val))
    assert len(got) == len(want) == len(val)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=ATOL)


def _jax_history_like(hist):
    """A JAX ``MultiModNHistory`` holding the same arrays."""
    jhist = jmm.MultiModNHistory(hist.decoder_names)
    for field in FIELDS:
        setattr(jhist, field, {k: list(v) for k, v in
                               getattr(hist, field).items()})
    jhist.state_change_loss = list(hist.state_change_loss)
    return jhist


def test_pipeline_artifacts(tmp_path, monkeypatch):
    """With persistence on, the reference's artifacts appear next to the
    pipeline: the pickled model (which loads and predicts as the trained
    one), the pickled history, the plot and a results CSV byte-equal to the
    JAX package's ``to_csv`` of the same history."""
    _jmod, tmod = _modules("titanic_mlp")
    monkeypatch.setattr(tmod, "__file__",
                        str(tmp_path / "titanic_mlp_pipeline.py"))
    model, history = tmod.main(["-e", "2"], device="cpu")
    files = {d: sorted(os.listdir(tmp_path / d))
             for d in ("models", "plots", "results")}
    assert files == {"models": ["titanic_mlp_history.pkl",
                                "titanic_mlp_model.pkl"],
                     "plots": ["titanic_mlp.png"],
                     "results": ["titanic_mlp.csv"]}
    with open(tmp_path / "models" / "titanic_mlp_model.pkl", "rb") as f:
        loaded = pickle.load(f)
    assert loaded._chain_spec is None and loaded.opt_state is None
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    np.testing.assert_array_equal(loaded.predict_proba([x])[0],
                                  model.predict_proba([x])[0])
    with open(tmp_path / "models" / "titanic_mlp_history.pkl", "rb") as f:
        assert len(pickle.load(f).loss["val"]) == 2
    _jax_history_like(history).save_results(str(tmp_path / "jax.csv"))
    assert (tmp_path / "results" / "titanic_mlp.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("name", PIPELINES)
def test_all_pipelines_smoke(name):
    """``pipelines/test_all_pipelines.sh`` for the port: 5 epochs with
    persistence off."""
    _jmod, tmod = _modules(name)
    _model, history = tmod.main(["-e", "5"] + NO_ARTIFACTS, device="cpu")
    assert len(history.loss["train"]) == len(history.loss["val"]) == 5
    assert np.isfinite(np.stack(history.loss["train"])).all()
    assert np.isfinite(np.stack(history.loss["val"])).all()


def test_pipelines_run_without_jax_pandas_or_sklearn(tmp_path):
    """One epoch of every port pipeline with the results CSV on, in a
    process where importing jax, the JAX package, pandas, scikit-learn or
    matplotlib fails; the plot then raises instead of being skipped."""
    script = textwrap.dedent("""
        import importlib, os, sys
        for name in ("jax", "multimodn_tpu", "pandas", "sklearn",
                     "matplotlib"):
            sys.modules[name] = None       # any import of them now fails
        from multimodn_tpu_torch.pipelines.titanic import common
        for name in %r:
            mod = importlib.import_module(
                f"multimodn_tpu_torch.pipelines.titanic.{name}_pipeline")
            path = os.path.join(sys.argv[1], f"{name}_pipeline.py")
            model, hist = common.run(mod.CONFIG, path, ["-e", "1", "-p",
                                                        "false"], "cpu")
            assert os.path.exists(os.path.join(sys.argv[1], "results",
                                               f"{name}.csv"))
        try:
            hist.plot(os.path.join(sys.argv[1], "p.png"), ["Survived"])
        except ImportError:
            pass
        else:
            raise AssertionError("plot without matplotlib did not raise")
        print("ok")
    """ % (PIPELINES,))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
