"""The port's quick-start (``multimodn_tpu_torch/examples/quickstart.py``)
against the JAX package's ``examples/quickstart.py`` on the CPU.

The JAX file runs unmodified as a module: its ``MultiModN`` and
``MultiModNHistory`` are wrapped to capture the initial weights and the
history, and its ``export_model`` / ``load_model`` are pointed at a
temporary directory instead of its fixed ``/tmp`` path. The port's
``main`` then trains from those weights.

Tolerance: the method of ``tests/test_torch_dropin.py::
test_quickstart_body_matches_jax``, every history field within rtol 1e-5 /
atol 1e-6 (the same fp32 operations in another order, XLA against
PyTorch), over the first ``EXACT_EPOCHS`` of the 300 epochs. There the
runs agree within 1.2e-7; after ~30 epochs of ``Adam`` (~550 steps) a
rounding difference flips one ReLU unit's sign for a sample and the runs
part, by up to 0.011 in a training loss over 300 epochs on this data. So
every epoch's losses and metrics are held within ``PARTED`` (absolute)
besides.
"""
import importlib.util
import os

import numpy as np
import pytest

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.examples import quickstart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("loss", "accuracy", "sensitivity", "specificity",
          "balanced_accuracy")
EPOCHS = 300
EXACT_EPOCHS = 15
PARTED = 0.05


def _assert_histories(got, want):
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert set(g) == set(w), field
        for tag in w:
            assert len(g[tag]) == len(w[tag]) == EPOCHS
            g_tag = np.asarray(g[tag], np.float64)
            w_tag = np.asarray(w[tag], np.float64)
            np.testing.assert_allclose(
                g_tag[:EXACT_EPOCHS], w_tag[:EXACT_EPOCHS], rtol=RTOL,
                atol=ATOL, err_msg=f"{field}[{tag}]")
            np.testing.assert_allclose(g_tag, w_tag, rtol=0, atol=PARTED,
                                       err_msg=f"{field}[{tag}]")
    g = np.asarray(got.state_change_loss, np.float64)
    w = np.asarray(want.state_change_loss, np.float64)
    assert g.shape == w.shape
    np.testing.assert_allclose(g.ravel()[:EXACT_EPOCHS],
                               w.ravel()[:EXACT_EPOCHS], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """``examples/quickstart.py``'s ``main()`` once per module: the initial
    weights, the history, the trained model and the artifact directory."""
    spec = importlib.util.spec_from_file_location(
        "_jax_quickstart", os.path.join(ROOT, "examples", "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    artifact = str(tmp_path_factory.mktemp("jax_quickstart") / "artifact")
    seen = {"paths": []}
    model_cls, hist_cls = mod.MultiModN, mod.MultiModNHistory
    export, load = mod.export_model, mod.load_model

    def model(*a, **k):
        seen["model"] = model_cls(*a, **k)
        seen["initial"] = seen["model"].state_dict()
        return seen["model"]

    def history(*a, **k):
        seen["history"] = hist_cls(*a, **k)
        return seen["history"]

    def redirect(fn):
        def call(m_or_path, *rest):
            if isinstance(m_or_path, str):
                seen["paths"].append(m_or_path)
                return fn(artifact)
            seen["paths"].append(rest[0])
            return fn(m_or_path, artifact)
        return call

    mod.MultiModN, mod.MultiModNHistory = model, history
    mod.export_model, mod.load_model = redirect(export), redirect(load)
    mod.main()
    return seen, artifact


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The port's ``main(device="cpu")`` from the JAX run's initial
    weights, its artifact under a temporary ``workdir``."""
    seen, _ = jax_run
    work = str(tmp_path_factory.mktemp("port_quickstart"))
    build = quickstart.MultiModN

    def transplanted(*a, **k):
        model = build(*a, **k)
        model.load_state_dict(seen["initial"])
        return model

    quickstart.MultiModN = transplanted
    try:
        out = quickstart.main(device="cpu", workdir=work, epochs=EPOCHS)
    finally:
        quickstart.MultiModN = build
    return out, work


def test_history_matches_jax(jax_run, port_run):
    seen, _ = jax_run
    out, _ = port_run
    assert seen["paths"] == ["/tmp/titanic_artifact"] * 2
    model = out["model"]
    assert isinstance(model, tmm.MultiModN) and model.device.type == "cpu"
    assert isinstance(model.encoders[0], tenc.MLPEncoder)
    _assert_histories(out["history"], seen["history"])


def test_session_and_artifact_match_jax(jax_run, port_run):
    """The session's probabilities before and after the tabular modality
    are the trained model's own on the same four validation rows (within
    ``PARTED`` of the JAX run's); the artifact lies under ``workdir`` and
    each package's artifact loads in the other and answers as the model
    that wrote it."""
    seen, artifact = jax_run
    out, work = port_run
    x = out["rows"]
    assert x.shape == (4, len(quickstart.FEATURES))
    mine = out["model"].predict_proba([x])[0]         # (E+1, 4, 2)
    np.testing.assert_allclose(out["prior"], mine[0, :, 1], rtol=1e-6)
    np.testing.assert_allclose(out["after"], mine[1, :, 1], rtol=1e-6)
    theirs = np.asarray(seen["model"].predict_proba([x])[0])
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=PARTED)
    assert out["round_trip"]
    assert out["artifact"] == os.path.join(work, "titanic_artifact")
    from multimodn_tpu import load_model as jload
    np.testing.assert_allclose(
        np.asarray(jload(out["artifact"]).predict_proba([x])[0]), mine,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tmm.load_model(artifact, device="cpu").predict_proba([x])[0], theirs,
        rtol=1e-5, atol=1e-6)
    for metric in ("f1", "auroc", "accuracy"):
        assert 0.0 <= out["val"][metric] <= 1.0


def test_no_fixed_tmp_path(tmp_path, monkeypatch):
    """Without ``workdir`` the artifact goes to a temporary directory of its
    own, removed at the end; nothing is written at the JAX file's fixed
    ``/tmp/titanic_artifact``."""
    monkeypatch.setattr(quickstart.tempfile, "tempdir", str(tmp_path))
    before = os.path.exists("/tmp/titanic_artifact") and os.stat(
        "/tmp/titanic_artifact").st_mtime_ns
    out = quickstart.main(device="cpu", epochs=2)
    assert os.path.dirname(os.path.dirname(out["artifact"])) == str(tmp_path)
    assert not os.path.exists(out["artifact"])
    assert out["round_trip"]
    assert len(out["history"].loss["train"]) == 2
    after = os.path.exists("/tmp/titanic_artifact") and os.stat(
        "/tmp/titanic_artifact").st_mtime_ns
    assert before == after
