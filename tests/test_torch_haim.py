"""The port's HAIM baseline against the JAX package's on the CPU, on
transplanted weights and identical batches: the forward, ``fit_best``'s
per-epoch scores and ``best_epoch`` (with and without ``skip_last_val``),
``test``'s 15-tuple, ``fit`` and the ``state_dict`` round trip.

Tolerances: XLA's and PyTorch's CPU matrix products sum in different orders
(~1e-7 relative), so outputs and parameters agree to atol 1e-5 over a few
epochs of Adam; validation scores (AUROC + BAC on 24 samples) to 1e-5, and
``best_epoch`` exactly; the test suite's counts exactly, its rates and
curves to 1e-5.
"""
import numpy as np
import pytest
import torch

from multimodn_tpu import Adam as JAdam
from multimodn_tpu.baselines.haim import HAIM as JHAIM
from multimodn_tpu.baselines.haim import HAIMDecoder as JHAIMDecoder
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
from multimodn_tpu_torch import Adam as TAdam
from multimodn_tpu_torch.baselines import HAIM, HAIMDecoder
from multimodn_tpu_torch.convert import haim_params_from_jax
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset

ATOL = 1e-5
WIDTHS = (7, 30, 5)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(WIDTHS))).astype(np.float32)
    y = (X[:, :4].sum(1) + 0.5 * rng.normal(size=n) > 0).astype(np.int64)
    return X, y


def _loaders(X, y, batch=16):
    return (JLoader(JDataset(X, y, list(WIDTHS)), batch),
            TLoader(TDataset(X, y, list(WIDTHS)), batch))


def _models(seed=3, hidden=(16, 16)):
    jm = JHAIM(JHAIMDecoder(sum(WIDTHS), hidden), seed=seed)
    tm = HAIM(HAIMDecoder(sum(WIDTHS), hidden), seed=seed, device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _close_params(tm, jm, atol=ATOL):
    for a, b in zip(tree_leaves(tm.state_dict()),
                    tree_leaves({"layers": [dict(layer) for layer in
                                            jm.state_dict()["layers"]]})):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def test_forward_matches_jax():
    jm, tm = _models()
    X, _ = _data(40)
    want = np.asarray(jm.decoder.apply(jm.params, X))
    got = tm.decoder.apply(tm.params, torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.shape == (40, 2)


def test_state_dict_round_trip_and_transplant():
    jm, tm = _models()
    state = tm.state_dict()
    assert [sorted(layer) for layer in state["layers"]] == [["b", "w"]] * 3
    assert [layer["w"].shape for layer in state["layers"]] == \
        [(42, 16), (16, 16), (16, 2)]
    other = HAIM(HAIMDecoder(sum(WIDTHS), (16, 16)), seed=9, device="cpu")
    other.load_state_dict(state)
    _close_params(other, jm, atol=0)
    params = haim_params_from_jax(jm.state_dict(), "cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))
    with pytest.raises(ValueError, match="only 'layers'"):
        haim_params_from_jax({"layers": [], "x": 1}, "cpu")


@pytest.mark.parametrize("skip_last_val", [False, True])
def test_fit_best_matches_jax(skip_last_val):
    X, y = _data(120)
    jtr, ttr = _loaders(X[:90], y[:90])
    jva, tva = _loaders(X[90:], y[90:], batch=10)
    jm, tm = _models()
    want = jm.fit_best(jtr, JAdam(1e-2), "cross_entropy", epochs=4,
                       val_loader=jva, skip_last_val=skip_last_val)
    got = tm.fit_best(ttr, TAdam(1e-2), "cross_entropy", epochs=4,
                      val_loader=tva, skip_last_val=skip_last_val)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL)
    assert got["scores"].dtype == np.float32 and len(got["scores"]) == 4
    assert got["best_epoch"] == want["best_epoch"]
    assert got["best_score"] == pytest.approx(want["best_score"], abs=ATOL)
    if skip_last_val:
        assert got["best_epoch"] < 3
    _close_params(tm, jm)
    for a, b in zip(tree_leaves(got["best_params"]),
                    tree_leaves({"layers": [dict(x) for x in
                                            want["best_params"]["layers"]]})):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert tm._epoch_counter == jm._epoch_counter == 4


def test_fit_best_one_epoch_skip_last_val_keeps_the_initial_params():
    X, y = _data(60)
    jtr, ttr = _loaders(X[:40], y[:40])
    jva, tva = _loaders(X[40:], y[40:])
    jm, tm = _models()
    init = tm.state_dict()
    want = jm.fit_best(jtr, JAdam(1e-2), epochs=1, val_loader=jva,
                       skip_last_val=True)
    got = tm.fit_best(ttr, TAdam(1e-2), epochs=1, val_loader=tva,
                      skip_last_val=True)
    assert got["best_epoch"] == want["best_epoch"] == -1
    assert got["best_score"] == want["best_score"] == float("-inf")
    for a, b in zip(tree_leaves(tm.state_dict()), tree_leaves(init)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL)


def test_test_suite_matches_jax():
    X, y = _data(100, seed=2)
    jtr, ttr = _loaders(X[:70], y[:70])
    jte, tte = _loaders(X[70:], y[70:])
    jm, tm = _models()
    jm.fit(jtr, JAdam(1e-2), epochs=3)
    tm.fit(ttr, TAdam(1e-2), epochs=3)
    _close_params(tm, jm)
    want, got = jm.test(jte), tm.test(tte)
    assert len(got) == len(want) == 15
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (9, 10, 11, 12):               # tn, fp, fn, tp
            assert g == w
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=ATOL, rtol=0)
    out, t = tm.predict(tte)
    jout, jt = jm.predict(jte)
    assert out.shape == (30, 2) and np.array_equal(t, jt)
    np.testing.assert_allclose(out, jout, atol=ATOL)


def test_train_epoch_last_epoch_and_optimizer_state():
    X, y = _data(50)
    jtr, ttr = _loaders(X, y)
    jm, tm = _models()
    opt = TAdam(1e-2)
    assert tm.train_epoch(ttr, opt) is None
    state = tm.opt_state
    res = tm.train_epoch(ttr, opt, last_epoch=True)
    assert tm.opt_state["t"].item() == 2 * ttr.n_batches
    assert tm.opt_state is not state and len(res) == 15
    jopt = JAdam(1e-2)
    jm.train_epoch(jtr, jopt)
    jres = jm.train_epoch(jtr, jopt, last_epoch=True)
    assert res[1] == pytest.approx(jres[1], abs=ATOL)
    _close_params(tm, jm)
    tm.load_state_dict(tm.state_dict())
    assert tm.opt_state is None and tm._opt is None


def test_fit_best_requires_val_loader():
    _, tm = _models()
    X, y = _data(20)
    with pytest.raises(ValueError, match="val_loader"):
        tm.fit_best(_loaders(X, y)[1], TAdam(1e-2))
