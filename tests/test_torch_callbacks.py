"""``on_epoch`` progress callbacks of the port's ``fit`` and ``fit_best``
against the JAX package's on the CPU: the same payload keys, one payload
per executed epoch in epoch order, delivered before the call returns, and
the values within 1e-5 relative of JAX's (losses) or 1e-5 absolute
(selection scores, as the k-fold parity test holds them). A callback
changes nothing about training, bit for bit.

JAX weights are transplanted with ``load_state_dict``; dropout is off, as
in every trajectory comparison. XLA's and PyTorch's CPU products sum in
different orders (~1e-7 relative), which stays at float32 rounding over a
few epochs of Adam.
"""
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
from multimodn_tpu.data.dataset import Subset as JSubset
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset
from multimodn_tpu_torch.data import Subset as TSubset

RTOL, ATOL = 1e-5, 1e-5
WIDTHS = (3, 3)


def _loaders(seed=0, n=80, n_train=56):
    """(JAX train, JAX val), (port train, port val) over the same rows,
    ~15% of the first modality's cells NaN."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(WIDTHS))).astype(np.float32)
    y = (X @ rng.normal(size=X.shape[1]) > 0).astype(np.int64)[:, None]
    X[rng.random(n) < 0.15, :WIDTHS[0]] = np.nan
    out = []
    for dataset, subset, loader in ((JDataset, JSubset, JLoader),
                                    (TDataset, TSubset, TLoader)):
        ds = dataset(X, y, list(WIDTHS))
        out.append((loader(subset(ds, list(range(n_train))), 16),
                    loader(subset(ds, list(range(n_train, n))), 16)))
    return out


def _models(seed=0):
    jm = jmm.MultiModN(2, [jenc.MLPEncoder(2, w, (4,)) for w in WIDTHS],
                       [jdec.LogisticDecoder(2)], 0.7, 0.3, seed=seed)
    tm = tmm.MultiModN(2, [tenc.MLPEncoder(2, w, (4,)) for w in WIDTHS],
                       [tdec.LogisticDecoder(2)], 0.7, 0.3, seed=seed,
                       device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _assert_payloads(got, want):
    """Ordered payload lists: equal keys and epochs, losses within RTOL,
    scores within ATOL; every value a Python number."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert type(g["epoch"]) is int and g["epoch"] == w["epoch"]
        for k in g:
            if k == "epoch":
                continue
            assert type(g[k]) is float, k
            if k == "score":
                assert g[k] == pytest.approx(w[k], abs=ATOL)
            else:
                assert g[k] == pytest.approx(w[k], rel=RTOL)


@pytest.mark.parametrize("with_val", [True, False])
def test_fit_payloads_match_jax(with_val):
    (jtr, jva), (ttr, tva) = _loaders(1)
    jm, tm = _models(1)
    want, got = [], []
    jm.fit(jtr, jmm.Adam(0.01), "cross_entropy", epochs=5,
           val_loader=jva if with_val else None, on_epoch=want.append)
    history = tmm.MultiModNHistory(["t"])
    tm.fit(ttr, tmm.Adam(0.01), "cross_entropy", epochs=5, history=history,
           val_loader=tva if with_val else None, on_epoch=got.append)
    assert [p["epoch"] for p in got] == list(range(5))
    assert ("val_loss" in got[0]) == with_val
    _assert_payloads(got, want)
    # The streamed train loss is the mean of the history's epoch grid.
    np.testing.assert_allclose([p["train_loss"] for p in got],
                               [float(np.mean(g))
                                for g in history.loss["train"]],
                               rtol=1e-6)


@pytest.mark.parametrize("optimizer, patience, ran", [
    ("adam", None, 4),
    # SGD(0.0) never moves the weights: the score never improves after
    # epoch 0, so patience 2 stops after epoch 2 (JAX test_callbacks.py:65).
    ("sgd0", 2, 3),
])
def test_fit_best_payloads_match_jax(optimizer, patience, ran):
    (jtr, jva), (ttr, tva) = _loaders(2)
    jm, tm = _models(2)
    jopt, topt = ((jmm.Adam(0.01), tmm.Adam(0.01)) if optimizer == "adam"
                  else (jmm.SGD(0.0), tmm.SGD(0.0)))
    want, got = [], []
    wres = jm.fit_best(jtr, jopt, "cross_entropy", epochs=4 if patience is
                       None else 20, val_loader=jva, patience=patience,
                       on_epoch=want.append)
    gres = tm.fit_best(ttr, topt, "cross_entropy", epochs=4 if patience is
                       None else 20, val_loader=tva, patience=patience,
                       on_epoch=got.append)
    assert gres["epochs_ran"] == wres["epochs_ran"] == ran
    assert [p["epoch"] for p in got] == list(range(ran))
    _assert_payloads(got, want)
    np.testing.assert_array_equal([p["score"] for p in got],
                                  gres["scores"].astype(np.float64))


@pytest.mark.parametrize("method", ["fit", "fit_best"])
def test_callback_does_not_change_training(method):
    """Bit for bit: parameters, optimizer state and history rows with and
    without a callback (and with a history or without one)."""
    _, (ttr, tva) = _loaders(4)
    runs = []
    for on_epoch in (None, lambda p: None):
        _, tm = _models(4)
        history = tmm.MultiModNHistory(["t"])
        getattr(tm, method)(ttr, tmm.Adam8bit(0.01), "cross_entropy",
                            epochs=3, val_loader=tva, history=history,
                            on_epoch=on_epoch)
        runs.append((tm, history))
    (a, ha), (b, hb) = runs
    for x, y in zip(tree_leaves([a.params, a.opt_state]),
                    tree_leaves([b.params, b.opt_state])):
        assert torch.equal(x, y)
    for tag in ("train", "val"):
        for x, y in zip(ha.loss[tag], hb.loss[tag]):
            np.testing.assert_array_equal(x, y)


def test_on_epoch_is_keyword_only():
    _, (ttr, tva) = _loaders(5)
    _, tm = _models(5)
    with pytest.raises(TypeError):
        tm.fit(ttr, tmm.Adam(0.01), "cross_entropy", 1, None, tva, "val",
               print)
