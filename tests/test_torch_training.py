"""The port's training slice against the JAX package on the CPU: the batch
loss and its gradients, dropout, the loader and split, ``train_epoch`` /
``test`` / ``fit`` / ``fit_best`` trajectories with their history rows,
selection and early stopping.

Inputs come from a seeded numpy generator; JAX weights are transplanted with
``load_state_dict``; dropout is 0 wherever the two are compared, because JAX
threefry and torch Philox draw different masks (dropout is tested alone).
Tolerances: XLA's and PyTorch's CPU matrix products sum in different orders
(~1e-7 relative per product), so losses and every gradient leaf agree to
atol 1e-5 at MIMIC width. Over a few epochs of Adam those differences stay at
float32 rounding (atol 1e-5 on histories and parameters); with Adam8bit a
moment that moved by one ulp may round to the neighbouring 8-bit code, which
moves one element's step by at most ~lr/8 (atol 1e-4 on parameters; the
history grids stay at 1e-5). Counts (accuracy, confusion) must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.core import metrics as jmetrics
from multimodn_tpu.core import step as jstep
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core import metrics as tmetrics
from multimodn_tpu_torch.core import nn as tnn
from multimodn_tpu_torch.core import step as tstep
from multimodn_tpu_torch.core.fusion import decode_grid
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset

ATOL = 1e-5
ATOL_8BIT_PARAMS = 1e-4
MIMIC_WIDTHS, MIMIC_S = (10, 1024, 768, 99), 50
SMALL_WIDTHS, SMALL_S = (5, 9, 4), 6
HISTORY_FIELDS = ("loss", "accuracy", "sensitivity", "specificity",
                  "balanced_accuracy")


def _models(widths, S, hidden, nan_skip="sample", seed=3, **kw):
    jm = jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, hidden, dropout=0.0) for w in widths],
        [jdec.MLPDecoder(S, hidden, 2) for _ in range(2)], 1.0, 0.5,
        seed=seed, nan_skip=nan_skip, chain_mode="unrolled", **kw)
    tm = tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, hidden, dropout=0.0) for w in widths],
        [tdec.MLPDecoder(S, hidden, 2) for _ in range(2)], 1.0, 0.5,
        seed=seed, nan_skip=nan_skip, device="cpu", **kw)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _data(n, widths, seed=0, missing=0.3):
    """Features, two labels from a linear rule, and a share of (sample,
    modality) cells set to NaN."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    y = np.stack([X[:, :3].sum(1) > 0, X[:, -3:].sum(1) > 0], 1) \
        .astype(np.int64)
    off = np.cumsum((0,) + tuple(widths[:-1]))
    for e, (o, w) in enumerate(zip(off, widths)):
        X[rng.random(n) < missing, o:o + w] = np.nan
    return X, y


def _loaders(X, y, widths, batch=16, **kw):
    return (JLoader(JDataset(X, y, list(widths)), batch, **kw),
            TLoader(TDataset(X, y, list(widths)), batch, **kw))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _params_close(jm, tm, atol):
    for a, b in zip(jax.tree_util.tree_leaves(jm.state_dict()),
                    tree_leaves(tm.params)):
        _close(b.numpy(), a, atol)


def _histories_close(jh, th, tags):
    for tag in tags:
        for field in HISTORY_FIELDS:
            _close(np.stack(getattr(th, field)[tag]),
                   np.stack(getattr(jh, field)[tag]))
    _close(np.stack(th.state_change_loss), np.stack(jh.state_change_loss))


@pytest.mark.parametrize("nan_skip", ["sample", "batch", "none"])
def test_loss_and_every_gradient_match_jax(nan_skip):
    """At MIMIC width, batch 16 with a padded tail: the loss, every
    gradient leaf and the aux grids."""
    jm, tm = _models(MIMIC_WIDTHS, MIMIC_S, (32, 32), nan_skip)
    X, y = _data(16, MIMIC_WIDTHS, missing=0.0 if nan_skip == "none"
                 else 0.3)
    if nan_skip == "batch":
        X[3, :10] = np.nan          # encoder 0 skipped for the whole batch
    off = np.cumsum((0,) + MIMIC_WIDTHS[:-1])
    data = [X[:, o:o + w] for o, w in zip(off, MIMIC_WIDTHS)]
    mask = np.ones(16, np.float32)
    mask[13:] = 0.0
    order = tuple((i, i) for i in range(4))

    jloss_fn = jm._loss_fn(jmm.core.losses.cross_entropy_loss, order,
                           nan_skip)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jm.params, tuple(jnp.asarray(d) for d in data), jnp.asarray(y),
        jnp.asarray(mask), jax.random.PRNGKey(0), 0, True)

    tloss_fn = tstep.make_batch_loss_fn(
        tm.encoders, tm.decoders, tm.init_state, resolve_criterion(None),
        tm.err_penalty, tm.state_change_penalty, order, nan_skip)
    live = tree_map(lambda t: t.detach().requires_grad_(), tm.params)
    tloss, taux = tloss_fn(live, tuple(torch.from_numpy(d.copy())
                                       for d in data),
                           torch.from_numpy(y), torch.from_numpy(mask),
                           None, 0, True)
    tgrads = torch.autograd.grad(tloss, tree_leaves(live),
                                 allow_unused=True)

    _close(tloss.item(), float(jloss))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads) == 37
    for a, b in zip(jleaves, tgrads):
        _close(b.numpy(), a)
    for key in tstep.GRID_KEYS:
        _close(taux[key].detach().numpy(), jaux[key])
    if nan_skip == "batch":
        np.testing.assert_array_equal(taux["enc_gates"].numpy(),
                                      np.asarray(jaux["enc_gates"]))
        assert taux["enc_gates"][0].item() == 0.0
    else:
        assert taux["enc_gates"] is None and jaux["enc_gates"] is None


def test_dropout_keep_rate_and_scaling():
    """torch Philox and JAX threefry draw different masks, so dropout is
    held to its definition: kept elements scaled by 1/keep, the rest 0, at
    a keep rate within 5 standard deviations of 1 - rate; the identity in
    evaluation."""
    x = torch.full((400, 250), 3.0)
    gen = torch.Generator().manual_seed(0)
    out = tnn.dropout(x, 0.2, gen, True)
    kept = out != 0
    np.testing.assert_allclose(out[kept].numpy(), 3.0 / 0.8, rtol=1e-7)
    n = x.numel()
    assert abs(kept.float().mean().item() - 0.8) < 5 * (0.8 * 0.2 / n) ** .5
    # The same generator state gives the same mask: the draw is
    # ``uniform < keep``.
    gen = torch.Generator().manual_seed(0)
    mask = torch.rand(x.shape, generator=gen) < 0.8
    assert torch.equal(kept, mask)
    assert tnn.dropout(x, 0.2, gen, False) is x
    assert tnn.dropout(x, 0.2, None, True) is x
    enc = tenc.MIMICMLPEncoder(4, 3, (5,), dropout=0.5)
    params = enc.init(torch.Generator().manual_seed(1))
    xs, st = torch.ones(2, 3), torch.ones(2, 4)
    assert torch.equal(enc.apply(params, st, xs), enc.apply(params, st, xs))
    assert not torch.equal(
        enc.apply(params, st, xs, train=True,
                  generator=torch.Generator().manual_seed(2)),
        enc.apply(params, st, xs))


def test_split_and_loader_stacks_match_jax():
    X, y = _data(53, SMALL_WIDTHS)
    jsplit = JDataset(X, y, list(SMALL_WIDTHS)).random_split(
        (0.6, 0.4, 0), seed=4, balanced_target_idx=0)
    tsplit = TDataset(X, y, list(SMALL_WIDTHS)).random_split(
        (0.6, 0.4, 0), seed=4, balanced_target_idx=0)
    for a, b in zip(jsplit, tsplit):
        assert a.indices == b.indices
    jl, tl = JLoader(jsplit[0], 8, shuffle=True, seed=1), \
        TLoader(tsplit[0], 8, shuffle=True, seed=1)
    for _ in range(2):
        jl.reshuffle()
        tl.reshuffle()
        jd, jt, jmask = jl.host_stacks()
        td, tt, tmask = tl.stacks("cpu")
        for a, b in zip(jd, td):
            np.testing.assert_array_equal(b.numpy(), a)
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tmask.numpy(), jmask)
    n = tl.n_samples
    assert tl.batch_counts() == [8] * (n // 8) + [n % 8] * (n % 8 > 0)


@pytest.mark.parametrize("optimizer", ["adam", "adam8bit"])
def test_train_epoch_and_test_trajectory_match_jax(optimizer):
    """Three epochs of ``train_epoch`` then ``test``: history rows,
    parameters and the performance tuples."""
    X, y = _data(70, SMALL_WIDTHS)
    jl, tl = _loaders(X, y, SMALL_WIDTHS)
    jm, tm = _models(SMALL_WIDTHS, SMALL_S, (8, 8))
    jopt, topt = {"adam": (jmm.Adam(0.01), tmm.Adam(0.01)),
                  "adam8bit": (jmm.Adam8bit(0.01),
                               tmm.Adam8bit(0.01))}[optimizer]
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    for _ in range(3):
        jm.train_epoch(jl, jopt, "cross_entropy", jh)
        tm.train_epoch(tl, topt, "cross_entropy", th)
    _params_close(jm, tm, ATOL if optimizer == "adam" else ATOL_8BIT_PARAMS)
    jres = jm.test(jl, "cross_entropy", jh, tag="val")
    tres = tm.test(tl, "cross_entropy", th, tag="val")
    _histories_close(jh, th, ("train", "val"))
    for a, b in zip(jres, tres):
        for i, (va, vb) in enumerate(zip(a, b)):
            # tn, fp, fn, tp are counts; the rest are rates and curves.
            _close(vb, va, 0 if 9 <= i <= 12 else ATOL)
    assert len(th.loss["train"]) == 3 and th.loss["train"][0].shape == (4, 2)


def test_fit_with_val_matches_jax():
    X, y = _data(64, SMALL_WIDTHS, seed=1)
    jl, tl = _loaders(X[:48], y[:48], SMALL_WIDTHS)
    jv, tv = _loaders(X[48:], y[48:], SMALL_WIDTHS)
    jm, tm = _models(SMALL_WIDTHS, SMALL_S, (8,))
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    jm.fit(jl, jmm.Adam(0.01), "cross_entropy", epochs=3, history=jh,
           val_loader=jv)
    assert tm.fit(tl, tmm.Adam(0.01), "cross_entropy", epochs=3, history=th,
                  val_loader=tv) is th
    _histories_close(jh, th, ("train", "val"))
    _params_close(jm, tm, ATOL)


@pytest.mark.parametrize("patience", [None, 1])
def test_fit_best_matches_jax(patience):
    """Selection on val AUROC + BAC and the early stop: best epoch, scores,
    epochs run, best parameters and the restored model."""
    X, y = _data(96, SMALL_WIDTHS, seed=2)
    jl, tl = _loaders(X[:64], y[:64], SMALL_WIDTHS)
    jv, tv = _loaders(X[64:], y[64:], SMALL_WIDTHS)
    jm, tm = _models(SMALL_WIDTHS, SMALL_S, (8,), seed=5)
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    kw = dict(epochs=8, patience=patience)
    jr = jm.fit_best(jl, jmm.Adam(0.05), "cross_entropy", val_loader=jv,
                     history=jh, **kw)
    tr = tm.fit_best(tl, tmm.Adam(0.05), "cross_entropy", val_loader=tv,
                     history=th, **kw)
    assert tr["epochs_ran"] == jr["epochs_ran"]
    assert tr["best_epoch"] == jr["best_epoch"]
    _close(tr["scores"], jr["scores"])
    _close(tr["best_score"], jr["best_score"])
    # The score first falls after epoch 5 on this data.
    assert tr["epochs_ran"] == (6 if patience else 8)
    _histories_close(jh, th, ("train", "val"))
    for a, b in zip(jax.tree_util.tree_leaves(jr["best_params"]),
                    jax.tree_util.tree_leaves(tr["best_params"])):
        _close(b, a)
    _params_close(jm, tm, ATOL)      # both restored the best epoch


def test_fit_best_rejects_bad_arguments():
    X, y = _data(32, SMALL_WIDTHS)
    _, tl = _loaders(X, y, SMALL_WIDTHS)
    _, tm = _models(SMALL_WIDTHS, SMALL_S, (8,))
    with pytest.raises(ValueError, match="val_loader"):
        tm.fit_best(tl, tmm.Adam(0.01))
    with pytest.raises(ValueError, match="patience"):
        tm.fit_best(tl, tmm.Adam(0.01), val_loader=tl, patience=0)


def test_selection_score_and_auroc_match_jax():
    rng = np.random.default_rng(3)
    outs = [rng.random((40, 2)).astype(np.float32) for _ in range(2)]
    outs[0][:5] = 0.5                       # ties
    targets = rng.integers(0, 2, (5, 8, 2))
    mask = np.ones((5, 8), np.float32)
    mask[4, 3:] = 0
    want = jstep.make_selection_score([True, True])(
        [jnp.asarray(o) for o in outs], jnp.asarray(targets),
        jnp.asarray(mask))
    got = tstep.make_selection_score([True, True])(
        [torch.from_numpy(o) for o in outs], torch.from_numpy(targets),
        torch.from_numpy(mask))
    _close(got.item(), float(want), 1e-6)
    assert tstep.make_selection_score([False, True])(
        [torch.from_numpy(o) for o in outs], torch.from_numpy(targets),
        torch.from_numpy(mask)).item() != got.item()
    probs = rng.random(300).astype(np.float32).round(2)
    labels = rng.integers(0, 2, 300)
    valid = (rng.random(300) < 0.8).astype(np.float32)
    _close(tmetrics.masked_binary_auroc(torch.from_numpy(probs),
                                        torch.from_numpy(labels),
                                        torch.from_numpy(valid)).item(),
           float(jmetrics.masked_binary_auroc(probs, labels, valid)), 1e-6)


def test_decode_grid_and_epoch_reduction_match_jax():
    """A 3-class head gets NaN confusion columns; a dead row (batch skip)
    keeps zeros; the epoch reduction's ones-initialised counts."""
    from multimodn_tpu.core.fusion import decode_grid as jdecode_grid
    rng = np.random.default_rng(4)
    S = 5
    jdecs = [jdec.MLPDecoder(S, (4,), 2), jdec.ClassDecoder(S, 3, "softmax")]
    tdecs = [tdec.MLPDecoder(S, (4,), 2), tdec.ClassDecoder(S, 3, "softmax")]
    jparams = {"decoders": [d.init(jax.random.PRNGKey(i))
                            for i, d in enumerate(jdecs)]}
    tparams = tmm.params_from_jax({"encoders": [], **jparams}, "cpu")
    states = rng.normal(size=(3, 7, S)).astype(np.float32)
    targets = np.stack([rng.integers(0, 2, 7), rng.integers(0, 3, 7)], 1)
    mask = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
    row_ok = np.array([1, 0, 1], np.float32)
    want = jdecode_grid(jdecs, jparams, jnp.asarray(states),
                        jnp.asarray(targets), jnp.asarray(mask),
                        jnp.asarray(row_ok),
                        jmm.core.losses.cross_entropy_loss)
    got = decode_grid(tdecs, tparams, torch.from_numpy(states),
                      torch.from_numpy(targets), torch.from_numpy(mask),
                      torch.from_numpy(row_ok), resolve_criterion(None))
    for key in ("err_loss", "n_correct", "tp", "tn", "fp", "fn"):
        _close(got[key].numpy(), want[key], 1e-6)
    assert np.isnan(got["tp"][:, 1].numpy()).all()
    sums = {k: np.asarray(want[k]) for k in ("err_loss", "n_correct", "tp",
                                             "tn", "fp", "fn")}
    sums["state_change"] = np.ones(2, np.float32)
    sums["n_counted"] = np.array([5.0, 0.0, 5.0], np.float32)
    jred = jstep.epoch_reduction(sums, 2)
    tred = tstep.epoch_reduction({k: torch.tensor(v)
                                  for k, v in sums.items()}, 2)
    for key, value in jred.items():
        _close(tred[key].numpy(), value, 1e-7)


def test_predict_from_loader_matches_jax():
    X, y = _data(37, SMALL_WIDTHS, missing=0.0)
    jl, tl = _loaders(X, y, SMALL_WIDTHS, batch=10)
    jm, tm = _models(SMALL_WIDTHS, SMALL_S, (8,))
    np.testing.assert_array_equal(tm.predict(tl), jm.predict(jl))
    for a, b in zip(jm.predict_proba(jl), tm.predict_proba(tl)):
        assert b.shape == (4, 37, 2)
        _close(b, a)


def test_static_init_state_cycle_continues_through_training():
    """A StaticInitState bank hands out rows round-robin across batches,
    epochs and calls, as the reference's shared itertools.cycle does."""
    bank = np.random.default_rng(5).normal(size=(3, SMALL_S)) \
        .astype(np.float32)
    X, y = _data(40, SMALL_WIDTHS, seed=6)
    jl, tl = _loaders(X, y, SMALL_WIDTHS, batch=16)
    jm, tm = _models(SMALL_WIDTHS, SMALL_S, (8,),
                     init_state=None)
    jm2 = jmm.MultiModN(
        SMALL_S, jm.encoders, jm.decoders, 1.0, 0.5, seed=3,
        init_state=jmm.StaticInitState(list(bank)), chain_mode="unrolled")
    tm2 = tmm.MultiModN(
        SMALL_S, tm.encoders, tm.decoders, 1.0, 0.5, seed=3,
        init_state=tmm.StaticInitState(list(bank)), device="cpu")
    tm2.load_state_dict(jm2.state_dict())
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    for _ in range(2):
        jm2.train_epoch(jl, jmm.Adam(0.01), "cross_entropy", jh)
        tm2.train_epoch(tl, tmm.Adam(0.01), "cross_entropy", th)
    jm2.test(jl, "cross_entropy", jh)
    tm2.test(tl, "cross_entropy", th)
    assert tm2._cycle_offset == jm2._cycle_offset == (3 * 40) % 3
    _histories_close(jh, th, ("train", "test"))


def test_log_interval_last_epoch_and_history_results():
    X, y = _data(48, SMALL_WIDTHS, seed=7)
    jl, tl = _loaders(X, y, SMALL_WIDTHS)
    jm, tm = _models(SMALL_WIDTHS, SMALL_S, (8,))
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    jlines, tlines = [], []
    jres = jm.train_epoch(jl, jmm.Adam(0.01), "cross_entropy", jh,
                          log_interval=2, logger=jlines.append,
                          last_epoch=True)
    tres = tm.train_epoch(tl, tmm.Adam(0.01), "cross_entropy", th,
                          log_interval=2, logger=tlines.append,
                          last_epoch=True)
    assert len(tlines) == len(jlines) == 1
    assert tlines[0].splitlines()[0] == jlines[0].splitlines()[0] == \
        "Batch 2/3"
    assert len(tres) == len(jres) == 2
    _close(tres[0][1], jres[0][1])
    jdf, tdf = jh.get_results(), th.get_results()
    assert list(tdf.columns) == list(jdf.columns)
    _close(tdf.values, jdf.values)


def test_unported_training_options_raise():
    X, y = _data(32, SMALL_WIDTHS)
    _, tl = _loaders(X, y, SMALL_WIDTHS)
    encs = [tenc.MIMICMLPEncoder(SMALL_S, w, (8,)) for w in SMALL_WIDTHS]
    decs = [tdec.LogisticDecoder(SMALL_S)]
    # shuffle_mode's per-call cadence (an explicit unrolled chain) cannot
    # redraw per epoch inside fit, so fit refuses it, as the JAX package's
    # _validate_fused_shuffle does.
    for kw in ({"shuffle_mode": True, "chain_mode": "unrolled"},):
        tm = tmm.MultiModN(SMALL_S, encs, decs, 1.0, 0.0, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="per-call"):
            tm.fit(tl, tmm.Adam(0.01))
        assert tm.opt_state is None


def test_criteria_resolve_like_the_jax_package():
    import torch.nn as nn
    ce = resolve_criterion(nn.CrossEntropyLoss())
    assert ce is resolve_criterion("cross_entropy") is resolve_criterion(None)
    two_arg = resolve_criterion(lambda out, tgt: out.mean())
    assert two_arg._accepts_mask is False
    with pytest.raises(ValueError, match="positional"):
        resolve_criterion(lambda out, tgt, gamma: out.mean())
    with pytest.raises(ValueError, match="Unknown loss"):
        resolve_criterion("hinge")
    with pytest.raises(NotImplementedError, match="label_smoothing"):
        resolve_criterion(nn.CrossEntropyLoss(label_smoothing=0.1))
