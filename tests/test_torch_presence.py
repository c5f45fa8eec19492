"""The port's MNAR mitigations (``presence_penalty``, ``presence_dropout``)
against the JAX package on the CPU: the penalised loss and every gradient
leaf against ``jax.grad`` at the MIMIC width, the same with JAX's own
dropout masks injected, the port's own draw, evaluation, the guards, a
``fit_best`` trajectory, and the flipped-class rescue.

JAX weights are transplanted with ``load_state_dict``; encoder dropout is 0
(JAX threefry and torch Philox draw different masks, so presence dropout is
held to JAX through injected masks and to its rate by a statistical test).
Tolerances: XLA's and PyTorch's CPU products sum in different orders (~1e-7
relative per product): the loss to 1e-6 relative, every gradient leaf and
trajectory value to atol 1e-5, counts and epochs exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core import step as tstep
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset

ATOL = 1e-5
MIMIC_WIDTHS, MIMIC_S = (10, 1024, 768, 99), 50
SMALL_WIDTHS, SMALL_S = (5, 9, 4), 6
LAMBDA = 25.0


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _models(widths, S, hidden, seed=3, **kw):
    jm = jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, hidden, dropout=0.0) for w in widths],
        [jdec.MLPDecoder(S, hidden, 2) for _ in range(2)], 1.0, 0.5,
        seed=seed, chain_mode="unrolled", **kw)
    tm = tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, hidden, dropout=0.0) for w in widths],
        [tdec.MLPDecoder(S, hidden, 2) for _ in range(2)], 1.0, 0.5,
        seed=seed, device="cpu", **kw)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _data(n, widths, seed=0, missing=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    y = np.stack([X[:, :3].sum(1) > 0, X[:, -3:].sum(1) > 0], 1) \
        .astype(np.int64)
    off = np.cumsum((0,) + tuple(widths[:-1]))
    for o, w in zip(off, widths):
        X[rng.random(n) < missing, o:o + w] = np.nan
    return X, y


def _batch(widths, n=16, n_pad=3, seed=0):
    X, y = _data(n, widths, seed)
    off = np.cumsum((0,) + widths[:-1])
    data = [X[:, o:o + w] for o, w in zip(off, widths)]
    data[2][4, data[2].shape[1] // 2] = np.nan   # one missing entry
    mask = np.ones(n, np.float32)
    mask[n - n_pad:] = 0.0
    return data, y, mask


def _jax_masks(rng, p, n_mod, batch):
    """The masks JAX's ``_inject_presence_dropout`` draws from ``rng``."""
    drng = jax.random.fold_in(rng, 715827883)
    return np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(drng, m), p, (batch,))) for m in range(n_mod)], 1)


def _loss_and_grads(jm, tm, data, y, mask, train=True, rng_seed=0,
                    drop=None):
    order = tuple((i, i) for i in range(len(data)))
    jloss_fn = jm._loss_fn(jmm.core.losses.cross_entropy_loss, order,
                           "sample")
    (jloss, jaux), jgrads = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True), static_argnums=(5, 6))(
        jm.params, tuple(jnp.asarray(d) for d in data), jnp.asarray(y),
        jnp.asarray(mask), jax.random.PRNGKey(rng_seed), 0, train)
    tloss_fn = tstep.make_batch_loss_fn(
        tm.encoders, tm.decoders, tm.init_state, resolve_criterion(None),
        tm.err_penalty, tm.state_change_penalty, order, "sample",
        presence_dropout=tm.presence_dropout,
        presence_penalty=tm.presence_penalty)
    live = tree_map(lambda t: t.detach().requires_grad_(), tm.params)
    tloss, taux = tloss_fn(
        live, tuple(torch.from_numpy(d.copy()) for d in data),
        torch.from_numpy(y), torch.from_numpy(mask),
        torch.Generator().manual_seed(0), 0, train,
        drop=None if drop is None else torch.from_numpy(drop))
    tgrads = torch.autograd.grad(tloss, tree_leaves(live),
                                 allow_unused=True)
    return (float(jloss), jaux, jax.tree_util.tree_leaves(jgrads),
            tloss.item(), taux, tgrads)


def _assert_match(out, n_leaves=37):
    jloss, jaux, jgrads, tloss, taux, tgrads = out
    assert tloss == pytest.approx(jloss, rel=1e-6)
    assert len(jgrads) == len(tgrads) == n_leaves
    for a, b in zip(jgrads, tgrads):
        _close(b.numpy(), a)
    for key in tstep.GRID_KEYS:
        _close(taux[key].detach().numpy(), jaux[key])


def test_penalty_loss_and_every_gradient_match_jax():
    """MIMIC width, lambda 25, a padded tail and NaN rows in every
    modality: the penalised loss and all 37 gradient leaves."""
    jm, tm = _models(MIMIC_WIDTHS, MIMIC_S, (32, 32),
                     presence_penalty=LAMBDA)
    out = _loss_and_grads(jm, tm, *_batch(MIMIC_WIDTHS))
    _assert_match(out)
    # The penalty moved the loss: the unpenalised model's is lower.
    plain = _models(MIMIC_WIDTHS, MIMIC_S, (32, 32))
    assert out[3] > _loss_and_grads(*plain, *_batch(MIMIC_WIDTHS))[3]


@pytest.mark.parametrize("p, lam", [(0.3, LAMBDA), (0.5, 0.0)],
                         ids=["dropout+penalty", "dropout"])
def test_presence_dropout_with_jax_masks_matches_jax(p, lam):
    """JAX's masks for its rng, injected into the port's loss: the loss and
    every gradient leaf, the penalty reading the injected data."""
    jm, tm = _models(MIMIC_WIDTHS, MIMIC_S, (32, 32), presence_dropout=p,
                     presence_penalty=lam)
    data, y, mask = _batch(MIMIC_WIDTHS, seed=1)
    drop = _jax_masks(jax.random.PRNGKey(7), p, 4, 16)
    assert drop.any() and not drop.all()
    out = _loss_and_grads(jm, tm, data, y, mask, rng_seed=7, drop=drop)
    _assert_match(out)
    # The injected pairs are really skipped: more rows missing than before.
    injected = tstep.inject_presence_dropout(
        tuple(torch.from_numpy(d.copy()) for d in data),
        torch.from_numpy(drop))
    for m, x in enumerate(injected):
        missing = tstep.sample_missing(x).numpy()
        assert (missing == (drop[:, m] | np.isnan(data[m]).any(1))).all()
        assert np.isnan(x.numpy()[drop[:, m]]).all()


def test_presence_dropout_draw_rate_and_reproducibility():
    """The port's own draw: one Bernoulli(p) per (sample, modality) from the
    generator, at a rate within 5 standard deviations of p, independent
    across modalities, the same for the same generator state."""
    p, B, M = 0.3, 20000, 4
    drop = tstep.draw_presence_dropout(torch.Generator().manual_seed(0), B,
                                       M, p, "cpu")
    assert drop.shape == (B, M) and drop.dtype == torch.bool
    sd = (p * (1 - p) / B) ** 0.5
    for m in range(M):
        assert abs(drop[:, m].float().mean().item() - p) < 5 * sd
    both = (drop[:, 0] & drop[:, 1]).float().mean().item()
    assert abs(both - p * p) < 5 * (p * p * (1 - p * p) / B) ** 0.5
    again = tstep.draw_presence_dropout(torch.Generator().manual_seed(0), B,
                                        M, p, "cpu")
    assert torch.equal(drop, again)
    # Without a given mask the loss draws it from the generator: the same
    # generator state gives the same loss, another state another one.
    _, tm = _models(SMALL_WIDTHS, SMALL_S, (8,), presence_dropout=0.5)
    data, y, mask = _batch(SMALL_WIDTHS, n=32)
    fn = tstep.make_batch_loss_fn(
        tm.encoders, tm.decoders, tm.init_state, resolve_criterion(None),
        tm.err_penalty, tm.state_change_penalty, ((0, 0), (1, 1), (2, 2)),
        "sample", presence_dropout=0.5)
    args = (tm.params, tuple(torch.from_numpy(d.copy()) for d in data),
            torch.from_numpy(y), torch.from_numpy(mask))
    losses = [fn(*args, torch.Generator().manual_seed(s), 0, True)[0].item()
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="generator"):
        fn(*args, None, 0, True)


def test_evaluation_ignores_both_knobs():
    """Out of training the loss, the grids and ``test`` are the plain
    model's, as in JAX (penalty and injection act only when ``train``)."""
    data, y, mask = _batch(MIMIC_WIDTHS, seed=2)
    jm, tm = _models(MIMIC_WIDTHS, MIMIC_S, (32, 32), presence_dropout=0.4,
                     presence_penalty=LAMBDA)
    out = _loss_and_grads(jm, tm, data, y, mask, train=False)
    _assert_match(out)
    jplain, tplain = _models(MIMIC_WIDTHS, MIMIC_S, (32, 32))
    assert out[3] == _loss_and_grads(jplain, tplain, data, y, mask,
                                     train=False)[3]
    X, yy = _data(40, SMALL_WIDTHS, seed=3)
    loader = TLoader(TDataset(X, yy, list(SMALL_WIDTHS)), 16)
    res = [_models(SMALL_WIDTHS, SMALL_S, (8,), **kw)[1].test(loader)
           for kw in ({}, {"presence_dropout": 0.4,
                           "presence_penalty": LAMBDA})]
    for a, b in zip(*res):
        assert a[1] == b[1] and a[9:13] == b[9:13]


def test_guards_raise_as_jax_does():
    encs = lambda mod: [mod.MIMICMLPEncoder(4, 3, (5,)),  # noqa: E731
                        mod.MIMICMLPEncoder(4, 3, (5,))]
    for kw, match in (({"nan_skip": "batch", "presence_penalty": 1.0},
                       "require nan_skip='sample'"),
                      ({"nan_skip": "none", "presence_dropout": 0.1},
                       "require nan_skip='sample'"),
                      ({"presence_dropout": 1.0}, r"in \[0, 1\)"),
                      ({"presence_dropout": -0.1}, r"in \[0, 1\)"),
                      ({"presence_penalty": -1.0}, ">= 0")):
        with pytest.raises(ValueError, match=match):
            jmm.MultiModN(4, encs(jenc), [jdec.LogisticDecoder(4)], 1.0, 0.0,
                          **kw)
        with pytest.raises(ValueError, match=match):
            tmm.MultiModN(4, encs(tenc), [tdec.LogisticDecoder(4)], 1.0, 0.0,
                          device="cpu", **kw)
    # The penalty needs a static order: repeated encoders, shuffle_mode.
    from multimodn_tpu.core.step import make_batch_loss_fn as jmake
    crit = resolve_criterion(None)
    for make, mod in ((jmake, jenc), (tstep.make_batch_loss_fn, tenc)):
        with pytest.raises(ValueError, match="STATIC modality order"):
            make(encs(mod), [], None, crit, 1.0, 0.0, ((0, 0), (1, 0)),
                 "sample", presence_penalty=1.0)
        with pytest.raises(ValueError, match="require nan_skip='sample'"):
            make(encs(mod), [], None, crit, 1.0, 0.0, ((0, 0), (1, 1)),
                 "batch", presence_dropout=0.1)
    X, y = _data(32, (3, 3))
    from multimodn_tpu.data import ArrayLoader as JLoader
    from multimodn_tpu.data import PartitionDataset as JDataset
    jm = jmm.MultiModN(4, encs(jenc), [jdec.LogisticDecoder(4)], 1.0, 0.0,
                       shuffle_mode=True, presence_penalty=1.0)
    tm = tmm.MultiModN(4, encs(tenc), [tdec.LogisticDecoder(4)], 1.0, 0.0,
                       shuffle_mode=True, presence_penalty=1.0, device="cpu")
    with pytest.raises(ValueError, match="STATIC modality order"):
        jm.train_epoch(JLoader(JDataset(X, y[:, :1], [3, 3]), 16),
                       jmm.Adam(0.01))
    with pytest.raises(ValueError, match="STATIC modality order"):
        tm.train_epoch(TLoader(TDataset(X, y[:, :1], [3, 3]), 16),
                       tmm.Adam(0.01))
    assert tm.opt_state is None


def test_fit_best_trajectory_with_penalty_matches_jax():
    """Three epochs of ``fit_best`` with lambda 25: scores, best epoch,
    history rows and the restored parameters."""
    from multimodn_tpu.data import ArrayLoader as JLoader
    from multimodn_tpu.data import PartitionDataset as JDataset
    X, y = _data(96, SMALL_WIDTHS, seed=4, missing=0.4)
    jl = JLoader(JDataset(X[:64], y[:64], list(SMALL_WIDTHS)), 16)
    tl = TLoader(TDataset(X[:64], y[:64], list(SMALL_WIDTHS)), 16)
    jv = JLoader(JDataset(X[64:], y[64:], list(SMALL_WIDTHS)), 16)
    tv = TLoader(TDataset(X[64:], y[64:], list(SMALL_WIDTHS)), 16)
    jm, tm = _models(SMALL_WIDTHS, SMALL_S, (8,), seed=5,
                     presence_penalty=LAMBDA)
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    jr = jm.fit_best(jl, jmm.Adam(0.01), "cross_entropy", epochs=3,
                     val_loader=jv, history=jh)
    tr = tm.fit_best(tl, tmm.Adam(0.01), "cross_entropy", epochs=3,
                     val_loader=tv, history=th)
    assert tr["best_epoch"] == jr["best_epoch"]
    assert tr["epochs_ran"] == jr["epochs_ran"] == 3
    _close(tr["scores"], jr["scores"])
    for tag in ("train", "val"):
        for field in ("loss", "accuracy", "balanced_accuracy"):
            _close(np.stack(getattr(th, field)[tag]),
                   np.stack(getattr(jh, field)[tag]))
    for a, b in zip(jax.tree_util.tree_leaves(jm.state_dict()),
                    tree_leaves(tm.params)):
        _close(b.numpy(), a)
    # The penalty changed the trajectory (data with missing cells).
    _, plain = _models(SMALL_WIDTHS, SMALL_S, (8,), seed=5)
    plain.fit_best(tl, tmm.Adam(0.01), epochs=3, val_loader=tv)
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(plain.params), tree_leaves(tm.params)))


def test_penalty_rescues_flipped_class_mnar():
    """The mechanism at a small scale (the JAX package's
    ``tests/test_presence.py`` problem and seed, JAX weights transplanted):
    modality B hidden for class 1 in training, for class 0 at test. Bare
    ``sample`` learns the presence channel and collapses on the flip; lambda
    50 recovers it, to JAX's AUROC. At this scale the outcome depends on
    the initial weights, so the port starts from JAX's seed-0 ones."""
    from multimodn_tpu.data import ArrayLoader as JLoader
    from multimodn_tpu.data import PartitionDataset as JDataset
    rng = np.random.default_rng(0)
    n = 384
    XA = rng.normal(size=(n, 4)).astype(np.float32)
    XB = rng.normal(size=(n, 4)).astype(np.float32)
    y = ((0.8 * XA[:, 0] + 2.0 * XB[:, 0] + 0.3 * rng.normal(size=n)) > 0) \
        .astype(np.int64)[:, None]

    def degraded(miss_class, dataset):
        Xb = XB.copy()
        Xb[y[:, 0] == miss_class] = np.nan
        return dataset(np.concatenate([XA, Xb], 1), y, [4, 4])

    def flip_auc(mod, enc, dec, loader, dataset, **kw):
        m = mod.MultiModN(8, [enc.MLPEncoder(8, 4, (8,)),
                              enc.MLPEncoder(8, 4, (8,))],
                          [dec.LogisticDecoder(8)], 1.0, 0.0,
                          nan_skip="sample", **kw)
        if mod is tmm:
            m.load_state_dict(jmm.MultiModN(
                8, [jenc.MLPEncoder(8, 4, (8,)), jenc.MLPEncoder(8, 4, (8,))],
                [jdec.LogisticDecoder(8)], 1.0, 0.0).state_dict())
        m.fit(loader(degraded(1, dataset), 32), mod.Adam(0.01),
              "cross_entropy", epochs=40)
        return float(m.test(loader(degraded(0, dataset), 32),
                            "cross_entropy")[0][1])

    port = (tmm, tenc, tdec, TLoader, TDataset)
    bare = flip_auc(*port, device="cpu")
    mitigated = flip_auc(*port, device="cpu", presence_penalty=50.0)
    assert bare < 0.2, f"collapse did not reproduce (auc={bare})"
    assert mitigated > 0.55, f"mitigation failed (auc={mitigated})"
    want = flip_auc(jmm, jenc, jdec, JLoader, JDataset,
                    presence_penalty=50.0)
    assert mitigated == pytest.approx(want, abs=1e-3)
