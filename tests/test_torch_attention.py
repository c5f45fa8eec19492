"""The port's attention encoders (``TransformerEncoder``, ``ViTEncoder``)
against the JAX package on the CPU: outputs, the ViT patching, a MultiModN's
loss and every gradient leaf against ``jax.grad``, a short training
trajectory, dropout, validation errors, and exports in both directions.

JAX weights are transplanted with ``params_from_jax``. Tolerances: XLA's and
PyTorch's CPU products sum in different orders (~1e-7 relative per
product); through an embed, two pre-LN blocks (LayerNorm, softmax, GELU)
and the output head that stays below 1e-5 at these widths, for outputs,
losses and gradients alike. Dropout is compared by its definition: JAX
threefry and torch Philox draw different masks.
"""
import json
import os

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
S = 6
SMALL = dict(embed_dim=16, n_heads=2, n_layers=2, mlp_ratio=2)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _transplant(jparams):
    return tmm.params_from_jax({"encoders": [jparams], "decoders": []},
                               "cpu")["encoders"][0]


def _pair(cls_j, cls_t, *args, seed=0, **kw):
    je, te = cls_j(*args, **kw), cls_t(*args, **kw)
    jp = je.init(jax.random.PRNGKey(seed))
    return je, te, jp, _transplant(jp)


@pytest.mark.parametrize("n_features, chunk, tokens, activation", [
    (13, 4, False, "gelu"),        # zero-padded to 4 tokens of 4
    (12, 4, False, "relu"),        # exact chunks
    (7, 16, False, "tanh"),        # one short token
    (5, None, True, "gelu"),       # (B, T, F) tokens taken as they are
], ids=["pad", "exact", "short", "tokens"])
def test_transformer_outputs_match_jax(n_features, chunk, tokens,
                                       activation):
    kw = dict(SMALL, activation=activation)
    if chunk is not None:
        kw["chunk"] = chunk
    else:
        kw["chunk"] = n_features
    je, te, jp, tp = _pair(jenc.TransformerEncoder, tenc.TransformerEncoder,
                           S, n_features, **kw)
    rng = np.random.default_rng(1)
    shape = (7, 3, n_features) if tokens else (7, n_features)
    x = rng.normal(size=shape).astype(np.float32)
    s = rng.normal(size=(7, S)).astype(np.float32)
    want = je.apply(jp, jnp.asarray(s), jnp.asarray(x))
    got = te.apply(tp, torch.from_numpy(s), torch.from_numpy(x))
    assert got.shape == (7, S)
    _close(got.numpy(), want)
    assert (te.n_tokens, te.pad, te.mlp_dim) == (je.n_tokens, je.pad,
                                                  je.mlp_dim)
    assert sorted(tp) == sorted(jp) == ["blocks", "embed", "ln_f", "out",
                                        "pos"]
    assert [sorted(b) for b in tp["blocks"]] == \
        [["ln1", "ln2", "mlp1", "mlp2", "proj", "qkv"]] * 2


def test_init_has_the_jax_shapes_and_constants():
    je, te = (jenc.TransformerEncoder(S, 13, chunk=4, **SMALL),
              tenc.TransformerEncoder(S, 13, chunk=4, **SMALL))
    jp = je.init(jax.random.PRNGKey(0))
    tp = te.init(torch.Generator().manual_seed(0))
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert not tp["pos"].any()
    for ln in [tp["ln_f"]] + [b[k] for b in tp["blocks"]
                              for k in ("ln1", "ln2")]:
        assert torch.equal(ln["scale"], torch.ones(16))
        assert not ln["bias"].any()
    w = tp["blocks"][0]["qkv"]["w"]
    assert w.abs().max() <= 16 ** -0.5 and w.std() > 0


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "nhwc"])
def test_vit_outputs_and_patches_match_jax(flat):
    kw = dict(image_size=(8, 12), patch_size=4, channels=2, **SMALL)
    je, te, jp, tp = _pair(jenc.ViTEncoder, tenc.ViTEncoder, S, **kw)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 8, 12, 2)).astype(np.float32)
    if flat:
        x = x.reshape(5, -1)
    s = rng.normal(size=(5, S)).astype(np.float32)
    np.testing.assert_array_equal(
        te._patchify(torch.from_numpy(x)).numpy(),
        np.asarray(je._patchify(jnp.asarray(x))))
    assert te.n_tokens == 6 and te.chunk == 32
    _close(te.apply(tp, torch.from_numpy(s), torch.from_numpy(x)).numpy(),
           je.apply(jp, jnp.asarray(s), jnp.asarray(x)))


def test_validation_errors_match_jax():
    for kw, match in ((dict(embed_dim=10, n_heads=4), "% n_heads"),):
        for mod in (jenc, tenc):
            with pytest.raises(ValueError, match=match):
                mod.TransformerEncoder(S, 8, **kw)
    for mod in (jenc, tenc):
        with pytest.raises(ValueError, match="divisible by patch_size"):
            mod.ViTEncoder(S, image_size=(10, 8), patch_size=4)
    te = tenc.ViTEncoder(S, image_size=8, patch_size=4, channels=1, **SMALL)
    assert te.image_size == (8, 8)
    with pytest.raises(ValueError, match="flat width 63"):
        te._patchify(torch.zeros(2, 63))
    with pytest.raises(ValueError, match=r"got \(8, 8, 3\)"):
        te._patchify(torch.zeros(2, 8, 8, 3))


def test_dropout_is_stochastic_in_training_only():
    te = tenc.TransformerEncoder(S, 12, chunk=4, dropout_rate=0.5, **SMALL)
    assert te.stochastic and not tenc.TransformerEncoder(S, 12).stochastic
    tp = te.init(torch.Generator().manual_seed(0))
    x, s = torch.randn(4, 12), torch.randn(4, S)
    assert torch.equal(te.apply(tp, s, x), te.apply(tp, s, x))
    assert torch.equal(te.apply(tp, s, x, train=True), te.apply(tp, s, x))

    def run(seed):
        return te.apply(tp, s, x, train=True,
                        generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert not torch.equal(run(1), te.apply(tp, s, x))
    # Dropout acts on the attention branch only: with zeroed attention
    # output weights the branch is 0 and the dropout draw changes nothing.
    quiet = tree_map(torch.clone, tp)
    for b in quiet["blocks"]:
        b["proj"]["w"].zero_()
        b["proj"]["b"].zero_()
    assert torch.equal(
        te.apply(quiet, s, x, train=True,
                 generator=torch.Generator().manual_seed(1)),
        te.apply(quiet, s, x))


# --------------------------------------------------------------------------
# A MultiModN with transformer encoders against jax.grad
# --------------------------------------------------------------------------

WIDTHS = (10, 13, 4)


def _models(nan_skip="sample", seed=3, vit=False):
    def encoders(mod):
        encs = [mod.TransformerEncoder(S, w, chunk=min(4, w), **SMALL)
                for w in WIDTHS]
        if vit:
            encs[1] = mod.ViTEncoder(S, image_size=(4, 6), patch_size=2,
                                     channels=1, **SMALL)
        return encs

    widths = (WIDTHS[0], 24, WIDTHS[2]) if vit else WIDTHS
    jm = jmm.MultiModN(S, encoders(jenc),
                       [jdec.MLPDecoder(S, (8,), 2) for _ in range(2)],
                       1.0, 0.5, seed=seed, nan_skip=nan_skip,
                       chain_mode="unrolled")
    tm = tmm.MultiModN(S, encoders(tenc),
                       [tdec.MLPDecoder(S, (8,), 2) for _ in range(2)],
                       1.0, 0.5, seed=seed, nan_skip=nan_skip, device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm, widths


def _data(n, widths, seed=0, missing=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    y = np.stack([X[:, :3].sum(1) > 0, X[:, -3:].sum(1) > 0], 1) \
        .astype(np.int64)
    off = np.cumsum((0,) + tuple(widths[:-1]))
    for o, w in zip(off, widths):
        X[rng.random(n) < missing, o:o + w] = np.nan
    return X, y


@pytest.mark.parametrize("nan_skip, vit", [("sample", False),
                                           ("batch", False),
                                           ("sample", True)],
                         ids=["sample", "batch", "sample-vit"])
def test_loss_and_every_gradient_match_jax(nan_skip, vit):
    """Batch 12 with a padded tail and NaN rows: the loss, every gradient
    leaf (all finite: a NaN row reaches the encoder zero-filled) and the
    aux grids."""
    jm, tm, widths = _models(nan_skip, vit=vit)
    X, y = _data(12, widths)
    if nan_skip == "batch":
        X[2, :widths[0]] = np.nan
    off = np.cumsum((0,) + widths[:-1])
    data = [X[:, o:o + w] for o, w in zip(off, widths)]
    mask = np.ones(12, np.float32)
    mask[10:] = 0.0
    order = tuple((i, i) for i in range(3))
    jloss_fn = jm._loss_fn(jmm.core.losses.cross_entropy_loss, order,
                           nan_skip)
    (jloss, jaux), jgrads = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True), static_argnums=(5, 6))(
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
    assert len(jleaves) == len(tgrads) > 3 * 25
    for a, b in zip(jleaves, tgrads):
        assert torch.isfinite(b).all()
        _close(b.numpy(), a)
    for key in tstep.GRID_KEYS:
        _close(taux[key].detach().numpy(), jaux[key])


def test_training_trajectory_and_optimizer_state_match_jax():
    """Two epochs of ``train_epoch`` with Adam, then ``test``: parameters,
    the Adam moments through ``opt_state_from_jax``, history rows. Adam
    steps by ``lr * m / sqrt(v)``, so an element whose gradient is near 0
    carries the products' rounding differences into its step at up to ~lr
    scale; lr 1e-3 keeps six such steps inside the 1e-5 tolerance."""
    from multimodn_tpu.data import ArrayLoader as JLoader
    from multimodn_tpu.data import PartitionDataset as JDataset
    jm, tm, widths = _models()
    X, y = _data(40, widths, seed=1)
    jl = JLoader(JDataset(X, y, list(widths)), 16)
    tl = TLoader(TDataset(X, y, list(widths)), 16)
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    jopt, topt = jmm.Adam(1e-3), tmm.Adam(1e-3)
    for _ in range(2):
        jm.train_epoch(jl, jopt, "cross_entropy", jh)
        tm.train_epoch(tl, topt, "cross_entropy", th)
    for a, b in zip(jax.tree_util.tree_leaves(jm.state_dict()),
                    tree_leaves(tm.params)):
        _close(b.numpy(), a)
    want = tmm.opt_state_from_jax(jm.opt_state, "cpu")
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(want[key]),
                        tree_leaves(tm.opt_state[key])):
            assert a.shape == b.shape
            _close(b.numpy(), a.numpy())
    jres, tres = jm.test(jl, "cross_entropy"), tm.test(tl, "cross_entropy")
    for a, b in zip(jres, tres):
        assert b[1] == pytest.approx(a[1], abs=1e-6)
        assert b[9:13] == a[9:13]
    for field in ("loss", "accuracy"):
        _close(np.stack(getattr(th, field)["train"]),
               np.stack(getattr(jh, field)["train"]))


# --------------------------------------------------------------------------
# Exports, serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exports_cross_both_ways(tmp_path, writer):
    """Transformer and ViT encoders (a non-default image geometry and
    activation) rebuild with every attribute; ``predict_proba`` agrees with
    the writer's model, and a reload of the port's export is bit-equal."""
    def model(mod, enc, dec, **kw):
        return mod.MultiModN(
            S, [enc.TransformerEncoder(S, 13, chunk=4, activation="relu",
                                       dropout_rate=0.1, **SMALL),
                enc.ViTEncoder(S, image_size=(4, 6), patch_size=2,
                               channels=1, **SMALL)],
            [dec.MLPDecoder(S, (8,), 2)], 1.0, 0.0, **kw)

    jm = model(jmm, jenc, jdec, seed=2, chain_mode="unrolled")
    tm = model(tmm, tenc, tdec, seed=2, device="cpu")
    tm.load_state_dict(jm.state_dict())
    path = str(tmp_path / "export")
    if writer == "jax":
        jmm.export_model(jm, path)
        loaded = tmm.load_model(path, device="cpu")
        src = tm
    else:
        tmm.export_model(tm, path)
        loaded = jmm.load_model(path)
        src = jm
    with open(os.path.join(path, "config.json")) as f:
        spec = json.load(f)["encoders"]
    assert spec[1]["image_size"] == [4, 6] and spec[1]["patch_size"] == 2
    assert spec[0]["chunk"] == 4 and spec[0]["activation"] == "relu"
    vit = loaded.encoders[1]
    assert (vit.image_size, vit.patch_size, vit.channels, vit.n_tokens) == \
        ((4, 6), 2, 1, 6)
    enc = loaded.encoders[0]
    assert (enc.embed_dim, enc.n_heads, enc.n_layers, enc.mlp_ratio,
            enc.chunk, enc.dropout_rate) == (16, 2, 2, 2, 4, 0.1)
    rng = np.random.default_rng(3)
    x = [rng.normal(size=(5, 13)).astype(np.float32),
         rng.normal(size=(5, 24)).astype(np.float32)]
    for g, w in zip(loaded.predict_proba(x), src.predict_proba(x)):
        _close(g, w)
    if writer == "port":
        back = tmm.load_model(path, device="cpu")
        for g, w in zip(back.predict_proba(x), tm.predict_proba(x)):
            np.testing.assert_array_equal(g, w)


def test_serving_runs_the_plain_chain_and_fused_forward_raises():
    _, tm, widths = _models()
    rng = np.random.default_rng(4)
    x = [rng.normal(size=(3, w)).astype(np.float32) for w in widths]
    x[1][1] = np.nan
    session = tmm.InferenceSession(tm)
    state = session.init(3)
    for e in range(3):
        state, probs = session.step(state, e, x[e])
    from multimodn_tpu_torch.core.fusion import default_order, forward_chain
    ref = forward_chain(tm.encoders, tm.init_state, tm.params,
                        tuple(torch.from_numpy(m) for m in x), torch.ones(3),
                        order=default_order(3), nan_skip="sample")[0]
    _close(state.numpy(), ref[-1].numpy(), 1e-6)
    assert np.isfinite(probs[0]).all()
    with pytest.raises(TypeError, match="MLP-family"):
        tm.fused_forward(x)
    jm, _, _ = _models()
    with pytest.raises(TypeError):
        jm.fused_forward(x)
