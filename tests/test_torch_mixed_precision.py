"""Mixed precision in the port against the JAX package on the CPU:
``MultiModN(compute_dtype='bfloat16')`` (the batch loss, its gradients,
``fit`` histories, ``test``, every fit entry point) and
``Adam(state_dtype=torch.bfloat16)`` (steps, checkpoints, JAX's states).

The three cases of ``tests/test_mixed_precision.py`` come first, with the
JAX test's own bound between the bf16 and fp32 runs (rtol 0.05, atol 0.02).
Tolerances against JAX at bf16: bfloat16 keeps 8 significant bits (a
relative step of 2**-8 ~ 0.4%), and XLA may fuse an elementwise chain and
round once where PyTorch rounds after each operation, so a value rounds to a
neighbouring bf16 number now and then. The batch loss and the aux grids
agree to 1e-2 relative and every gradient leaf to 2e-2 of its largest
magnitude; over 5 epochs of Adam the loss grids agree to atol 2e-2 and the
counts (accuracy, balanced accuracy) to two samples' worth. fp32
results keep the fp32 tolerances of the other files. Within the port,
equality is bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import checkpoint as tckpt
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.fusion import forward_chain
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.nn import dtype_name, resolve_dtype
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset

BF16_RTOL = 1e-2
BF16_GRAD = 2e-2
BF16_HISTORY_ATOL = 2e-2
FLIPS = 2
JAX_TEST_RTOL, JAX_TEST_ATOL = 0.05, 0.02      # tests/test_mixed_precision.py
FP32_ATOL = 1e-5
S, WIDTHS = 4, (4, 4)
HISTORY_FIELDS = ("loss", "accuracy", "balanced_accuracy")


def _data(n=64, seed=0, nan=False):
    """The JAX test's data: 8 features in two modalities of 4, a linear
    label; ``nan`` marks a quarter of the first modality missing."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (X @ rng.normal(size=8) > 0).astype(np.int64)[:, None]
    if nan:
        X[rng.random(n) < 0.25, :4] = np.nan
    return X, y


def _tmodel(dtype, seed=0, **kw):
    return tmm.MultiModN(S, [tenc.MLPEncoder(S, w, (8,)) for w in WIDTHS],
                         [tdec.LogisticDecoder(S)], 1.0, 0.0, seed=seed,
                         compute_dtype=dtype, device="cpu", **kw)


def _pair(dtype, seed=0, **kw):
    """A JAX model and its port twin on the same weights."""
    jm = jmm.MultiModN(S, [jenc.MLPEncoder(S, w, (8,)) for w in WIDTHS],
                       [jdec.LogisticDecoder(S)], 1.0, 0.0, seed=seed,
                       compute_dtype=dtype, **kw)
    tm = _tmodel(dtype, seed, **kw)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _loaders(X, y, batch=16, **kw):
    return (JLoader(JDataset(X, y, list(WIDTHS)), batch, **kw),
            TLoader(TDataset(X, y, list(WIDTHS)), batch, **kw))


def _scaled(got, want, tol):
    """Within ``tol`` of ``want``'s largest magnitude (at least 1)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# The JAX test's three cases
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fits():
    """5 epochs of ``fit`` with ``Adam(0.01)`` in fp32 and in bf16, in both
    packages from the same weights: the histories and final models."""
    X, y = _data()
    out = {}
    for dtype in (None, "bfloat16"):
        jm, tm = _pair(dtype)
        jl, tl = _loaders(X, y)
        jh, th = jmm.MultiModNHistory(["t"]), tmm.MultiModNHistory(["t"])
        jm.fit(jl, jmm.Adam(0.01), "cross_entropy", epochs=5, history=jh)
        tm.fit(tl, tmm.Adam(0.01), "cross_entropy", epochs=5, history=th)
        out[dtype] = (jm, tm, jh, th)
    return out


def test_bf16_training_tracks_fp32(fits):
    """The JAX test in the port: master parameters stay fp32, the losses
    are finite, and the bf16 run's last loss is within the JAX test's bound
    of the fp32 run's."""
    for dtype in (None, "bfloat16"):
        _jm, tm, _jh, th = fits[dtype]
        assert all(p.dtype == torch.float32 for p in tree_leaves(tm.params))
        assert np.isfinite(th.loss["train"][-1]).all()
    np.testing.assert_allclose(fits[None][3].loss["train"][-1],
                               fits["bfloat16"][3].loss["train"][-1],
                               rtol=JAX_TEST_RTOL, atol=JAX_TEST_ATOL)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_fit_histories_match_jax(fits, dtype):
    """5-epoch histories against JAX's: fp32 at the fp32 tolerance, bf16
    at the bf16 one; the bf16 run really ran in bf16 (it differs from the
    fp32 run by more than fp32 rounding)."""
    _jm, _tm, jh, th = fits[dtype]
    for field in HISTORY_FIELDS:
        got = np.stack(getattr(th, field)["train"])
        atol = FP32_ATOL if dtype is None else BF16_HISTORY_ATOL
        if dtype is not None and field != "loss":
            # A count: a sample whose two logits are within a bf16 rounding
            # of each other may take the other class in one package.
            atol = FLIPS / np.bincount(_data()[1][:, 0]).min()
        np.testing.assert_allclose(got, np.stack(getattr(jh, field)["train"]),
                                   rtol=0, atol=atol)
    if dtype is not None:
        gap = np.abs(np.stack(th.loss["train"])
                     - np.stack(fits[None][3].loss["train"])).max()
        assert gap > 1e-4


def test_bf16_eval_and_suite(fits):
    """``test`` in bf16: 15 metrics per decoder, a finite AUROC, the loss
    grid against JAX's bf16 ``test`` at the bf16 tolerance."""
    jm, tm, _jh, _th = fits["bfloat16"]
    X, y = _data(seed=1)
    jl, tl = _loaders(X, y)
    jh, th = jmm.MultiModNHistory(["t"]), tmm.MultiModNHistory(["t"])
    jm.test(jl, "cross_entropy", history=jh)
    tres = tm.test(tl, "cross_entropy", history=th)
    assert len(tres[0]) == 15 and np.isfinite(tres[0][1])
    np.testing.assert_allclose(np.stack(th.loss["test"]),
                               np.stack(jh.loss["test"]), rtol=BF16_RTOL,
                               atol=BF16_RTOL)


def test_static_bank_respects_compute_dtype():
    """A ``StaticInitState`` bank lives outside the parameters, so the cast
    never reaches it; the chain casts the initial state to the data's
    dtype and stays bf16."""
    bank = [np.ones(3, np.float32), np.zeros(3, np.float32)]
    m = tmm.MultiModN(3, [tenc.MLPEncoder(3, 4, (5,))],
                      [tdec.LogisticDecoder(3)], 0.7, 0.3,
                      init_state=tmm.StaticInitState(bank),
                      compute_dtype=torch.bfloat16, device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    params = tree_map(lambda t: t.bfloat16(), m.params)
    states, *_ = forward_chain(
        m.encoders, m.init_state, params,
        (torch.as_tensor(x).bfloat16(),), torch.ones(4), order=((0, 0),),
        nan_skip="sample")
    assert states.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The cast against JAX's, and what stays fp32
# ---------------------------------------------------------------------------

def _batch(nan):
    X, y = _data(16, seed=2, nan=nan)
    mask = np.ones(16, np.float32)
    mask[13:] = 0.0
    return (X[:, :4], X[:, 4:]), y, mask


@pytest.mark.parametrize("nan_skip", ["sample", "batch"])
def test_bf16_loss_and_gradients_match_jax(nan_skip):
    """JAX's cast on transplanted weights: the loss, every gradient leaf
    and the aux grids of a step with NaN rows and a padded tail; the
    gradients reach the fp32 masters as fp32; the NaN survived the cast
    (the skip fired: ``batch`` gates encoder 0 off)."""
    jm, tm = _pair("bfloat16", seed=3, nan_skip=nan_skip)
    data, y, mask = _batch(nan=True)
    order = ((0, 0), (1, 1))
    jloss_fn = jm._loss_fn(jmm.core.losses.cross_entropy_loss, order,
                           nan_skip)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jm.params, tuple(jnp.asarray(d) for d in data), jnp.asarray(y),
        jnp.asarray(mask), jax.random.PRNGKey(0), 0, True)
    tloss_fn, _ = tm._loss_fn(resolve_criterion(None), order)
    live = tree_map(lambda t: t.detach().requires_grad_(), tm.params)
    tloss, taux = tloss_fn(live, tuple(torch.as_tensor(d) for d in data),
                           torch.as_tensor(y), torch.as_tensor(mask), None,
                           0, True)
    grads = torch.autograd.grad(tloss, tree_leaves(live))
    assert tloss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    assert taux["final_state"].dtype == torch.bfloat16
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=BF16_RTOL)
    for a, g in zip(jax.tree_util.tree_leaves(jgrads), grads):
        _scaled(g.numpy(), a, BF16_GRAD)
    for key in ("err_loss", "state_change", "n_correct", "n_counted"):
        _scaled(taux[key].detach().numpy(), jaux[key], BF16_RTOL)
    if nan_skip == "batch":
        assert taux["enc_gates"].tolist() == [0.0, 1.0]


def test_predict_stays_fp32_and_test_runs_in_bf16():
    """The forward paths ignore ``compute_dtype`` (as in JAX): a bf16
    model's ``predict_proba``, ``fused_forward`` (its plain version here)
    and ``get_states`` equal the fp32 model's bit for bit on the same
    weights, while its ``test`` loss differs."""
    X, y = _data(seed=4)
    fp32, bf16 = _tmodel(None, seed=5), _tmodel("bfloat16", seed=5)
    x = [X[:8, :4], X[:8, 4:]]
    for a, b in zip(fp32.predict_proba(x), bf16.predict_proba(x)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(fp32.fused_forward(x)[1], bf16.fused_forward(x)[1]):
        assert torch.equal(a, b)
    loader = TLoader(TDataset(X, y, list(WIDTHS)), 16)
    np.testing.assert_array_equal(np.stack(fp32.get_states(loader)),
                                  np.stack(bf16.get_states(loader)))
    h32, h16 = tmm.MultiModNHistory(["t"]), tmm.MultiModNHistory(["t"])
    fp32.test(loader, None, history=h32)
    bf16.test(loader, None, history=h16)
    assert not np.array_equal(h32.loss["test"][0], h16.loss["test"][0])


def test_resolve_dtype_takes_what_the_jax_constructor_takes():
    assert resolve_dtype(None) is None
    assert resolve_dtype("bfloat16") is torch.bfloat16
    assert resolve_dtype(torch.float16) is torch.float16
    assert resolve_dtype(jnp.bfloat16) is torch.bfloat16
    assert resolve_dtype(np.dtype("float32")) is torch.float32
    assert dtype_name(jnp.bfloat16) == "bfloat16" and dtype_name(None) is None
    for bad in ("int32", "bfloat", torch.int8):
        with pytest.raises(ValueError, match="floating dtype"):
            resolve_dtype(bad)
    with pytest.raises(ValueError, match="floating dtype"):
        _tmodel("int8")


def test_export_keeps_compute_dtype(tmp_path):
    """``export_model`` writes the dtype's name, as JAX does, and
    ``load_model`` rebuilds it in either package."""
    tm = _tmodel(torch.bfloat16, seed=6)
    tmm.export_model(tm, str(tmp_path))
    back = tmm.load_model(str(tmp_path), device="cpu")
    assert back.compute_dtype == "bfloat16"
    assert jmm.load_model(str(tmp_path)).compute_dtype == "bfloat16"
    _same(back.params, tm.params)


# ---------------------------------------------------------------------------
# Every fit entry point trains in the compute dtype
# ---------------------------------------------------------------------------

EPOCHS = 3


def _entry_run(entry, dtype, tmp_path):
    """Final or best parameters of one ``entry`` call on a fresh model."""
    from multimodn_tpu_torch.data.streaming import StreamingLoader, \
        fit_best_streaming
    from multimodn_tpu_torch.experiments import kfold_fit_best, \
        sweep_fit_best
    X, y = _data(nan=True)
    ds = TDataset(X, y, list(WIDTHS))
    tr, va = TLoader(ds, 16), TLoader(ds, 16)
    opt = tmm.Adam(0.01)
    model = _tmodel(dtype, seed=7)
    work = str(tmp_path / f"{entry}_{dtype}")
    if entry == "fit":
        model.fit(tr, opt, epochs=EPOCHS)
    elif entry == "fit_best":
        model.fit_best(tr, opt, epochs=EPOCHS, val_loader=va,
                       restore_best=False)
    elif entry == "fit_resumable":
        tckpt.fit_resumable(model, tr, opt, epochs=EPOCHS,
                            checkpoint_dir=work, chunk_epochs=1)
    elif entry == "fit_best_resumable":
        tckpt.fit_best_resumable(model, tr, opt, epochs=EPOCHS,
                                 checkpoint_dir=work, val_loader=va,
                                 chunk_epochs=1, restore_best=False)
    elif entry == "fit_best_streaming":
        fit_best_streaming(model, StreamingLoader(ds, 16), opt,
                           epochs=EPOCHS, val_loader=StreamingLoader(ds, 16),
                           restore_best=False)
    elif entry == "kfold_fit_best":
        model = kfold_fit_best(lambda s: _tmodel(dtype, seed=7), [(tr, va)],
                               opt, epochs=EPOCHS)[0]["model"]
    elif entry == "sweep_fit_best":
        model = sweep_fit_best(lambda s: _tmodel(dtype, seed=7), tr, va,
                               opt, epochs=EPOCHS, seeds=(7,))[0]["model"]
    return model


def _best_reference(dtype):
    X, y = _data(nan=True)
    ds = TDataset(X, y, list(WIDTHS))
    model = _tmodel(dtype, seed=7)
    model.fit_best(TLoader(ds, 16), tmm.Adam(0.01), epochs=EPOCHS,
                   val_loader=TLoader(ds, 16))
    return model


def _final_reference(dtype):
    """``EPOCHS`` looped ``train_epoch`` calls: the step the loss and
    gradient tests hold against JAX."""
    X, y = _data(nan=True)
    model = _tmodel(dtype, seed=7)
    opt = tmm.Adam(0.01)
    for _ in range(EPOCHS):
        model.train_epoch(TLoader(TDataset(X, y, list(WIDTHS)), 16), opt)
    return model


@pytest.mark.parametrize("entry", [
    "fit", "fit_best", "fit_resumable", "fit_best_resumable",
    "fit_best_streaming", "kfold_fit_best", "sweep_fit_best"])
def test_every_fit_entry_point_honours_compute_dtype(entry, tmp_path):
    """Each entry point with a bf16 model ends bit-equal to looped bf16
    ``train_epoch`` calls (the best-restoring ones to a bf16 ``fit_best``)
    and apart from the same call in fp32; its masters stay fp32."""
    best = entry in ("kfold_fit_best", "sweep_fit_best")
    ref = _best_reference if best else _final_reference
    got = _entry_run(entry, "bfloat16", tmp_path)
    _same(got.params, ref("bfloat16").params)
    assert all(p.dtype == torch.float32 for p in tree_leaves(got.params))
    fp32 = _entry_run(entry, None, tmp_path)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got.params), tree_leaves(fp32.params)))


# ---------------------------------------------------------------------------
# Adam(state_dtype=bf16)
# ---------------------------------------------------------------------------

def test_bf16_moment_adam_matches_jax():
    """``Adam(0.01, state_dtype=bf16)`` over 3 epochs (12 steps) against
    JAX's ``Adam(state_dtype=jnp.bfloat16)`` (``tests/test_fit.py``): the
    moments are stored bf16, the arithmetic is fp32, the parameters agree
    within a few bf16 roundings of a moment (each moves a step by at most
    ~2**-8 of lr)."""
    X, y = _data(nan=True)
    jm, tm = _pair(None, seed=8)
    jl, tl = _loaders(X, y)
    jm.fit(jl, jmm.Adam(0.01, state_dtype=jnp.bfloat16), "cross_entropy",
           epochs=3)
    tm.fit(tl, tmm.Adam(0.01, state_dtype=torch.bfloat16), "cross_entropy",
           epochs=3)
    for leaf in tree_leaves(tm.opt_state["m"]) + tree_leaves(
            tm.opt_state["v"]):
        assert leaf.dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(jm.state_dict()),
                    tree_leaves(tm.params)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=12 * 0.01 / 16)
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jm.opt_state[key]),
                        tree_leaves(tm.opt_state[key])):
            _scaled(b.float().numpy(), np.asarray(a, np.float32), BF16_GRAD)


def test_bf16_moments_read_from_jax_bit_for_bit():
    """``opt_state_from_jax`` keeps JAX's bf16 moments (``ml_dtypes``
    arrays to numpy) as bf16 tensors with the same bits, and the port's
    Adam steps on from them."""
    X, y = _data()
    jm, tm = _pair(None, seed=9)
    jl, tl = _loaders(X, y)
    jm.fit(jl, jmm.Adam(0.01, state_dtype=jnp.bfloat16), "cross_entropy",
           epochs=1)
    state = tmm.opt_state_from_jax(jm.opt_state, device="cpu")
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jm.opt_state[key]),
                        tree_leaves(state[key])):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                b.view(torch.int16).numpy(),
                np.asarray(a).view(np.int16))
    opt = tmm.Adam(0.01, state_dtype=torch.bfloat16)
    tm.load_state_dict(jm.state_dict())
    tm._opt, tm.opt_state = opt, state
    tm.fit(tl, opt, "cross_entropy", epochs=1)
    assert all(torch.isfinite(p).all() for p in tree_leaves(tm.params))


def test_fit_resumable_with_bf16_moments_round_trips_bit_for_bit(tmp_path):
    """A checkpoint stores bf16 moments as uint16 views and gives them back
    bit for bit; a ``fit_resumable`` interrupted after its first chunk and
    resumed by a fresh model ends bit-equal to one uninterrupted ``fit``,
    moments included."""
    X, y = _data(nan=True)
    ds = TDataset(X, y, list(WIDTHS))

    def opt():
        return tmm.Adam(0.01, state_dtype=torch.bfloat16)

    full = _tmodel("bfloat16", seed=10)
    full.fit(TLoader(ds, 16), opt(), epochs=3)
    path = str(tmp_path / "c.pkl")
    tckpt.save_checkpoint(path, full, 3, include_opt_state=True)
    payload = tckpt.load_checkpoint(path)
    assert all(a.dtype == np.uint16
               for a in tree_leaves(payload["opt_state"]["m"]))
    restored = tckpt.opt_state_from_numpy(opt(), payload["opt_state"],
                                          full.params)
    _same(restored, full.opt_state)

    class Stop(Exception):
        pass

    def stop(done, _total):
        if done == 1:
            raise Stop

    ckpt = str(tmp_path / "ck")
    with pytest.raises(Stop):
        tckpt.fit_resumable(_tmodel("bfloat16", seed=10), TLoader(ds, 16),
                            opt(), epochs=3, checkpoint_dir=ckpt,
                            chunk_epochs=1, on_chunk=stop)
    revived = _tmodel("bfloat16", seed=10)
    tckpt.fit_resumable(revived, TLoader(ds, 16), opt(), epochs=3,
                        checkpoint_dir=ckpt, chunk_epochs=1)
    _same(revived.params, full.params)
    _same(revived.opt_state, full.opt_state)
