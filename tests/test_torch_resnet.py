"""The port's ResNet-18 image encoder against the JAX package's on the CPU,
at the JAX tests' size (32 x 32 images, state 4): features, ``apply`` and
gradients (``freeze`` included), masked train-mode BatchNorm, the ``.npz``
overlay, ``update_batch_stats``, and the encoder inside ``MultiModN`` with
padded and NaN rows left out of every block's batch statistics on every
chain form.

JAX parameters are transplanted with ``params_from_jax``. Tolerances: the
convolutions sum in other orders in XLA's and PyTorch's CPU kernels (~1e-7
relative per sum), carried through 20 convolutions. In evaluation mode the
features agree to ~3e-6 (atol 1e-5). In training mode every BatchNorm
divides by a batch standard deviation, and the last stage's is taken over
the batch's rows at one 1 x 1 position, which amplifies rounding: at 8 rows
both float32 versions sit ~3e-5 of a leaf's largest gradient from a float64
run of the same input (~2e-4 at 4 rows). So training-mode values and
gradients are held leaf by leaf to 5e-4 of the leaf's largest magnitude
(at least 1). The statistics of ``update_batch_stats`` are means over the
batch: atol 1e-5 + rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.encoders import resnet as jresnet
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.convert import params_from_jax, params_to_numpy
from multimodn_tpu_torch.core import step as tstep
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.encoders import resnet as tresnet

S, B, H = 4, 8, 32
EVAL_ATOL = 1e-5
TRAIN_TOL = 5e-4
STATS_ATOL, STATS_RTOL = 1e-5, 1e-4


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _transplant(jparams):
    return params_from_jax({"encoders": [jparams], "decoders": []},
                           "cpu")["encoders"][0]


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _near(got, want):
    """Training-mode agreement: within ``TRAIN_TOL`` of the largest
    magnitude of ``want`` (at least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    _close(got, want, TRAIN_TOL * scale)


def _tree_close(tparams, jparams, atol=None, rtol=0.0):
    """Leaf by leaf, in order: within ``atol`` + ``rtol``, or ``_near``."""
    jleaves = jax.tree_util.tree_leaves(jparams)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == tuple(np.shape(a))
        if atol is None:
            _near(b.detach().numpy(), a)
        else:
            _close(b.detach().numpy(), a, atol, rtol)


@pytest.fixture(scope="module")
def weights():
    """One ResNet's parameters with stored statistics away from (0, 1), so
    evaluation mode reads them, as the JAX tree and its transplant, and
    seeded images and states. The weights are drawn on the torch side (a
    JAX init compiles a random draw per leaf shape)."""
    rng = np.random.default_rng(1)
    tp = tenc.ResNet(state_size=S).init(torch.Generator().manual_seed(0))
    for bn in _bn_dicts(tp):
        bn["mean"] = _t(rng.normal(size=bn["mean"].shape) * 0.1).float()
        bn["var"] = _t(rng.uniform(0.5, 1.5, size=bn["var"].shape)).float()
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp))
    imgs = rng.normal(size=(B, H, H, 3)).astype(np.float32)
    state = rng.normal(size=(B, S)).astype(np.float32)
    return jenc.ResNet(state_size=S), jp, _transplant(jp), imgs, state


def _bn_dicts(params):
    yield params["stem"]["bn"]
    for blocks in params["stages"]:
        for block in blocks:
            for conv in block.values():
                yield conv["bn"]


def test_parameter_tree_matches_jax():
    """Same leaves in the same (sorted-key) order and shapes as a JAX
    init: HWIO kernels and BatchNorm statistics in the tree, 102 leaves."""
    tp = tenc.ResNet(state_size=S).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves(
        jax.eval_shape(jenc.ResNet(state_size=S).init,
                       jax.random.PRNGKey(0)))
    tleaves = tree_leaves(tp)
    assert len(tleaves) == len(jleaves) == 102
    assert [tuple(t.shape) for t in tleaves] == \
        [tuple(np.shape(a)) for a in jleaves]
    assert tuple(tp["stem"]["w"].shape) == (7, 7, 3, 64)
    assert tuple(tp["stages"][3][1]["conv2"]["w"].shape) == (3, 3, 512, 512)


@pytest.mark.parametrize("train", [False, True])
def test_features_and_apply_match_jax(weights, train):
    enc, jp, tp, imgs, state = weights
    tenc_ = tenc.ResNet(state_size=S)
    check = _near if train else (lambda g, w: _close(g, w, EVAL_ATOL))
    want = enc.features(jp, jnp.asarray(imgs), train=train)
    got = tenc_.features(tp, _t(imgs), train=train)
    assert tuple(got.shape) == (B, 512)
    check(got.numpy(), want)
    want = enc.apply(jp, jnp.asarray(state), jnp.asarray(imgs), train=train)
    got = tenc_.apply(tp, _t(state), _t(imgs), train=train)
    assert tuple(got.shape) == (B, S) and torch.isfinite(got).all()
    check(got.numpy(), want)


def test_masked_train_batchnorm_matches_jax(weights):
    """Train mode with a sample mask: three rows out of the statistics."""
    enc, jp, tp, imgs, state = weights
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    want = enc.apply(jp, jnp.asarray(state), jnp.asarray(imgs), train=True,
                     sample_mask=jnp.asarray(mask))
    got = tenc.ResNet(state_size=S).apply(tp, _t(state), _t(imgs),
                                          train=True, sample_mask=_t(mask))
    _near(got.numpy(), want)


@pytest.mark.parametrize("freeze", [False, True])
def test_gradients_match_jax(weights, freeze):
    """d sum(apply^2) / d every leaf in train mode; ``freeze`` stops the
    backbone's gradient at the features (the stem's is exactly 0, the
    head's is not)."""
    _enc, jp, tp, imgs, state = weights
    jenc_ = jenc.ResNet(state_size=S, freeze=freeze)
    tenc_ = tenc.ResNet(state_size=S, freeze=freeze)
    jg = jax.grad(lambda p: jnp.sum(jenc_.apply(
        p, jnp.asarray(state), jnp.asarray(imgs), train=True) ** 2))(jp)
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    out = tenc_.apply(live, _t(state), _t(imgs), train=True)
    grads = torch.autograd.grad((out ** 2).sum(), tree_leaves(live),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tree_leaves(live), grads)]
    it = iter(grads)
    tg = tree_map(lambda _x: next(it), tp)
    _tree_close(tg, jg)
    assert float(tg["head"]["w"].abs().max()) > 0.0
    stem = float(tg["stem"]["w"].abs().max())
    assert stem == 0.0 if freeze else stem > 0.0


def test_npz_overlay_reads_the_jax_keys(weights, tmp_path):
    """A flat ``.npz`` with the JAX package's keys overlays the initial
    tree: a file of JAX's whole tree gives JAX's parameters exactly, and
    a partial file keeps the other leaves at their initial values (the
    JAX test's ``stem/w`` overlay)."""
    from multimodn_tpu.serving import _flatten_with_paths
    _enc, jp, _tp, _imgs, _state = weights
    full = tmp_path / "full.npz"
    np.savez(full, **dict(_flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jp))))
    got = tenc.ResNet(state_size=S, pretrained_path=str(full)).init(
        torch.Generator().manual_seed(5))
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    custom = np.full((7, 7, 3, 64), 0.123, np.float32)
    part = tmp_path / "ckpt.npz"
    np.savez(part, **{"stem/w": custom})
    base = tenc.ResNet(state_size=S).init(torch.Generator().manual_seed(2))
    over = tenc.ResNet(state_size=S, pretrained_path=str(part)).init(
        torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(over["stem"]["w"].numpy(), custom)
    np.testing.assert_array_equal(over["head"]["w"].numpy(),
                                  base["head"]["w"].numpy())


def test_rejects_network_pretrained_and_an_empty_state():
    with pytest.raises(ValueError, match="No network"):
        tenc.ResNet(state_size=S, pretrained=True)
    with pytest.raises(ValueError, match="not both"):
        tenc.ResNet(state_size=S, pretrained=True, pretrained_path="x.npz")
    with pytest.raises(ValueError, match="state_size >= 1"):
        tenc.ResNet(state_size=0)


def test_bn_train_stats_exclude_padded_rows():
    """Masked train-mode BatchNorm equals BatchNorm over the real rows only,
    and JAX's ``_bn`` on the same input (NHWC there, NCHW views here)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4, 4, 8)).astype(np.float32)
    x[4:] = 0.0
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    p = tresnet._bn_init(8)
    nchw = _t(x).permute(0, 3, 1, 2)
    full = tresnet._bn(nchw[:4], p, True)
    masked = tresnet._bn(nchw, p, True, _t(mask))
    _close(masked[:4].numpy(), full.numpy(), 1e-6, 0.0)
    want = jresnet._bn(jnp.asarray(x), jresnet._bn_init(8), True,
                       jnp.asarray(mask))
    _close(masked.permute(0, 2, 3, 1).numpy(), want, 1e-6, 0.0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_update_batch_stats_matches_jax(weights, momentum):
    """The explicit running average: with momentum 0 the stem's mean is the
    batch mean of its convolution; every statistic equals JAX's; other
    leaves are untouched copies; evaluation then reads the new statistics."""
    enc, jp, tp, imgs, state = weights
    imgs = imgs * 3 + 1
    tenc_ = tenc.ResNet(state_size=S)
    want = enc.update_batch_stats(jp, jnp.asarray(imgs), momentum=momentum)
    got = tenc_.update_batch_stats(tp, _t(imgs), momentum=momentum)
    _tree_close(got, want, STATS_ATOL, STATS_RTOL)
    if momentum == 0.0:
        stem = tresnet._conv(_t(imgs).permute(0, 3, 1, 2), tp["stem"]["w"], 2)
        _close(got["stem"]["bn"]["mean"].numpy(),
               stem.mean(dim=(0, 2, 3)).numpy(), STATS_ATOL, 0.0)
    assert got["head"]["w"] is not tp["head"]["w"]
    np.testing.assert_array_equal(got["head"]["w"].numpy(),
                                  tp["head"]["w"].numpy())
    before = tenc_.apply(tp, _t(state), _t(imgs))
    after = tenc_.apply(got, _t(state), _t(imgs))
    assert not torch.allclose(before, after)


def test_update_batch_stats_masked_padding(weights):
    """With ``sample_mask`` the padded rows drop out: the statistics of a
    padded batch equal the unpadded batch's at every depth, and JAX's;
    without it they differ."""
    enc, jp, tp, _imgs, _state = weights
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(6, H, H, 3)).astype(np.float32)
    padded = np.concatenate([imgs, np.zeros((2, H, H, 3), np.float32)])
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    tenc_ = tenc.ResNet(state_size=S)
    clean = tenc_.update_batch_stats(tp, _t(imgs))
    masked = tenc_.update_batch_stats(tp, _t(padded), sample_mask=_t(mask))
    _tree_close(masked, clean, STATS_ATOL, STATS_RTOL)
    want = enc.update_batch_stats(jp, jnp.asarray(padded),
                                  sample_mask=jnp.asarray(mask))
    _tree_close(masked, want, STATS_ATOL, STATS_RTOL)
    unmasked = tenc_.update_batch_stats(tp, _t(padded))
    assert not torch.allclose(unmasked["stem"]["bn"]["mean"],
                              clean["stem"]["bn"]["mean"])


# ---------------------------------------------------------------------------
# Inside MultiModN
# ---------------------------------------------------------------------------

N_ROWS, BATCH, FEAT = 20, 8, 5
NAN_IMAGES = (1, 6)


class ImageDataset:
    """Images (N, H, W, 3) and a 5-wide feature modality; ``arrays()`` keeps
    the images 4-D in both packages' loaders. Rows 1 and 6 have one NaN
    pixel each, so their other pixels would reach BatchNorm's statistics
    if the chain did not mask them."""

    def __init__(self, seed=0, n=N_ROWS):
        rng = np.random.default_rng(seed)
        self.img = rng.normal(size=(n, H, H, 3)).astype(np.float32)
        self.img[list(NAN_IMAGES), 3, 5, 1] = np.nan
        self.x = rng.normal(size=(n, FEAT)).astype(np.float32)
        self.y = (self.x[:, :2].sum(1) > 0).astype(np.int64)[:, None]

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return [self.img[i], self.x[i]], self.y[i]

    def arrays(self):
        return [self.img, self.x], self.y, None


def _image_models(seed=4):
    jm = jmm.MultiModN(S, [jenc.ResNet(state_size=S),
                           jenc.MLPEncoder(S, FEAT, (6,))],
                       [jdec.LogisticDecoder(S)], 1.0, 0.5, seed=seed)
    tm = tmm.MultiModN(S, [tenc.ResNet(state_size=S),
                           tenc.MLPEncoder(S, FEAT, (6,))],
                       [tdec.LogisticDecoder(S)], 1.0, 0.5, seed=seed,
                       device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _batch(ds, rows):
    """Rows of ``ds`` padded to ``BATCH`` with zero rows, and the mask."""
    idx = list(rows)
    n = len(idx)
    img = np.zeros((BATCH, H, H, 3), np.float32)
    x = np.zeros((BATCH, FEAT), np.float32)
    y = np.zeros((BATCH, 1), np.int64)
    img[:n], x[:n], y[:n] = ds.img[idx], ds.x[idx], ds.y[idx]
    mask = np.zeros(BATCH, np.float32)
    mask[:n] = 1.0
    return (img, x), y, mask


def test_resnet_model_loss_and_gradients_match_jax():
    """The batch loss, its gradient on all 102 + 7 leaves and the aux grids
    of a training step whose batch holds a NaN image and a padded row
    (``_batch`` of rows 4-10: batch row 2 is row 6's NaN image, row 7 is
    padding)."""
    jm, tm = _image_models()
    data, y, mask = _batch(ImageDataset(), range(4, 11))
    order = ((0, 0), (1, 1))
    jloss_fn = jm._loss_fn(jmm.core.losses.cross_entropy_loss, order,
                           "sample")
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jm.params, tuple(jnp.asarray(d) for d in data), jnp.asarray(y),
        jnp.asarray(mask), jax.random.PRNGKey(0), 0, True)
    tloss_fn, _ = tm._loss_fn(resolve_criterion(None), order)
    live = tree_map(lambda t: t.detach().requires_grad_(), tm.params)
    tloss, taux = tloss_fn(live, tuple(_t(d) for d in data), _t(y),
                           _t(mask), None, 0, True)
    grads = torch.autograd.grad(tloss, tree_leaves(live), allow_unused=True)
    _near(tloss.item(), float(jloss))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == 109
    for a, g, p in zip(jleaves, grads, tree_leaves(live)):
        _near((torch.zeros_like(p) if g is None else g).numpy(), a)
    for key in tstep.GRID_KEYS:
        _near(taux[key].detach().numpy(), jaux[key])


def test_image_nan_rows_are_found_over_every_axis():
    """An image modality is 4-D: a row is missing when any of its H x W x 3
    values is NaN (``sample_missing`` flattens the non-batch axes, as JAX's
    ``chain_step_skip`` reduces over them)."""
    from multimodn_tpu_torch.core.fusion import sample_missing
    img = np.zeros((5, 4, 4, 3), np.float32)
    img[1, 3, 0, 2] = np.nan
    img[4] = np.nan
    assert sample_missing(_t(img)).tolist() == [False, True, False, False,
                                                True]


def _chain_loss(tm, data, y, mask, chain, order):
    traced = chain in ("scan", "switch")
    fn = tstep.make_batch_loss_fn(
        tm.encoders if chain != "scan" else [tm.encoders[0]] * len(order),
        tm.decoders, tm.init_state, resolve_criterion(None), tm.err_penalty,
        tm.state_change_penalty, order, "sample",
        chain if traced else "unrolled", per_batch_seq=traced)
    seq = torch.tensor([e for _d, e in order]) if traced else None
    params = tm.params if chain != "scan" else dict(
        tm.params, encoders=[tm.params["encoders"][0]] * len(order))
    with torch.no_grad():
        return fn(params, tuple(_t(d) for d in data), _t(y), _t(mask), None,
                  0, True, seq=seq)


@pytest.mark.parametrize("chain", ["unrolled", "executions", "scan",
                                   "switch"])
def test_nan_and_padded_rows_leave_the_batch_statistics(chain):
    """On every chain form, the present rows' states and the batch loss do
    not move when a NaN image's other pixels or a padded row's pixels
    change: both are out of every block's statistics, the downsample
    branches' included. ``executions`` runs the ResNet twice (a repeated
    order); ``scan`` runs two ResNets' shared computation."""
    _jm, tm = _image_models()
    ds = ImageDataset()
    data, y, mask = _batch(ds, range(4, 11))
    if chain == "scan":
        data = (data[0], data[0])
    order = {"executions": ((0, 0), (1, 1), (0, 0))}.get(chain,
                                                        ((0, 0), (1, 1)))
    base_loss, base = _chain_loss(tm, data, y, mask, chain, order)
    moved = [d.copy() for d in data]
    moved[0][2] = np.where(np.isnan(moved[0][2]), np.nan, 7.0)   # NaN row
    moved[0][7] = 5.0                                             # padding
    if chain == "scan":
        moved[1] = moved[0]
    loss, aux = _chain_loss(tm, tuple(moved), y, mask, chain, order)
    assert torch.isfinite(base_loss)
    assert torch.equal(loss, base_loss)
    present = [0, 1, 3, 4, 5, 6]
    assert torch.equal(aux["final_state"][present],
                       base["final_state"][present])
    if chain == "unrolled":
        # Without the mask the NaN row's pixels would move the statistics.
        enc = tm.encoders[0]
        p = tm.params["encoders"][0]
        s0 = torch.zeros(BATCH, S)
        a = enc.apply(p, s0, torch.nan_to_num(_t(data[0])), train=True,
                      sample_mask=_t(mask))
        b = enc.apply(p, s0, torch.nan_to_num(_t(moved[0])), train=True,
                      sample_mask=_t(mask))
        assert not torch.allclose(a[present], b[present])


@pytest.mark.parametrize("optimizer", ["Adam", "Adam8bit"])
def test_training_leaves_the_stored_statistics_alone(optimizer):
    """BatchNorm's stored statistics are parameters with zero gradients, as
    in the JAX package: a training epoch with ``Adam`` or ``Adam8bit``
    (K2's plain version on the CPU) leaves them bit for bit, moves the
    weights, and ``test`` (evaluation mode, stored statistics) is finite;
    ``parameters()`` has JAX's count, order and shapes."""
    jm, tm = _image_models()
    before = tree_map(torch.clone, tm.params)
    loader = TLoader(ImageDataset(), BATCH)
    hist = tmm.MultiModNHistory(["y"])
    tm.train_epoch(loader, getattr(tmm, optimizer)(1e-3), None, hist)
    res = tm.test(loader, None)
    assert np.isfinite(hist.loss["train"][-1]).all()
    assert np.isfinite(res[0][1])
    bn = before["encoders"][0]["stages"][1][0]["down"]["bn"]
    now = tm.params["encoders"][0]["stages"][1][0]["down"]["bn"]
    for key in ("mean", "var"):
        assert torch.equal(bn[key], now[key])
    assert not torch.equal(bn["scale"], now["scale"])
    assert [tuple(p.shape) for p in tm.parameters()] == \
        [tuple(p.shape) for p in jm.parameters()]
