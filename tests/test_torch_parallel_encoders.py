"""Every encoder family on a mesh (``MultiModN(mesh=)`` with the attention,
recurrent and ResNet encoders) against the JAX package's mesh runs.

As in ``test_torch_parallel.py``: each world is ``gloo`` ranks on the CPU,
started once per module (rank code in ``test_torch_parallel_ranks.py``),
and the JAX side runs on ``conftest.py``'s 8 virtual CPU devices with the
same seeded data and the JAX model's initial weights transplanted. The
families (``ranks.family_modules``) are built at tiny widths: a
transformer (embed 8, 2 heads, 1 layer), a ViT over 4 x 4 x 3 images, an
LSTM and an RNN in one model (``MIXED``), and a ResNet-18 over 8 x 8
images beside an MLP encoder (``IMAGES``).

Tolerances are ``test_torch_parallel.py``'s (rtol 1e-5 / atol 1e-6,
``Adam8bit`` parameters atol 2e-3), with two exceptions, both properties
of the math and not of either package:

- The key bias of an attention block (``qkv``'s bias, columns D..2D) has
  a gradient of exactly 0: ``q . (k + b)`` adds one constant to every
  logit of a row, which the softmax removes. Its computed gradient is
  rounding (~1e-9), and Adam's scale-free step turns rounding into steps of
  up to ``lr``, whose sign differs between any two summation orders (a
  mesh and one device, XLA and PyTorch alike). Those elements are held at
  ``lr`` per step instead.
- Train-mode BatchNorm at one 1 x 1 position over 8 rows amplifies fp32
  rounding (``test_torch_resnet.py``): on one device, permuting the rows of
  a batch of 16 (an exact symmetry) moves a ResNet's gradients by up to
  3.8e-4 of a leaf's largest value, and after 4 ``Adam`` steps moves
  thousands of convolution weights by 1e-3 to 0.046. So the ResNet is held
  by one step's gradients (an ``SGD(1.0)`` step, whose parameter change is
  minus the global gradient) leaf by leaf at 5e-4 of the leaf's largest
  magnitude (at least 1; ``test_torch_resnet.py``'s ``TRAIN_TOL``), by its
  losses, and its ``Adam`` runs' parameters within ``lr`` per step.

Within the port, replicas are held bit for bit (digests for the ResNet).
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.parallel import make_mesh as jmake_mesh
from multimodn_tpu.parallel import shard_params as jshard_params

from multimodn_tpu_torch.parallel.dryrun import spawn

import test_torch_parallel_ranks as ranks

RTOL, ATOL = 1e-5, 1e-6
ADAM8_ATOL = 2e-3       # ~lr/8 for one flipped 8-bit code at lr 0.01
LR = 0.01
RESNET_TOL = 5e-4       # of a leaf's largest magnitude (module docstring)
# Loss histories of a ResNet: at these sizes the row-permutation spread of
# one device's loss after 2 Adam steps is 2.4e-4, and JAX's own (2,) and
# (2, 2) meshes differ by 5.6e-4 relative in a 2-epoch run.
RESNET_LOSS_RTOL = 2e-3
S = 4

MIXED = {"state": S, "encoders": [("transformer", 6), ("vit", 48),
                                  ("lstm", 3), ("rnn", 3)]}
IMAGES = {"state": S, "encoders": [("resnet", (8, 8, 3)), ("mlp", 2)],
          "digest": True}
REC = {"state": S, "encoders": [("lstm", 3), ("rnn", 3)]}
REC_SEQ = dict(REC, unbatched=False)
TRANSFORMER = {"state": S, "encoders": [("transformer", 6), ("mlp", 2)]}
DROPOUT = dict(TRANSFORMER, dropout=0.1)


def _arrays(spec, n, nv, seed, nan=None):
    """Seeded per-modality train and val arrays for ``spec``; ``nan =
    (modality, first row, stop row)`` puts NaN in those rows of every
    block of 16 rows (a 2-way data axis gives rows 8-15 of a batch of 16 to
    the second rank)."""
    rng = np.random.default_rng(seed)
    xs = []
    for _kind, w in spec["encoders"]:
        shape = (n + nv,) + (tuple(w) if isinstance(w, tuple) else (w,))
        xs.append(rng.normal(size=shape).astype(np.float32))
    flat = np.concatenate([x.reshape(n + nv, -1)[:, :3] for x in xs], 1)
    y = (flat @ rng.normal(size=flat.shape[1]) > 0).astype(np.int64)[:, None]
    if nan is not None:
        mod, lo, hi = nan
        for b in range(0, n + nv, 16):
            xs[mod][b + lo:b + hi] = np.nan
    return ([x[:n] for x in xs], y[:n]), ([x[n:] for x in xs], y[n:])


MIXED_ARRAYS = _arrays(MIXED, 48, 16, seed=1, nan=(2, 10, 12))
# 13 rows in one batch of 16: the loader pads rows 13-15 and rows 9-10 hold
# a NaN image; all of them are the second rank's on a 2-way data axis.
IMAGE_STEP = _arrays(IMAGES, 13, 16, seed=2, nan=(0, 9, 11))
IMAGE_ARRAYS = _arrays(IMAGES, 32, 16, seed=3, nan=(0, 9, 11))
# 30 rows: batches of 8 end in a tail batch of 6; batches of 7 do not
# divide a 2-way data axis (4 rows each, the second rank's last padded).
REC_ARRAYS = _arrays(REC, 30, 14, seed=4, nan=(0, 5, 6))


def jbuild(spec, mesh=None, engine="auto"):
    """The JAX twin of ``ranks.build`` for a family spec."""
    encs, decs = ranks.family_modules(jenc, jdec, spec)
    return jmm.MultiModN(spec["state"], encs, decs, 0.7, 0.3,
                         nan_skip=spec.get("nan_skip", "sample"), seed=0,
                         mesh=mesh, dp_engine=engine)


def jtrain(spec, arrays, mesh, engine="auto", opt="adam", how="fit",
           epochs=2, batch=16):
    model = jbuild(spec, mesh, engine)
    (X, y), (Xv, yv) = arrays
    tr = JLoader(ranks.Arrays(X, y), batch)
    va = JLoader(ranks.Arrays(Xv, yv), batch)
    h = jmm.MultiModNHistory(["t"])
    out = {}
    if how == "step":
        before = _leaves(model.state_dict())
        model.train_epoch(tr, jmm.SGD(1.0), "cross_entropy", h)
        out["delta"] = [a - b for a, b in zip(_leaves(model.state_dict()),
                                              before)]
    else:
        o = {"adam": jmm.Adam, "adam8bit": jmm.Adam8bit}[opt](LR)
        model.fit(tr, o, "cross_entropy", epochs=epochs, history=h,
                  val_loader=va)
    out["history"] = ranks.history_arrays(h)
    out["state"] = jax.tree_util.tree_map(np.asarray, model.state_dict())
    return out


_JAX_RUNS = {}


def jrun(name, *args, **kw):
    """``jtrain(*args, **kw)``, once per ``name`` in this module."""
    if name not in _JAX_RUNS:
        _JAX_RUNS[name] = jtrain(*args, **kw)
    return _JAX_RUNS[name]


def _init(spec):
    return jax.tree_util.tree_map(np.asarray, jbuild(spec).state_dict())


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), msg
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)


def _histories_close(got, want, tags=("train", "val"), rtol=RTOL):
    for k in want:
        for tag in tags:
            if tag in want[k]:
                _close(got[k][tag], want[k][tag], rtol=rtol,
                       msg=f"{k}/{tag}")


def _key_bias_apart(state, spec):
    """``state``'s leaves with every attention block's key bias cut out,
    and those key biases (module docstring)."""
    state = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), state)
    keys = []
    for (kind, _w), enc in zip(spec["encoders"], state["encoders"]):
        if kind in ("transformer", "vit"):
            for block in enc["blocks"]:
                b = block["qkv"]["b"]
                d = b.shape[0] // 3
                keys.append(b[d:2 * d].copy())
                b[d:2 * d] = 0.0
    return state, keys


def _state_close(got, want, spec, steps, atol=ATOL):
    """Parameters within ``atol`` + ``RTOL``; attention key biases within
    ``LR`` per step (module docstring)."""
    g, gk = _key_bias_apart(got, spec)
    w, wk = _key_bias_apart(want, spec)
    _close(g, w, atol=atol)
    for a, b in zip(gk, wk):
        np.testing.assert_allclose(a, b, rtol=0, atol=LR * steps + ATOL)


def _resnet_near(got, want, msg=""):
    """Leaf by leaf within ``RESNET_TOL`` of the leaf's largest magnitude
    (at least 1)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=RESNET_TOL * scale,
                                   err_msg=f"{msg} leaf {i}")


def _replicas_equal(results):
    """Ranks with one model coordinate hold bit-equal pieces and optimizer
    states; every rank's whole parameters are bit-equal (digests where the
    run gives them)."""
    by_coord = {}
    for r in results:
        by_coord.setdefault((r["coords"] or {}).get("model", 0),
                            []).append(r)
    for group in by_coord.values():
        for other in group[1:]:
            for a, b in zip(group[0]["local"] + group[0]["local_opt"],
                            other["local"] + other["local_opt"]):
                np.testing.assert_array_equal(a, b)
    if "state_digest" in results[0]:
        assert len({r["state_digest"] for r in results}) == 1
        return
    for other in results[1:]:
        for a, b in zip(_leaves(results[0]["state"]),
                        _leaves(other["state"])):
            np.testing.assert_array_equal(a, b)


def _job(name, fn, **kw):
    return (name, fn, kw)


def _runs(world, name):
    return [r[name] for r in world]


def _steps(arrays, batch, epochs):
    return epochs * -(-len(arrays[0][1]) // batch)


@pytest.fixture(scope="module")
def inits():
    return {"mixed": _init(MIXED), "images": _init(IMAGES),
            "rec": _init(REC), "rec_seq": _init(REC_SEQ)}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel_encoders")


@pytest.fixture(scope="module")
def world2(inits, work):
    """Every two-rank job of this module, in one spawned world."""
    data2 = dict(shape=(2,), axes=("data",))
    tp = dict(shape=(1, 2), axes=("data", "model"))
    rec = []
    for label, spec, batch, engine in (
            ("rec_auto", REC, 8, "auto"), ("rec_sm", REC, 8, "shard_map"),
            ("rec_odd", REC, 7, "auto"),
            ("seq_auto", REC_SEQ, 8, "auto"),
            ("seq_sm", REC_SEQ, 8, "shard_map")):
        rec.append(_job(label, "train", spec=spec,
                        params=inits["rec_seq" if spec is REC_SEQ else "rec"],
                        arrays=REC_ARRAYS, engine=engine, batch=batch,
                        epochs=2, **data2))
    img = dict(spec=IMAGES, params=inits["images"])
    jobs = rec + [
        _job("mixed_tp_adam8", "train", spec=MIXED, params=inits["mixed"],
             arrays=MIXED_ARRAYS, epochs=2, opt="adam8bit", **tp),
        _job("res_step", "train", arrays=IMAGE_STEP, how="step", opt="sgd",
             **img, **data2),
        _job("res_step_sm", "train", arrays=IMAGE_STEP, how="step",
             opt="sgd", engine="shard_map", **img, **data2),
        _job("res_tp_adam8", "train", arrays=IMAGE_ARRAYS, epochs=1,
             opt="adam8bit", **img, **tp),
        _job("dropout", "train", spec=DROPOUT, params=None,
             arrays=MIXED_ARRAYS_TF, epochs=2, **data2),
        _job("cross_images", "cross_rank_tree", spec=IMAGES),
        _job("cross_mixed", "cross_rank_tree", spec=MIXED),
        _job("kfold_mixed", "experiments", spec=MIXED,
             arrays_list=FOLD_ARRAYS, kind="kfold", fold_axis_size=2,
             params=None),
        _job("resume_full", "resumable", spec=TRANSFORMER,
             arrays=MIXED_ARRAYS_TF, ckpt=str(work / "full"), opt="adam",
             **tp),
        _job("resume_cut", "resumable", spec=TRANSFORMER,
             arrays=MIXED_ARRAYS_TF, ckpt=str(work / "cut"), opt="adam",
             kill_after=2, **tp),
    ]
    return spawn(ranks.world, 2, "gloo", "cpu", jobs)


@pytest.fixture(scope="module")
def world4(inits):
    """Every four-rank job: a (data, model) = (2, 2) mesh."""
    dptp = dict(shape=(2, 2), axes=("data", "model"))
    jobs = [
        _job("mixed_adam", "train", spec=MIXED, params=inits["mixed"],
             arrays=MIXED_ARRAYS, epochs=2, **dptp),
        _job("res_step", "train", spec=IMAGES, params=inits["images"],
             arrays=IMAGE_STEP, how="step", opt="sgd", **dptp),
        _job("res_adam", "train", spec=IMAGES, params=inits["images"],
             arrays=IMAGE_ARRAYS, epochs=1, **dptp),
    ]
    return spawn(ranks.world, 4, "gloo", "cpu", jobs)


# The transformer-only model's data: the first two modalities of MIXED's
# layout (a 6-wide and a 2-wide block).
MIXED_ARRAYS_TF = _arrays(TRANSFORMER, 48, 16, seed=5)
FOLD_ARRAYS = [_arrays(MIXED, 24, 8, seed=s) for s in (7, 8, 9)]


# ---------------------------------------------------------------------------
# The repair: the recurrence over the global batch on a data axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, spec, batch", [
    ("rec_auto", REC, 8), ("rec_sm", REC, 8), ("rec_odd", REC, 7),
    ("seq_auto", REC_SEQ, 8), ("seq_sm", REC_SEQ, 8)])
def test_recurrent_encoders_on_a_data_axis_match_jax_auto(world2, case,
                                                          spec, batch):
    """An LSTM and an RNN, ``unbatched_compat`` True (one recurrence over
    the batch's rows) and False (a sequence per row), on a 2-way data axis
    under both engines, against the JAX package's ``auto`` engine on 2
    devices: the unbatched recurrence runs over the GLOBAL batch, as one
    device runs it; a tail batch and a batch of 7 rows (the second rank's
    last row padded) included. JAX's mesh refuses a batch of 7 on 2
    devices (its dimension must divide), so that case is held to JAX's one
    device, whose numbers its ``auto`` engine gives."""
    mesh = jmake_mesh((2,), ("data",)) if batch % 2 == 0 else None
    want = jrun(f"{case}_{batch}".replace("_sm", "_auto"), spec, REC_ARRAYS,
                mesh, batch=batch)
    runs = _runs(world2, case)
    _histories_close(runs[0]["history"], want["history"])
    _close(runs[0]["state"], want["state"])
    _replicas_equal(runs)


def test_jax_shard_map_restarts_the_recurrence_per_shard(world2):
    """A fault of the JAX package, pinned: its ``shard_map`` engine runs an
    ``unbatched_compat`` recurrence on each shard's rows, restarting it at
    every shard, so it leaves its own ``auto`` engine (and one device). The
    port runs the global recurrence under either engine."""
    mesh = jmake_mesh((2,), ("data",))
    auto = jrun("rec_auto_8", REC, REC_ARRAYS, mesh, batch=8)
    sm = jtrain(REC, REC_ARRAYS, mesh, "shard_map", batch=8)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(sm["state"]), _leaves(auto["state"])))
    assert gap > 1e-3
    _close(_runs(world2, "rec_sm")[0]["state"], auto["state"])


# ---------------------------------------------------------------------------
# Attention and recurrent encoders, column-sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world_name, case, shape, opt", [
    ("world2", "mixed_tp_adam8", (1, 2), "adam8bit"),
    ("world4", "mixed_adam", (2, 2), "adam")])
def test_attention_and_recurrent_encoders_match_jax_mesh(
        request, world_name, case, shape, opt):
    """A transformer, a ViT, an LSTM and an RNN in one model on ``(data,
    model)`` = (1, 2) with ``Adam8bit`` (K2's cross-rank form) and on (2,
    2) with ``Adam``: LayerNorm vectors, position tables and gate columns
    gathered once per forward, ``qkv`` and every other dense layer
    column-parallel, the recurrences over the global batch; histories and
    parameters against the JAX package's mesh run."""
    world = request.getfixturevalue(world_name)
    want = jtrain(MIXED, MIXED_ARRAYS, jmake_mesh(shape, ("data", "model")),
                  opt=opt)
    runs = _runs(world, case)
    steps = _steps(MIXED_ARRAYS, 16, 2)
    if opt == "adam":
        _histories_close(runs[0]["history"], want["history"])
        _state_close(runs[0]["state"], want["state"], MIXED, steps)
    else:
        _histories_close(runs[0]["history"], want["history"],
                         tags=("train",))
        _state_close(runs[0]["state"], want["state"], MIXED, steps,
                     atol=ADAM8_ATOL)
    _replicas_equal(runs)


def test_attention_dropout_draws_at_the_global_batch_shape(world2):
    """Attention dropout on a 2-way data axis draws the mask one device
    draws over the whole batch (``RowStream``): the run equals the
    mesh-free one."""
    free = ranks.train(DROPOUT, None, MIXED_ARRAYS_TF, None, None, epochs=2)
    got = _runs(world2, "dropout")[0]
    _histories_close(got["history"], free["history"])
    _state_close(got["state"], free["state"], DROPOUT,
                 _steps(MIXED_ARRAYS_TF, 16, 2))


def test_new_leaves_are_placed_by_jax_specs(world2, world4):
    """Leaf for leaf, every family's placement is JAX's PartitionSpec
    (LayerNorm and BatchNorm vectors, position tables, gate columns split;
    4-D convolution kernels whole), and each rank holds the pieces it
    implies."""
    for spec, world, case, shape in ((MIXED, world4, "mixed_adam", (2, 2)),
                                     (IMAGES, world2, "res_tp_adam8",
                                      (1, 2))):
        jmesh = jmake_mesh(shape, ("data", "model"))
        jm = jbuild(spec)
        jspecs = [tuple(x.sharding.spec) for x in jax.tree_util.tree_leaves(
            jshard_params(jm.params, jmesh))]
        got = world[0][case]["specs"]
        assert [tuple(s) for s in got] == jspecs
        assert ("model",) in jspecs and (None, "model") in jspecs
        whole = [np.asarray(x).shape for x in jax.tree_util.tree_leaves(
            jm.params)]
        if spec is IMAGES:
            assert any(len(s) == 4 for s in whole)
            assert all(sp == () for s, sp in zip(whole, jspecs)
                       if len(s) == 4)
        for r in world:
            for w, sp, local in zip(whole, got, r[case]["local_shapes"]):
                want = list(w)
                if "model" in sp:
                    want[list(sp).index("model")] //= 2
                assert tuple(want) == local


# ---------------------------------------------------------------------------
# ResNet: global BatchNorm moments, gathered BatchNorm vectors
# ---------------------------------------------------------------------------

def test_resnet_global_moments_on_a_data_axis_match_jax(world2):
    """One ``SGD(1.0)`` step of the ResNet model on a 2-way data axis with
    NaN images and padded rows in the second rank's block only: the
    BatchNorm moments are the global batch's (two summing all-reduces per
    BatchNorm), so loss and gradients are the JAX ``auto`` engine's, under
    both of the port's engines."""
    want = jrun("res_step", IMAGES, IMAGE_STEP, jmake_mesh((2,), ("data",)),
                how="step")
    for case in ("res_step", "res_step_sm"):
        runs = _runs(world2, case)
        _histories_close(runs[0]["history"], want["history"],
                         tags=("train",))
        _resnet_near(runs[0]["delta"], want["delta"], case)
        _replicas_equal(runs)


def test_jax_shard_map_takes_per_shard_batchnorm_moments():
    """A fault of the JAX package, pinned: its ``shard_map`` engine takes
    each shard's BatchNorm moments, so its gradients leave its own
    ``auto`` engine's by far more than the BatchNorm rounding spread."""
    mesh = jmake_mesh((2,), ("data",))
    auto = jrun("res_step", IMAGES, IMAGE_STEP, mesh, how="step")
    sm = jtrain(IMAGES, IMAGE_STEP, mesh, "shard_map", how="step")
    rel = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
              for a, b in zip(sm["delta"], auto["delta"]))
    assert rel > 10 * RESNET_TOL


def test_resnet_on_a_dp_tp_mesh_matches_jax(world4):
    """One ``SGD(1.0)`` step on ``(data, model)`` = (2, 2) (BatchNorm
    vectors gathered, the head column-parallel, the moments global, the
    NaN and padded rows in one data block): gradients leaf by leaf against
    the JAX package's mesh run."""
    want = jtrain(IMAGES, IMAGE_STEP, jmake_mesh((2, 2), ("data", "model")),
                  how="step")
    runs = _runs(world4, "res_step")
    _histories_close(runs[0]["history"], want["history"], tags=("train",))
    _resnet_near(runs[0]["delta"], want["delta"])
    _replicas_equal(runs)


@pytest.mark.parametrize("world_name, case, shape, opt", [
    ("world2", "res_tp_adam8", (1, 2), "adam8bit"),
    ("world4", "res_adam", (2, 2), "adam")])
def test_resnet_training_matches_jax_mesh(request, world_name, case, shape,
                                          opt):
    """An epoch of 2 batches on (1, 2) with ``Adam8bit`` (K2's cross-rank
    form on the ResNet's leaves, sharded BatchNorm vectors beside whole 4-D
    kernels) and on (2, 2) with ``Adam``: losses against the JAX package's
    mesh run (``RESNET_LOSS_RTOL``); ``Adam``'s parameters within ``lr``
    per step. ``Adam8bit``'s are not compared: where an element's 8-bit v
    code rounds to 0 under a nonzero m code it steps by m / eps, so runs
    that differ in their last bits end far apart in single parameters
    (``test_torch_parallel.py``); its step is held bit for bit against the
    plain whole-leaf update instead (the cross-rank test below)."""
    world = request.getfixturevalue(world_name)
    want = jtrain(IMAGES, IMAGE_ARRAYS, jmake_mesh(shape, ("data", "model")),
                  opt=opt, epochs=1)
    runs = _runs(world, case)
    _histories_close(runs[0]["history"], want["history"],
                     rtol=RESNET_LOSS_RTOL)
    if opt == "adam":
        _close(runs[0]["state"], want["state"],
               atol=LR * _steps(IMAGE_ARRAYS, 16, 1), rtol=0)
    _replicas_equal(runs)


# ---------------------------------------------------------------------------
# K2's cross-rank form on the new leaf sets, the elastic resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, leaves", [("cross_images", 102),
                                          ("cross_mixed", 0)])
def test_adam8bit_cross_rank_plain_form_on_the_new_leaf_sets(world2, case,
                                                             leaves):
    """One optimizer step's leaves in one ``multi_leaf_update`` call on a
    model axis of 2: the ResNet model's (BatchNorm vectors split beside
    whole 4-D convolution kernels) and the transformer, ViT and gate
    columns; every rank's pieces bit-equal to the whole leaves' plain
    update, sliced."""
    for r in _runs(world2, case):
        assert r["equal"]
        assert r["split"] > 0
        assert r["leaves"] > leaves
        if case == "cross_images":
            assert 4 in r["ndims"]


def test_elastic_two_to_one_resume_of_a_column_sharded_transformer(world2,
                                                                   work):
    """A transformer model's ``fit_best_resumable`` on ``(data, model)`` =
    (1, 2), stopped after 2 of 4 epochs and resumed on one device from the
    gathered checkpoint, against the uninterrupted 2-rank run (fp32
    ``Adam``)."""
    full = _runs(world2, "resume_full")[0]
    assert _runs(world2, "resume_cut") == [None, None]
    elastic = str(work / "elastic")
    shutil.copytree(str(work / "cut"), elastic)
    got = ranks.resumable(TRANSFORMER, MIXED_ARRAYS_TF, None, None, elastic,
                          opt="adam")
    _close(got["scores"], full["scores"])
    _state_close(got["state"], full["state"], TRANSFORMER,
                 _steps(MIXED_ARRAYS_TF, 8, 4))
    assert os.listdir(elastic) == ["resume_best_latest.pkl"]


def test_fold_axis_kfold_carries_the_new_families(world2):
    """``kfold_fit_best(mesh=)`` over a 2-rank ``fold`` axis with the
    transformer, ViT, LSTM and RNN model: every rank gets every fold's
    result, equal to the folds run one after another on one device."""
    want = ranks.experiments(MIXED, FOLD_ARRAYS, "kfold", None, None)
    runs = _runs(world2, "kfold_mixed")
    assert len(runs[0]) == len(want) == 3
    steps = _steps(FOLD_ARRAYS[0], 8, 2)
    for got, wt in zip(runs[0], want):
        _close(got["scores"], wt["scores"])
        assert got["best_epoch"] == wt["best_epoch"]
        _state_close(got["state"], wt["state"], MIXED, steps)
    for a, b in zip(runs[0], runs[1]):
        assert np.array_equal(a["scores"], b["scores"])
        for x, y in zip(_leaves(a["state"]), _leaves(b["state"])):
            np.testing.assert_array_equal(x, y)
