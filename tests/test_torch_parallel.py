"""The port's multi-device training (``multimodn_tpu_torch.parallel``,
``MultiModN(mesh=, dp_engine=)``) against the JAX package's mesh runs.

The port runs one process per device: each world below is ``gloo`` ranks on
the CPU, started once per module by ``parallel.dryrun.spawn`` (rank code in
``test_torch_parallel_ranks.py``, which imports no JAX). The JAX side runs on
``conftest.py``'s 8 virtual CPU devices, with the same seeded data and the
JAX model's initial weights transplanted into the port's.

Tolerances: rtol 1e-5 / atol 1e-6, JAX's own for a mesh run against a
single device (``tests/test_parallel.py``): the ranks sum gradients and
grids in another order than one device, and XLA and PyTorch multiply in
different orders, each ~1e-7 relative at these widths. Counts (accuracy,
confusion cells) are compared at the same tolerance, which makes them
equal. The DP x TP selection scores are held within one step of a rank
statistic (``_rank_step``), the best epoch exactly. ``Adam8bit`` against
JAX's: a moment that moved by one ulp may round to the neighbouring 8-bit
code, which moves that element's step by at most ~lr/8
(``test_torch_optim.py``), so parameters are held at atol 2e-3 for lr
0.01 (histories at 1e-5); the port's cross-rank form against its own
whole-leaf plain version is held bit for bit. Within the port, the ranks'
copies of every parameter piece are bit-equal, and a one-rank mesh is
bit-equal to the mesh-free model.
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
from multimodn_tpu import experiments as jexp
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
from multimodn_tpu.parallel import make_mesh as jmake_mesh
from multimodn_tpu.parallel import shard_params as jshard_params

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch.parallel import batch_sharding, replicate
from multimodn_tpu_torch.parallel.dryrun import default_device, \
    dryrun_multichip, spawn
from multimodn_tpu_torch.parallel.sharding import P, leaf_spec, param_specs

import test_torch_parallel_ranks as ranks

RTOL, ATOL = 1e-5, 1e-6
ADAM8_ATOL = 2e-3       # ~lr/8 for one flipped 8-bit code at lr 0.01

DP = {"family": "mlp", "state": 3, "widths": [3, 3], "hidden": (4,)}
TP = {"family": "mimic", "state": 4, "widths": [3, 5], "hidden": (8,),
      "dec_hidden": (4,)}
NAN = dict(DP, nan_skip="batch")
PRESENCE = dict(DP, presence_penalty=25.0)
rng = np.random.default_rng(7)
STATIC = dict(DP, bank=[rng.normal(size=3).astype(np.float32)
                        for _ in range(5)])


def _arrays(n=64, nv=32, widths=(3, 3), seed=0, nan_rows=None, nan_mod=1):
    """Seeded train and val arrays; ``nan_rows`` (within each batch of 16)
    get NaN in modality ``nan_mod``."""
    rng = np.random.default_rng(seed)
    f = sum(widths)
    X = rng.normal(size=(n + nv, f)).astype(np.float32)
    y = (X @ rng.normal(size=f) > 0).astype(np.int64)[:, None]
    if nan_rows is not None:
        lo = sum(widths[:nan_mod])
        for b in range((n + nv) // 16):
            X[b * 16 + nan_rows[0]:b * 16 + nan_rows[1],
              lo:lo + widths[nan_mod]] = np.nan
    return (X[:n], y[:n]), (X[n:], y[n:])


# Rank 1 holds rows 8-15 of a batch of 16 on a 2-way data axis: these
# NaNs are in rank 1's rows only.
NAN_ARRAYS = _arrays(seed=1, nan_rows=(10, 12))
FREEZE_ARRAYS = _arrays(seed=2, nan_rows=(0, 16))
PRESENCE_ARRAYS = _arrays(seed=3, nan_rows=(3, 6), nan_mod=0)
STATIC_ARRAYS = ((_arrays(n=40, seed=7)[0]), _arrays(n=40, seed=7)[0])
TP_ARRAYS = _arrays(widths=(3, 5), seed=4)


def jbuild(spec, mesh=None, engine="auto", seed=None):
    """The JAX twin of ``test_torch_parallel_ranks.build``."""
    S = spec["state"]
    if spec["family"] == "mimic":
        encs = [jenc.MIMICMLPEncoder(S, w, spec["hidden"], dropout=0.0)
                for w in spec["widths"]]
        decs = [jdec.MLPDecoder(S, spec["dec_hidden"], 2)]
    else:
        encs = [jenc.MLPEncoder(S, w, spec["hidden"]) for w in spec["widths"]]
        decs = [jdec.LogisticDecoder(S)]
    kw = {}
    if spec.get("bank") is not None:
        kw["init_state"] = jmm.StaticInitState(
            [np.asarray(b, np.float32) for b in spec["bank"]])
    return jmm.MultiModN(
        S, encs, decs, spec.get("err", 0.7), spec.get("sc", 0.3),
        nan_skip=spec.get("nan_skip", "sample"),
        presence_penalty=spec.get("presence_penalty", 0.0),
        seed=spec.get("seed", 0) if seed is None else seed, mesh=mesh,
        dp_engine=engine, **kw)


def jloaders(arrays, widths, batch=16, shuffle=False):
    (X, y), (Xv, yv) = arrays
    return (JLoader(JDataset(X, y, list(widths)), batch, shuffle=shuffle),
            JLoader(JDataset(Xv, yv, list(widths)), batch))


def jtrain(spec, arrays, mesh, engine="auto", opt="adam", how="fit",
           epochs=3):
    model = jbuild(spec, mesh, engine)
    tr, va = jloaders(arrays, spec["widths"])
    h = jmm.MultiModNHistory(["t"])
    o = {"adam": jmm.Adam, "adam8bit": jmm.Adam8bit}[opt](0.01)
    out = {}
    if how == "fit":
        model.fit(tr, o, "cross_entropy", epochs=epochs, history=h,
                  val_loader=va)
    elif how == "fit_best":
        r = model.fit_best(tr, o, "cross_entropy", epochs=epochs,
                           val_loader=va, history=h)
        out.update(scores=np.asarray(r["scores"]),
                   best_epoch=int(r["best_epoch"]),
                   best_params=jax.tree_util.tree_map(np.asarray,
                                                      r["best_params"]))
    elif how == "static":
        model.train_epoch(tr, o, "cross_entropy", h)
        model.fit(tr, o, "cross_entropy", epochs=2, history=h,
                  val_loader=va)
        r = model.fit_best(tr, o, "cross_entropy", epochs=4, val_loader=va,
                           patience=3)
        out.update(scores=np.asarray(r["scores"]),
                   best_epoch=int(r["best_epoch"]),
                   cycle=model._cycle_offset, epochs_ran=r["epochs_ran"])
    out["history"] = ranks.history_arrays(h)
    out["state"] = jax.tree_util.tree_map(np.asarray, model.state_dict())
    out["test"] = model.test(va, "cross_entropy")
    return out


def _init(spec):
    return jax.tree_util.tree_map(np.asarray, jbuild(spec).state_dict())


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), msg
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)


def _histories_close(got, want, tags=("train", "val")):
    for k in want:
        for tag in tags:
            if tag in want[k]:
                _close(got[k][tag], want[k][tag], msg=f"{k}/{tag}")


def _replicas_equal(results):
    """Ranks with one model coordinate hold bit-equal pieces and optimizer
    states; every rank's whole parameters are bit-equal."""
    by_coord = {}
    for r in results:
        key = (r["coords"] or {}).get("model", 0)
        by_coord.setdefault(key, []).append(r)
    for group in by_coord.values():
        for other in group[1:]:
            for a, b in zip(group[0]["local"] + group[0]["local_opt"],
                            other["local"] + other["local_opt"]):
                np.testing.assert_array_equal(a, b)
    for other in results[1:]:
        for a, b in zip(_leaves(results[0]["state"]),
                        _leaves(other["state"])):
            np.testing.assert_array_equal(a, b)


def _job(name, fn, **kw):
    return (name, fn, kw)


@pytest.fixture(scope="module")
def world2():
    """Every two-rank job of this module, in one spawned world."""
    seed_params = {s: _init(dict(DP, seed=s)) for s in (0, 1, 2)}
    jobs = [
        _job("dp_fit", "train", spec=DP, params=_init(DP),
             arrays=_arrays(), shape=(2,), axes=("data",)),
        _job("dp_fit_best", "train", spec=DP, params=_init(DP),
             arrays=_arrays(), shape=(2,), axes=("data",), how="fit_best",
             epochs=4),
        _job("dp_fit_sm", "train", spec=DP, params=_init(DP),
             arrays=_arrays(), shape=(2,), axes=("data",),
             engine="shard_map"),
        _job("nan_auto", "train", spec=NAN, params=_init(NAN),
             arrays=NAN_ARRAYS, shape=(2,), axes=("data",)),
        _job("nan_sm", "train", spec=NAN, params=_init(NAN),
             arrays=NAN_ARRAYS, shape=(2,), axes=("data",),
             engine="shard_map", how="fit_best"),
        _job("nan_freeze", "train", spec=NAN, params=_init(NAN),
             arrays=FREEZE_ARRAYS, shape=(2,), axes=("data",)),
        _job("presence", "train", spec=PRESENCE, params=_init(PRESENCE),
             arrays=PRESENCE_ARRAYS, shape=(2,), axes=("data",)),
        _job("static", "train", spec=STATIC, params=_init(STATIC),
             arrays=STATIC_ARRAYS, shape=(2,), axes=("data",),
             engine="shard_map", how="static"),
        _job("kfold", "experiments", spec=DP,
             arrays_list=[_arrays(seed=s) for s in (11, 12, 13)],
             kind="kfold", fold_axis_size=2, params=seed_params),
        _job("sweep", "experiments", spec=DP, arrays_list=[_arrays(seed=14)],
             kind="sweep", fold_axis_size=2, params=seed_params),
        _job("cross_fp8", "cross_rank_adam", fmt="fp8"),
        _job("cross_int8", "cross_rank_adam", fmt="int8"),
        _job("guards", "guards", spec=DP, arrays=_arrays()),
    ]
    return spawn(ranks.world, 2, "gloo", "cpu", jobs)


@pytest.fixture(scope="module")
def world1():
    """A one-rank world: a one-rank mesh beside the mesh-free model."""
    jobs = [
        _job("one_rank_dp", "train", spec=NAN, params=_init(NAN),
             arrays=NAN_ARRAYS, shape=(1,), axes=("data",), how="fit_best",
             opt="adam8bit"),
        _job("mesh_free", "train", spec=NAN, params=_init(NAN),
             arrays=NAN_ARRAYS, shape=None, axes=None, how="fit_best",
             opt="adam8bit"),
    ]
    return spawn(ranks.world, 1, "gloo", "cpu", jobs)


@pytest.fixture(scope="module")
def world4():
    """Every four-rank job: a (data, model) = (2, 2) mesh."""
    jobs = [
        _job("facts", "mesh_facts", world=4),
        _job("tp_fit", "train", spec=TP, params=_init(TP), arrays=TP_ARRAYS,
             shape=(2, 2), axes=("data", "model")),
        _job("tp_fit_best", "train", spec=TP, params=_init(TP),
             arrays=TP_ARRAYS, shape=(2, 2), axes=("data", "model"),
             how="fit_best", epochs=4),
        _job("tp_adam8bit", "train", spec=TP, params=_init(TP),
             arrays=TP_ARRAYS, shape=(2, 2), axes=("data", "model"),
             opt="adam8bit"),
        _job("tp_nan", "train", spec=dict(TP, nan_skip="batch"),
             params=_init(dict(TP, nan_skip="batch")),
             arrays=_arrays(widths=(3, 5), seed=5, nan_rows=(10, 12)),
             shape=(2, 2), axes=("data", "model")),
        _job("opt_place", "opt_state_placement", spec=TP, params=_init(TP),
             arrays=TP_ARRAYS),
    ]
    return spawn(ranks.world, 4, "gloo", "cpu", jobs)


def _runs(world, name):
    return [r[name] for r in world]


# ---------------------------------------------------------------------------
# Meshes and placement
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_errors(world4):
    facts = _runs(world4, "facts")
    jmesh = jmake_mesh((2, 2), ("data", "model"))
    assert facts[0]["default"] == {"data": 4}
    assert facts[0]["dp_tp"] == dict(jmesh.shape)
    assert [f["coords"] for f in facts] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert facts[0]["axis_sizes"] == (2, 2, 1)
    # devices= selects ranks, in the given order.
    assert facts[0]["sub_ranks"] == [3, 0]
    assert facts[3]["sub_coords"] == {"fold": 0}
    assert facts[1]["sub_coords"] is None
    with pytest.raises(ValueError) as jerr:
        jmake_mesh((16,))
    assert facts[0]["too_big"] == "Mesh shape (8,) needs 8 devices, have 4"
    assert str(jerr.value) == "Mesh shape (16,) needs 16 devices, have 8"


def test_make_mesh_needs_a_process_group():
    from multimodn_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="never initializes"):
        make_mesh(device="cpu")


def test_shard_params_placement_matches_jax_specs(world4):
    """Leaf for leaf, the port's rule gives JAX's PartitionSpec, and the
    ranks hold the pieces it implies."""
    jmesh = jmake_mesh((2, 2), ("data", "model"))
    jm = jbuild(TP)
    jspecs = [tuple(x.sharding.spec) for x in
              jax.tree_util.tree_leaves(jshard_params(jm.params, jmesh))]
    got = world4[0]["tp_fit"]["specs"]
    assert [tuple(s) for s in got] == jspecs
    whole = [np.asarray(x).shape for x in jax.tree_util.tree_leaves(
        jm.params)]
    for r in world4:
        for shape, spec, local in zip(whole, got,
                                      r["tp_fit"]["local_shapes"]):
            want = list(shape)
            if "model" in spec:
                want[list(spec).index("model")] //= 2
            assert tuple(want) == local
    # The records of the placement helpers.
    fake = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": 2, "model": 2}})()
    assert tuple(batch_sharding(fake).spec) == (None, "data")
    assert tuple(replicate(fake).spec) == ()
    assert leaf_spec((3, 8), fake) == P(None, "model")
    assert leaf_spec((3,), fake) == P()
    assert leaf_spec((1,), fake) == P()
    no_model = type("M", (), {"axis_names": ("data",), "shape": {"data": 4}})
    assert leaf_spec((3, 8), no_model) == P()
    assert param_specs({"a": np.zeros((4, 6))}, fake)["a"] == P(None,
                                                                 "model")


# ---------------------------------------------------------------------------
# Data parallel, world 2, against JAX make_mesh((2,), ("data",))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, engine, how", [
    ("dp_fit", "auto", "fit"), ("dp_fit_best", "auto", "fit_best"),
    ("dp_fit_sm", "shard_map", "fit")])
def test_data_parallel_matches_jax_mesh(world2, case, engine, how):
    mesh = jmake_mesh((2,), ("data",))
    want = jtrain(DP, _arrays(), mesh, engine, how=how,
                  epochs=4 if how == "fit_best" else 3)
    runs = _runs(world2, case)
    _histories_close(runs[0]["history"], want["history"])
    _close(runs[0]["state"], want["state"])
    if how == "fit_best":
        _close(runs[0]["scores"], want["scores"])
        assert runs[0]["best_epoch"] == want["best_epoch"]
        _close(runs[0]["best_params"], want["best_params"])
    for got, wt in zip(runs[0]["test"], want["test"]):
        _close(np.asarray(got[:3], float), np.asarray(wt[:3], float))
    _replicas_equal(runs)


@pytest.mark.parametrize("case, engine, how", [
    ("nan_auto", "auto", "fit"), ("nan_sm", "shard_map", "fit_best")])
def test_batch_skip_with_nans_in_one_rank_matches_jax(world2, case, engine,
                                                      how):
    """``nan_skip='batch'`` with NaNs in rank 1's rows only: every rank
    takes the whole batch's skip decision (``test_nan_mesh.py``)."""
    want = jtrain(NAN, NAN_ARRAYS, jmake_mesh((2,), ("data",)), engine,
                  how=how)
    runs = _runs(world2, case)
    _histories_close(runs[0]["history"], want["history"])
    _close(runs[0]["state"], want["state"])
    _replicas_equal(runs)


def test_batch_skip_freezes_the_degraded_encoder(world2):
    """A modality with a NaN in every batch (in both ranks' rows) skips its
    encoder on every step: its weights never move, as on JAX's mesh."""
    want = jtrain(NAN, FREEZE_ARRAYS, jmake_mesh((2,), ("data",)))
    runs = _runs(world2, "nan_freeze")
    init = _init(NAN)
    _close(runs[0]["state"]["encoders"][1], init["encoders"][1], atol=0,
           rtol=0)
    _close(runs[0]["state"], want["state"])
    _histories_close(runs[0]["history"], want["history"])


def test_presence_penalty_takes_global_counts(world2):
    """The penalty's counts are the global batch's: equal to JAX's mesh run
    (whose shard_map engine psums them) and to one device."""
    want = jtrain(PRESENCE, PRESENCE_ARRAYS, jmake_mesh((2,), ("data",)),
                  "shard_map")
    single = jtrain(PRESENCE, PRESENCE_ARRAYS, None)
    runs = _runs(world2, "presence")
    _close(runs[0]["state"], want["state"])
    _close(runs[0]["state"], single["state"])
    _histories_close(runs[0]["history"], want["history"])


def test_static_init_state_global_round_robin(world2):
    """JAX's ``test_shard_map_static_init_state_global_round_robin``: bank
    rows are served by global position across train_epoch, fit with val
    and fit_best with patience; the cycle ends where JAX's does."""
    want = jtrain(STATIC, STATIC_ARRAYS, jmake_mesh((2,), ("data",)),
                  "shard_map", how="static")
    runs = _runs(world2, "static")
    got = runs[0]
    assert got["cycle"] == want["cycle"] == (
        40 + 2 * 80 + got["epochs_ran"] * 80) % 5
    assert got["best_epoch"] == want["best_epoch"]
    _close(got["scores"], want["scores"])
    _histories_close(got["history"], want["history"])
    _close(got["state"], want["state"])
    _replicas_equal(runs)


def test_shard_opt_state_inverts_the_gather(world4):
    """``shard_opt_state`` and the gather read one placement rule
    (``opt_state_specs``): an ``Adam`` and an ``Adam8bit`` state gathered
    after an epoch on a (2, 2) mesh and cut again, with the model's specs
    and with the default, give every rank its pieces back bit for bit (and
    some pieces are narrower than their whole leaves)."""
    for r in _runs(world4, "opt_place"):
        assert r == {"adam": [True, True, True],
                     "adam8bit": [True, True, True]}


def test_one_rank_mesh_is_bit_equal_to_mesh_free(world1):
    """A one-rank mesh: scale 1.0 and collectives of one rank leave every
    value unchanged (``Adam8bit``, ``nan_skip='batch'``)."""
    one, free = world1[0]["one_rank_dp"], world1[0]["mesh_free"]
    assert np.array_equal(one["scores"], free["scores"])
    for a, b in zip(_leaves(one["state"]), _leaves(free["state"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(one["local_opt"], free["local_opt"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# DP x TP, world 4, against JAX make_mesh((2, 2), ("data", "model"))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, how", [("tp_fit", "fit"),
                                       ("tp_fit_best", "fit_best")])
def test_dp_tp_matches_jax_mesh(world4, case, how):
    mesh = jmake_mesh((2, 2), ("data", "model"))
    want = jtrain(TP, TP_ARRAYS, mesh, how=how,
                  epochs=4 if how == "fit_best" else 3)
    runs = _runs(world4, case)
    _histories_close(runs[0]["history"], want["history"])
    _close(runs[0]["state"], want["state"])
    if how == "fit_best":
        _close(runs[0]["scores"], want["scores"], atol=_rank_step(TP_ARRAYS))
        assert runs[0]["best_epoch"] == want["best_epoch"]
    _replicas_equal(runs)


def _rank_step(arrays) -> float:
    """One step of the selection score (AUROC + BAC, rank and count
    statistics of the validation outputs): an output moved by float32
    rounding (the column-parallel products sum in another order) can swap
    one (positive, negative) pair, 1 / (n_pos n_neg) of AUROC, or cross the
    decision threshold, 1 / (2 n_class) of BAC."""
    y = arrays[1][1][:, 0]
    n_pos, n_neg = int(y.sum()), int((1 - y).sum())
    return 1.0 / (n_pos * n_neg) + 0.5 / min(n_pos, n_neg)


def test_dp_tp_batch_skip_matches_jax_mesh(world4):
    spec = dict(TP, nan_skip="batch")
    arrays = _arrays(widths=(3, 5), seed=5, nan_rows=(10, 12))
    want = jtrain(spec, arrays, jmake_mesh((2, 2), ("data", "model")))
    runs = _runs(world4, "tp_nan")
    _histories_close(runs[0]["history"], want["history"])
    _close(runs[0]["state"], want["state"])
    _replicas_equal(runs)


def test_adam8bit_cross_rank_form_matches_jax_on_tp_mesh(world4):
    """``Adam8bit`` on column pieces (each row's absmax a MAX across the
    model axis) against JAX's ``Adam8bit`` on its TP mesh (tolerance in the
    module docstring)."""
    want = jtrain(TP, TP_ARRAYS, jmake_mesh((2, 2), ("data", "model")),
                  opt="adam8bit")
    runs = _runs(world4, "tp_adam8bit")
    _histories_close(runs[0]["history"], want["history"], tags=("train",))
    _close(runs[0]["state"], want["state"], atol=ADAM8_ATOL)
    _replicas_equal(runs)


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_adam8bit_cross_rank_plain_form_is_the_whole_leaf_update(world2,
                                                                 fmt):
    """On every rank, the plain cross-rank update of a column piece (a NaN
    row included) equals the whole leaf's plain update, sliced, bit for
    bit."""
    assert all(_runs(world2, f"cross_{fmt}"))


# ---------------------------------------------------------------------------
# Experiments, resume, guards, the dry run
# ---------------------------------------------------------------------------

def _jfactory(spec):
    return lambda s: jbuild(spec, seed=s)


@pytest.mark.parametrize("kind", ["kfold", "sweep"])
def test_fold_and_seed_axis_experiments_match_jax(world2, kind):
    """Folds (seeds) round-robin over a 2-rank ``fold`` axis; every rank
    gets every result in order, equal to the JAX package's fold-axis run
    (and, within the port, the same on both ranks)."""
    jmesh = jmake_mesh((2,), ("fold",), devices=jax.devices()[:2])
    if kind == "kfold":
        folds = [jloaders(_arrays(seed=s), DP["widths"], 8)
                 for s in (11, 12, 13)]
        want = jexp.kfold_fit_best(_jfactory(DP), folds, jmm.Adam(0.01),
                                   "cross_entropy", epochs=2, mesh=jmesh)
    else:
        tr, va = jloaders(_arrays(seed=14), DP["widths"], 8)
        want = jexp.sweep_fit_best(_jfactory(DP), tr, va, jmm.Adam(0.01),
                                   "cross_entropy", epochs=2, seeds=(0, 1, 2),
                                   mesh=jmesh)
    runs = _runs(world2, kind)
    assert len(runs[0]) == len(want) == 3
    for got, wt in zip(runs[0], want):
        _close(got["scores"], np.asarray(wt["scores"]))
        assert got["best_epoch"] == int(wt["best_epoch"])
        _close(got["state"], wt["model"].state_dict())
    for a, b in zip(runs[0], runs[1]):
        assert np.array_equal(a["scores"], b["scores"])
        assert a["t"] == b["t"]
        for x, y in zip(_leaves(a["state"]), _leaves(b["state"])):
            np.testing.assert_array_equal(x, y)
    assert {r["device"] for rank in runs for r in rank} == {"cpu"}


def test_resume_on_the_mesh_and_elastic_two_to_one(tmp_path):
    """A 2-rank ``fit_best_resumable`` stopped after 2 of 4 epochs and
    resumed on 2 ranks equals the uninterrupted run bit for bit, on a DP x
    TP mesh too; resumed on one rank (elastic) it agrees within the
    tolerance."""
    runs = {}
    for label, shape, axes in (("dp", (2,), ("data",)),
                               ("tp", (1, 2), ("data", "model"))):
        full = spawn(ranks.world, 2, "gloo", "cpu", [_job(
            "r", "resumable", spec=TP, arrays=_arrays(widths=(3, 5),
                                                      seed=21),
            shape=shape, axes=axes, ckpt=str(tmp_path / f"full_{label}"))])
        ck = str(tmp_path / f"cut_{label}")
        spawn(ranks.world, 2, "gloo", "cpu", [_job(
            "r", "resumable", spec=TP, arrays=_arrays(widths=(3, 5),
                                                      seed=21),
            shape=shape, axes=axes, ckpt=ck, kill_after=2)])
        shutil.copytree(ck, str(tmp_path / f"elastic_{label}"))
        resumed = spawn(ranks.world, 2, "gloo", "cpu", [_job(
            "r", "resumable", spec=TP, arrays=_arrays(widths=(3, 5),
                                                      seed=21),
            shape=shape, axes=axes, ckpt=ck)])
        runs[label] = (full, resumed)
        f, r = full[0]["r"], resumed[0]["r"]
        assert np.array_equal(f["scores"], r["scores"])
        for a, b in zip(_leaves(f["state"]), _leaves(r["state"])):
            np.testing.assert_array_equal(a, b)
        assert r["files"] == ["resume_best_latest.pkl"]
    elastic = spawn(ranks.world, 1, "gloo", "cpu", [_job(
        "r", "resumable", spec=TP, arrays=_arrays(widths=(3, 5), seed=21),
        shape=None, axes=None, ckpt=str(tmp_path / "elastic_tp"))])[0]["r"]
    full = runs["tp"][0][0]["r"]
    _close(elastic["scores"], full["scores"])
    _close(elastic["state"], full["state"])
    assert os.path.exists(tmp_path / "elastic_dp" / "resume_best_latest.pkl")


def _jax_error(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    raise AssertionError("the JAX package raised nothing")


def test_engine_and_mesh_guards_match_jax(world2):
    """Every ``dp_engine`` / mesh guard raises the JAX package's exception
    with its message."""
    jdata = jmake_mesh((2,), ("data",))
    jtp = jmake_mesh((1, 2), ("data", "model"))
    fake_tp = type("M", (), {"axis_names": ("data", "model"),
                             "shape": {"data": 1, "model": 2}})()
    for kw, jkw in (({"dp_engine": "bogus"}, {"dp_engine": "bogus"}),
                    ({"dp_engine": "shard_map"}, {"dp_engine": "shard_map"}),
                    ({"dp_engine": "shard_map", "mesh": fake_tp},
                     {"dp_engine": "shard_map", "mesh": jtp})):
        with pytest.raises(ValueError) as got:
            tmm.MultiModN(3, [], [], 1.0, 0.0, device="cpu", **kw)
        want = _jax_error(lambda: jmm.MultiModN(3, [], [], 1.0, 0.0, **jkw))
        assert ("ValueError", str(got.value)) == want
    g = world2[0]["guards"]
    jmodel = jbuild(DP, jdata, "shard_map")
    tr, _ = jloaders(_arrays(), DP["widths"], 7)
    assert g["batch_size"] == _jax_error(
        lambda: jmodel.fit(tr, jmm.Adam(0.01), epochs=1))
    with open(os.path.join(os.path.dirname(jmm.__file__), "model.py")) as f:
        source = " ".join(f.read().split())
    kind, msg = g["per_batch"]
    assert kind == "ValueError"
    assert " ".join(msg.split()) in source.replace('" "', "")
    jfold = jmake_mesh((2,), ("fold",), devices=jax.devices()[:2])
    tr8, va8 = jloaders(_arrays(), DP["widths"], 8)
    assert g["model_mesh"] == _jax_error(lambda: jexp.kfold_fit_best(
        lambda s: jbuild(DP, jdata, seed=s), [(tr8, va8)], jmm.Adam(0.01),
        epochs=1, mesh=jfold))
    assert g["shard_map_fold"][0] == "ValueError"
    assert "mutually exclusive" in g["shard_map_fold"][1]
    assert g["no_axis"] == _jax_error(lambda: jexp.sweep_fit_best(
        _jfactory(DP), tr8, va8, jmm.Adam(0.01), epochs=1, mesh=jdata))


def test_dryrun_multichip_four_ranks():
    """``dryrun_multichip(4)``: a (2, 2) DP x TP mesh, fit_best through the
    public API, replicas bit-equal (``__graft_entry__.dryrun_multichip``'s
    counterpart)."""
    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["best_epoch"] >= 0 and np.isfinite(out["best_score"])
    assert len(out["scores"]) == 3


def test_spawn_and_dryrun_default_to_the_card():
    """Left without a device, ``spawn`` and ``dryrun_multichip`` put the
    ranks on the card; without a GPU they raise before starting a rank
    rather than run on the CPU unasked."""
    if torch.cuda.is_available():
        assert default_device(1) == "cuda"
        return
    for call in (lambda: spawn(ranks.world, 2), lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
