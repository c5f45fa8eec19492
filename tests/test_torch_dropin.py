"""The port's drop-in torch surface against the JAX package's on the CPU:
the adapters of ``multimodn_tpu_torch.interop``, torch optimizers, losses and
``DataLoader``s at the model's entry points, ``parameters()``, torch
activations by name, and the reference import tree
(``multimodn_tpu_torch.compat``).

Torch objects go into a JAX model and a port model with the same weights
(``load_state_dict`` of the JAX model's) on the same rows. Tolerance: the
JAX package's own drop-in test's, rtol 1e-5 and atol 1e-6 on every history
array: XLA's and PyTorch's CPU products sum in different orders (~1e-7
relative), which stays at float32 rounding over 3 epochs. Runs of the port
against the port (torch objects against its own optimizer and loader) must be
bit-equal.
"""
import gc
import os
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.data as tud

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.data import PartitionDataset as JDataset
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import checkpoint, compat, experiments, interop
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core import nn as tnn
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset
from tests.ref_pipeline_harness import REF_PATH

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("loss", "accuracy", "sensitivity", "specificity",
          "balanced_accuracy")
WIDTHS, S, HIDDEN = (5, 9, 4), 6, (8,)
EPOCHS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICKSTART = os.path.join(ROOT, "multimodn_tpu_torch", "compat", "examples",
                          "titanic_mlp_pipeline.py")
REF_TITANIC = os.path.join(REF_PATH, "pipelines", "titanic")


def _data(n=72, seed=0, missing=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(WIDTHS))).astype(np.float32)
    y = np.stack([X[:, :3].sum(1) > 0, X[:, -3:].sum(1) > 0], 1) \
        .astype(np.int64)
    off = np.cumsum((0,) + WIDTHS[:-1])
    for o, w in zip(off, WIDTHS):
        X[rng.random(n) < missing, o:o + w] = np.nan
    return X, y


def _models(seed=3, **kw):
    jm = jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, HIDDEN, dropout=0.0) for w in WIDTHS],
        [jdec.MLPDecoder(S, HIDDEN, 2) for _ in range(2)], 1.0, 0.5,
        seed=seed, chain_mode="unrolled", **kw)
    tm = _port_model(seed, **kw)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _port_model(seed=3, **kw):
    return tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, HIDDEN, dropout=0.0) for w in WIDTHS],
        [tdec.MLPDecoder(S, HIDDEN, 2) for _ in range(2)], 1.0, 0.5,
        seed=seed, device="cpu", **kw)


def _assert_histories(got, want, rtol=RTOL, atol=ATOL):
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert set(g) == set(w), field
        for tag in w:
            assert len(g[tag]) == len(w[tag]) > 0
            np.testing.assert_allclose(
                np.asarray(g[tag], np.float64), np.asarray(w[tag], np.float64),
                rtol=rtol, atol=atol, err_msg=f"{field}[{tag}]")
    np.testing.assert_allclose(
        np.asarray(got.state_change_loss, np.float64),
        np.asarray(want.state_change_loss, np.float64), rtol=rtol, atol=atol)


def _params():
    return [torch.nn.Parameter(torch.zeros(2))]


# ---------------------------------------------------------------------------
# The adapters
# ---------------------------------------------------------------------------
def test_caches_are_stable_and_weak():
    """One torch optimizer or DataLoader maps to one port object on every
    call (one optimizer state across a loop of train_epoch calls), and a dead
    torch object leaves the caches."""
    ds = TDataset(np.zeros((8, 4), np.float32), np.zeros((8, 1), np.int64))
    n_opt, n_ldr = len(interop._OPT_CACHE), len(interop._LOADER_CACHE)
    opt = torch.optim.Adam(_params(), 1e-3)
    ldr = tud.DataLoader(ds, batch_size=4)
    a1, a2 = interop.adapt_optimizer(opt), interop.adapt_optimizer(opt)
    l1, l2 = interop.adapt_loader(ldr), interop.adapt_loader(ldr)
    assert a1 is a2 and isinstance(a1, tmm.Adam)
    assert l1 is l2 and isinstance(l1, TLoader) and l1.batch_size == 4
    assert len(interop._OPT_CACHE) == n_opt + 1
    assert len(interop._LOADER_CACHE) == n_ldr + 1
    del opt, ldr, a1, a2, l1, l2
    gc.collect()
    assert len(interop._OPT_CACHE) == n_opt
    assert len(interop._LOADER_CACHE) == n_ldr


def test_a_dataset_is_not_a_loader():
    """Only a DataLoader is a loader: a Dataset, Subset or Sampler of
    torch.utils.data passes the adapters untouched."""
    ds = tud.TensorDataset(torch.zeros(4, 3), torch.zeros(4, 1))
    for obj in (ds, tud.Subset(ds, [0, 1]), tud.SequentialSampler(ds)):
        assert not interop.is_torch_dataloader(obj)
        assert interop.adapt_loader(obj) is obj
    assert interop.is_torch_dataloader(tud.DataLoader(ds, batch_size=2))


def test_subset_random_sampler_serves_exactly_its_rows():
    X = np.arange(40, dtype=np.float32).reshape(10, 4)
    ds = TDataset(X, np.zeros((10, 1), np.int64))
    idx = [1, 3, 5]
    ours = interop.adapt_loader(tud.DataLoader(
        ds, batch_size=2, sampler=tud.SubsetRandomSampler(idx)))
    assert ours.n_samples == 3 and ours.shuffle and ours.batch_size == 2
    served = np.sort(ours.host_stacks()[0][0].reshape(-1, 4)[:3, 0])
    np.testing.assert_array_equal(served, X[idx, 0])


def test_sampler_decides_shuffle_and_batch_geometry():
    """Sequential and random samplers over every row; the shuffled order is
    the JAX package's ArrayLoader(shuffle=True, seed=0); batch_size None
    (unbatched) is one batch of everything, as in the JAX package."""
    X, y = _data(20)
    ds = TDataset(X, y, list(WIDTHS))
    seq = interop.adapt_loader(tud.DataLoader(ds, batch_size=8))
    rnd = interop.adapt_loader(tud.DataLoader(ds, batch_size=8,
                                              shuffle=True))
    whole = interop.adapt_loader(tud.DataLoader(ds, batch_size=None))
    assert not seq.shuffle and rnd.shuffle
    assert (seq.n_batches, rnd.n_batches, whole.n_batches) == (3, 3, 1)
    want = TLoader(ds, 8, shuffle=True, seed=0)
    for _ in range(2):
        rnd.reshuffle()
        want.reshuffle()
        np.testing.assert_array_equal(rnd.host_stacks()[1],
                                      want.host_stacks()[1])


@pytest.mark.parametrize("kind", ["drop_last", "batch_sampler",
                                  "replacement", "num_samples", "weighted"])
def test_unmappable_loaders_are_rejected(kind):
    ds = TDataset(np.zeros((10, 4), np.float32), np.zeros((10, 1), np.int64))
    make = {
        "drop_last": lambda: tud.DataLoader(ds, batch_size=4,
                                            drop_last=True),
        "batch_sampler": lambda: tud.DataLoader(ds, batch_sampler=[[0, 1],
                                                                   [2]]),
        "replacement": lambda: tud.DataLoader(
            ds, batch_size=2, sampler=tud.RandomSampler(ds,
                                                        replacement=True)),
        "num_samples": lambda: tud.DataLoader(
            ds, batch_size=2, sampler=tud.RandomSampler(ds, num_samples=4)),
        "weighted": lambda: tud.DataLoader(
            ds, batch_size=2,
            sampler=tud.WeightedRandomSampler([1.0] * 10, num_samples=10)),
    }[kind]
    match = {"drop_last": "drop_last", "batch_sampler": "batch_sampler",
             "replacement": "replacement", "num_samples": "num_samples",
             "weighted": "sampler"}[kind]
    with pytest.raises(NotImplementedError, match=match):
        interop.adapt_loader(make())


@pytest.mark.parametrize("make,want", [
    (lambda p: torch.optim.Adam(p, lr=0.02, betas=(0.8, 0.99), eps=1e-6),
     (tmm.Adam, {"lr": 0.02, "b1": 0.8, "b2": 0.99, "eps": 1e-6})),
    (lambda p: torch.optim.AdamW(p, lr=0.02, weight_decay=0.05),
     (tmm.AdamW, {"lr": 0.02, "weight_decay": 0.05})),
    (lambda p: torch.optim.Adam(p, lr=0.02, weight_decay=0.05,
                                decoupled_weight_decay=True),
     (tmm.AdamW, {"lr": 0.02, "weight_decay": 0.05})),
    (lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
     (tmm.SGD, {"lr": 0.1, "momentum": 0.9})),
], ids=["adam", "adamw", "adam_decoupled", "sgd"])
def test_optimizers_map_with_their_hyperparameters(make, want):
    cls, fields = want
    ours = interop.adapt_optimizer(make(_params()))
    assert type(ours) is cls
    for k, v in fields.items():
        assert getattr(ours, k) == v, k


@pytest.mark.parametrize("make,match", [
    (lambda p: torch.optim.Adam(p, 0.1, amsgrad=True), "amsgrad"),
    (lambda p: torch.optim.Adam(p, 0.1, weight_decay=0.1), "weight_decay"),
    (lambda p: torch.optim.Adam(p, 0.1, foreach=True), "foreach"),
    (lambda p: torch.optim.Adam(p, 0.1, differentiable=True),
     "differentiable"),
    (lambda p: torch.optim.AdamW(p, 0.1, amsgrad=True), "amsgrad"),
    (lambda p: torch.optim.SGD(p, 0.1, momentum=0.9, nesterov=True),
     "nesterov"),
    (lambda p: torch.optim.SGD(p, 0.1, momentum=0.9, dampening=0.1),
     "dampening"),
    (lambda p: torch.optim.SGD(p, 0.1, weight_decay=0.1), "weight_decay"),
    (lambda p: torch.optim.RMSprop(p, 0.1), "RMSprop"),
], ids=["adam_amsgrad", "adam_weight_decay", "adam_foreach",
        "adam_differentiable", "adamw_amsgrad", "sgd_nesterov",
        "sgd_dampening", "sgd_weight_decay", "rmsprop"])
def test_unmappable_optimizer_knobs_are_rejected(make, match):
    with pytest.raises(NotImplementedError, match=match):
        interop.adapt_optimizer(make(_params()))


@pytest.mark.parametrize("cls", [torch.optim.Adam, torch.optim.AdamW,
                                 torch.optim.SGD])
def test_maximize_is_rejected(cls):
    """maximize=True is gradient ascent: mapping it onto a minimizing
    optimizer would train the other way."""
    with pytest.raises(NotImplementedError, match="maximize"):
        interop.adapt_optimizer(cls(_params(), lr=0.1, maximize=True))


def test_per_group_hyperparameters_are_rejected():
    p = [torch.nn.Parameter(torch.zeros(2)),
         torch.nn.Parameter(torch.zeros(3))]
    multi = torch.optim.Adam([{"params": p[:1], "lr": 0.1},
                              {"params": p[1:], "lr": 0.2}])
    with pytest.raises(NotImplementedError, match="param-group"):
        interop.adapt_optimizer(multi)


@pytest.mark.parametrize("criterion,want", [
    (nn.CrossEntropyLoss(), "cross_entropy"), (nn.BCELoss(), "bce"),
    (nn.MSELoss(), "mse"), ("cross_entropy", None)])
def test_criteria_map_to_the_ports_losses(criterion, want):
    assert interop.adapt_criterion(criterion) == want


@pytest.mark.parametrize("criterion", [
    nn.CrossEntropyLoss(reduction="sum"), nn.CrossEntropyLoss(
        label_smoothing=0.1), nn.BCELoss(weight=torch.ones(2)),
    nn.L1Loss()], ids=["reduction", "label_smoothing", "bce_weight", "l1"])
def test_unmappable_criteria_are_rejected(criterion):
    with pytest.raises(NotImplementedError):
        interop.adapt_criterion(criterion)


def test_scheduler_lr_is_honoured_on_the_same_optimizer():
    """A StepLR step is read from param_groups into the SAME port optimizer,
    so the model's Adam state carries across it: the step count goes 4 then
    8, as in the JAX package's test (tests/test_dropin.py:284-307)."""
    rng = np.random.default_rng(0)
    ds = TDataset(rng.normal(size=(32, 4)).astype(np.float32),
                  rng.integers(0, 2, (32, 1)))
    model = tmm.MultiModN(2, [tenc.MLPEncoder(2, 4, (4,))],
                          [tdec.LogisticDecoder(2)], 1.0, 0.0, device="cpu")
    opt = torch.optim.Adam(list(model.parameters()), lr=0.05)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.1)
    ours = interop.adapt_optimizer(opt)
    model.train_epoch(TLoader(ds, 8), opt, nn.CrossEntropyLoss())
    assert float(model.opt_state["t"]) == 4.0 and ours.lr == 0.05
    sched.step()
    model.train_epoch(TLoader(ds, 8), opt, nn.CrossEntropyLoss())
    assert interop.adapt_optimizer(opt) is ours
    assert model._opt is ours and abs(ours.lr - 0.005) < 1e-12
    assert float(model.opt_state["t"]) == 8.0


# ---------------------------------------------------------------------------
# Torch objects at the entry points: the port against the JAX package
# ---------------------------------------------------------------------------
CASES = {
    "adam": (lambda p: torch.optim.Adam(p, lr=0.01), False, None),
    "adamw": (lambda p: torch.optim.AdamW(p, lr=0.01, weight_decay=0.05),
              False, None),
    "sgd_momentum": (lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9),
                     False, None),
    "adam_steplr": (lambda p: torch.optim.Adam(p, lr=0.02), False,
                    lambda o: torch.optim.lr_scheduler.StepLR(o, 1, 0.5)),
    "adam_shuffled": (lambda p: torch.optim.Adam(p, lr=0.01), True, None),
}


def _torch_run(model, history, make_opt, shuffle, make_sched, train_set,
               val_set):
    """The reference's loop: torch optimizer over model.parameters(),
    nn.CrossEntropyLoss, DataLoaders, train_epoch + test(tag='val') per
    epoch (and a scheduler step after each epoch)."""
    opt = make_opt(list(model.parameters()))
    sched = make_sched(opt) if make_sched else None
    criterion = nn.CrossEntropyLoss()
    train = tud.DataLoader(train_set, 16, shuffle=shuffle)
    val = tud.DataLoader(val_set, 16)
    for _ in range(EPOCHS):
        model.train_epoch(train, opt, criterion, history)
        model.test(val, criterion, history, tag="val")
        if sched is not None:
            sched.step()
    return history


@pytest.mark.parametrize("case", list(CASES))
def test_torch_objects_match_jax(case):
    make_opt, shuffle, make_sched = CASES[case]
    X, y = _data()
    jm, tm = _models()
    jhist = _torch_run(jm, jmm.MultiModNHistory(["a", "b"]), make_opt, shuffle, make_sched,
                       JDataset(X[:56], y[:56], list(WIDTHS)),
                       JDataset(X[56:], y[56:], list(WIDTHS)))
    thist = _torch_run(tm, tmm.MultiModNHistory(["a", "b"]), make_opt, shuffle, make_sched,
                       TDataset(X[:56], y[:56], list(WIDTHS)),
                       TDataset(X[56:], y[56:], list(WIDTHS)))
    _assert_histories(thist, jhist)
    for a, b in zip(tree_leaves(tm.state_dict()),
                    tree_leaves(jm.state_dict())):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-5)


def test_fit_best_with_torch_objects_equals_native_objects():
    """fit_best with torch Adam, DataLoader(shuffle=True) and
    nn.CrossEntropyLoss equals fit_best with the port's Adam, ArrayLoader(
    shuffle=True, seed=0) and 'cross_entropy', bit for bit."""
    X, y = _data()
    train, val = (TDataset(X[:56], y[:56], list(WIDTHS)),
                  TDataset(X[56:], y[56:], list(WIDTHS)))
    runs = []
    for torch_objects in (True, False):
        model = _port_model()
        history = tmm.MultiModNHistory(["a", "b"])
        if torch_objects:
            args = (tud.DataLoader(train, 16, shuffle=True),
                    torch.optim.Adam(list(model.parameters()), 0.01),
                    nn.CrossEntropyLoss())
            val_loader = tud.DataLoader(val, 16)
        else:
            args = (TLoader(train, 16, shuffle=True, seed=0), tmm.Adam(0.01),
                    "cross_entropy")
            val_loader = TLoader(val, 16)
        info = model.fit_best(*args, epochs=EPOCHS, val_loader=val_loader,
                              history=history)
        runs.append((model, history, info))
    (m1, h1, i1), (m2, h2, i2) = runs
    for a, b in zip(tree_leaves(m1.state_dict()), tree_leaves(m2.state_dict())):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(i1["scores"], i2["scores"])
    assert i1["best_epoch"] == i2["best_epoch"]
    _assert_histories(h1, h2, rtol=0, atol=0)


def test_resumable_and_kfold_fits_take_torch_objects(tmp_path):
    """fit_resumable (killed after its first chunk: the optimizer state
    resumes, t 4 -> 8) and kfold_fit_best with torch objects equal the same
    calls with the port's own, bit for bit. The JAX package's fit_resumable
    binds the torch optimizer to the restored state and so resets Adam on
    resume; the port maps it first."""
    X, y = _data(48)
    ds = TDataset(X, y, list(WIDTHS))
    states = []
    for torch_objects in (True, False):
        ckpt = str(tmp_path / f"ck{torch_objects}")
        for epochs in (1, 2):             # a fresh process resumes at 1
            model = _port_model()
            if torch_objects:
                opt, loader = (torch.optim.Adam(list(model.parameters()),
                                                0.01),
                               tud.DataLoader(ds, 16, shuffle=True))
            else:
                opt, loader = tmm.Adam(0.01), TLoader(ds, 16, shuffle=True,
                                                      seed=0)
            checkpoint.fit_resumable(model, loader, opt, epochs=epochs,
                                     checkpoint_dir=ckpt, chunk_epochs=1)
        assert float(model.opt_state["t"]) == 6.0
        states.append(model.state_dict())
    for a, b in zip(*(tree_leaves(s) for s in states)):
        np.testing.assert_array_equal(a, b)

    folds = [(TDataset(X[:32], y[:32], list(WIDTHS)),
              TDataset(X[32:], y[32:], list(WIDTHS))),
             (TDataset(X[16:], y[16:], list(WIDTHS)),
              TDataset(X[:16], y[:16], list(WIDTHS)))]
    got = experiments.kfold_fit_best(
        lambda s: _port_model(s),
        [(tud.DataLoader(t, 16), tud.DataLoader(v, 16)) for t, v in folds],
        torch.optim.Adam(_params(), 0.01), nn.CrossEntropyLoss(), epochs=2)
    want = experiments.kfold_fit_best(
        lambda s: _port_model(s),
        [(TLoader(t, 16), TLoader(v, 16)) for t, v in folds],
        tmm.Adam(0.01), "cross_entropy", epochs=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["scores"], w["scores"])
        for a, b in zip(tree_leaves(g["model"].state_dict()),
                        tree_leaves(w["model"].state_dict())):
            np.testing.assert_array_equal(a, b)


def test_inference_entry_points_take_a_dataloader():
    """predict, predict_proba and get_states on a DataLoader equal the same
    calls on an ArrayLoader (a DataLoader used to reach ``loader.stacks``
    unadapted)."""
    X, y = _data(40)
    ds = TDataset(X, y, list(WIDTHS))
    model = _port_model()
    torch_loader, ours = tud.DataLoader(ds, 16), TLoader(ds, 16)
    np.testing.assert_array_equal(model.predict(torch_loader),
                                  model.predict(ours))
    for a, b in zip(model.predict_proba(torch_loader),
                    model.predict_proba(ours)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(model.get_states(torch_loader)),
                                  np.stack(model.get_states(ours)))


@pytest.mark.parametrize("chain_mode", ["unrolled", "scan"])
def test_parameters_match_jax(chain_mode):
    """parameters(): the JAX package's count, order and values (stacked
    encoders on a scan-planned model), detached, on the model's device; a
    torch optimizer builds from them."""
    widths = WIDTHS if chain_mode == "unrolled" else (5, 5, 5)
    jm = jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, HIDDEN) for w in widths],
        [jdec.MLPDecoder(S, HIDDEN, 2)], 1.0, 0.0, chain_mode=chain_mode)
    tm = tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, HIDDEN) for w in widths],
        [tdec.MLPDecoder(S, HIDDEN, 2)], 1.0, 0.0, chain_mode=chain_mode,
        device="cpu")
    tm.load_state_dict(jm.state_dict())
    want, got = list(jm.parameters()), list(tm.parameters())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.nn.Parameter) and g.device == tm.device
        np.testing.assert_array_equal(g.detach().numpy(), w.detach().numpy())
    got[0].data.add_(1.0)              # a snapshot: the model is untouched
    assert not any(t is g for t in tree_leaves(tm.params) for g in got)
    torch.optim.Adam(list(tm.parameters()), 0.01)


# ---------------------------------------------------------------------------
# Torch activations by name
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act,name", [(F.relu, "relu"),
                                      (torch.sigmoid, "sigmoid"),
                                      (torch.tanh, "tanh"), (F.gelu, "gelu"),
                                      (nn.ReLU(), "relu")],
                         ids=["F.relu", "torch.sigmoid", "torch.tanh",
                              "F.gelu", "nn.ReLU"])
def test_torch_activations_map_by_name(act, name):
    assert tnn.resolve_activation(act) is tnn.ACTIVATIONS[name]


def test_f_gelu_maps_to_the_tanh_form():
    """F.gelu maps by name to the registry's tanh-form gelu, as in the JAX
    package, not to torch's erf default."""
    x = torch.linspace(-4, 4, 101)
    got = tnn.resolve_activation(F.gelu)(x)
    assert torch.equal(got, F.gelu(x, approximate="tanh"))
    assert (got - F.gelu(x)).abs().max() > 1e-4
    with pytest.raises(ValueError, match="silu"):
        tnn.resolve_activation(F.silu)


def test_relu_built_model_exports_loads_and_serves(tmp_path):
    """A model built the reference's way, MLPEncoder(..., F.relu) and an
    MLPDecoder with torch.tanh, exports, loads in the port and in the JAX
    package, serves through fused_forward (its plain version here) equal to
    the chain path, and round-trips through pickle."""
    enc = [tenc.MLPEncoder(S, w, (5, 5), F.relu) for w in WIDTHS]
    model = tmm.MultiModN(S, enc, [tdec.MLPDecoder(S, (5,), 2, "softmax",
                                                   torch.tanh)],
                          0.7, 0.3, device="cpu")
    tmm.export_model(model, str(tmp_path))
    loaded = tmm.load_model(str(tmp_path), device="cpu")
    jloaded = jmm.load_model(str(tmp_path))
    X, _ = _data(16, missing=0.0)
    xs = np.split(X, np.cumsum(WIDTHS)[:-1], axis=1)
    want = model.predict_proba(xs)
    states, outs = loaded.fused_forward(xs)
    np.testing.assert_allclose(outs[0].numpy(), want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jloaded.predict_proba(xs)[0]),
                               want[0], rtol=RTOL, atol=ATOL)
    again = pickle.loads(pickle.dumps(model))
    np.testing.assert_array_equal(again.predict_proba(xs)[0], want[0])
    assert again.encoders[0].activation is tnn.relu


# ---------------------------------------------------------------------------
# The reference import tree
# ---------------------------------------------------------------------------
def _owned():
    return {k: v for k, v in sys.modules.items()
            if k.partition(".")[0] in compat.NAMES}


def test_reference_paths_resolve_to_the_port():
    from multimodn_tpu_torch.core import history, metrics, state
    from multimodn_tpu_torch.data import dataset, mimic, titanic
    from multimodn_tpu_torch.decoders import base as dbase
    from multimodn_tpu_torch.encoders import base as ebase
    from multimodn_tpu_torch.pipelines import utils
    want = {
        "multimodn": {"MultiModNHistory": history.MultiModNHistory,
                      "TrainableInitState": state.TrainableInitState},
        "multimodn.multimodn": {
            "compute_metrics": metrics.compute_metrics,
            "get_performance_metrics": metrics.get_performance_metrics},
        "multimodn.state": {"StaticInitState": state.StaticInitState},
        "multimodn.history": {"display_title": history.display_title},
        "multimodn.encoders": {"MLPEncoder": tenc.MLPEncoder},
        "multimodn.encoders.mlp_encoder": {
            "MIMIC_MLPEncoder": tenc.MIMIC_MLPEncoder},
        "multimodn.encoders.slp_encoders": {"SLPEncoder": tenc.SLPEncoder},
        "multimodn.encoders.lstm_encoder": {
            "LSTMFeatureEncoder": tenc.LSTMFeatureEncoder},
        "multimodn.encoders.rnn_encoder": {"RNNEncoder": tenc.RNNEncoder},
        "multimodn.encoders.multimod_encoder": {
            "MultiModEncoder": ebase.MultiModEncoder},
        "multimodn.decoders": {"LogisticDecoder": tdec.LogisticDecoder},
        "multimodn.decoders.decoders": {"ClassDecoder": tdec.ClassDecoder},
        "multimodn.decoders.multimod_decoder": {
            "MultiModDecoder": dbase.MultiModDecoder},
        "datasets": {"PartitionDataset": dataset.PartitionDataset},
        "datasets.multimod_dataset": {
            "FeatureWiseDataset": dataset.FeatureWiseDataset},
        "datasets.titanic": {"TitanicDataset": titanic.TitanicDataset},
        "datasets.titanic.titanic_dataset": {
            "titanic_preprocessing": titanic.titanic_preprocessing},
        "datasets.mimic": {"MIMICDataset": mimic.MIMICDataset},
        "datasets.mimic.mimic_dataset": {"source_dict": mimic.source_dict},
        "pipelines.utils": {"parse_args": utils.parse_args,
                            "get_logger": utils.get_logger},
    }
    import importlib
    with compat.reference_paths(device="cpu"):
        for path, names in want.items():
            module = importlib.import_module(path)
            assert module.__name__ == f"multimodn_tpu_torch.compat.{path}"
            for name, obj in names.items():
                assert getattr(module, name) is obj, (path, name)
        from multimodn.multimodn import MultiModN
        assert issubclass(MultiModN, tmm.MultiModN)
        assert MultiModN(1, [tenc.MLPEncoder(1, 2)], [tdec.LogisticDecoder(
            1)], 1.0, 0.0).device == torch.device("cpu")
        from datasets.mimic import source_size
        assert source_size[1] == 1024
        from multimodn.encoders.resnet_encoder import ResNet
        assert ResNet is tenc.ResNet
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module("pipelines.titanic")


def test_reference_paths_restore_the_jax_shims():
    """The JAX shims and the port's tree share their names in one process:
    leaving the context restores sys.modules exactly, and the repo root's
    ``multimodn`` is the JAX shim again, whether it was imported before the
    context or only after it."""
    import multimodn as jshim
    before = _owned()
    with compat.reference_paths(device="cpu"):
        import multimodn
        from multimodn.multimodn import MultiModN
        assert multimodn is not jshim and issubclass(MultiModN,
                                                     tmm.MultiModN)
    after = _owned()
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)
    from multimodn.multimodn import MultiModN as again
    assert again is jmm.MultiModN

    saved = {k: sys.modules.pop(k) for k in _owned()}
    try:
        with compat.reference_paths(device="cpu"):
            from multimodn.multimodn import MultiModN  # noqa: F811
        assert not _owned()
        from multimodn.multimodn import MultiModN as fresh
        assert fresh is jmm.MultiModN
    finally:
        for k in list(_owned()):
            del sys.modules[k]
        sys.modules.update(saved)


def _exec_body(src_path, workdir, argv, context, transplant=None):
    """Exec a pipeline body (not as __main__) from a copy in ``workdir``
    inside ``context``, wrap the MultiModN and MultiModNHistory of the
    script's namespace to capture them (the JAX drop-in test's harness,
    tests/test_dropin.py:27-66), and call its main(). ``transplant(model)``
    runs on each model right after it is built."""
    path = os.path.join(workdir, os.path.basename(src_path))
    shutil.copy(src_path, path)
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    captured = {"models": [], "histories": []}
    mod = types.ModuleType("_dropin_body")
    mod.__file__ = path
    argv_saved, path_saved = sys.argv, list(sys.path)
    sys.argv = [path] + list(argv)
    try:
        with context:
            exec(code, mod.__dict__)
            model_cls, hist_cls = mod.MultiModN, mod.MultiModNHistory

            def model(*a, **k):
                m = model_cls(*a, **k)
                if transplant is not None:
                    transplant(m)
                captured["models"].append(m)
                return m

            def history(*a, **k):
                captured["histories"].append(hist_cls(*a, **k))
                return captured["histories"][-1]

            mod.MultiModN, mod.MultiModNHistory = model, history
            mod.main()
    finally:
        sys.argv = argv_saved
        sys.path[:] = path_saved
    return captured


@pytest.fixture(scope="module")
def jax_quickstart(tmp_path_factory):
    """The quick-start body under the repo root's JAX shims, every save flag
    on, run once per module: its initial weights, history and directory."""
    import contextlib
    work = str(tmp_path_factory.mktemp("jax_quickstart"))
    initial = []
    cap = _exec_body(QUICKSTART, work, ["-e", str(EPOCHS)],
                     contextlib.nullcontext(),
                     lambda m: initial.append(m.state_dict()))
    assert isinstance(cap["models"][0], jmm.MultiModN)
    return initial[0], cap["histories"][0], work


def _artifacts(work):
    return [os.path.join(work, *p) for p in (
        ("models", "titanic_mlp_model.pkl"),
        ("models", "titanic_mlp_history.pkl"),
        ("plots", "titanic_mlp.png"), ("results", "titanic_mlp.csv"))]


def test_quickstart_body_matches_jax(jax_quickstart, tmp_path):
    """The reference-idiom quick-start runs under the port's tree on the CPU
    (torch Adam, nn.CrossEntropyLoss, DataLoaders, an F.relu encoder) from
    the JAX run's initial weights: its history equals the JAX run's, and
    both write model and history pickles, the plot and the results CSV."""
    initial, jhist, jwork = jax_quickstart
    cap = _exec_body(QUICKSTART, str(tmp_path), ["-e", str(EPOCHS)],
                     compat.reference_paths(device="cpu"),
                     lambda m: m.load_state_dict(initial))
    model, thist = cap["models"][0], cap["histories"][0]
    assert isinstance(model, tmm.MultiModN) and model.device.type == "cpu"
    assert model.encoders[0].activation is tnn.relu
    _assert_histories(thist, jhist)
    for path in _artifacts(str(tmp_path)) + _artifacts(jwork):
        assert os.path.getsize(path) > 0, path
    with open(_artifacts(str(tmp_path))[0], "rb") as f:
        loaded = pickle.load(f)
    assert loaded.predict([np.zeros((4, 6), np.float32)]).shape == (2, 1, 4)


def test_run_script_and_cli_run_the_body(tmp_path):
    """run_script and ``python -m multimodn_tpu_torch.compat`` run the
    unmodified body as __main__ against the port, leaving sys.argv and the
    reference names as they were."""
    path = str(tmp_path / "titanic_mlp_pipeline.py")
    shutil.copy(QUICKSTART, path)
    argv, owned = list(sys.argv), _owned()
    flags = ["-e", "1", "-m", "true", "-y", "false", "-p", "false", "-r"]
    compat.run_script(path, flags + ["false"], device="cpu")
    with open(tmp_path / "models" / "titanic_mlp_model.pkl", "rb") as f:
        assert isinstance(pickle.load(f), tmm.MultiModN)
    compat.main([path, "--device", "cpu", "--"] + flags + ["true"])
    assert (tmp_path / "results" / "titanic_mlp.csv").exists()
    assert sys.argv == argv and _owned().keys() == owned.keys()


@pytest.mark.parametrize("name", [
    "titanic_mlp_pipeline", "titanic_partitioned_pipeline",
    "titanic_featurewise_pipeline", "titanic_missingness_pipeline",
    "titanic_lstm_pipeline", "titanic_rnn_pipeline"])
def test_reference_scripts_run_unmodified(name, tmp_path):
    """The reference's six Titanic scripts, unmodified, through run_script
    on the CPU, where the reference checkout exists."""
    src = os.path.join(REF_TITANIC, name + ".py")
    if not os.path.exists(src):
        pytest.skip(f"needs the reference checkout ({REF_TITANIC})")
    path = str(tmp_path / (name + ".py"))
    shutil.copy(src, path)
    epochs = "1" if name == "titanic_missingness_pipeline" else "2"
    compat.run_script(path, ["-e", epochs, "-m", "true", "-y", "true", "-p",
                             "false", "-r", "false"], device="cpu")
    with open(tmp_path / "models" / f"{name[:-9]}_history.pkl", "rb") as f:
        history = pickle.load(f)
    assert len(history.loss["train"]) == int(epochs)
    assert np.isfinite(np.asarray(history.loss["train"])).all()
