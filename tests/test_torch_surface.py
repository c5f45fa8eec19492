"""The rest of the port's model surface against the JAX package on the CPU:
the SLP encoders, ``SGD`` and ``AdamW`` training trajectories and their
optimizer states (optax's arithmetic), ``display_arch``, ``get_states`` with
a ``StaticInitState`` cycle, ``export_model`` / ``load_model`` of SLP and
recurrent models in both directions, and the results table of
``MultiModNHistory`` without pandas.

JAX weights are transplanted (``load_state_dict``); inputs come from a
seeded numpy generator. Tolerance: XLA's and PyTorch's CPU products sum in
different orders (~1e-7 relative), which stays at float32 rounding over a
few optimizer steps: parameters, optimizer states, history rows, states and
outputs agree to atol 1e-5. Printed architecture lines and the results CSV
are compared as text, exactly.
"""
import jax
import numpy as np
import pandas as pd
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.convert import opt_state_from_jax
from multimodn_tpu_torch.core.nn import dense_apply
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset
from multimodn_tpu_torch.ops.fused_chain import ChainSpec

ATOL = 1e-5
S = 4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


def _pair(make_encoders, nan_skip="sample", init_bank=None, **kw):
    def init_state(m):
        return None if init_bank is None else \
            m.StaticInitState(list(init_bank))

    jm = jmm.MultiModN(S, make_encoders(jenc), [jdec.LogisticDecoder(S),
                                                jdec.MLPDecoder(S, (3,), 2)],
                       0.7, 0.3, nan_skip=nan_skip, seed=1,
                       init_state=init_state(jmm), chain_mode="unrolled", **kw)
    tm = tmm.MultiModN(S, make_encoders(tenc), [tdec.LogisticDecoder(S),
                                                tdec.MLPDecoder(S, (3,), 2)],
                       0.7, 0.3, nan_skip=nan_skip, seed=1,
                       init_state=init_state(tmm), device="cpu", **kw)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _data(widths, n=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    y = np.stack([X[:, 0] > 0, X[:, -1] > 0], 1).astype(np.int64)
    X[rng.random(n) < 0.25, :widths[0]] = np.nan
    return X, y


SLP = lambda m: [m.SLPEncoder(S, 3), m.LinearEncoder(S, 2),  # noqa: E731
                 m.LogisticEncoder(S, 2)]
RECURRENT = lambda m: [  # noqa: E731
    m.LSTMEncoder(S, 3, (5,), "tanh"), m.RNNFeatureEncoder(S, 3, "relu", False),
    m.LSTMFeatureEncoder(S, 2), m.RNNEncoder(S, 2, (3, 3),
                                             unbatched_compat=False)]
WIDTHS = {"slp": (3, 2, 2), "recurrent": (3, 1, 1, 2)}
MAKERS = {"slp": SLP, "recurrent": RECURRENT}


@pytest.mark.parametrize("kind", ["SLPEncoder", "LinearEncoder",
                                  "LogisticEncoder"])
def test_slp_encoders_match_jax(kind):
    """One unactivated layer over ``[x, state]``: the sigmoid of SLP and
    Logistic is accepted but inert, as in the JAX package."""
    jenc_, tenc_ = getattr(jenc, kind)(S, 3), getattr(tenc, kind)(S, 3)
    assert tenc_._layer_dims == jenc_._layer_dims == [(3 + S, S)]
    jp = jenc_.init(jax.random.PRNGKey(2))
    tp = tmm.params_from_jax({"encoders": [jp], "decoders": []},
                             "cpu")["encoders"][0]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    state = rng.normal(size=(5, S)).astype(np.float32)
    got = tenc_.apply(tp, torch.from_numpy(state), torch.from_numpy(x))
    _close(got, jenc_.apply(jp, state, x))
    linear = dense_apply(tp["layers"][0], torch.cat(
        [torch.from_numpy(x), torch.from_numpy(state)], dim=-1))
    assert torch.equal(got, linear)


def test_slp_model_runs_the_kernel_plan():
    """SLP encoders are ``MLPEncoder``s, so the fused chain's plan takes
    them; on the CPU its plain version answers as the unrolled chain."""
    _jm, tm = _pair(SLP)
    spec = ChainSpec(tm.encoders, tm.decoders, S)
    assert [j.K for j in spec.a_jobs] == [3, 2, 2]
    x = [np.random.default_rng(e).normal(size=(6, w)).astype(np.float32)
         for e, w in enumerate(WIDTHS["slp"])]
    states, outs = tm.fused_forward(x)
    for got, want in zip(outs, tm.predict_proba(x)):
        _close(got.numpy(), want)


OPTIMIZERS = {
    "sgd": lambda m: m.SGD(0.05),
    "sgd_momentum": lambda m: m.SGD(0.05, momentum=0.9),
    "adamw": lambda m: m.AdamW(0.01, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_optax(name):
    """Two epochs of 3 steps under ``nan_skip='batch'`` (an encoder skipped
    for a whole batch still gets its zero gradient: no ``enc_gates``), then
    the JAX optimizer state converted by ``opt_state_from_jax`` equals the
    port's."""
    make = lambda m: [m.MLPEncoder(S, 3, (5,)),  # noqa: E731
                      m.MLPEncoder(S, 4, ())]
    jm, tm = _pair(make, nan_skip="batch")
    X, y = _data((3, 4))
    jl, tl = JLoader(JDataset(X, y, [3, 4]), 8), TLoader(TDataset(X, y, [3, 4]), 8)
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(["a", "b"])
    jopt, topt = OPTIMIZERS[name](jmm), OPTIMIZERS[name](tmm)
    for _ in range(2):
        jm.train_epoch(jl, jopt, "cross_entropy", jh)
        tm.train_epoch(tl, topt, "cross_entropy", th)
    for a, b in zip(jax.tree_util.tree_leaves(jm.state_dict()),
                    tree_leaves(tm.params)):
        _close(b.numpy(), a)
    for field in ("loss", "accuracy", "balanced_accuracy"):
        _close(np.stack(getattr(th, field)["train"]),
               np.stack(getattr(jh, field)["train"]))
    converted = opt_state_from_jax(jm.opt_state, "cpu")
    assert sorted(converted) == sorted(tm.opt_state)
    assert sorted(tm.opt_state) == {"sgd": [], "sgd_momentum": ["trace"],
                                    "adamw": ["count", "mu", "nu"]}[name]
    for a, b in zip(tree_leaves(converted), tree_leaves(tm.opt_state)):
        _close(b.numpy(), a.numpy())


def test_adamw_needs_the_parameters():
    opt = tmm.AdamW(0.1)
    params = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="parameters"):
        opt.update({"w": torch.ones(2)}, opt.init(params))


@pytest.mark.parametrize("kind", ["mlp", "slp", "recurrent"])
def test_display_arch_prints_the_jax_lines(kind, capsys):
    make = {"mlp": lambda m: [m.MLPEncoder(S, 6, (5, 5)),
                              m.MLPFeatureEncoder(S, 3)],
            **MAKERS}[kind]
    jm, tm = _pair(make)
    jm.display_arch()
    want = capsys.readouterr().out
    tm.display_arch()
    got = capsys.readouterr().out
    assert got == want and "Total parameters:" in got


def test_get_states_matches_jax_and_advances_the_cycle():
    """The final state per sample, NaN-skipped, padded rows dropped, with a
    ``StaticInitState`` bank whose cycle continues across calls."""
    bank = np.random.default_rng(5).normal(size=(3, S)).astype(np.float32)
    jm, tm = _pair(RECURRENT, init_bank=bank)
    X, y = _data(WIDTHS["recurrent"], n=19)
    jl = JLoader(JDataset(X, y, list(WIDTHS["recurrent"])), 8)
    tl = TLoader(TDataset(X, y, list(WIDTHS["recurrent"])), 8)
    for _ in range(2):
        got, want = tm.get_states(tl), jm.get_states(jl)
        assert len(got) == len(want) == 19
        _close(np.stack(got), np.stack(want))
        assert tm._cycle_offset == jm._cycle_offset


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_export_and_load_in_both_directions(kind, tmp_path):
    jm, _tm = _pair(MAKERS[kind])
    x = [np.random.default_rng(e).normal(size=(7, w)).astype(np.float32)
         for e, w in enumerate(WIDTHS[kind])]
    jmm.export_model(jm, str(tmp_path / "jax"))
    tm = tmm.load_model(str(tmp_path / "jax"), device="cpu")
    assert [type(e).__name__ for e in tm.encoders] == \
        [type(e).__name__ for e in jm.encoders]
    assert [getattr(e, "unbatched_compat", None) for e in tm.encoders] == \
        [getattr(e, "unbatched_compat", None) for e in jm.encoders]
    for got, want in zip(tm.predict_proba(x), jm.predict_proba(x)):
        _close(got, want)
    tmm.export_model(tm, str(tmp_path / "port"))
    back = jmm.load_model(str(tmp_path / "port"))
    for got, want in zip(back.predict_proba(x), tm.predict_proba(x)):
        _close(got, want)


def _history():
    """Two targets, training and validation epochs, a NaN sensitivity, a
    tiny and a whole-number value."""
    rng = np.random.default_rng(2)
    hist = tmm.MultiModNHistory(["Survived", "Other, quoted"])
    for epoch in range(2):
        for tag in ("train", "val"):
            grids = {k: rng.random((3, 2)).astype(np.float32) for k in
                     ("loss", "accuracy", "sensitivity", "specificity",
                      "balanced_accuracy")}
            grids["sensitivity"][-1, 1] = np.nan
            grids["loss"][-1, 0] = 1e-5
            grids["accuracy"][-1, 0] = 1.0
            hist.append_epoch(tag, grids, state_change=rng.random(2).astype(
                np.float32) if tag == "train" else None)
    return hist


def test_results_table_matches_pandas(tmp_path, capsys):
    hist = _history()
    jhist = jmm.MultiModNHistory(hist.decoder_names)
    for tag in ("train", "val"):
        for e in range(2):
            jhist.append_epoch(tag, {k: getattr(hist, k)[tag][e] for k in (
                "loss", "accuracy", "sensitivity", "specificity",
                "balanced_accuracy")})
    jhist.state_change_loss = list(hist.state_change_loss)
    hist.save_results(str(tmp_path / "port.csv"))
    jhist.save_results(str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    pd.testing.assert_frame_equal(hist.get_results(), jhist.get_results())
    hist.print_results()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("Target")
    assert "Val balanced accuracy" in lines[0]
    assert lines[1].startswith("Survived") and "nan" in lines[2]
