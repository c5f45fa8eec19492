"""The port's ``Adam`` and ``Adam8bit`` against the JAX package's on the CPU.

Both packages take the same gradients (seeded numpy) for several steps on
the parameter tree of a small MIMIC-style model, ungated and with the
per-encoder gates of ``nan_skip='batch'``. Tolerances: the bias corrections
``1 - b^t`` come from each framework's ``pow`` of a float32 step count,
which may differ in the last bit, and XLA fuses each leaf's update (FMA
contraction, reciprocal products), so fp32 Adam agrees to float32 rounding
(rtol 1e-5, atol 1e-7 over 6 steps). For ``Adam8bit`` a moment that moved by
one ulp may land on the neighbouring 8-bit code (up to 2^-3 of its value for
fp8), which moves that element's step by at most ~lr/8; with lr 1e-3 and 6
steps, parameters agree within atol 1e-4, and almost all within 1e-6.
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
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset
from multimodn_tpu_torch.ops import fused_adam as ta

LR = 1e-3
WIDTHS = (5, 9, 4)
GATES = [[1, 0, 1], [0, 0, 1], None, [1, 1, 1], [0, 1, 0], [1, 0, 0]]


def _jax_model(nan_skip="sample", **kw):
    return jmm.MultiModN(
        6, [jenc.MIMICMLPEncoder(6, w, (8,), dropout=0.0) for w in WIDTHS],
        [jdec.MLPDecoder(6, (8,), 2), jdec.LogisticDecoder(6)], 1.0, 0.5,
        seed=2, nan_skip=nan_skip, chain_mode="unrolled", **kw)


def _torch_model(nan_skip="sample"):
    return tmm.MultiModN(
        6, [tenc.MIMICMLPEncoder(6, w, (8,), dropout=0.0) for w in WIDTHS],
        [tdec.MLPDecoder(6, (8,), 2), tdec.LogisticDecoder(6)], 1.0, 0.5,
        seed=2, nan_skip=nan_skip, device="cpu")


def _grads(params, rng):
    return jax.tree_util.tree_map(
        lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _pairs(jtree, ttree):
    """Aligned (JAX, port) leaves as numpy arrays."""
    return zip(jax.tree_util.tree_leaves(jtree), tree_leaves(ttree))


def _assert_params_close(jparams, tparams, atol, rtol=0.0):
    for a, b in _pairs(jparams, tparams):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)


def _run_both(joptim, toptim, gates, fused):
    """Feed both optimizers the same gradients; returns the final
    (JAX params, JAX state, port params, port state)."""
    jparams = _jax_model().params
    tparams = tmm.params_from_jax(jparams, "cpu")
    jstate = joptim.tx.init(jparams)
    tstate = tmm.opt_state_from_jax(jstate, "cpu")
    rng = np.random.default_rng(0)
    for gate in gates:
        g = _grads(jparams, rng)
        jg = None if gate is None else jnp.asarray(gate, jnp.float32)
        tg = None if gate is None else torch.tensor(gate, dtype=torch.float32)
        if fused:
            jparams, jstate = joptim.tx.fused_apply(
                jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams,
                enc_gates=jg)
            tstate = toptim.fused_apply(_to_torch(g), tstate, tparams,
                                        enc_gates=tg)
        else:
            upd, jstate = joptim.tx.update(
                jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams,
                enc_gates=jg)
            jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                             upd)
            tupd, tstate = toptim.update(_to_torch(g), tstate, tparams,
                                         enc_gates=tg)
            tree_map(lambda p, u: p.add_(u), tparams, tupd)
    return jparams, jstate, tparams, tstate


def _assert_counts_equal(jstate, tstate):
    assert float(jstate["t"]) == tstate["t"].item()
    np.testing.assert_array_equal(
        np.asarray([float(t) for t in jstate["t_enc"]]),
        np.asarray([t.item() for t in tstate["t_enc"]]))


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_adam_matches_jax(gated):
    gates = GATES if gated else [None] * len(GATES)
    jp, js, tp, ts = _run_both(jmm.Adam(LR), tmm.Adam(LR), gates, False)
    _assert_params_close(jp, tp, atol=1e-7, rtol=1e-5)
    for key in ("m", "v"):
        _assert_params_close(js[key], ts[key], atol=1e-7, rtol=1e-5)
    _assert_counts_equal(js, ts)
    if gated:
        # Each encoder counts the steps it ran: its gated-on steps and the
        # ungated one.
        assert [t.item() for t in ts["t_enc"]] == [4.0, 3.0, 4.0]


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_adam8bit_fused_apply_matches_jax(fmt, gated):
    gates = GATES if gated else [None] * len(GATES)
    jp, js, tp, ts = _run_both(jmm.Adam8bit(LR, fmt=fmt),
                               tmm.Adam8bit(LR, fmt=fmt), gates, True)
    _assert_params_close(jp, tp, atol=1e-4)
    diffs = np.concatenate([
        np.abs(b.numpy() - np.asarray(a)).reshape(-1)
        for a, b in _pairs(jp, tp)])
    assert np.mean(diffs > 1e-6) < 0.01
    _assert_counts_equal(js, ts)
    assert ts["mq"]["encoders"][0]["layers"][0]["w"].dtype == \
        ta.code_dtype(fmt)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_adam8bit_update_equals_fused_apply(gated):
    """The protocol form (updates returned, then added) and the in-place
    form compute the same numbers."""
    gates = GATES if gated else [None] * len(GATES)
    params = _torch_model().params
    fused, proto = tmm.Adam8bit(LR), tmm.Adam8bit(LR)
    p_f = tree_map(torch.clone, params)
    p_u = tree_map(torch.clone, params)
    s_f, s_u = fused.init(p_f), proto.init(p_u)
    rng = np.random.default_rng(5)
    for gate in gates:
        g = _to_torch(_grads(params, rng))
        tg = None if gate is None else torch.tensor(gate, dtype=torch.float32)
        s_f = fused.fused_apply(g, s_f, p_f, enc_gates=tg)
        upd, s_u = proto.update(g, s_u, p_u, enc_gates=tg)
        tree_map(lambda p, u: p.add_(u), p_u, upd)
    for a, b in zip(tree_leaves(p_f), tree_leaves(p_u)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("make", [lambda: tmm.Adam(LR),
                                  lambda: tmm.Adam8bit(LR)],
                         ids=["adam", "adam8bit"])
def test_gated_off_encoder_is_frozen(make):
    """torch's None-grad skip: an encoder gated off keeps its parameters
    and its step count, however large its (zero or not) gradient."""
    params = _torch_model().params
    before = tree_map(torch.clone, params["encoders"][1])
    opt = make()
    state = opt.init(params)
    rng = np.random.default_rng(6)
    for _ in range(3):
        g = _to_torch(_grads(params, rng))
        gates = torch.tensor([1.0, 0.0, 1.0])
        if hasattr(opt, "fused_apply"):
            state = opt.fused_apply(g, state, params, enc_gates=gates)
        else:
            upd, state = opt.update(g, state, params, enc_gates=gates)
            tree_map(lambda p, u: p.add_(u), params, upd)
    for a, b in zip(tree_leaves(before), tree_leaves(params["encoders"][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [t.item() for t in state["t_enc"]] == [3.0, 0.0, 3.0]
    assert state["t"].item() == 3.0


@pytest.mark.parametrize("optimizer", ["adam", "adam8bit"])
def test_jax_state_mid_training_crosses_over(optimizer):
    """A JAX model trained one epoch hands its weights and optimizer state
    (fp8 codes as uint8 views) to the port; one more epoch on each side
    agrees."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(48, sum(WIDTHS))).astype(np.float32)
    y = np.stack([X[:, 0] > 0, X[:, 6] > 0], 1).astype(np.int64)
    make = {"adam": (jmm.Adam, tmm.Adam),
            "adam8bit": (jmm.Adam8bit, tmm.Adam8bit)}[optimizer]
    jm, jopt = _jax_model(), make[0](LR)
    jm.train_epoch(JLoader(JDataset(X, y, list(WIDTHS)), 16), jopt)
    tm, topt = _torch_model(), make[1](LR)
    tm.load_state_dict(jm.state_dict())
    tm._opt, tm.opt_state = topt, tmm.opt_state_from_jax(jm.opt_state, "cpu")
    if optimizer == "adam8bit":
        np.testing.assert_array_equal(
            tm.opt_state["mq"]["encoders"][1]["layers"][0]["w"]
            .view(torch.uint8).numpy(),
            np.asarray(jm.opt_state["mq"]["encoders"][1]["layers"][0]["w"])
            .view(np.uint8))
    jm.train_epoch(JLoader(JDataset(X, y, list(WIDTHS)), 16), jopt)
    tm.train_epoch(TLoader(TDataset(X, y, list(WIDTHS)), 16), topt)
    _assert_params_close(jm.state_dict(), tm.params, atol=1e-5)
    assert tm.opt_state["t"].item() == float(jm.opt_state["t"]) == 6.0


def test_scalar_leaves_keep_their_shape():
    params = {"s": torch.tensor(2.0), "w": torch.ones(3, 4)}
    opt = tmm.Adam8bit(0.1)
    state = opt.init(params)
    assert state["mq"]["s"].shape == () and state["ms"]["s"].shape == ()
    assert state["t_enc"] is None
    grads = tree_map(torch.ones_like, params)
    for _ in range(2):
        state = opt.fused_apply(grads, state, params)
    assert params["s"].shape == () and torch.isfinite(params["s"])
    assert state["t"].item() == 2.0


def test_fmt_is_checked():
    with pytest.raises(ValueError, match="fmt"):
        tmm.Adam8bit(0.01, fmt="fp16")
