"""The port's recurrent encoders (``LSTMEncoder``, ``RNNEncoder`` and their
Feature variants) against the JAX package on the CPU: outputs in both
``unbatched_compat`` modes, with 2-D and 3-D inputs, and the loss and every
gradient leaf against ``jax.grad`` through a padded batch with NaN-zeroed
rows inside the fusion chain, for ``nan_skip`` 'sample', 'batch' and
'none'.

JAX weights are transplanted (``convert.params_from_jax``); inputs come from
a seeded numpy generator. Tolerance: XLA and PyTorch sum each small matrix
product in their own order (~1e-7 relative) and the recurrence carries that
through up to 12 time steps of 3 layers; outputs, losses and gradients
agree to atol 1e-5.
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
from multimodn_tpu_torch.convert import params_from_jax
from multimodn_tpu_torch.core import step as tstep
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map

ATOL = 1e-5
S = 3

ENCODERS = {
    "lstm": lambda m, compat: m.LSTMEncoder(S, 4, (5, 6), "tanh", compat),
    "rnn": lambda m, compat: m.RNNEncoder(S, 4, (5,), "relu", compat),
    "lstm_feature": lambda m, compat: m.LSTMFeatureEncoder(S, 4,
                                                           "relu", compat),
    "rnn_feature": lambda m, compat: m.RNNFeatureEncoder(S, 5, "sigmoid",
                                                         compat),
}


def _transplant(jparams):
    """One encoder's JAX params as the port's tensors on the CPU."""
    return params_from_jax({"encoders": [jparams], "decoders": []},
                           "cpu")["encoders"][0]


@pytest.mark.parametrize("shape", ["2d", "3d"])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("kind", sorted(ENCODERS))
def test_encoder_output_matches_jax(kind, compat, shape):
    """(B, F) runs across the batch rows (compat) or as length-1 sequences;
    (B, T, F) is a batch of sequences in both modes, the last step's output
    being the state."""
    jenc_, tenc_ = ENCODERS[kind](jenc, compat), ENCODERS[kind](tenc, compat)
    assert tenc_._layer_dims == jenc_._layer_dims
    jp = jenc_.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(1)
    B, F = 6, jenc_.n_features
    x = rng.normal(size=(B, F) if shape == "2d" else (B, 5, F)) \
        .astype(np.float32)
    state = rng.normal(size=(B, S)).astype(np.float32)
    want = np.asarray(jenc_.apply(jp, jnp.asarray(state), jnp.asarray(x)))
    got = tenc_.apply(_transplant(jp), torch.from_numpy(state),
                      torch.from_numpy(x))
    assert got.shape == (B, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_init_draws_the_torch_shapes_and_bounds():
    enc = tenc.LSTMEncoder(S, 4, (5,))
    p = enc.init(torch.Generator().manual_seed(0))["layers"]
    assert [tuple(l["w_ih"].shape) for l in p] == [(4, 20), (8, 12)]
    assert [tuple(l["w_hh"].shape) for l in p] == [(5, 20), (3, 12)]
    assert [tuple(l["b_hh"].shape) for l in p] == [(20,), (12,)]
    for layer, hidden in zip(p, (5, 3)):
        for t in layer.values():
            assert t.abs().max() <= hidden ** -0.5


def test_unbatched_recurrence_runs_across_rows():
    """In the compat mode a row's output depends on the rows before it and
    never on the rows after it, so a loader's padded tail rows cannot reach
    a real row."""
    enc = tenc.LSTMEncoder(S, 4, (5,))
    p = enc.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    state = torch.from_numpy(rng.normal(size=(8, S)).astype(np.float32))
    full = enc.apply(p, state, x)
    torch.testing.assert_close(enc.apply(p, state[:5], x[:5]), full[:5],
                               rtol=0, atol=0)
    moved = x.clone()
    moved[0] += 1.0
    assert not torch.allclose(enc.apply(p, state, moved)[1:], full[1:])
    batched = tenc.LSTMEncoder(S, 4, (5,), unbatched_compat=False)
    out = batched.apply(p, state, moved)
    torch.testing.assert_close(out[1:], batched.apply(p, state, x)[1:],
                               rtol=0, atol=0)


def _models(nan_skip):
    def make(m):
        return [m.LSTMEncoder(S, 3, (4,)), m.RNNFeatureEncoder(S, 4),
                m.LSTMEncoder(S, 2, (3,), "relu", False),
                m.RNNEncoder(S, 2, (3, 2))]

    jm = jmm.MultiModN(S, make(jenc), [jdec.MLPDecoder(S, (4,), 2),
                                       jdec.LogisticDecoder(S)], 1.0, 0.5,
                       seed=2, nan_skip=nan_skip, chain_mode="unrolled")
    tm = tmm.MultiModN(S, make(tenc), [tdec.MLPDecoder(S, (4,), 2),
                                       tdec.LogisticDecoder(S)], 1.0, 0.5,
                       seed=2, nan_skip=nan_skip, device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


@pytest.mark.parametrize("nan_skip", ["sample", "batch", "none"])
def test_loss_and_every_gradient_match_jax(nan_skip):
    """A batch of 12 rows with 2 padded at the end; NaN rows in the first
    and second modalities are zero-filled and still feed the recurrence
    (and, under 'batch', one skips encoder 0 for the whole batch)."""
    jm, tm = _models(nan_skip)
    rng = np.random.default_rng(3)
    widths = (3, 1, 2, 2)
    data = [rng.normal(size=(12, w)).astype(np.float32) for w in widths]
    if nan_skip != "none":
        data[0][[2, 7]] = np.nan
        data[1][4, 0] = np.nan
    y = rng.integers(0, 2, size=(12, 2)).astype(np.int64)
    mask = np.ones(12, np.float32)
    mask[10:] = 0.0
    order = tuple((i, i) for i in range(4))

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
    tloss, taux = tloss_fn(live, tuple(torch.from_numpy(d) for d in data),
                           torch.from_numpy(y), torch.from_numpy(mask),
                           None, 0, True)
    tgrads = torch.autograd.grad(tloss, tree_leaves(live))

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=0, atol=ATOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads) == 1 + 4 * 9 + 3 * 2
    for a, b in zip(jleaves, tgrads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)
    for key in tstep.GRID_KEYS:
        np.testing.assert_allclose(taux[key].detach().numpy(),
                                   np.asarray(jaux[key]), rtol=0, atol=ATOL)


def test_adam_state_of_recurrent_leaves_transplants():
    """A JAX ``Adam`` state over recurrent leaves (``layers[i].{w_ih, w_hh,
    b_ih, b_hh}``) after one update crosses with ``opt_state_from_jax``;
    the next update from it equals the JAX package's."""
    from multimodn_tpu_torch.convert import opt_state_from_jax
    jm, tm = _models("sample")
    rng = np.random.default_rng(8)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
        jm.params) for _ in range(2)]
    jopt, topt = jmm.Adam(0.01), tmm.Adam(0.01)
    update = jax.jit(jopt.update)
    _, jstate = update(grads[0], jopt.init(jm.params), jm.params)
    want, _ = update(grads[1], jstate, jm.params)
    tstate = opt_state_from_jax(jstate, "cpu")
    got, _ = topt.update(params_from_jax(grads[1], "cpu"), tstate,
                         tm.params)
    assert len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(want)) \
        == 43
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)
