"""The fused chain with a gradient (``make_fused_chain_vjp``) and its plain
twin (``make_xla_chain_forward``) against the JAX package's, on the CPU.

The JAX side runs its Pallas forward in interpret mode with the plain-XLA
backward, as ``tests/test_pallas.py`` does; the port's forward on CPU
tensors is the kernel's plain version and its backward differentiates the
plain chain. Both models carry the same weights (``load_state_dict`` of the
JAX model), the same numpy inputs and a partial ``valid``.

Tolerance: rtol 1e-5 / atol 1e-6 on the loss and every gradient. XLA's and
PyTorch's CPU matrix products sum in different orders (~1e-7 relative at
these widths), through 2-3 chained encoders and 2 decoder layers.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodn_tpu import MultiModN as JMultiModN
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.ops import fused_chain as jfc
from multimodn_tpu_torch import Adam, MultiModN
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_map
from multimodn_tpu_torch.ops import fused_chain as fc

RTOL, ATOL = 1e-5, 1e-6
B = 12

CASES = {
    "mimic_first_concat": (
        6, lambda m: [m.MIMICMLPEncoder(6, w, (8,), dropout=0.0)
                      for w in (5, 9, 3)],
        lambda m: [m.MLPDecoder(6, (8,), 2),
                   m.ClassDecoder(6, 3, "softmax")]),
    "mlp_last_concat": (
        8, lambda m: [m.MLPEncoder(8, w, (7,), "tanh") for w in (4, 10)],
        lambda m: [m.MLPDecoder(8, (5,), 2),
                   m.ClassDecoder(8, 3, "sigmoid")]),
}


def _pair(case, seed=0):
    S, make_enc, make_dec = CASES[case]
    jm = JMultiModN(S, make_enc(jenc), make_dec(jdec), 1.0, 0.0, seed=seed)
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0,
                   device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _inputs(encoders, seed=3):
    rng = np.random.default_rng(seed)
    data = [rng.normal(size=(B, e.n_features)).astype(np.float32)
            for e in encoders]
    valid = (rng.random((B, len(encoders))) > 0.3).astype(np.float32)
    assert 0 < valid.sum() < valid.size
    return data, valid


def _loss(states, outs, sum_fn):
    # bench_pallas.py's loss.
    return (states ** 2).mean() + sum_fn([o.mean() for o in outs])


def _port_params(tm):
    """The encoders' and decoders' layers as fresh leaves that take
    gradients, and the init-state row."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      {"encoders": tm.params["encoders"],
                       "decoders": tm.params["decoders"]})
    init = tm.params["init_state"]["value"][0].detach().clone()
    return params, init.requires_grad_(True)


def _layer_leaves(params):
    return [layer[k] for part in ("encoders", "decoders")
            for module in params[part] for layer in module["layers"]
            for k in ("w", "b")]


def _port_grads(fwd, tm, data, valid):
    params, init = _port_params(tm)
    xs = [torch.tensor(d, requires_grad=True) for d in data]
    v = torch.tensor(valid, requires_grad=True)
    states, outs = fwd(params, xs, v, init)
    loss = _loss(states, outs, sum)
    wrt = _layer_leaves(params) + xs + [init]
    grads = torch.autograd.grad(loss, wrt)
    return loss, grads, v


def _jax_grads(jm, data, valid):
    S = jm.state_size
    fwd = jfc.make_fused_chain_vjp(jm.encoders, jm.decoders, S,
                                   interpret=True)

    def f(params, xs, init):
        states, outs = fwd(params, xs, jnp.asarray(valid), init)
        return _loss(states, outs, lambda v: sum(v[1:], v[0]))

    init = jm.params["init_state"]["value"][0]
    loss, (gp, gx, gi) = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jm.params, tuple(jnp.asarray(d) for d in data), init)
    return loss, _layer_leaves(gp) + list(gx) + [gi]


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_match_jax_vjp(case):
    jm, tm = _pair(case)
    data, valid = _inputs(tm.encoders)
    fwd = fc.make_fused_chain_vjp(tm.encoders, tm.decoders, tm.state_size)
    loss, grads, _v = _port_grads(fwd, tm, data, valid)
    jloss, jgrads = _jax_grads(jm, data, valid)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                               atol=ATOL)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        assert tuple(g.shape) == tuple(jg.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL)
    # The skipped cells' data gets no gradient: the where drops them.
    for e, g in enumerate(grads[-len(data) - 1:-1]):
        assert not g[valid[:, e] == 0].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_xla_chain_forward_matches_jax(case):
    jm, tm = _pair(case, seed=1)
    data, valid = _inputs(tm.encoders, seed=4)
    jfwd = jfc.make_xla_chain_forward(jm.encoders, jm.decoders,
                                      jm.state_size)
    want = jfwd(jm.params, tuple(jnp.asarray(d) for d in data),
                jnp.asarray(valid), jm.params["init_state"]["value"][0])
    fwd = fc.make_xla_chain_forward(tm.encoders, tm.decoders, tm.state_size)
    got = fwd(tm.params, [torch.as_tensor(d) for d in data],
              torch.as_tensor(valid), tm.params["init_state"]["value"][0])
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_vjp_gradients_equal_plain_autograd_on_cpu():
    """On the CPU the forward is the plain version, so the loss and the
    gradients equal autograd through the plain chain bit for bit."""
    _jm, tm = _pair("mimic_first_concat")
    data, valid = _inputs(tm.encoders)
    args = (tm.encoders, tm.decoders, tm.state_size)
    loss, grads, _ = _port_grads(fc.make_fused_chain_vjp(*args), tm, data,
                                 valid)
    ploss, pgrads, _ = _port_grads(fc.make_xla_chain_forward(*args), tm,
                                   data, valid)
    assert torch.equal(loss, ploss)
    for g, p in zip(grads, pgrads):
        assert torch.equal(g, p)


def test_fused_forward_builder_is_the_plain_version_on_cpu():
    _jm, tm = _pair("mlp_last_concat")
    data, valid = _inputs(tm.encoders)
    args = (tm.encoders, tm.decoders, tm.state_size)
    inputs = ([torch.as_tensor(d) for d in data], torch.as_tensor(valid),
              tm.params["init_state"]["value"][0])
    before = fc.FUSED_CHAIN.launches
    got = fc.make_fused_chain_forward(*args)(tm.params, *inputs)
    want = fc.make_xla_chain_forward(*args)(tm.params, *inputs)
    assert fc.FUSED_CHAIN.launches == before
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        assert torch.equal(g, w)


def test_valid_gets_no_gradient():
    _jm, tm = _pair("mimic_first_concat")
    data, valid = _inputs(tm.encoders)
    fwd = fc.make_fused_chain_vjp(tm.encoders, tm.decoders, tm.state_size)
    params, init = _port_params(tm)
    v = torch.tensor(valid, requires_grad=True)
    states, outs = fwd(params, [torch.as_tensor(d) for d in data], v, init)
    _loss(states, outs, sum).backward()
    assert v.grad is None
    assert init.grad is not None and init.grad.abs().sum() > 0


def test_forward_saves_only_its_inputs():
    """The residuals are the inputs (no activation is kept): what the
    backward node saved is the inputs' storage, and a second backward after
    the inputs' gradients were cleared gives the first one's gradients."""
    _jm, tm = _pair("mlp_last_concat")
    data, valid = _inputs(tm.encoders)
    fwd = fc.make_fused_chain_vjp(tm.encoders, tm.decoders, tm.state_size)
    params, init = _port_params(tm)
    xs = [torch.tensor(d, requires_grad=True) for d in data]
    v = torch.as_tensor(valid)
    states, outs = fwd(params, xs, v, init)
    inputs = _layer_leaves(params) + xs + [v, init]
    saved = states.grad_fn.saved_tensors
    assert [t.data_ptr() for t in saved] == [t.data_ptr() for t in inputs]
    loss = _loss(states, outs, sum)
    loss.backward(retain_graph=True)
    wrt = _layer_leaves(params) + xs + [init]
    first = [t.grad.clone() for t in wrt]
    for t in wrt:
        t.grad = None
    loss.backward()
    for t, g in zip(wrt, first):
        assert torch.equal(t.grad, g)


def test_adam_steps_through_vjp_equal_plain_on_cpu():
    _jm, tm = _pair("mimic_first_concat")
    data, valid = _inputs(tm.encoders)
    args = (tm.encoders, tm.decoders, tm.state_size)
    xs = [torch.as_tensor(d) for d in data]
    v = torch.as_tensor(valid)
    finals = []
    for fwd in (fc.make_fused_chain_vjp(*args),
                fc.make_xla_chain_forward(*args)):
        params, init = _port_params(tm)
        opt = Adam(1e-2)
        state = opt.init(params)
        losses = []
        for _ in range(3):
            states, outs = fwd(params, xs, v, init)
            loss = _loss(states, outs, sum)
            leaves = _layer_leaves(params)
            grads = dict(zip(map(id, leaves),
                             torch.autograd.grad(loss, leaves)))
            upd, state = opt.update(tree_map(lambda p: grads[id(p)], params),
                                    state)
            params = tree_map(
                lambda p, u: (p + u).detach().requires_grad_(True),
                params, upd)
            losses.append(loss.item())
        assert losses[-1] < losses[0]
        finals.append((losses, _layer_leaves(params)))
    assert finals[0][0] == finals[1][0]
    for a, b in zip(finals[0][1], finals[1][1]):
        assert torch.equal(a, b)


def test_vjp_rejects_modules_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        fc.make_fused_chain_vjp([tenc.RNNEncoder(4, 6, (5,))],
                                [tdec.LogisticDecoder(4)], 4)
    with pytest.raises(TypeError):
        jfc.make_fused_chain_vjp([jenc.RNNEncoder(4, 6, (5,))],
                                 [jdec.LogisticDecoder(4)], 4)


def test_the_jax_modules_builders_are_in_the_port():
    for name in ("make_fused_chain_forward", "make_xla_chain_forward",
                 "make_fused_chain_vjp"):
        jparams = list(inspect.signature(getattr(jfc, name)).parameters)
        params = list(inspect.signature(getattr(fc, name)).parameters)
        # The kernel's tile and interpret mode have no counterpart here.
        assert params == [p for p in jparams
                          if p not in ("batch_tile", "interpret")]
