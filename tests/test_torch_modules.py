"""The PyTorch port's modules against their JAX twins on the CPU.

Inputs come from a seeded numpy generator; JAX parameters are transplanted
with ``params_from_jax``. Tolerances: the activations and element-wise
maths agree to a few float32 ulp (atol 1e-6); anything with a matrix product
sums in another order in XLA's and PyTorch's CPU kernels, which moves fp32
results by ~1e-7 relative at these widths (atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
from multimodn_tpu.core import nn as jnn
from multimodn_tpu.core import state as jstate
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu_torch import params_from_jax
from multimodn_tpu_torch.core import nn as tnn
from multimodn_tpu_torch.core import state as tstate
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc

ELEMENTWISE_ATOL = 1e-6
MATMUL_ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _transplant_encoder(jparams):
    return params_from_jax({"encoders": [jparams], "decoders": []},
                           "cpu")["encoders"][0]


def _transplant_decoder(jparams):
    return params_from_jax({"encoders": [], "decoders": [jparams]},
                           "cpu")["decoders"][0]


@pytest.mark.parametrize("name", sorted(tnn.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(scale=3.0, size=(7, 9)) \
        .astype(np.float32)
    want = np.asarray(jnn.ACTIVATIONS[name](jnp.asarray(x)))
    got = tnn.ACTIVATIONS[name](_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ELEMENTWISE_ATOL)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; F.gelu defaults to
    erf. The two differ by up to ~5e-4, far above the tolerance."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    got = tnn.gelu(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(x)),
                               rtol=0, atol=ELEMENTWISE_ATOL)
    assert (got - F.gelu(_t(x))).abs().max() > 1e-4


def test_softmax_runs_over_the_last_axis():
    x = _t(np.random.default_rng(1).normal(size=(3, 4, 5))
           .astype(np.float32))
    np.testing.assert_allclose(tnn.softmax(x).sum(-1).numpy(), 1.0,
                               atol=ELEMENTWISE_ATOL)


def test_resolve_activation_rejects_unknown_names():
    with pytest.raises(ValueError, match="Unknown activation"):
        tnn.resolve_activation("swish")


def test_dense_apply_matches_jax_float32():
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(13, 6)).astype(np.float32),
         "b": rng.normal(size=(6,)).astype(np.float32)}
    x = rng.normal(size=(3, 5, 13)).astype(np.float32)
    want = np.asarray(jnn.dense_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                      jnp.asarray(x)))
    got = tnn.dense_apply({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_ATOL)


def test_dense_apply_casts_before_the_bias_add():
    """bf16 activations: fp32-accumulated product, cast to bf16, then the
    bias add in bf16 (core/nn.py:44-45). Adding the bias in fp32 before the
    cast rounds differently; the port must round as JAX does (equal up to
    one bf16 ulp, 2**-7 relative, from the product's summation order)."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    b = (rng.normal(size=(16,)) * 100).astype(np.float32)
    x = rng.normal(size=(8, 32)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b, jnp.bfloat16)}
    want = np.asarray(jnn.dense_apply(jp, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    tp = {"w": _t(w).bfloat16(), "b": _t(b).bfloat16()}
    got = tnn.dense_apply(tp, _t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=0)


def test_dense_init_follows_torch_linear_distribution():
    gen = torch.Generator().manual_seed(0)
    p = tnn.dense_init(gen, 400, 300)
    bound = 1 / 20.0
    assert p["w"].shape == (400, 300) and p["b"].shape == (300,)
    assert p["w"].abs().max() <= bound
    assert p["w"].abs().max() > 0.99 * bound
    assert abs(p["w"].mean().item()) < 1e-3


ENCODER_CASES = [
    ("mlp_no_hidden", lambda m: m.MLPEncoder(6, 9, ())),
    ("mlp_relu", lambda m: m.MLPEncoder(6, 9, (16,))),
    ("mlp_gelu_deep", lambda m: m.MLPEncoder(6, 9, (16, 8), "gelu")),
    ("mlp_tanh", lambda m: m.MLPEncoder(6, 9, (12,), "tanh")),
    ("feature", lambda m: m.MLPFeatureEncoder(6, 5, "sigmoid")),
    ("mimic", lambda m: m.MIMICMLPEncoder(6, 9, (16, 16), dropout=0.2)),
    ("mimic_gelu", lambda m: m.MIMICMLPEncoder(6, 9, (8,), 0.0, "gelu")),
]


@pytest.mark.parametrize("make", [c[1] for c in ENCODER_CASES],
                         ids=[c[0] for c in ENCODER_CASES])
def test_encoder_matches_jax(make):
    jenc_obj, tenc_obj = make(jenc), make(tenc)
    rng = np.random.default_rng(4)
    B = 11
    x = rng.normal(size=(B, jenc_obj.n_features)).astype(np.float32)
    s = rng.normal(size=(B, 6)).astype(np.float32)
    jp = jenc_obj.init(jax.random.PRNGKey(0))
    want = np.asarray(jenc_obj.apply(jp, jnp.asarray(s), jnp.asarray(x),
                                     train=False))
    got = tenc_obj.apply(_transplant_encoder(jp), _t(s), _t(x))
    assert got.shape == (B, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_ATOL)
    # The port's own init has the JAX layout, so the same tree shapes.
    tp = tenc_obj.init(torch.Generator().manual_seed(0))
    assert [tuple(layer["w"].shape) for layer in tp["layers"]] == \
        [tuple(layer["w"].shape) for layer in jp["layers"]]


def test_encoder_concat_order_is_x_then_state():
    """The concat layer's weight rows are [x rows, state rows]: zeroing the
    state rows must remove the state's influence in both packages."""
    enc = tenc.MIMICMLPEncoder(4, 3, (), dropout=0.0, activation="identity")
    p = enc.init(torch.Generator().manual_seed(0))
    p["layers"][0]["w"][3:] = 0.0
    x = torch.ones(2, 3)
    a = enc.apply(p, torch.zeros(2, 4), x)
    b = enc.apply(p, torch.full((2, 4), 5.0), x)
    torch.testing.assert_close(a, b)


DECODER_CASES = [
    ("class_softmax", lambda m: m.ClassDecoder(6, 4, "softmax")),
    ("logistic", lambda m: m.LogisticDecoder(6)),
    ("mlp", lambda m: m.MLPDecoder(6, (16, 8), 2)),
    ("mlp_gelu_softmax", lambda m: m.MLPDecoder(6, (8,), 3, "softmax",
                                                 "gelu")),
]


@pytest.mark.parametrize("make", [c[1] for c in DECODER_CASES],
                         ids=[c[0] for c in DECODER_CASES])
def test_decoder_matches_jax_over_state_stack(make):
    jdec_obj, tdec_obj = make(jdec), make(tdec)
    states = np.random.default_rng(5).normal(size=(4, 7, 6)) \
        .astype(np.float32)
    jp = jdec_obj.init(jax.random.PRNGKey(1))
    want = np.asarray(jdec_obj.apply(jp, jnp.asarray(states)))
    got = tdec_obj.apply(_transplant_decoder(jp), _t(states))
    assert got.shape == (4, 7, jdec_obj.n_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_ATOL)


def test_trainable_init_state_matches_jax():
    js, ts = jstate.TrainableInitState(5), tstate.TrainableInitState(5)
    jp = js.init(jax.random.PRNGKey(2))
    tp = params_from_jax({"init_state": jp, "encoders": [], "decoders": []},
                         "cpu")["init_state"]
    np.testing.assert_array_equal(ts.apply(tp, 4).numpy(),
                                  np.asarray(js.apply(jp, 4, 0)))
    own = ts.init(torch.Generator().manual_seed(0))["value"]
    assert own.shape == (1, 5)


@pytest.mark.parametrize("offset", [0, 3, 7, 12])
def test_static_init_state_cycles_like_jax(offset):
    bank = np.random.default_rng(6).normal(size=(5, 3)).astype(np.float32)
    js, ts = jstate.StaticInitState(list(bank)), \
        tstate.StaticInitState(list(bank))
    np.testing.assert_array_equal(ts.apply({}, 8, offset).numpy(),
                                  np.asarray(js.apply({}, 8, offset)))
    np.testing.assert_array_equal(ts.bank(), bank)
