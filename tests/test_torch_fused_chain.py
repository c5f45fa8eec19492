"""The fused-chain kernel's plain PyTorch version and plan against the JAX
package's Pallas kernel (interpret mode) and its XLA twin, on the CPU.

The CUDA kernel itself cannot run here; its arithmetic is held on the CPU
three ways: the plain version against the Pallas kernel and the XLA twin,
and a numpy interpreter of the int32 plan + flat weight buffer that the
kernel reads, against the plain version. ``test_torch_cuda.py`` holds the
kernel against the plain version on a GPU.

Tolerance: XLA's and PyTorch's CPU matrix products sum in different orders
(fp32, K <= 1074 at MIMIC width), which moves results by ~1e-7 relative;
atol 1e-5 leaves headroom through 4 chained encoders and 3 decoder layers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodn_tpu import MultiModN as JMultiModN
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.ops.fused_chain import (
    make_fused_chain_forward,
    make_xla_chain_forward,
)
from multimodn_tpu_torch import MultiModN
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.encoders.base import MultiModEncoder
from multimodn_tpu_torch.ops import fused_chain as fc

ATOL = 1e-5

SMALL_CASES = {
    # The Pallas test's sizes (tests/test_pallas.py): S=8, widths 12 and 20.
    "mimic_first_concat": (
        8, lambda m: [m.MIMICMLPEncoder(8, w, (16, 16), dropout=0.0)
                      for w in (12, 20)],
        lambda m: [m.MLPDecoder(8, (16,), 2), m.LogisticDecoder(8)]),
    "mlp_last_concat": (
        8, lambda m: [m.MLPEncoder(8, w, (16,)) for w in (12, 20)],
        lambda m: [m.MLPDecoder(8, (16,), 2), m.LogisticDecoder(8)]),
    "mixed_gelu_tanh_softmax": (
        8, lambda m: [m.MLPEncoder(8, 12, (16,), "gelu"),
                      m.MIMICMLPEncoder(8, 20, (16,), 0.0, "tanh"),
                      m.MLPEncoder(8, 5, ())],
        lambda m: [m.ClassDecoder(8, 3, "softmax"),
                   m.MLPDecoder(8, (16,), 4, "softmax", "gelu")]),
}
# The MIMIC multi-task model at pipelines/mimic/common.py's defaults.
MIMIC_CASE = (
    50, lambda m: [m.MIMICMLPEncoder(50, w, (32, 32), dropout=0.2)
                   for w in (10, 1024, 768, 99)],
    lambda m: [m.MLPDecoder(50, (32, 32), 2) for _ in range(2)])
ALL_CASES = dict(SMALL_CASES, mimic=MIMIC_CASE)


def _pair(S, make_enc, make_dec, seed=0):
    """A JAX model and the port's twin holding the same weights."""
    jm = JMultiModN(S, make_enc(jenc), make_dec(jdec), 1.0, 0.0, seed=seed)
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0,
                   device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _inputs(encoders, B, seed=0):
    rng = np.random.default_rng(seed)
    data = [rng.normal(size=(B, e.n_features)).astype(np.float32)
            for e in encoders]
    valid = (rng.random((B, len(encoders))) > 0.3).astype(np.float32)
    return data, valid


def _port_forward(tm, data, valid, fn=fc.fused_chain_forward_ref):
    spec = fc.ChainSpec(tm.encoders, tm.decoders, tm.state_size)
    return fn(spec, tm.params, [torch.as_tensor(d) for d in data],
              torch.as_tensor(valid), tm.params["init_state"]["value"][0])


def _assert_close(got, want, atol):
    states, outs = got
    np.testing.assert_allclose(np.asarray(states), np.asarray(want[0]),
                               rtol=0, atol=atol)
    assert len(outs) == len(want[1])
    for o, w in zip(outs, want[1]):
        np.testing.assert_allclose(np.asarray(o), np.asarray(w), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("case", sorted(SMALL_CASES))
def test_plain_version_matches_pallas_interpret(case):
    S, make_enc, make_dec = SMALL_CASES[case]
    jm, tm = _pair(S, make_enc, make_dec)
    data, valid = _inputs(jm.encoders, 16)
    fwd = make_fused_chain_forward(jm.encoders, jm.decoders, S,
                                   interpret=True)
    want = fwd(jm.params, tuple(jnp.asarray(d) for d in data),
               jnp.asarray(valid), jm.params["init_state"]["value"][0])
    _assert_close(_port_forward(tm, data, valid), want, ATOL)
    # On CPU tensors the wrapper is the plain version.
    _assert_close(_port_forward(tm, data, valid, fc.fused_chain_forward),
                  want, ATOL)


def test_plain_version_matches_xla_twin_at_mimic_width():
    jm, tm = _pair(*MIMIC_CASE)
    data, valid = _inputs(jm.encoders, 16, seed=1)
    fwd = make_xla_chain_forward(jm.encoders, jm.decoders, 50)
    want = fwd(jm.params, tuple(jnp.asarray(d) for d in data),
               jnp.asarray(valid), jm.params["init_state"]["value"][0])
    _assert_close(_port_forward(tm, data, valid), want, ATOL)


# ---------------------------------------------------------------------------
# The plan the kernel reads
# ---------------------------------------------------------------------------

def _act(code, v):
    if code == fc.ACT_CODES["relu"]:
        return np.maximum(v, 0.0)
    if code == fc.ACT_CODES["sigmoid"]:
        return 1.0 / (1.0 + np.exp(-v))
    if code == fc.ACT_CODES["tanh"]:
        return np.tanh(v)
    if code == fc.ACT_CODES["gelu"]:
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (v + 0.044715 * v ** 3)))
    if code == fc.ACT_CODES["softmax"]:
        e = np.exp(v - v.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    assert code == fc.ACT_CODES["identity"]
    return v


def _run_plan(plan, weights, data, valid, init):
    """What csrc/fused_chain.cu computes, read from the same int32 plan and
    flat weight buffer, in float64 numpy."""
    E, D, S, L = plan[:4]
    enc = plan[6:6 + 3 * E].reshape(E, 3)
    dec = plan[6 + 3 * E:6 + 3 * E + 3 * D].reshape(D, 3)
    lay = plan[6 + 3 * E + 3 * D:].reshape(L, 7)
    assert len(weights) == plan[5]

    def run_layers(first, n, x, state):
        prev = None
        for src, K, N, act, w_off, ws_off, b_off in lay[first:first + n]:
            inp = {fc.SRC_DATA: x, fc.SRC_PREV: prev, fc.SRC_STATE: state}[
                src]
            y = inp @ weights[w_off:w_off + K * N].reshape(K, N)
            if ws_off >= 0:
                y = y + state @ weights[ws_off:ws_off + S * N].reshape(S, N)
            prev = _act(act, y + weights[b_off:b_off + N])
        return prev

    state = np.broadcast_to(init, (data[0].shape[0], S))
    states = [state]
    for e, (first, n, F) in enumerate(enc):
        assert data[e].shape[1] == F
        new = run_layers(first, n, data[e], state)
        state = np.where(valid[:, e:e + 1] > 0, new, state)
        states.append(state)
    outs = [np.stack([run_layers(first, n, None, s) for s in states])
            for first, n, _c in dec]
    return np.stack(states), outs


@pytest.mark.parametrize("case", sorted(ALL_CASES))
def test_kernel_plan_reproduces_plain_version(case):
    S, make_enc, make_dec = ALL_CASES[case]
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0, seed=3,
                   device="cpu")
    data, valid = _inputs(tm.encoders, 9, seed=2)
    spec = fc.ChainSpec(tm.encoders, tm.decoders, S)
    weights = spec.flatten_params(tm.params).double().numpy()
    init = tm.params["init_state"]["value"][0].double().numpy()
    want = _port_forward(tm, data, valid)
    _assert_close(_run_plan(spec.plan, weights,
                            [d.astype(np.float64) for d in data], valid,
                            init), want, ATOL)


def test_mimic_plan_sizes():
    S, make_enc, make_dec = MIMIC_CASE
    spec = fc.ChainSpec(make_enc(tenc), make_dec(tdec), S)
    # 4 encoders x 3 layers + 2 decoders x 3 layers; header + records.
    assert len(spec.layers) == 18
    assert len(spec.plan) == 6 + 3 * 4 + 3 * 2 + 7 * 18
    assert spec.n_weights == 83692          # ~335 KB of fp32 weights
    assert spec.hidden_width == 50
    assert spec.shared_bytes <= fc.MAX_SHARED_BYTES


def test_chain_spec_rejects_other_encoders():
    class Recurrent(MultiModEncoder):
        def init(self, generator, device=None):
            return {}

        def apply(self, params, state, x):
            return state

    with pytest.raises(TypeError, match="MLP-family"):
        fc.ChainSpec([Recurrent(4, 3)], [tdec.LogisticDecoder(4)], 4)


def test_flatten_params_rejects_mismatched_trees():
    tm = MultiModN(8, [tenc.MLPEncoder(8, 5, (4,))],
                   [tdec.LogisticDecoder(8)], 1.0, 0.0, device="cpu")
    spec = fc.ChainSpec(tm.encoders, tm.decoders, 8)
    params = dict(tm.params, decoders=[])
    with pytest.raises(ValueError, match="dense layers"):
        spec.flatten_params(params)


def test_wrapper_input_checks():
    """What the wrapper checks before a CUDA launch, on CPU tensors."""
    tm = MultiModN(8, [tenc.MLPEncoder(8, 5, (4,))],
                   [tdec.LogisticDecoder(8)], 1.0, 0.0, device="cpu")
    spec = fc.ChainSpec(tm.encoders, tm.decoders, 8)
    w = spec.flatten_params(tm.params)
    data, valid, init = [torch.zeros(3, 5)], torch.ones(3, 1), torch.zeros(8)
    fc._check_inputs(spec, w, data, valid, init)
    with pytest.raises(TypeError, match="float32"):
        fc._check_inputs(spec, w, [data[0].double()], valid, init)
    with pytest.raises(ValueError, match="shape"):
        fc._check_inputs(spec, w, [torch.zeros(3, 6)], valid, init)
    with pytest.raises(ValueError, match="contiguous"):
        fc._check_inputs(spec, w, [torch.zeros(5, 3).t()], valid, init)
    with pytest.raises(ValueError, match="modality arrays"):
        fc._check_inputs(spec, w, data * 2, valid, init)


def test_wrapper_refuses_other_devices():
    tm = MultiModN(8, [tenc.MLPEncoder(8, 5, (4,))],
                   [tdec.LogisticDecoder(8)], 1.0, 0.0, device="cpu")
    spec = fc.ChainSpec(tm.encoders, tm.decoders, 8)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fc.fused_chain_forward(spec, tm.params, [torch.zeros(3, 5,
                                                             device=meta)],
                               torch.ones(3, 1, device=meta),
                               torch.zeros(8, device=meta))
