"""The port's serving slice against the JAX package, at the MIMIC shape.

A JAX ``MultiModN`` (the MIMIC multi-task model of
``pipelines/mimic/common.py``) is exported with the JAX ``export_model`` and
loaded with the port's ``load_model`` on the CPU; both then answer the same
requests, with NaN rows in some modalities.

Tolerance: XLA's and PyTorch's CPU matrix products sum in different orders
(fp32, K <= 1074), ~1e-7 relative per product; atol 1e-5 covers 4 chained
encoders and 3 decoder layers. NaN positions must agree exactly (quirk #9).
"""
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc

ATOL = 1e-5
S, WIDTHS, B = 50, (10, 1024, 768, 99), 16


def _jax_mimic(seed=0, **kw):
    return jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, (32, 32), dropout=0.2)
            for w in WIDTHS],
        [jdec.MLPDecoder(S, (32, 32), 2) for _ in range(2)], 1.0, 0.0,
        seed=seed, **kw)


def _requests(n=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = [rng.normal(size=(B, w)).astype(np.float32) for w in WIDTHS]
        x[1][[2, 9]] = np.nan            # whole rows missing
        x[3][5, 4] = np.nan              # one missing entry
        x[0][[2, 11]] = np.nan
        out.append(x)
    return out


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jm = _jax_mimic()
    path = str(tmp_path_factory.mktemp("mimic_export"))
    jmm.export_model(jm, path)
    return jm, path


@pytest.fixture()
def pair(exported):
    jm, path = exported
    return jm, tmm.load_model(path, device="cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_load_model_restores_jax_weights(pair):
    jm, tm = pair
    want, got = jm.state_dict(), tm.state_dict()
    for wl, gl in zip(want["encoders"][1]["layers"],
                      got["encoders"][1]["layers"]):
        np.testing.assert_array_equal(gl["w"], wl["w"])
        np.testing.assert_array_equal(gl["b"], wl["b"])
    np.testing.assert_array_equal(got["init_state"]["value"],
                                  want["init_state"]["value"])
    assert tm.state_change_penalty == jm.state_change_penalty
    assert [type(e).__name__ for e in tm.encoders] == \
        ["MIMICMLPEncoder"] * 4
    assert tm.encoders[0].dropout_rate == 0.2


def test_fused_forward_matches_jax(pair):
    jm, tm = pair
    x = _requests(1)[0]
    want_states, want_outs = jm.fused_forward(x, use_interpret=True)
    states, outs = tm.fused_forward(x)
    _close(states, want_states)
    for o, w in zip(outs, want_outs):
        _close(o, w)
    # A skipped sample keeps its state for that step.
    np.testing.assert_array_equal(states[2, 2].numpy(), states[1, 2].numpy())


def test_predict_and_proba_match_jax_with_nan_propagation(pair):
    jm, tm = pair
    x = _requests(1, seed=1)[0]
    want = jm.predict_proba(x)
    got = tm.predict_proba(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.isnan(g).any()          # quirk #9: NaN flows, no skip
        _close(g, w)
    np.testing.assert_array_equal(tm.predict(x), jm.predict(x))


@pytest.mark.parametrize("nan_skip", [None, True, False])
def test_inference_session_matches_jax(pair, nan_skip):
    jm, tm = pair
    x = _requests(1, seed=2)[0]
    js, ts = jmm.InferenceSession(jm), tmm.InferenceSession(tm)
    jstate, tstate = js.init(B), ts.init(B)
    for w, g in zip(js.decode(jstate), ts.decode(tstate)):
        _close(g, w)
    for e in range(len(WIDTHS)):
        jstate, jprobs = js.step(jstate, e, x[e], nan_skip=nan_skip)
        tstate, tprobs = ts.step(tstate, e, x[e], nan_skip=nan_skip)
        _close(tstate, jstate)
        for g, w in zip(tprobs, jprobs):
            _close(g, w)


def test_inference_session_batch_mode_matches_jax(exported):
    jm, path = exported
    jb = jmm.load_model(path)
    jb.nan_skip = "batch"
    tb = tmm.load_model(path, device="cpu")
    tb.nan_skip = "batch"
    x = _requests(1, seed=3)[0]
    js, ts = jmm.InferenceSession(jb), tmm.InferenceSession(tb)
    jstate, tstate = js.init(B), ts.init(B)
    for e in range(len(WIDTHS)):
        jstate, _ = js.step(jstate, e, x[e])
        tstate, _ = ts.step(tstate, e, x[e])
        _close(tstate, jstate)


def test_session_steps_reproduce_fused_forward_rows(pair):
    _jm, tm = pair
    x = _requests(1, seed=4)[0]
    states, outs = tm.fused_forward(x)
    session = tmm.InferenceSession(tm)
    state = session.init(B)
    for e in range(len(WIDTHS)):
        state, probs = session.step(state, e, x[e])
        _close(state, states[e + 1])
        for p, o in zip(probs, outs):
            _close(p, o[e + 1])


def _static_pair(tmp_path):
    bank = np.random.default_rng(7).normal(size=(3, 6)).astype(np.float32)
    jm = jmm.MultiModN(
        6, [jenc.MLPEncoder(6, 4, (5,)), jenc.MIMICMLPEncoder(6, 3, (5,))],
        [jdec.LogisticDecoder(6)], 1.0, 0.0,
        init_state=jmm.StaticInitState(list(bank)))
    jmm.export_model(jm, str(tmp_path))
    return jm, tmm.load_model(str(tmp_path), device="cpu")


def test_static_init_state_cycle_carries_across_predict_calls(tmp_path):
    jm, tm = _static_pair(tmp_path)
    rng = np.random.default_rng(8)
    for n in (5, 4, 7):
        x = [rng.normal(size=(n, 4)).astype(np.float32),
             rng.normal(size=(n, 3)).astype(np.float32)]
        for g, w in zip(tm.predict_proba(x), jm.predict_proba(x)):
            _close(g, w)
        assert tm._cycle_offset == jm._cycle_offset
    with pytest.raises(NotImplementedError, match="ONE initial-state row"):
        tm.fused_forward(x)


def test_scan_stacked_export_loads(tmp_path):
    """A JAX model with scan-stacked encoder storage (leading (E,) axis)
    unstacks into the port's per-encoder parameters."""
    jm = jmm.MultiModN(
        6, [jenc.MIMICMLPEncoder(6, 4, (5,), dropout=0.0) for _ in range(3)],
        [jdec.MLPDecoder(6, (5,), 2)], 1.0, 0.0, chain_mode="scan")
    assert isinstance(jm.params["encoders"], dict)
    jmm.export_model(jm, str(tmp_path))
    tm = tmm.load_model(str(tmp_path), device="cpu")
    x = [np.random.default_rng(9).normal(size=(5, 4)).astype(np.float32)
         for _ in range(3)]
    for g, w in zip(tm.predict_proba(x), jm.predict_proba(x)):
        _close(g, w)


def test_port_export_loads_in_jax(tmp_path):
    tm = tmm.MultiModN(
        6, [tenc.MLPEncoder(6, 4, (5,), "gelu"),
            tenc.MLPFeatureEncoder(6, 3, "tanh")],
        [tdec.ClassDecoder(6, 3, "softmax"), tdec.LogisticDecoder(6)],
        0.5, 2.0, nan_skip="batch", seed=3, device="cpu")
    tmm.export_model(tm, str(tmp_path))
    jm = jmm.load_model(str(tmp_path))
    assert jm.nan_skip == "batch" and jm.state_change_penalty == \
        pytest.approx(tm.state_change_penalty)
    rng = np.random.default_rng(10)
    x = [rng.normal(size=(5, 4)).astype(np.float32),
         rng.normal(size=(5, 1)).astype(np.float32)]
    for g, w in zip(tm.predict_proba(x), jm.predict_proba(x)):
        _close(g, w)
    back = tmm.load_model(str(tmp_path), device="cpu")
    for g, w in zip(back.predict_proba(x), tm.predict_proba(x)):
        np.testing.assert_array_equal(g, w)


def test_load_model_rejects_unported_classes(tmp_path):
    jm = jmm.MultiModN(4, [jenc.RNNEncoder(4, 6, (5,))],
                       [jdec.LogisticDecoder(4)], 1.0, 0.0)
    jmm.export_model(jm, str(tmp_path))
    with pytest.raises(NotImplementedError, match="RNNEncoder"):
        tmm.load_model(str(tmp_path), device="cpu")


def test_state_dict_round_trips_through_jax(pair):
    jm, tm = pair
    jm2 = _jax_mimic(seed=5)
    jm2.load_state_dict(tm.state_dict())
    x = _requests(1, seed=6)[0]
    for g, w in zip(tm.predict_proba(x), jm2.predict_proba(x)):
        _close(g, w)


def test_model_checks_match_jax():
    enc = [tenc.MLPEncoder(4, 3)]
    with pytest.raises(ValueError, match="state_size"):
        tmm.MultiModN(5, enc, [tdec.LogisticDecoder(5)], 1, 0, device="cpu")
    with pytest.raises(ValueError, match="nan_skip"):
        tmm.MultiModN(4, enc, [], 1, 0, nan_skip="rows", device="cpu")
    with pytest.raises(ValueError, match="presence"):
        tmm.MultiModN(4, enc, [], 1, 0, nan_skip="batch",
                      presence_penalty=0.1, device="cpu")
    m = tmm.MultiModN(4, enc, [], 1, 3, device="cpu")
    assert m.state_change_penalty == pytest.approx(0.03)   # quirk #1
    with pytest.raises(NotImplementedError, match="repeat an encoder"):
        m.predict([np.zeros((2, 3), np.float32)] * 2,
                  encoder_sequence=[0, 0])
