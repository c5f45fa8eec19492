"""Mask-aware encoders under the NaN skip in the port, the seven cases of
``tests/test_mask_aware.py`` over the port's chain forms, each against the
JAX package's chain on the same inputs.

A mask-aware encoder (``_accepts_sample_mask``: ResNet's train-mode
BatchNorm) folds the rows it is shown into batch statistics. Under
``nan_skip='sample'`` a NaN row's state update is discarded, but the encoder
still ran on its ``nan_to_num`` zeros, so those rows must be out of the
statistics the present rows are normalized with: every chain form passes the
encoder the effective mask (real and modality-present rows).

Tolerances: a masked mean of six numbers, added to the state; float32
rounding in either package, rtol 1e-5 against the expected value and atol
1e-6 between the packages (the JAX test's own bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodn_tpu.core import fusion as jfusion
from multimodn_tpu.core import scan_chain as jscan
from multimodn_tpu.core.state import TrainableInitState as JInitState
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core import fusion as tfusion
from multimodn_tpu_torch.core import scan_chain as tscan
from multimodn_tpu_torch.core.state import TrainableInitState
from multimodn_tpu_torch.core.step import make_forward_fn

B, S, F = 6, 3, 2
NAN_ROWS = (0, 3)
PAD_ROWS = (5,)
JAX_ATOL = 1e-6


class BatchStatEncoder:
    """The JAX test's minimal mask-aware encoder, in torch: ``state +
    masked batch-mean(x)``, whose present-row output moves with any row
    wrongly included in the statistics."""

    _accepts_sample_mask = True

    def __init__(self, state_size: int, n_features: int = F):
        self.state_size = state_size
        self.n_features = n_features

    def apply(self, params, state, x, train=False, generator=None,
              sample_mask=None):
        w = torch.ones(x.shape[0]) if sample_mask is None \
            else sample_mask.float()
        mean = (x * w[:, None]).sum() / w.sum().clamp_min(1.0)
        return state + mean


class JaxBatchStatEncoder:
    """The same encoder in JAX (``tests/test_mask_aware.py``)."""

    _accepts_sample_mask = True

    def __init__(self, state_size: int, n_features: int = F):
        self.state_size = state_size
        self.n_features = n_features

    def apply(self, params, state, x, *, train=False, rng=None,
              sample_mask=None):
        w = jnp.ones((x.shape[0],), jnp.float32) if sample_mask is None \
            else sample_mask.astype(jnp.float32)
        return state + jnp.sum(x * w[:, None]) / jnp.maximum(jnp.sum(w), 1.0)


def _setup(nans=True):
    """The JAX test's inputs: rows 0 and 3 missing, row 5 padding; the
    JAX init state transplanted."""
    init = JInitState(S)
    ip = init.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, F)).astype(np.float32)
    if nans:
        x[list(NAN_ROWS), 0] = np.nan
    mask = np.ones((B,), np.float32)
    mask[list(PAD_ROWS)] = 0.0
    state0 = np.asarray(init.apply(ip, B, 0))
    present = [i for i in range(B) if i not in NAN_ROWS + PAD_ROWS]
    clean = np.nan_to_num(x)
    good_mean = float(np.sum(clean[present]) / len(present))
    jparams = {"init_state": ip, "encoders": [{}]}
    tparams = {"init_state": {k: torch.as_tensor(np.array(v))
                              for k, v in ip.items()}, "encoders": [{}]}
    return {"init": init, "tinit": TrainableInitState(S), "x": x,
            "mask": mask, "state0": state0, "good_mean": good_mean,
            "present": present, "jparams": jparams, "tparams": tparams}


def _check(final, c):
    final = np.asarray(final)
    for i in range(B):
        if i in c["present"]:
            np.testing.assert_allclose(final[i], c["state0"][i]
                                       + c["good_mean"], rtol=1e-5,
                                       err_msg=f"present row {i}")
        elif i in NAN_ROWS:
            np.testing.assert_allclose(final[i], c["state0"][i], rtol=1e-6,
                                       err_msg=f"missing row {i} "
                                               "passthrough")


def _run(form, c, nan_skip="sample"):
    """The final state of a one-encoder chain of ``form`` in the port and
    in JAX."""
    t_args = (c["tinit"], c["tparams"], (torch.as_tensor(c["x"]),),
              torch.as_tensor(c["mask"]))
    j_args = (c["init"], c["jparams"], (jnp.asarray(c["x"]),),
              jnp.asarray(c["mask"]))
    tenc_, jenc_ = BatchStatEncoder(S), JaxBatchStatEncoder(S)
    zero_t, zero_j = [0], jnp.zeros((1,), jnp.int32)
    if form == "unrolled":
        t = tfusion.forward_chain([tenc_], *t_args, order=((0, 0),),
                                  nan_skip=nan_skip)
        j = jfusion.forward_chain([jenc_], *j_args, order=((0, 0),),
                                  nan_skip=nan_skip)
    elif form == "executions":
        t = tfusion.forward_chain_executions([tenc_], *t_args,
                                             order=((0, 0),),
                                             nan_skip=nan_skip)
        j = jfusion.forward_chain_executions([jenc_], *j_args,
                                             order=((0, 0),),
                                             nan_skip=nan_skip)
    elif form == "scan":
        t = tscan.forward_chain_scan(tenc_, 1, *t_args, data_order=zero_t,
                                     enc_order=zero_t, nan_skip=nan_skip)
        j = jscan.forward_chain_scan(jenc_, 1, *j_args, data_order=zero_j,
                                     enc_order=zero_j, nan_skip=nan_skip)
    else:
        t = tscan.forward_chain_switch([tenc_], *t_args, data_order=zero_t,
                                       enc_order=zero_t, nan_skip=nan_skip)
        j = jscan.forward_chain_switch([jenc_], *j_args, data_order=zero_j,
                                       enc_order=zero_j, nan_skip=nan_skip)
    final = t[-1].numpy()
    np.testing.assert_allclose(final, np.asarray(j[-1]), rtol=0,
                               atol=JAX_ATOL)
    return final


@pytest.mark.parametrize("form", ["unrolled", "executions", "scan",
                                  "switch"])
def test_chain_excludes_nan_rows_from_batch_stats(form):
    """The four chain forms' cases of the JAX file, one parametrised test:
    present rows advance by the mean over the real, present rows only;
    missing rows keep their state."""
    c = _setup()
    _check(_run(form, c), c)


@pytest.mark.parametrize("form", ["unrolled", "executions"])
def test_batch_mode_discards_whole_step(form):
    """Batch granularity: one NaN anywhere skips the step for every row."""
    c = _setup()
    np.testing.assert_allclose(_run(form, c, "batch"), c["state0"],
                               rtol=1e-6)


def test_padded_rows_still_excluded_without_nans():
    """With no NaN the effective mask is the sample mask: only padding is
    left out."""
    c = _setup(nans=False)
    final = _run("unrolled", c)
    real = [i for i in range(B) if i not in PAD_ROWS]
    mean_real = float(np.sum(c["x"][real]) / len(real))
    np.testing.assert_allclose(final[real[0]], c["state0"][real[0]]
                               + mean_real, rtol=1e-5)


def test_nan_skip_none_passes_the_sample_mask():
    """``nan_skip='none'`` (``predict``'s mode) hands the encoder the
    sample mask itself: padding out, NaN rows in (their NaN reaches every
    row's mean, as in JAX)."""
    c = _setup()
    final = _run("unrolled", c, "none")
    assert np.isnan(final).all()
    c = _setup(nans=False)
    seen = []

    class Recorder(BatchStatEncoder):
        def apply(self, params, state, x, train=False, generator=None,
                  sample_mask=None):
            seen.append(sample_mask)
            return super().apply(params, state, x, train, generator,
                                 sample_mask)

    tfusion.forward_chain([Recorder(S)], c["tinit"], c["tparams"],
                          (torch.as_tensor(c["x"]),),
                          torch.as_tensor(c["mask"]), order=((0, 0),),
                          nan_skip="none")
    assert torch.equal(seen[0], torch.as_tensor(c["mask"]))


def test_encoders_without_the_flag_get_no_mask():
    """An encoder without ``_accepts_sample_mask`` is called as before,
    without a ``sample_mask`` argument (the MLP family's ``apply`` takes
    none)."""
    c = _setup()
    enc = tenc.MLPEncoder(S, F, (4,))
    params = dict(c["tparams"], encoders=[enc.init(
        torch.Generator().manual_seed(0))])
    *_, final = tfusion.forward_chain(
        [enc], c["tinit"], params, (torch.as_tensor(c["x"]),),
        torch.as_tensor(c["mask"]), order=((0, 0),), nan_skip="sample")
    assert torch.isfinite(final).all()


def test_forward_fn_repeated_skipped_rows_hold_initial_state():
    """``make_forward_fn``'s repeated-encoder branch: rows whose every
    execution was skipped hold the initial state, not zeros."""
    model = tmm.MultiModN(S, [tenc.MLPFeatureEncoder(S, 4)],
                          [tdec.LogisticDecoder(S)], 0.7, 0.3, device="cpu")
    fwd = make_forward_fn(model.encoders, model.decoders, model.init_state,
                          ((0, 0), (0, 0)), nan_skip="batch")
    x = torch.ones((4, 1))
    x[1, 0] = float("nan")
    _preds, _outputs, states, final = fwd(model.params, (x,), torch.ones(4))
    state0 = model.init_state.apply(model.params["init_state"], 4, 0)
    assert torch.equal(states[1], state0) and torch.equal(final, state0)
