"""The port's encoding-order core against the JAX package on the CPU: the
traced chains (``core/scan_chain.py``), executions and
``combine_executions`` for static orders that repeat an encoder, the batch
loss and its gradients on such orders, the repeated-order forward, the
chain plan and every guard.

Inputs come from a seeded numpy generator with NaN cells and padded rows;
JAX weights are transplanted (``params_from_jax``); dropout is 0. XLA's and
PyTorch's CPU matrix products sum in different orders (~1e-7 relative per
product), so forward values and grids agree to atol 1e-6 at these widths,
losses and every gradient leaf to atol 1e-5; counts must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.core import fusion as jfusion
from multimodn_tpu.core import scan_chain as jscan
from multimodn_tpu.core import step as jstep
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core import fusion as tfusion
from multimodn_tpu_torch.core import scan_chain as tscan
from multimodn_tpu_torch.core import step as tstep
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset

FWD_ATOL = 1e-6
GRAD_ATOL = 1e-5
S = 4
NAMES = ("states", "state_change", "row_ok", "n_counted", "final")


def _close(got, want, atol=FWD_ATOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=name)


def _batch(widths, B=10, n_real=8, seed=0, nan=True):
    """Per-modality (B, F) arrays with NaN cells in real rows and a mask
    whose last ``B - n_real`` rows are padding."""
    rng = np.random.default_rng(seed)
    data = [rng.normal(size=(B, w)).astype(np.float32) for w in widths]
    if nan:
        for x in data:
            x[rng.random(B) < 0.3, rng.integers(x.shape[1])] = np.nan
    mask = (np.arange(B) < n_real).astype(np.float32)
    return data, mask


def _pair(jencs, tencs, decs=None, seed=1, **kw):
    """A JAX model and the port's twin encoders, init state and decoders
    with the JAX weights (per-encoder storage)."""
    jm = jmm.MultiModN(S, jencs, decs[0] if decs else [], 1.0, 0.5,
                       seed=seed, chain_mode="unrolled", **kw)
    tm = tmm.MultiModN(S, tencs, decs[1] if decs else [], 1.0, 0.5,
                       seed=seed, chain_mode="unrolled", device="cpu", **kw)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _homogeneous(E=5):
    return _pair([jenc.MLPFeatureEncoder(S, 4) for _ in range(E)],
                 [tenc.MLPFeatureEncoder(S, 4) for _ in range(E)])


def _heterogeneous():
    """Mixed classes and widths 2, 5, 3: the switch chain pads to 5 and
    cuts to each encoder's width."""
    return _pair([jenc.MLPEncoder(S, 2, (4,)),
                  jenc.MIMICMLPEncoder(S, 5, (4,), dropout=0.0),
                  jenc.MLPEncoder(S, 3, (6,))],
                 [tenc.MLPEncoder(S, 2, (4,)),
                  tenc.MIMICMLPEncoder(S, 5, (4,), dropout=0.0),
                  tenc.MLPEncoder(S, 3, (6,))])


# (data_order, enc_order) per case. The heterogeneous cases pair modalities
# with encoders of other widths on purpose: zero-padding and cutting run.
SCAN_ORDERS = {"permuted": ([0, 1, 2, 3, 4], [3, 0, 4, 1, 2]),
               "shorter": ([4, 1], [0, 3]),
               "repeat": ([0, 1, 2, 3, 4], [1, 0, 0, 3, 3])}
SWITCH_ORDERS = {"permuted": ([0, 1, 2], [2, 0, 1]),
                 "shorter": ([2, 0], [1, 2]),
                 "repeat": ([0, 1, 2], [1, 0, 0])}


@pytest.mark.parametrize("nan_skip", ["sample", "batch", "none"])
@pytest.mark.parametrize("case", sorted(SCAN_ORDERS))
@pytest.mark.parametrize("chain", ["scan", "switch"])
def test_traced_chains_match_jax(chain, case, nan_skip):
    """Every output of ``forward_chain_scan`` / ``forward_chain_switch`` at
    permuted orders, orders shorter than E and a sequence that repeats an
    encoder (last execution wins, unexecuted rows keep the initial
    state)."""
    if chain == "scan":
        jm, tm = _homogeneous()
        widths, (d_ord, e_ord) = [1] * 5, SCAN_ORDERS[case]
    else:
        jm, tm = _heterogeneous()
        widths, (d_ord, e_ord) = [2, 5, 3], SWITCH_ORDERS[case]
    data, mask = _batch(widths, seed=len(case), nan=nan_skip != "none")
    if nan_skip == "batch":
        data[d_ord[-1]][1, 0] = np.nan   # the last step skips every row
    kw = dict(data_order=d_ord, enc_order=e_ord, nan_skip=nan_skip)
    jdata = tuple(jnp.asarray(x) for x in data)
    tdata = tuple(torch.from_numpy(x) for x in data)
    if chain == "scan":
        want = jscan.forward_chain_scan(
            jm.encoders[0], 5, jm.init_state, jm.params, jdata,
            jnp.asarray(mask), data_order=jnp.asarray(d_ord),
            enc_order=jnp.asarray(e_ord), nan_skip=nan_skip)
        got = tscan.forward_chain_scan(tm.encoders[0], 5, tm.init_state,
                                       tm.params, tdata,
                                       torch.from_numpy(mask), **kw)
    else:
        want = jscan.forward_chain_switch(
            jm.encoders, jm.init_state, jm.params, jdata, jnp.asarray(mask),
            data_order=jnp.asarray(d_ord), enc_order=jnp.asarray(e_ord),
            nan_skip=nan_skip)
        got = tscan.forward_chain_switch(tm.encoders, tm.init_state,
                                         tm.params, tdata,
                                         torch.from_numpy(mask), **kw)
    for g, w, name in zip(got, want, NAMES):
        _close(g.numpy(), w, name=name)


def test_homogeneity_matches_jax():
    cases = [
        lambda m: [m.MLPFeatureEncoder(3, 4) for _ in range(3)],
        lambda m: [m.MLPEncoder(3, 2, (4,)), m.MLPEncoder(3, 3, (4,))],
        lambda m: [m.MLPEncoder(3, 2, (4,)), m.MIMICMLPEncoder(3, 2, (4,))],
        lambda m: [m.MIMICMLPEncoder(3, 2, (4,), dropout=0.1),
                   m.MIMICMLPEncoder(3, 2, (4,), dropout=0.2)],
        lambda m: [m.MLPEncoder(3, 2, (4,), activation="relu"),
                   m.MLPEncoder(3, 2, (4,), activation="tanh")],
        lambda m: [m.TransformerEncoder(4, 32, embed_dim=16, n_heads=2,
                                        n_layers=1, chunk=16),
                   m.TransformerEncoder(4, 32, embed_dim=16, n_heads=4,
                                        n_layers=1, chunk=16)],
    ]
    got = [tscan.encoders_homogeneous(c(tenc)) for c in cases]
    want = [jscan.encoders_homogeneous(c(jenc)) for c in cases]
    assert got == want == [True, False, False, False, False, False]


def _repeat_models(nan_skip):
    """Three encoders over widths (4, 6, 4) and a binary and a 3-class
    head; the order runs encoders 0 and 1 twice."""
    hidden = (5,)
    jm, tm = _pair(
        [jenc.MIMICMLPEncoder(S, 4, hidden, dropout=0.0),
         jenc.MIMICMLPEncoder(S, 6, hidden, dropout=0.0),
         jenc.MLPEncoder(S, 4, hidden)],
        [tenc.MIMICMLPEncoder(S, 4, hidden, dropout=0.0),
         tenc.MIMICMLPEncoder(S, 6, hidden, dropout=0.0),
         tenc.MLPEncoder(S, 4, hidden)],
        decs=([jdec.MLPDecoder(S, hidden, 2), jdec.MLPDecoder(S, hidden, 3)],
              [tdec.MLPDecoder(S, hidden, 2), tdec.MLPDecoder(S, hidden, 3)]),
        nan_skip=nan_skip)
    return jm, tm


REPEAT_ORDER = ((0, 0), (1, 1), (2, 0), (0, 2), (1, 1))


def _repeat_batch(nan_skip, seed=3):
    data, mask = _batch((4, 6, 4), B=12, n_real=9, seed=seed,
                        nan=nan_skip == "sample")
    if nan_skip == "batch":
        data[2][4, 1] = np.nan        # execution (2, 0) skips: 0's row keeps
        data[0][10, 0] = np.nan       # a padded row's NaN skips nothing
    targets = np.random.default_rng(seed).integers(0, 2, (12, 2))
    targets[:, 1] = np.random.default_rng(seed + 1).integers(0, 3, 12)
    return data, mask, targets


@pytest.mark.parametrize("nan_skip", ["sample", "batch", "none"])
def test_executions_and_combine_match_jax(nan_skip):
    """Every combined grid: err_loss, n_correct, the four confusion cells
    (NaN for the 3-class head), n_counted, row_ok, outputs, state_change."""
    jm, tm = _repeat_models(nan_skip)
    data, mask, targets = _repeat_batch(nan_skip)
    crit_j = jmm.core.losses.cross_entropy_loss
    crit_t = resolve_criterion(None)
    jx = jfusion.forward_chain_executions(
        jm.encoders, jm.init_state, jm.params,
        tuple(jnp.asarray(x) for x in data), jnp.asarray(mask),
        order=REPEAT_ORDER, nan_skip=nan_skip)
    tx = tfusion.forward_chain_executions(
        tm.encoders, tm.init_state, tm.params,
        tuple(torch.from_numpy(x) for x in data), torch.from_numpy(mask),
        order=REPEAT_ORDER, nan_skip=nan_skip)
    for g, w, name in zip(tx, jx, NAMES):
        _close(g.numpy(), w, name=name)
    jgrid = jfusion.decode_grid(jm.decoders, jm.params, jx[0],
                                jnp.asarray(targets), jnp.asarray(mask),
                                jx[2], crit_j)
    tgrid = tfusion.decode_grid(tm.decoders, tm.params, tx[0],
                                torch.from_numpy(targets),
                                torch.from_numpy(mask), tx[2], crit_t)
    want = jfusion.combine_executions(REPEAT_ORDER, 3, jgrid, jx[1], jx[2],
                                      jx[3], jgrid["outputs"])
    got = tfusion.combine_executions(REPEAT_ORDER, 3, tgrid, tx[1], tx[2],
                                     tx[3], tgrid["outputs"])
    assert sorted(got) == sorted(want)
    for key in ("err_loss", "n_correct", "tp", "tn", "fp", "fn",
                "n_counted", "row_ok", "state_change"):
        _close(got[key].numpy(), want[key], name=key)
    assert np.isnan(got["tp"].numpy()[:, 1][got["row_ok"].numpy() > 0]).all()
    for g, w in zip(got["outputs"], want["outputs"]):
        _close(g.numpy(), w, name="outputs")
    if nan_skip == "batch":
        assert float(got["row_ok"][1]) == 1.0      # (0, 0) ran
        assert float(tx[2][3]) == 0.0               # (2, 0) skipped


@pytest.mark.parametrize("nan_skip", ["sample", "batch", "none"])
def test_repeated_order_loss_and_gradients_match_jax(nan_skip):
    """The batch loss on a static order that repeats encoders (executions
    plus combine) and all its gradient leaves against ``jax.grad``."""
    jm, tm = _repeat_models(nan_skip)
    data, mask, targets = _repeat_batch(nan_skip, seed=5)
    jloss_fn = jm._loss_fn(jmm.core.losses.cross_entropy_loss, REPEAT_ORDER,
                           nan_skip)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jm.params, tuple(jnp.asarray(x) for x in data),
        jnp.asarray(targets), jnp.asarray(mask), jax.random.PRNGKey(0), 0,
        True)
    tloss_fn, shuffles = tm._loss_fn(resolve_criterion(None), REPEAT_ORDER)
    assert not shuffles
    live = tree_map(lambda t: t.detach().requires_grad_(), tm.params)
    tloss, taux = tloss_fn(live, tuple(torch.from_numpy(x) for x in data),
                           torch.from_numpy(targets), torch.from_numpy(mask),
                           None, 0, True)
    tgrads = torch.autograd.grad(tloss, tree_leaves(live),
                                 allow_unused=True)
    _close(tloss.item(), float(jloss), GRAD_ATOL, "loss")
    for key in ("err_loss", "state_change", "n_correct", "tp", "tn", "fp",
                "fn", "n_counted"):
        _close(taux[key].detach().numpy(), jaux[key], name=key)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for a, b in zip(jleaves, tgrads):
        _close(np.zeros(a.shape) if b is None else b.numpy(), a, GRAD_ATOL,
               "grad")
    if nan_skip == "batch":
        _close(taux["enc_gates"].numpy(), jaux["enc_gates"])


def test_repeated_order_predict_and_states_match_jax():
    """``predict_proba`` with a repeated ``encoder_sequence`` (each row the
    encoder's last execution) and ``get_states`` on a loader whose dataset
    repeats an encoder (the model's NaN skip)."""
    jm, tm = _repeat_models("sample")
    data, _, _ = _repeat_batch("none", seed=7)
    seq = [0, 1, 0]
    for g, w in zip(tm.predict_proba(data, encoder_sequence=seq),
                    jm.predict_proba(data, encoder_sequence=seq)):
        _close(g, w)
    np.testing.assert_array_equal(tm.predict(data, encoder_sequence=seq),
                                  jm.predict(data, encoder_sequence=seq))
    X = np.concatenate(_repeat_batch("sample", seed=8)[0], axis=1)
    y = np.zeros((len(X), 2), np.int64)
    jl = JLoader(_SeqDataset(JDataset, X, y, [4, 6, 4], [0, 1, 0]), 5)
    tl = TLoader(_SeqDataset(TDataset, X, y, [4, 6, 4], [0, 1, 0]), 5)
    _close(np.stack(tm.get_states(tl)), np.stack(jm.get_states(jl)))


def _SeqDataset(base, X, y, partitions, seq):
    """``base`` (a PartitionDataset class of either package) whose samples
    all carry ``seq``."""
    class WithSequence(base):
        def __getitem__(self, idx):
            x, t = super().__getitem__(idx)
            return x, t, np.asarray(seq)

        def arrays(self):
            xs, t, _ = super().arrays()
            return xs, t, np.tile(np.asarray(seq), (len(t), 1))

    return WithSequence(X, y, partitions)


def _plan_models(mm, enc, dec, chain_mode, homogeneous, shuffle, E, **kw):
    widths = [3] * E if homogeneous else [3, 4] * (E // 2)
    encs = [enc.MLPEncoder(S, w, (4,)) for w in widths]
    return mm.MultiModN(S, encs, [dec.LogisticDecoder(S)], 1.0, 0.0,
                        shuffle_mode=shuffle, chain_mode=chain_mode, **kw)


@pytest.mark.parametrize("chain_mode", ["auto", "unrolled", "scan",
                                        "switch"])
def test_chain_plan_matches_jax(chain_mode):
    """``_chain_plan`` for every homogeneous x ``shuffle_mode`` x E in
    {4, 16}; ``chain_mode='scan'`` on mixed encoders raises the same
    ``ValueError`` in both constructors."""
    for homogeneous in (True, False):
        for shuffle in (False, True):
            for E in (4, 16):
                args = (chain_mode, homogeneous, shuffle, E)
                if chain_mode == "scan" and not homogeneous:
                    for mm, e, d, kw in ((jmm, jenc, jdec, {}),
                                         (tmm, tenc, tdec,
                                          {"device": "cpu"})):
                        with pytest.raises(ValueError, match="identical"):
                            _plan_models(mm, e, d, *args, **kw)
                    continue
                jm = _plan_models(jmm, jenc, jdec, *args)
                tm = _plan_models(tmm, tenc, tdec, *args, device="cpu")
                assert tm._chain_plan() == jm._chain_plan(), args


def _guard_loaders(seq_rows=None, widths=(3, 3), n=8, batch=4):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    y = rng.integers(0, 2, (n, 1))
    if seq_rows is None:
        return (JLoader(JDataset(X, y, list(widths)), batch),
                TLoader(TDataset(X, y, list(widths)), batch))
    seqs = np.asarray(seq_rows)

    def make(base, loader):
        class PerSample(base):
            def arrays(self):
                xs, t, _ = super().arrays()
                return xs, t, seqs

        return loader(PerSample(X, y, list(widths)), batch)

    return make(JDataset, JLoader), make(TDataset, TLoader)


def _guard_case(name):
    """``(exception, match, call(mm, enc, dec, loaders, kw))`` per guard."""
    def model(mm, enc, dec, kw, encs=None, **more):
        encs = encs or [enc.MLPEncoder(S, 3, (4,)) for _ in range(2)]
        return mm.MultiModN(S, encs, [dec.LogisticDecoder(S)], 1.0, 0.0,
                            **kw, **more)

    def opt(mm):
        return mm.Adam(0.01)

    return {
        "width_mismatch": (
            ValueError, "widths must match", [[1, 0]] * 8, (3, 5),
            lambda mm, e, d, ldr, kw: model(
                mm, e, d, kw, [e.MLPEncoder(S, 3, (4,)),
                               e.MLPEncoder(S, 5, (4,))]).test(ldr)),
        "per_batch_repeats": (
            NotImplementedError, "REPEATED", [[0, 0]] * 4 + [[1, 0]] * 4,
            (3, 3), lambda mm, e, d, ldr, kw: model(mm, e, d, kw)
            .train_epoch(ldr, opt(mm))),
        "mixed_batch": (
            ValueError, "different values across the batch",
            [[0, 1], [1, 0]] * 4, (3, 3),
            lambda mm, e, d, ldr, kw: model(mm, e, d, kw).test(ldr)),
        "penalty_with_shuffle": (
            ValueError, "STATIC modality order", None, (3, 3),
            lambda mm, e, d, ldr, kw: model(
                mm, e, d, kw, shuffle_mode=True, presence_penalty=1.0)
            .train_epoch(ldr, opt(mm))),
        "unrolled_shuffle_in_fit": (
            NotImplementedError, "unrolled chain.s", None, (3, 3),
            lambda mm, e, d, ldr, kw: model(
                mm, e, d, kw, shuffle_mode=True, chain_mode="unrolled")
            .fit(ldr, opt(mm))),
        "repeat_on_switch": (
            ValueError, "REPEATED", [[0, 0]] * 8, (3, 3),
            lambda mm, e, d, ldr, kw: model(mm, e, d, kw,
                                            chain_mode="switch")
            .train_epoch(ldr, opt(mm))),
        "repeat_with_traced_shuffle": (
            NotImplementedError, "REPEATED", [[0, 0]] * 8, (3, 3),
            lambda mm, e, d, ldr, kw: model(mm, e, d, kw, shuffle_mode=True)
            .train_epoch(ldr, opt(mm))),
        "sequence_beside_loader": (
            ValueError, "loader's dataset", None, (3, 3),
            lambda mm, e, d, ldr, kw: model(mm, e, d, kw)
            .predict(ldr, encoder_sequence=[1, 0])),
    }[name]


@pytest.mark.parametrize("name", [
    "width_mismatch", "per_batch_repeats", "mixed_batch",
    "penalty_with_shuffle", "unrolled_shuffle_in_fit", "repeat_on_switch",
    "repeat_with_traced_shuffle", "sequence_beside_loader"])
def test_guards_raise_like_jax(name):
    """Each guard raises the JAX package's exception type."""
    exc, match, rows, widths, call = _guard_case(name)
    jl, tl = _guard_loaders(rows, widths)
    with pytest.raises(exc, match=match):
        call(jmm, jenc, jdec, jl, {})
    with pytest.raises(exc, match=match):
        call(tmm, tenc, tdec, tl, {"device": "cpu"})


def test_loss_routing_guards_match_jax():
    """``make_batch_loss_fn``'s own checks: per-batch orders need a traced
    chain, a traced chain refuses a repeated static order, and the
    presence penalty refuses per-batch orders, in both packages."""
    crit = resolve_criterion(None)
    for make, mod in ((jstep.make_batch_loss_fn, jenc),
                      (tstep.make_batch_loss_fn, tenc)):
        encs = [mod.MLPEncoder(S, 3, (4,)) for _ in range(2)]
        with pytest.raises(ValueError, match="per_batch_seq requires"):
            make(encs, [], None, crit, 1.0, 0.0, ((0, 0), (1, 1)), "sample",
                 chain="unrolled", per_batch_seq=True)
        with pytest.raises(ValueError, match="REPEATED"):
            make(encs, [], None, crit, 1.0, 0.0, ((0, 0), (1, 0)), "sample",
                 chain="scan")
        with pytest.raises(ValueError, match="STATIC modality order"):
            make(encs, [], None, crit, 1.0, 0.0, ((0, 0), (1, 1)), "sample",
                 chain="switch", per_batch_seq=True, presence_penalty=1.0)
