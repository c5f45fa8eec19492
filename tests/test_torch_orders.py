"""The port's encoding orders at the model surface against the JAX package
on the CPU: ``ArrayLoader.batch_sequences``, ``shuffle_mode`` in both
cadences (a fresh order per training batch on the traced chains, fed JAX's
own permutations; once per call on an explicit unrolled chain, from
``random.Random(seed)``), per-batch sequences through ``fit_best`` and
``kfold_fit_best``, export and load both ways, the streaming guard, and a
killed and resumed shuffled fit.

Inputs come from a seeded numpy generator (NaN cells, a padded tail batch);
JAX weights are transplanted with ``load_state_dict``, from JAX's
scan-stacked storage where its chain plan stacks them; dropout is 0 where
the two packages are compared. XLA's and PyTorch's CPU matrix products sum
in different orders (~1e-7 relative), so history rows, selection scores and
``Adam`` parameters after 2-3 epochs agree to atol 1e-5; with ``Adam8bit``
a moment one ulp away may round to the neighbouring 8-bit code, which moves
that element's step by at most ~lr/8 (atol 1e-4 on parameters, as in
``test_torch_training.py``). Counts and best epochs must be equal; resumed
runs must equal uninterrupted ones bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
from multimodn_tpu.data.streaming import StreamingLoader as JStream
from multimodn_tpu.data.streaming import fit_streaming as jfit_streaming
from multimodn_tpu.experiments import kfold_fit_best as jkfold
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import checkpoint as tckpt
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.convert import params_from_jax
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset
from multimodn_tpu_torch.data.streaming import StreamingLoader as TStream
from multimodn_tpu_torch.data.streaming import fit_best_streaming, \
    fit_streaming
from multimodn_tpu_torch.experiments import kfold_fit_best as tkfold

ATOL = 1e-5
ATOL_8BIT_PARAMS = 1e-4
S, HIDDEN = 5, (6,)
ORDER_FOLD = 982451653          # JAX core/step.py:221
HISTORY_FIELDS = ("loss", "accuracy", "sensitivity", "specificity",
                  "balanced_accuracy")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _encoders(mod, kind):
    if kind == "homogeneous":
        return [mod.MIMICMLPEncoder(S, 3, HIDDEN, dropout=0.0)
                for _ in range(4)]
    if kind == "equal_width":       # mixed classes over equal widths
        return [mod.MIMICMLPEncoder(S, 3, HIDDEN, dropout=0.0),
                mod.MLPEncoder(S, 3, HIDDEN),
                mod.MIMICMLPEncoder(S, 3, (4,), dropout=0.0)]
    return [mod.MIMICMLPEncoder(S, 3, HIDDEN, dropout=0.0),
            mod.MLPEncoder(S, 5, HIDDEN),
            mod.MIMICMLPEncoder(S, 4, HIDDEN, dropout=0.0)]


WIDTHS = {"homogeneous": (3, 3, 3, 3), "equal_width": (3, 3, 3),
          "heterogeneous": (3, 5, 4)}


def _models(kind, seed=3, **kw):
    jm = jmm.MultiModN(S, _encoders(jenc, kind),
                       [jdec.MLPDecoder(S, HIDDEN, 2) for _ in range(2)],
                       1.0, 0.5, seed=seed, **kw)
    tm = tmm.MultiModN(S, _encoders(tenc, kind),
                       [tdec.MLPDecoder(S, HIDDEN, 2) for _ in range(2)],
                       1.0, 0.5, seed=seed, device="cpu", **kw)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _data(n, widths, seed=0, missing=0.25):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    y = np.stack([X[:, :2].sum(1) > 0, X[:, -2:].sum(1) > 0], 1) \
        .astype(np.int64)
    off = np.cumsum((0,) + tuple(widths[:-1]))
    for o, w in zip(off, widths):
        X[rng.random(n) < missing, o:o + w] = np.nan
    return X, y


def _with_sequences(base, seqs):
    """``base`` (either package's PartitionDataset) whose sample i carries
    ``seqs[i]``."""
    class Sequenced(base):
        def __getitem__(self, idx):
            x, t = super().__getitem__(idx)
            return x, t, np.asarray(seqs[idx])

        def arrays(self):
            xs, t, _ = super().arrays()
            return xs, t, np.asarray(seqs)

    return Sequenced


def _loaders(X, y, widths, batch=16, seqs=None, **kw):
    jd, td = (JDataset, TDataset) if seqs is None else \
        (_with_sequences(JDataset, seqs), _with_sequences(TDataset, seqs))
    return (JLoader(jd(X, y, list(widths)), batch, **kw),
            TLoader(td(X, y, list(widths)), batch, **kw))


def _batch_seq_rows(n, batch, L, seed):
    """One permutation of 0..L-1 per batch, repeated on its rows."""
    rng = np.random.default_rng(seed)
    per_batch = [rng.permutation(L) for _ in range(-(-n // batch))]
    return np.stack([per_batch[i // batch] for i in range(n)])


def _jax_perms(seed, counter, n_batches, L, epochs=1, fused=False):
    """The permutations JAX's traced chains draw: ``fold_in(batch_rng,
    982451653)`` with ``batch_rng = fold_in(erng, b)``; ``erng`` is the
    epoch key ``fold_in(PRNGKey(seed), counter)`` in ``train_epoch``, and
    ``fold_in(fold_in(PRNGKey(seed), counter), eid)`` in the fused fit
    programs. Returns ``{absolute epoch: [perm per batch]}``."""
    out = {}
    for e in range(epochs):
        if fused:
            erng = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed), counter), e)
        else:
            erng = jax.random.fold_in(jax.random.PRNGKey(seed), counter + e)
        out[counter + e] = [np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(erng, b), ORDER_FOLD), L))
            for b in range(n_batches)]
    return out


def _inject(tm, perms):
    """Feed ``perms`` ({absolute epoch: [perm per batch]}) to the port's
    training passes instead of its own draws."""
    tm._order_perms = lambda epoch, length: iter(perms[epoch])


def _params_close(jm, tm, atol):
    want = tree_leaves(params_from_jax(jm.state_dict(), "cpu"))
    got = tree_leaves(tm.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), atol)


def _histories_close(jh, th, tags):
    for tag in tags:
        for field in HISTORY_FIELDS:
            _close(np.stack(getattr(th, field)[tag]),
                   np.stack(getattr(jh, field)[tag]))
    _close(np.stack(th.state_change_loss), np.stack(jh.state_change_loss))


def test_batch_sequences_match_jax():
    """Per-batch rows over each batch's real rows (padded tail included),
    the reference's error for a batch that mixes sequences, batch size 1 as
    its escape, and a reshuffle that regroups the rows."""
    X, y = _data(10, (3, 3), missing=0.0)
    rows = _batch_seq_rows(10, 4, 2, seed=1)
    jl, tl = _loaders(X, y, (3, 3), batch=4, seqs=rows)
    np.testing.assert_array_equal(tl.batch_sequences(), jl.batch_sequences())
    assert tl.batch_sequences().shape == (3, 2)
    mixed = rows.copy()
    mixed[1] = mixed[1][::-1]
    for ldr in _loaders(X, y, (3, 3), batch=4, seqs=mixed):
        with pytest.raises(ValueError, match="different values across"):
            ldr.batch_sequences()
    jl1, tl1 = _loaders(X, y, (3, 3), batch=1, seqs=mixed)
    np.testing.assert_array_equal(tl1.batch_sequences(),
                                  jl1.batch_sequences())
    uniform = _loaders(X, y, (3, 3), batch=4, seqs=np.tile([1, 0], (10, 1)))
    assert [ldr.batch_sequences() for ldr in uniform] == [None, None]
    shuffled = _loaders(X, y, (3, 3), batch=1, seqs=mixed, shuffle=True)[1]
    before = shuffled.batch_sequences().copy()
    shuffled.reshuffle()
    np.testing.assert_array_equal(shuffled.batch_sequences(),
                                  mixed[shuffled._order])
    assert not np.array_equal(before, shuffled.batch_sequences())


@pytest.mark.parametrize("opt", ["Adam", "Adam8bit"])
@pytest.mark.parametrize("kind", ["homogeneous", "heterogeneous"])
def test_per_batch_shuffle_trajectory_matches_jax(kind, opt):
    """Two epochs of ``train_epoch`` with ``shuffle_mode`` on the traced
    chain (scan for identical encoders, switch otherwise), JAX's
    permutations fed to the port: history rows and parameters."""
    jm, tm = _models(kind, shuffle_mode=True)
    assert tm._chain_plan() == jm._chain_plan() == (
        "scan" if kind == "homogeneous" else "switch", True)
    widths = WIDTHS[kind]
    X, y = _data(40, widths, seed=1)
    jl, tl = _loaders(X, y, widths)
    _inject(tm, _jax_perms(3, 0, jl.n_batches, len(widths), epochs=2))
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    jopt, topt = getattr(jmm, opt)(0.01), getattr(tmm, opt)(0.01)
    for _ in range(2):
        jm.train_epoch(jl, jopt, "cross_entropy", jh)
        tm.train_epoch(tl, topt, "cross_entropy", th)
    _histories_close(jh, th, ["train"])
    _params_close(jm, tm, ATOL if opt == "Adam" else ATOL_8BIT_PARAMS)


def test_per_batch_shuffle_draws_from_the_epoch():
    """Without injection the port draws one permutation per batch from a
    generator keyed on the seed and the absolute epoch: the same on a
    second model, different across batches and epochs."""
    a, b = (_models("homogeneous", shuffle_mode=True)[1] for _ in range(2))
    draws = [[p.tolist() for p, _ in zip(m._order_perms(e, 4), range(6))]
             for m in (a, b) for e in (0, 1)]
    assert draws[:2] == draws[2:]
    assert len({tuple(p) for p in draws[0] + draws[1]}) > 3
    X, y = _data(40, WIDTHS["homogeneous"], seed=2)
    tl = _loaders(X, y, WIDTHS["homogeneous"])[1]
    for m in (a, b):
        m.train_epoch(tl, tmm.Adam(0.01))
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)


def test_per_call_shuffle_matches_jax():
    """An explicit ``chain_mode='unrolled'`` shuffles once per call from
    ``random.Random(seed)``: the port draws JAX's orders, and three
    ``train_epoch`` calls give JAX's history rows and parameters."""
    jm, tm = _models("heterogeneous", shuffle_mode=True,
                     chain_mode="unrolled")
    X, y = _data(40, WIDTHS["heterogeneous"], seed=3)
    jl, tl = _loaders(X, y, WIDTHS["heterogeneous"])
    state = jm._shuffle_rng.getstate()
    orders = [tm._resolve_order(tl, train=True) for _ in range(3)]
    assert orders == [jm._resolve_order(jl, train=True) for _ in range(3)]
    assert len(set(orders)) > 1
    jm._shuffle_rng.setstate(state)
    tm._shuffle_rng.setstate(state)
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    jopt, topt = jmm.Adam(0.01), tmm.Adam(0.01)
    for _ in range(3):
        jm.train_epoch(jl, jopt, "cross_entropy", jh)
        tm.train_epoch(tl, topt, "cross_entropy", th)
    assert tm._shuffle_rng.getstate() == jm._shuffle_rng.getstate()
    _histories_close(jh, th, ["train"])
    _params_close(jm, tm, ATOL)


def test_sequences_through_fit_best_match_jax():
    """Per-batch train sequences and a different uniform val order run
    through ``fit_best`` (the switch chain, each loader its own order):
    selection scores, best epoch, history rows and parameters."""
    jm, tm = _models("equal_width")
    widths = WIDTHS["equal_width"]
    X, y = _data(48, widths, seed=4)
    jl, tl = _loaders(X, y, widths, seqs=_batch_seq_rows(48, 16, 3, 5))
    Xv, yv = _data(20, widths, seed=6)
    jv, tv = _loaders(Xv, yv, widths, seqs=np.tile([2, 0, 1], (20, 1)))
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    want = jm.fit_best(jl, jmm.Adam(0.01), epochs=3, val_loader=jv,
                       history=jh)
    got = tm.fit_best(tl, tmm.Adam(0.01), epochs=3, val_loader=tv,
                      history=th)
    _close(got["scores"], want["scores"])
    assert got["best_epoch"] == want["best_epoch"]
    _histories_close(jh, th, ["train", "val"])
    _params_close(jm, tm, ATOL)


def _fold_loaders(kind, seqs):
    widths = WIDTHS[kind]
    folds = ([], [])
    for f in range(2):
        X, y = _data(32, widths, seed=10 + f)
        Xv, yv = _data(16, widths, seed=20 + f)
        rows = _batch_seq_rows(32, 16, len(widths), 30 + f) if seqs \
            else None
        tr = _loaders(X, y, widths, seqs=rows)
        va = _loaders(Xv, yv, widths)
        folds[0].append((tr[0], va[0]))
        folds[1].append((tr[1], va[1]))
    return folds


@pytest.mark.parametrize("case", ["shuffle", "sequences"])
def test_kfold_orders_match_jax(case):
    """``kfold_fit_best`` runs every fold with ``shuffle_mode`` (each fold
    fed the permutations JAX's vmapped program draws for its seed) and
    with per-batch sequences: per-fold scores, best epochs, parameters."""
    shuffle = case == "shuffle"
    kind = "homogeneous" if shuffle else "equal_width"
    jfolds, tfolds = _fold_loaders(kind, seqs=not shuffle)

    def jfactory(seed):
        return _models(kind, seed=seed, shuffle_mode=shuffle)[0]

    def tfactory(seed):
        tm = _models(kind, seed=seed, shuffle_mode=shuffle)[1]
        if shuffle:
            _inject(tm, _jax_perms(seed, 0, 2, 4, epochs=2, fused=True))
        return tm

    want = jkfold(jfactory, jfolds, jmm.Adam(0.01), epochs=2)
    got = tkfold(tfactory, tfolds, tmm.Adam(0.01), epochs=2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g["scores"], w["scores"])
        assert g["best_epoch"] == w["best_epoch"]
        _params_close(w["model"], g["model"], ATOL)


def test_kfold_refuses_the_per_call_cadence_like_jax():
    jfolds, tfolds = _fold_loaders("heterogeneous", seqs=False)
    for kfold, folds, mm, kw in ((jkfold, jfolds, jmm, {}),
                                 (tkfold, tfolds, tmm, {"device": "cpu"})):
        enc = jenc if mm is jmm else tenc
        dec = jdec if mm is jmm else tdec

        def factory(seed, mm=mm, enc=enc, dec=dec, kw=kw):
            return mm.MultiModN(S, _encoders(enc, "heterogeneous"),
                                [dec.MLPDecoder(S, HIDDEN, 2)] * 2, 1.0,
                                0.5, seed=seed, shuffle_mode=True,
                                chain_mode="unrolled", **kw)

        with pytest.raises(NotImplementedError, match="per batch|in-program"):
            kfold(factory, folds, mm.Adam(0.01))


def test_export_round_trips_keep_the_order_options(tmp_path):
    """Both ways: ``chain_mode``, ``shuffle_mode`` and ``scan_unroll``
    survive, and the loaded model answers as the exported one. A port
    model whose plan is the scan chain exports JAX's stacked storage."""
    _, tm = _models("homogeneous", shuffle_mode=True, scan_unroll=4)
    tmm.export_model(tm, str(tmp_path / "t"))
    jm = jmm.load_model(str(tmp_path / "t"))
    assert isinstance(jm.params["encoders"], dict)
    jm2, _ = _models("heterogeneous", shuffle_mode=True, chain_mode="switch",
                     scan_unroll=2)
    jmm.export_model(jm2, str(tmp_path / "j"))
    tm2 = tmm.load_model(str(tmp_path / "j"), device="cpu")
    for src, dst in ((tm, jm), (jm2, tm2)):
        for attr in ("chain_mode", "shuffle_mode", "scan_unroll"):
            assert getattr(dst, attr) == getattr(src, attr), attr
        assert dst._chain_plan() == src._chain_plan()
    for kind, src, dst in (("homogeneous", tm, jm),
                           ("heterogeneous", jm2, tm2)):
        X, _ = _data(6, WIDTHS[kind], seed=7, missing=0.0)
        x = np.split(X, np.cumsum(WIDTHS[kind])[:-1], axis=1)
        for g, w in zip(dst.predict_proba(x), src.predict_proba(x)):
            _close(g, w)


def test_jax_scan_stacked_export_loads_predicts_and_trains(tmp_path):
    """A 16-encoder featurewise JAX model (auto plan: the scan chain,
    stacked storage) loads into the port, predicts, and trains an epoch of
    ``Adam`` to JAX's parameters."""
    jm = jmm.MultiModN(S, [jenc.MLPFeatureEncoder(S, 4) for _ in range(16)],
                       [jdec.MLPDecoder(S, HIDDEN, 2)], 1.0, 0.5, seed=2)
    assert jm._chain_plan() == ("scan", False)
    assert isinstance(jm.params["encoders"], dict)
    jmm.export_model(jm, str(tmp_path))
    tm = tmm.load_model(str(tmp_path), device="cpu")
    assert tm._chain_plan() == ("scan", False)
    X, y = _data(24, (1,) * 16, seed=8, missing=0.2)
    x = np.split(X, 16, axis=1)
    for g, w in zip(tm.predict_proba(x), jm.predict_proba(x)):
        _close(g, w)
    jl, tl = _loaders(X, y[:, :1], (1,) * 16, batch=8)
    jm.train_epoch(jl, jmm.Adam(0.01))
    tm.train_epoch(tl, tmm.Adam(0.01))
    _params_close(jm, tm, ATOL)


def test_streaming_per_call_shuffle_and_guard_match_jax():
    """``fit_streaming`` draws an order per epoch on the unrolled chain,
    with JAX's history rows; ``fit_best_streaming`` refuses that cadence,
    as JAX's does."""
    jm, tm = _models("heterogeneous", shuffle_mode=True,
                     chain_mode="unrolled")
    widths = WIDTHS["heterogeneous"]
    X, y = _data(40, widths, seed=9)
    Xv, yv = _data(16, widths, seed=10)
    jsl = JStream(JDataset(X, y, list(widths)), 16)
    tsl = TStream(TDataset(X, y, list(widths)), 16)
    jvl = JStream(JDataset(Xv, yv, list(widths)), 16)
    tvl = TStream(TDataset(Xv, yv, list(widths)), 16)
    jh, th = jmm.MultiModNHistory(["a", "b"]), tmm.MultiModNHistory(
        ["a", "b"])
    jfit_streaming(jm, jsl, jmm.Adam(0.01), epochs=2, history=jh,
                   val_loader=jvl)
    fit_streaming(tm, tsl, tmm.Adam(0.01), epochs=2, history=th,
                  val_loader=tvl)
    _histories_close(jh, th, ["train", "val"])
    with pytest.raises(NotImplementedError, match="unrolled chain"):
        fit_best_streaming(tm, tsl, tmm.Adam(0.01), epochs=1,
                           val_loader=tvl)
    from multimodn_tpu.data.streaming import fit_best_streaming as jfbs
    with pytest.raises(NotImplementedError, match="unrolled chain"):
        jfbs(jm, jsl, jmm.Adam(0.01), epochs=1, val_loader=jvl)


class _Killed(Exception):
    pass


def _kill_after_first(done, _total):
    raise _Killed(done)


def _equal_states(a, b):
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)
    for p, q in zip(tree_leaves(a.opt_state), tree_leaves(b.opt_state)):
        assert torch.equal(p.view(torch.uint8) if p.dtype.itemsize == 1
                           else p, q.view(torch.uint8)
                           if q.dtype.itemsize == 1 else q)


def _resume_model(dropout=0.2, **kw):
    encs = [tenc.MIMICMLPEncoder(S, 3, HIDDEN, dropout=dropout)
            for _ in range(4)]
    return tmm.MultiModN(S, encs, [tdec.MLPDecoder(S, HIDDEN, 2)] * 2, 1.0,
                         0.5, seed=4, device="cpu", **kw)


def test_resumed_per_batch_shuffle_fit_best_is_bit_equal(tmp_path):
    """``fit_best_resumable`` with ``shuffle_mode`` on the scan chain (and
    dropout), killed after its first epoch and resumed by a new model,
    equals one uninterrupted ``fit_best`` bit for bit."""
    X, y = _data(40, WIDTHS["homogeneous"], seed=11)
    Xv, yv = _data(16, WIDTHS["homogeneous"], seed=12)
    tl = _loaders(X, y, WIDTHS["homogeneous"], shuffle=True)[1]
    tv = _loaders(Xv, yv, WIDTHS["homogeneous"])[1]
    whole = _resume_model(shuffle_mode=True)
    want = whole.fit_best(tl, tmm.Adam8bit(0.01), epochs=3, val_loader=tv)
    tl = _loaders(X, y, WIDTHS["homogeneous"], shuffle=True)[1]
    with pytest.raises(_Killed):
        tckpt.fit_best_resumable(
            _resume_model(shuffle_mode=True), tl, tmm.Adam8bit(0.01),
            epochs=3, checkpoint_dir=str(tmp_path), val_loader=tv,
            chunk_epochs=1, on_chunk=_kill_after_first)
    tl = _loaders(X, y, WIDTHS["homogeneous"], shuffle=True)[1]
    resumed = _resume_model(shuffle_mode=True)
    got = tckpt.fit_best_resumable(
        resumed, tl, tmm.Adam8bit(0.01), epochs=3,
        checkpoint_dir=str(tmp_path), val_loader=tv, chunk_epochs=1)
    assert got["epochs_run"] == 2
    np.testing.assert_array_equal(got["scores"], want["scores"])
    assert got["best_epoch"] == want["best_epoch"]
    _equal_states(resumed, whole)


def test_resumed_per_call_shuffle_fit_is_bit_equal(tmp_path):
    """``fit_resumable`` over streaming loaders with the per-call cadence
    (an order per epoch from ``random.Random``), killed after its first
    epoch and resumed by a new model: the payload carries the order
    stream, so the run equals the uninterrupted one bit for bit."""
    widths = WIDTHS["homogeneous"]
    X, y = _data(40, widths, seed=13)

    def run(model, directory, on_chunk=None):
        loader = TStream(TDataset(X, y, list(widths)), 16)
        return tckpt.fit_resumable(
            model, loader, tmm.Adam(0.01), epochs=4,
            checkpoint_dir=str(directory), chunk_epochs=1, on_chunk=on_chunk)

    kw = dict(shuffle_mode=True, chain_mode="unrolled")
    whole = _resume_model(**kw)
    run(whole, tmp_path / "whole")
    with pytest.raises(_Killed):
        run(_resume_model(**kw), tmp_path / "killed", _kill_after_first)
    resumed = _resume_model(**kw)
    assert run(resumed, tmp_path / "killed")[1] == 3
    assert resumed._shuffle_rng.getstate() == whole._shuffle_rng.getstate()
    _equal_states(resumed, whole)
    fresh = _resume_model(**kw)
    orders = {fresh._resolve_order(train=True) for _ in range(4)}
    assert len(orders) > 1


def test_models_pickled_before_the_order_options_run_unrolled():
    """A model pickled without ``chain_mode``, ``scan_unroll`` and the order
    stream (as the port wrote them before it had encoding orders) loads
    with the unrolled chain and a stream seeded like a new model's."""
    import pickle
    _, tm = _models("homogeneous", shuffle_mode=True)
    state = tm.__getstate__()
    for key in ("chain_mode", "scan_unroll", "_shuffle_rng"):
        del state[key]
    old = tmm.MultiModN.__new__(tmm.MultiModN)
    old.__setstate__(pickle.loads(pickle.dumps(state)))
    assert old._chain_plan() == ("unrolled", False)
    assert (old.chain_mode, old.scan_unroll) == ("unrolled", None)
    assert old._shuffle_rng.getstate() == _models("homogeneous")[1] \
        ._shuffle_rng.getstate()
    x = np.split(_data(4, WIDTHS["homogeneous"], missing=0.0)[0], 4, axis=1)
    for g, w in zip(old.predict_proba(x), tm.predict_proba(x)):
        np.testing.assert_array_equal(g, w)
