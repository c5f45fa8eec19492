"""The port's streaming loaders and streamed training on the CPU:
``StreamingLoader``'s batches against the JAX package's; the streamed
``train_epoch`` / ``fit`` / ``test`` / ``fit_best`` / ``predict`` against the
port's ``ArrayLoader`` path bit for bit (dropout, Adam8bit, every
``nan_skip``, a ``StaticInitState`` cycle) and against the JAX package's
streamed functions; ``TorchStreamingLoader``'s geometry; streamed k-fold
against the port's ``ArrayLoader`` k-fold bit for bit and against the JAX
package's ``kfold_fit_best_streamed``.

Against JAX (transplanted weights, dropout 0, ``Adam``): XLA's and
PyTorch's CPU matrix products sum in different orders (~1e-7 relative), so
loss grids, scores, outputs and parameters agree to atol 1e-5 over a few
epochs; best epochs, epoch counts, argmax predictions and confusion counts
exactly.
"""
import numpy as np
import pytest
import torch
import torch.utils.data as tud

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import (ArrayLoader, PartitionDataset,
                                      StreamingLoader, Subset,
                                      TorchStreamingLoader,
                                      fit_best_streaming, fit_streaming,
                                      predict_proba_streaming,
                                      predict_streaming,
                                      train_epoch_streaming)
from multimodn_tpu_torch.data import test_epoch_streaming as stream_test
from multimodn_tpu_torch.data.streaming import device_batches
from multimodn_tpu_torch.experiments import kfold_fit_best

ATOL = 1e-5
WIDTHS, S = (3, 5), 6
COUNT_KEYS = ("n_correct", "tp", "tn", "fp", "fn", "n_counted")


def _dataset(n=50, seed=0, missing=0.25):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(WIDTHS))).astype(np.float32)
    X[rng.random(n) < missing, :WIDTHS[0]] = np.nan
    X[rng.random(n) < missing / 2, WIDTHS[0]:] = np.nan
    y = np.stack([np.nan_to_num(X[:, 4:]).sum(1) > 0,
                  np.nan_to_num(X[:, :2]).sum(1) > 0], 1).astype(np.int64)
    return PartitionDataset(X, y, list(WIDTHS))


def _model(seed=3, dropout=0.0, nan_skip="sample", static=False):
    kw = {}
    if static:
        kw["init_state"] = tmm.StaticInitState(
            np.arange(3 * S, dtype=np.float32).reshape(3, S) / 10)
    return tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, (8,), dropout=dropout)
            for w in WIDTHS], [tdec.MLPDecoder(S, (8,), 2) for _ in range(2)],
        1.0, 0.3, seed=seed, nan_skip=nan_skip, device="cpu", **kw)


def _jax_model(seed=3):
    import multimodn_tpu as jmm
    from multimodn_tpu import decoders as jdec
    from multimodn_tpu import encoders as jenc
    return jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, (8,), dropout=0.0) for w in WIDTHS],
        [jdec.MLPDecoder(S, (8,), 2) for _ in range(2)], 1.0, 0.3,
        seed=seed)


def _pair(seed=3):
    jm = _jax_model(seed)
    tm = _model(seed)
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _jax_dataset(ds):
    from multimodn_tpu.data import PartitionDataset as JDataset
    xs, y, _ = ds.arrays()
    return JDataset(np.concatenate(xs, axis=1), y, list(WIDTHS))


def _bits(t):
    """The tensor's bits: NaNs compare equal, float8 codes compare."""
    return t.view({1: torch.uint8, 4: torch.int32}[t.element_size()])


def _leaf_pairs(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return zip(la, lb)


def _assert_same_model(a, b):
    for x, y in _leaf_pairs(a.params, b.params):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    for x, y in _leaf_pairs(a.opt_state, b.opt_state):
        assert (x is None and y is None) or (
            x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)))
    assert (a._epoch_counter, a._cycle_offset) == \
        (b._epoch_counter, b._cycle_offset)


def _assert_same_history(a, b):
    for field in ("loss", "accuracy", "sensitivity", "balanced_accuracy"):
        ga, gb = getattr(a, field), getattr(b, field)
        assert sorted(ga) == sorted(gb)
        for tag in ga:
            np.testing.assert_array_equal(np.asarray(ga[tag]),
                                          np.asarray(gb[tag]))


# --------------------------------------------------------------------------
# StreamingLoader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch, shuffle", [(16, False), (7, True), (0, False)])
def test_streaming_loader_batches_equal_jax(batch, shuffle):
    """Same rows, order, padding and masks as the JAX package's loader
    over three reshuffled epochs (targets int64 here, as in ArrayLoader)."""
    from multimodn_tpu.data import StreamingLoader as JStream
    ds = _dataset()
    mine = StreamingLoader(ds, batch, shuffle=shuffle, seed=5)
    theirs = JStream(_jax_dataset(ds), batch, shuffle=shuffle, seed=5)
    assert (mine.n_samples, mine.batch_size, mine.n_batches,
            mine.modality_widths) == (theirs.n_samples, theirs.batch_size,
                                      theirs.n_batches,
                                      theirs.modality_widths)
    for _ in range(3):
        mine.reshuffle()
        theirs.reshuffle()
        got, want = list(mine.iter_batches()), list(theirs.iter_batches())
        assert len(got) == len(want) == mine.n_batches
        for (gd, gt, gm), (wd, wt, wm) in zip(got, want):
            assert gt.dtype == np.int64
            for a, b in zip(gd, wd):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gm, wm)


def test_streaming_loader_rejects_empty_and_sequences():
    with pytest.raises(ValueError, match="empty"):
        StreamingLoader(Subset(_dataset(), []), 4)

    class WithSequence:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return [np.zeros(3, np.float32)], np.zeros(1), np.zeros(1)

    with pytest.raises(NotImplementedError, match="sequences"):
        StreamingLoader(WithSequence(), 2)


def test_cpu_batches_wrap_without_a_copy():
    """On a CPU model each batch is the loader's own numpy memory; nothing
    is pinned and no stream is made."""
    ds = _dataset(n=20)
    host = list(StreamingLoader(ds, 8).iter_batches())
    got = list(device_batches(StreamingLoader(ds, 8), "cpu"))
    assert [n for _, n in got] == [8, 8, 4]
    for ((data, targets, mask), _n), (hd, ht, hm) in zip(got, host):
        assert not data[0].is_pinned()
        np.testing.assert_array_equal(data[0].numpy(), hd[0])
        np.testing.assert_array_equal(targets.numpy(), ht)
        np.testing.assert_array_equal(mask.numpy(), hm)


# --------------------------------------------------------------------------
# Streamed training against the port's ArrayLoader path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nan_skip", ["sample", "batch", "none"])
def test_train_epoch_streaming_equals_array_loader(nan_skip):
    ds = _dataset()
    a = _model(dropout=0.2, nan_skip=nan_skip)
    b = _model(dropout=0.2, nan_skip=nan_skip)
    oa, ob = tmm.Adam8bit(1e-2), tmm.Adam8bit(1e-2)
    ha, hb = tmm.MultiModNHistory(["y", "z"]), tmm.MultiModNHistory(["y", "z"])
    for _ in range(2):
        a.train_epoch(ArrayLoader(ds, 16), oa, history=ha)
        stats = train_epoch_streaming(b, StreamingLoader(ds, 16), ob,
                                      history=hb)
    np.testing.assert_array_equal(stats["loss"], hb.loss["train"][-1])
    _assert_same_model(a, b)
    _assert_same_history(ha, hb)


def test_fit_and_test_streaming_equal_array_loader():
    """fit with a shuffled train loader and a val loader, then test, with
    a StaticInitState whose cycle continues across the calls."""
    ds, val = _dataset(), _dataset(n=23, seed=1)
    a, b = _model(dropout=0.2, static=True), _model(dropout=0.2, static=True)
    ha = a.fit(ArrayLoader(ds, 16, shuffle=True, seed=1), tmm.Adam(1e-2),
               epochs=3, history=tmm.MultiModNHistory(["y", "z"]),
               val_loader=ArrayLoader(val, 8))
    hb = fit_streaming(b, StreamingLoader(ds, 16, shuffle=True, seed=1),
                       tmm.Adam(1e-2), epochs=3,
                       history=tmm.MultiModNHistory(["y", "z"]),
                       val_loader=StreamingLoader(val, 8))
    _assert_same_model(a, b)
    _assert_same_history(ha, hb)
    ra = a.test(ArrayLoader(val, 8), history=ha)
    rb = stream_test(b, StreamingLoader(val, 8), history=hb)
    for x, y in zip(ra, rb):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert a._cycle_offset == b._cycle_offset


@pytest.mark.parametrize("static", [False, True])
def test_fit_best_streaming_equals_fit_best(static):
    ds, val = _dataset(n=64), _dataset(n=30, seed=2)
    a = _model(dropout=0.2, static=static)
    b = _model(dropout=0.2, static=static)
    ha, hb = tmm.MultiModNHistory(["y", "z"]), tmm.MultiModNHistory(["y", "z"])
    want = a.fit_best(ArrayLoader(ds, 16), tmm.Adam8bit(1e-2), epochs=5,
                      val_loader=ArrayLoader(val, 16), history=ha)
    seen = []
    got = fit_best_streaming(b, StreamingLoader(ds, 16), tmm.Adam8bit(1e-2),
                             epochs=5, val_loader=StreamingLoader(val, 16),
                             history=hb, on_epoch=seen.append)
    assert got["best_epoch"] == want["best_epoch"]
    assert got["epochs_ran"] == want["epochs_ran"] == len(seen)
    np.testing.assert_array_equal(got["scores"], want["scores"])
    assert [s["score"] for s in seen] == list(map(float, want["scores"]))
    _assert_same_model(a, b)
    _assert_same_history(ha, hb)
    for x, y in zip(tree_leaves(got["best_params"]),
                    tree_leaves(want["best_params"])):
        np.testing.assert_array_equal(x, y)


def test_predict_streaming_equals_predict():
    """No NaN skip (quirk #9), the StaticInitState cycle tracked across
    interleaved calls."""
    ds = _dataset(n=37)
    a, b = _model(static=True), _model(static=True)
    for _ in range(2):
        np.testing.assert_array_equal(
            a.predict(ArrayLoader(ds, 16)),
            predict_streaming(b, StreamingLoader(ds, 16)))
        for x, y in zip(a.predict_proba(ArrayLoader(ds, 16)),
                        predict_proba_streaming(b, StreamingLoader(ds, 16))):
            np.testing.assert_array_equal(x, y)
    assert a._cycle_offset == b._cycle_offset
    states = [np.stack(m.get_states(loader)) for m, loader in
              ((a, ArrayLoader(ds, 16)), (b, StreamingLoader(ds, 16)))]
    np.testing.assert_array_equal(*states)
    with pytest.raises(ValueError, match="mapped back"):
        predict_streaming(b, StreamingLoader(ds, 16, shuffle=True))


# --------------------------------------------------------------------------
# Against the JAX package's streamed functions
# --------------------------------------------------------------------------

def test_train_epoch_and_test_streaming_match_jax():
    from multimodn_tpu import Adam as JAdam
    from multimodn_tpu import MultiModNHistory as JHistory
    from multimodn_tpu.data import StreamingLoader as JStream
    from multimodn_tpu.data import test_epoch_streaming as jtest
    from multimodn_tpu.data import train_epoch_streaming as jtrain
    ds = _dataset()
    jm, tm = _pair()
    jds = _jax_dataset(ds)
    jh, th = JHistory(["y", "z"]), tmm.MultiModNHistory(["y", "z"])
    jo, to = JAdam(1e-2), tmm.Adam(1e-2)
    for _ in range(3):
        jtrain(jm, JStream(jds, 16), jo, "cross_entropy", jh)
        train_epoch_streaming(tm, StreamingLoader(ds, 16), to,
                              "cross_entropy", th)
    for a, b in zip(th.loss["train"], jh.loss["train"]):
        np.testing.assert_allclose(a, b, atol=ATOL)
    wres = jtest(jm, JStream(jds, 16), "cross_entropy")
    tres = stream_test(tm, StreamingLoader(ds, 16), "cross_entropy")
    for t, w in zip(tres, wres):
        assert t[1] == pytest.approx(w[1], abs=ATOL)
        assert tuple(t[9:13]) == tuple(w[9:13])
    for a, b in zip(tree_leaves(tm.state_dict()),
                    tree_leaves(tmm.params_from_jax(jm.state_dict(),
                                                    "cpu"))):
        np.testing.assert_allclose(a, b.numpy(), atol=ATOL, rtol=0)


def test_fit_best_and_predict_streaming_match_jax():
    from multimodn_tpu import Adam as JAdam
    from multimodn_tpu.data import StreamingLoader as JStream
    from multimodn_tpu.data import fit_best_streaming as jfit_best
    from multimodn_tpu.data import predict_proba_streaming as jproba
    from multimodn_tpu.data import predict_streaming as jpredict
    ds, val = _dataset(n=64), _dataset(n=30, seed=2)
    jm, tm = _pair()
    want = jfit_best(jm, JStream(_jax_dataset(ds), 16), JAdam(1e-2),
                     "cross_entropy", epochs=4,
                     val_loader=JStream(_jax_dataset(val), 16))
    got = fit_best_streaming(tm, StreamingLoader(ds, 16), tmm.Adam(1e-2),
                             "cross_entropy", epochs=4,
                             val_loader=StreamingLoader(val, 16))
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL)
    jval = JStream(_jax_dataset(val), 16)
    np.testing.assert_array_equal(predict_streaming(tm, StreamingLoader(
        val, 16)), jpredict(jm, jval))
    for a, b in zip(predict_proba_streaming(tm, StreamingLoader(val, 16)),
                    jproba(jm, jval)):
        np.testing.assert_allclose(a, b, atol=ATOL)


# --------------------------------------------------------------------------
# TorchStreamingLoader
# --------------------------------------------------------------------------

class _Pairs(tud.Dataset):
    """The reference's ``([modality, ...], target)`` items as tensors."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        xs, y = self.ds[i][:2]
        return ([torch.from_numpy(np.ascontiguousarray(x, np.float32))
                 for x in xs], torch.as_tensor(np.asarray(y)))


def _torch_cases(ds):
    pairs = _Pairs(ds)

    class Iterable(tud.IterableDataset):
        def __iter__(self):
            return (pairs[i] for i in range(len(pairs)))

    return {
        "sequential": (tud.DataLoader(pairs, batch_size=16), 50, 4, False),
        "batch_sampler": (tud.DataLoader(pairs, batch_sampler=tud.BatchSampler(
            tud.SequentialSampler(pairs), 16, False)), 50, 4, False),
        "subset_sequential": (tud.DataLoader(
            pairs, sampler=tud.SequentialSampler(range(32)), batch_size=16),
            32, 2, False),
        "random": (tud.DataLoader(pairs, batch_size=16, shuffle=True), 50, 4,
                   True),
        "subset_random": (tud.DataLoader(
            pairs, sampler=tud.SubsetRandomSampler(list(range(20))),
            batch_size=8), 20, 3, True),
        "unsized_iterable": (tud.DataLoader(Iterable(), batch_size=16), None,
                             None, False),
    }


@pytest.mark.parametrize("case", ["sequential", "batch_sampler",
                                  "subset_sequential", "random",
                                  "subset_random", "unsized_iterable"])
def test_torch_streaming_loader_geometry(case):
    ds = _dataset()
    loader, n_samples, n_batches, shuffled = _torch_cases(ds)[case]
    tl = TorchStreamingLoader(loader)
    assert (tl.n_samples, tl.n_batches, tl.shuffle) == \
        (n_samples, n_batches, shuffled)
    assert tl.modality_widths == (None if case == "unsized_iterable"
                                  else list(WIDTHS))
    batches = list(tl.iter_batches())
    assert sum(int(m.sum()) for _, _, m in batches) == \
        (n_samples or len(ds))
    if not shuffled:
        # The same batches as a StreamingLoader over those rows, so the
        # same training, unsized loaders counted as they iterate.
        rows = Subset(ds, range(n_samples or len(ds)))
        want = list(StreamingLoader(rows, tl.batch_size).iter_batches())
        for (gd, gt, gm), (wd, wt, wm) in zip(batches, want):
            for a, b in zip(gd, wd):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gm, wm)
        a, b = _model(dropout=0.2), _model(dropout=0.2)
        ha = tmm.MultiModNHistory(["y", "z"])
        hb = tmm.MultiModNHistory(["y", "z"])
        a.train_epoch(ArrayLoader(rows, tl.batch_size), tmm.Adam(1e-2),
                      history=ha)
        train_epoch_streaming(b, tl, tmm.Adam(1e-2), history=hb)
        _assert_same_model(a, b)
        _assert_same_history(ha, hb)
    if n_batches is None:
        with pytest.raises(TypeError, match="unsized"):
            len(tl)
    if shuffled:
        with pytest.raises(NotImplementedError, match="shuffle"):
            fit_best_streaming(_model(), tl, tmm.Adam(1e-2), epochs=1,
                               val_loader=tl)


def test_torch_streaming_loader_rejections():
    pairs = _Pairs(_dataset(n=32))
    with pytest.raises(TypeError, match="DataLoader"):
        TorchStreamingLoader(pairs)
    with pytest.raises(NotImplementedError, match="drop_last"):
        TorchStreamingLoader(tud.DataLoader(pairs, batch_size=16,
                                            drop_last=True))
    with pytest.raises(NotImplementedError, match="automatic batching"):
        TorchStreamingLoader(tud.DataLoader(pairs, batch_size=None))

    class OddBatches:
        def __iter__(self):
            yield list(range(10))
            yield list(range(10, 32))

        def __len__(self):
            return 2

    with pytest.raises(NotImplementedError, match="BatchSampler"):
        TorchStreamingLoader(tud.DataLoader(pairs,
                                            batch_sampler=OddBatches()))


# --------------------------------------------------------------------------
# Streamed k-fold
# --------------------------------------------------------------------------

FOLD_SIZES = ((40, 20), (70, 23), (33, 30))


def _folds(cls, seed=0):
    out = []
    for i, (n_train, n_val) in enumerate(FOLD_SIZES):
        out.append((cls(_dataset(n_train, seed + 2 * i), 16),
                    cls(_dataset(n_val, seed + 2 * i + 1), 16)))
    return out


def _factory(seed):
    return _model(seed, dropout=0.2)


@pytest.mark.parametrize("patience", [None, 1])
def test_streamed_kfold_equals_array_kfold(patience):
    kw = dict(epochs=4, seeds=[3, 4, 5], patience=patience)
    want = kfold_fit_best(_factory, _folds(ArrayLoader), tmm.Adam8bit(1e-2),
                          **kw)
    got = kfold_fit_best(_factory, _folds(StreamingLoader),
                         tmm.Adam8bit(1e-2), **kw)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("best_epoch", "best_score", "epochs_ran",
                  "n_train_batches", "n_val_batches"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["scores"], w["scores"])
        for key in ("train_sums", "val_sums"):
            for k in w[key]:
                np.testing.assert_array_equal(g[key][k], w[key][k])
        _assert_same_model(g["model"], w["model"])


@pytest.mark.parametrize("patience", [None, 1])
def test_streamed_kfold_matches_jax(patience):
    """Unequal fold sizes (the JAX program pads folds with empty batches)
    and patience, against kfold_fit_best_streamed."""
    from multimodn_tpu import Adam as JAdam
    from multimodn_tpu.data import StreamingLoader as JStream
    from multimodn_tpu.experiments import kfold_fit_best as jkfold

    jfolds = [(JStream(_jax_dataset(_dataset(n_train, 2 * i)), 16),
               JStream(_jax_dataset(_dataset(n_val, 2 * i + 1)), 16))
              for i, (n_train, n_val) in enumerate(FOLD_SIZES)]

    kw = dict(epochs=4, seeds=[3, 4, 5], patience=patience)
    want = jkfold(_jax_model, jfolds, JAdam(1e-2), "cross_entropy", **kw)
    got = kfold_fit_best(lambda seed: _pair(seed)[1],
                         _folds(StreamingLoader), tmm.Adam(1e-2),
                         "cross_entropy", **kw)
    for g, w in zip(got, want):
        assert g["best_epoch"] == w["best_epoch"]
        assert g["epochs_ran"] == w["epochs_ran"]
        assert (g["n_train_batches"], g["n_val_batches"]) == \
            (w["n_train_batches"], w["n_val_batches"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=ATOL)
        for key in ("train_sums", "val_sums"):
            for k, v in w[key].items():
                if k in COUNT_KEYS:
                    np.testing.assert_array_equal(g[key][k], v)
                else:
                    np.testing.assert_allclose(g[key][k], v, atol=1e-4)
        for a, b in zip(tree_leaves(g["model"].state_dict()),
                        tree_leaves(tmm.params_from_jax(
                            w["model"].state_dict(), "cpu"))):
            np.testing.assert_allclose(a, b.numpy(), atol=ATOL, rtol=0)
    if patience is not None:
        assert any(g["epochs_ran"] < 4 for g in got)


def test_streamed_kfold_guards():
    folds = _folds(StreamingLoader)
    with pytest.raises(ValueError, match="mixed"):
        kfold_fit_best(_factory, [folds[0], _folds(ArrayLoader)[1]],
                       tmm.Adam(1e-2))
    shuffled = [(StreamingLoader(_dataset(), 16, shuffle=True),
                 folds[0][1])]
    with pytest.raises(NotImplementedError, match="shuffle"):
        kfold_fit_best(_factory, shuffled, tmm.Adam(1e-2))
    unsized = TorchStreamingLoader(_torch_cases(_dataset())[
        "unsized_iterable"][0])
    with pytest.raises(NotImplementedError, match="sized"):
        kfold_fit_best(_factory, [(unsized, folds[0][1])], tmm.Adam(1e-2))
