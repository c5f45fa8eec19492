"""The port's experiment surface against the JAX package on the CPU:
``sweep_fit_best`` (seed after seed) against JAX's vmapped sweep, each seed
against the port's own ``fit_best`` bit for bit (with ``Adam`` and with
``Adam8bit``, whose update is the fused Adam kernel's plain version here),
a shuffled shared loader, the streamed sweep and k-fold against the
ArrayLoader ones, ``fold_history``, ``kfold_fit_best(on_epoch=)`` and
``sweep_fit_best(on_epoch=)`` payloads, and the JAX package's guards for
streamed experiments.

JAX weights are transplanted into every port model (``load_state_dict``);
dropout is off. Tolerances are the k-fold parity test's
(``test_torch_pipelines.py``): parameters and selection scores within atol
1e-5, loss sums within 1e-4 (they add ~50 per-sample terms), confusion
counts, best epochs and epoch counts exactly; progress payloads within
1e-5 relative (losses) or absolute (scores). JAX's vmapped programs emit
payloads in no fixed order, so those are compared as per-epoch multisets.
"""
import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu import experiments as jexp
from multimodn_tpu import experiments_stream as jexps
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
from multimodn_tpu.data.dataset import Subset as JSubset
from multimodn_tpu.data.streaming import StreamingLoader as JStream
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch import experiments as texp
from multimodn_tpu_torch import experiments_stream as texps
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset
from multimodn_tpu_torch.data import StreamingLoader as TStream
from multimodn_tpu_torch.data import Subset as TSubset

ATOL, SUM_ATOL, RTOL = 1e-5, 1e-4, 1e-5
WIDTHS, S = (4, 6), 5
COUNT_KEYS = ("n_correct", "tp", "tn", "fp", "fn", "n_counted")
HISTORY_FIELDS = ("loss", "accuracy", "sensitivity", "specificity",
                  "balanced_accuracy")


def _jfactory(seed):
    return jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, (8,), dropout=0.0) for w in WIDTHS],
        [jdec.MLPDecoder(S, (8,), 2)], 1.0, 0.2, seed=seed)


def _tfactory(seed):
    model = tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, (8,), dropout=0.0) for w in WIDTHS],
        [tdec.MLPDecoder(S, (8,), 2)], 1.0, 0.2, seed=seed, device="cpu")
    model.load_state_dict(_jfactory(seed).state_dict())
    return model


def _dataset(kind, seed=0, n=72):
    """Rows with ~20% of the first modality's cells NaN, for ``kind``
    'jax' or 'torch'."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(WIDTHS))).astype(np.float32)
    y = (X[:, :1] + X[:, 5:6] > 0).astype(np.int64)
    X[rng.random(n) < 0.2, :WIDTHS[0]] = np.nan
    return (JDataset if kind == "jax" else TDataset)(X, y, list(WIDTHS))


def _pair(kind, loader="array", seed=0, shuffle=False, n_train=56):
    ds = _dataset(kind, seed)
    subset = JSubset if kind == "jax" else TSubset
    cls = {("jax", "array"): JLoader, ("torch", "array"): TLoader,
           ("jax", "stream"): JStream, ("torch", "stream"): TStream}[
        (kind, loader)]
    extra = {"shuffle": True, "seed": 7} if shuffle else {}
    return (cls(subset(ds, list(range(n_train))), 8, **extra),
            cls(subset(ds, list(range(n_train, 72))), 8))


def _folds(kind, loader="array", sizes=((48, 16), (32, 24), (56, 8))):
    """Unequal fold sizes: 6, 4 and 7 training batches of 8."""
    ds = _dataset(kind, 3)
    subset = JSubset if kind == "jax" else TSubset
    cls = {("jax", "array"): JLoader, ("torch", "array"): TLoader,
           ("jax", "stream"): JStream, ("torch", "stream"): TStream}[
        (kind, loader)]
    return [(cls(subset(ds, list(range(tr))), 8),
             cls(subset(ds, list(range(tr, tr + va))), 8))
            for tr, va in sizes]


def _assert_like_jax(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("best_epoch", "epochs_ran", "n_train_batches",
                    "n_val_batches"):
            assert g[key] == w[key], key
        assert g["best_score"] == pytest.approx(w["best_score"], abs=ATOL)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=ATOL)
        for key in ("train_sums", "val_sums"):
            assert sorted(g[key]) == sorted(w[key])
            for k, v in w[key].items():
                v = np.asarray(v)
                assert g[key][k].shape == v.shape, (key, k)
                if k in COUNT_KEYS:
                    np.testing.assert_array_equal(g[key][k], v)
                else:
                    np.testing.assert_allclose(g[key][k], v, atol=SUM_ATOL)
        for a, b in zip(tree_leaves(g["model"].state_dict()),
                        tree_leaves(tmm.params_from_jax(
                            w["model"].state_dict(), "cpu"))):
            np.testing.assert_allclose(a, b.numpy(), atol=ATOL, rtol=0)


def _assert_bit_equal(got, want):
    """Two port results (or a result and a fit_best run) bit for bit."""
    assert got["best_epoch"] == want["best_epoch"]
    assert got["epochs_ran"] == want["epochs_ran"]
    np.testing.assert_array_equal(got["scores"], want["scores"])
    for key in ("train_sums", "val_sums"):
        for k in want[key]:
            np.testing.assert_array_equal(got[key][k], want[key][k])
    a, b = got["model"], want["model"]
    for x, y in zip(tree_leaves([a.params, a.opt_state]),
                    tree_leaves([b.params, b.opt_state])):
        assert torch.equal(x, y)
    assert a._epoch_counter == b._epoch_counter


@pytest.mark.parametrize("patience", [None, 1])
def test_sweep_matches_jax(patience):
    seeds = [0, 3, 11]
    want = jexp.sweep_fit_best(_jfactory, *_pair("jax"), jmm.Adam(0.01),
                               "cross_entropy", epochs=4, seeds=seeds,
                               patience=patience)
    got = texp.sweep_fit_best(_tfactory, *_pair("torch"), tmm.Adam(0.01),
                              "cross_entropy", epochs=4, seeds=seeds,
                              patience=patience)
    _assert_like_jax(got, want)
    if patience is not None:
        assert any(g["epochs_ran"] < 4 for g in got)


@pytest.mark.parametrize("optimizer", ["adam", "adam8bit"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sweep_seeds_equal_their_own_fit_best(optimizer, shuffle):
    """Each seed bit-equal to ``model_factory(seed).fit_best`` on loaders
    in the state the sweep's started from, its trained optimizer state
    kept; a shuffled loader is left as the last seed's fit left it."""
    make = {"adam": lambda: tmm.Adam(0.01),
            "adam8bit": lambda: tmm.Adam8bit(0.01)}[optimizer]
    seeds = [2, 5, 9]
    train, val = _pair("torch", shuffle=shuffle)
    got = texp.sweep_fit_best(_tfactory, train, val, make(),
                              "cross_entropy", epochs=3, seeds=seeds)
    for seed, res in zip(seeds, got):
        model = _tfactory(seed)
        ftrain, fval = _pair("torch", shuffle=shuffle)
        info, tsums, vsums = model._fit_best(
            ftrain, make(), "cross_entropy", 3, fval, None, "val", True,
            None)
        _assert_bit_equal(res, {
            "model": model, "best_epoch": info["best_epoch"],
            "epochs_ran": info["epochs_ran"], "scores": info["scores"],
            "train_sums": texp._stack_sums(tsums),
            "val_sums": texp._stack_sums(vsums)})
        assert res["model"].opt_state is not None
    np.testing.assert_array_equal(train._order, ftrain._order)


def test_shuffled_sweep_seeds_are_independent():
    """A seed's result does not depend on the seeds run before it on the
    shared shuffled loader."""
    alone = texp.sweep_fit_best(_tfactory, *_pair("torch", shuffle=True),
                                tmm.Adam(0.01), "cross_entropy", epochs=3,
                                seeds=[4])
    after = texp.sweep_fit_best(_tfactory, *_pair("torch", shuffle=True),
                                tmm.Adam(0.01), "cross_entropy", epochs=3,
                                seeds=[1, 8, 4])
    _assert_bit_equal(after[2], alone[0])


@pytest.mark.parametrize("patience", [None, 2])
def test_streamed_experiments_equal_array_loaders(patience):
    """``kfold_fit_best`` and ``sweep_fit_best`` over StreamingLoaders equal
    the ArrayLoader runs bit for bit, payloads included."""
    runs = {}
    for loader in ("array", "stream"):
        seen = []
        kfold = texp.kfold_fit_best(
            _tfactory, _folds("torch", loader), tmm.Adam8bit(0.01),
            "cross_entropy", epochs=4, patience=patience,
            on_epoch=seen.append)
        sweep = texp.sweep_fit_best(
            _tfactory, *_pair("torch", loader), tmm.Adam(0.01),
            "cross_entropy", epochs=4, seeds=[1, 6], patience=patience,
            on_epoch=seen.append)
        runs[loader] = (kfold + sweep, seen)
    (array, array_seen), (stream, stream_seen) = runs["array"], \
        runs["stream"]
    for a, s in zip(array, stream):
        _assert_bit_equal(s, a)
    assert stream_seen == array_seen


def test_fold_history_matches_jax_and_fit_best():
    """``fold_history`` rows against JAX's from JAX's results, and against
    the history the port's own ``fit_best`` writes for that fold."""
    want = jexp.kfold_fit_best(_jfactory, _folds("jax"), jmm.Adam(0.01),
                               "cross_entropy", epochs=3)
    got = texp.kfold_fit_best(_tfactory, _folds("torch"), tmm.Adam(0.01),
                              "cross_entropy", epochs=3)
    for f, (g, w) in enumerate(zip(got, want)):
        gh = texp.fold_history(g, ["t"])
        wh = jexp.fold_history(w, ["t"])
        for field in HISTORY_FIELDS:
            for tag in ("train", "val"):
                assert len(getattr(gh, field)[tag]) == 3
                for x, y in zip(getattr(gh, field)[tag],
                                getattr(wh, field)[tag]):
                    np.testing.assert_allclose(x, np.asarray(y),
                                               atol=ATOL)
        np.testing.assert_allclose(gh.state_change_loss,
                                   np.asarray(wh.state_change_loss),
                                   atol=ATOL)
        model = _tfactory(f)
        history = tmm.MultiModNHistory(["t"])
        train, val = _folds("torch")[f]
        model.fit_best(train, tmm.Adam(0.01), "cross_entropy", epochs=3,
                       val_loader=val, history=history)
        for field in HISTORY_FIELDS:
            for tag in ("train", "val"):
                for x, y in zip(getattr(gh, field)[tag],
                                getattr(history, field)[tag]):
                    np.testing.assert_array_equal(x, y)


def _jax_payloads(results, max_tb=None, max_vb=None):
    """What each fold's fit_best would emit, rebuilt from its sums; with
    ``max_tb`` / ``max_vb`` the losses divide by the longest fold's batch
    counts, as JAX's vmapped k-fold does."""
    out = []
    for r in results:
        for e in range(r["epochs_ran"]):
            out.append({
                "epoch": e,
                "train_loss": float(np.mean(r["train_sums"]["err_loss"][e])
                                    / (max_tb or r["n_train_batches"])),
                "val_loss": float(np.mean(r["val_sums"]["err_loss"][e])
                                  / (max_vb or r["n_val_batches"])),
                "score": float(r["scores"][e])})
    return out


def _assert_multiset(got, want):
    """Per-epoch multisets of payloads, matched by score then losses."""
    key = lambda p: (p["epoch"], p["score"], p["train_loss"])
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        assert g["score"] == pytest.approx(w["score"], abs=ATOL)
        for k in ("train_loss", "val_loss"):
            assert g[k] == pytest.approx(w[k], rel=RTOL)


@pytest.mark.parametrize("patience", [None, 1])
def test_kfold_on_epoch_matches_jax(patience):
    """Once per fold per executed epoch, fold after fold. JAX's vmapped
    program divides a shorter fold's losses by the longest fold's batch
    count; the port emits what that fold's ``fit_best`` emits (its own
    count), and the two differ by exactly that ratio."""
    jseen, tseen = [], []
    # Patience 1 stops the folds after 4, 6 and 4 of their 8 epochs.
    epochs = 4 if patience is None else 8
    want = jexp.kfold_fit_best(_jfactory, _folds("jax"), jmm.Adam(0.01),
                               "cross_entropy", epochs=epochs,
                               patience=patience, on_epoch=jseen.append)
    got = texp.kfold_fit_best(_tfactory, _folds("torch"), tmm.Adam(0.01),
                              "cross_entropy", epochs=epochs,
                              patience=patience, on_epoch=tseen.append)
    _assert_like_jax(got, want)
    max_tb = max(w["n_train_batches"] for w in want)
    max_vb = max(w["n_val_batches"] for w in want)
    # What JAX emits: its folds' own payloads with the padded counts.
    _assert_multiset(_jax_payloads(want, max_tb, max_vb), jseen)
    # The port: fold after fold, each fold's own counts.
    assert [p["epoch"] for p in tseen] == [
        e for g in got for e in range(g["epochs_ran"])]
    for g, w in zip(tseen, _jax_payloads(want)):
        assert g["epoch"] == w["epoch"]
        assert g["score"] == pytest.approx(w["score"], abs=ATOL)
        for k in ("train_loss", "val_loss"):
            assert g[k] == pytest.approx(w[k], rel=RTOL)
    if patience is not None:
        assert len({g["epochs_ran"] for g in got}) > 1


def test_sweep_on_epoch_matches_jax():
    jseen, tseen = [], []
    jexp.sweep_fit_best(_jfactory, *_pair("jax"), jmm.Adam(0.01),
                        "cross_entropy", epochs=3, seeds=[0, 1],
                        on_epoch=jseen.append)
    texp.sweep_fit_best(_tfactory, *_pair("torch"), tmm.Adam(0.01),
                        "cross_entropy", epochs=3, seeds=[0, 1],
                        on_epoch=tseen.append)
    assert [p["epoch"] for p in tseen] == [0, 1, 2, 0, 1, 2]
    _assert_multiset(tseen, jseen)


@pytest.mark.parametrize("case", ["mixed", "shuffle", "mesh", "batch_size",
                                  "patience", "sweep_mixed"])
def test_streamed_guards_match_jax(case):
    """The JAX package's guards for streamed experiments
    (``test_experiments_stream.py:156``), raised alike by both."""
    errors = {"mixed": (ValueError, "mixed"),
              "shuffle": (NotImplementedError, "shuffle"),
              "mesh": (ValueError, "fused-path"),
              "batch_size": (ValueError, "batch size"),
              "patience": (ValueError, "patience"),
              "sweep_mixed": (ValueError, "mixed")}
    for kind, exp, mm, factory in (("jax", jexp, jmm, _jfactory),
                                   ("torch", texp, tmm, _tfactory)):
        ds = _dataset(kind)
        subset = JSubset if kind == "jax" else TSubset
        array, stream = (JLoader, JStream) if kind == "jax" \
            else (TLoader, TStream)
        tr, va = subset(ds, list(range(48))), subset(ds, list(range(48, 72)))
        folds, kw = [(stream(tr, 8), stream(va, 8))], {}
        if case == "mixed":
            folds = [(array(tr, 8), stream(va, 8))]
        elif case == "shuffle":
            folds = [(stream(tr, 8, shuffle=True), stream(va, 8))]
        elif case == "mesh":
            kw = {"mesh": object()}
        elif case == "batch_size":
            folds = [(stream(tr, 8), stream(va, 12))]
        elif case == "patience":
            kw = {"patience": 0}
        with pytest.raises(errors[case][0], match=errors[case][1]):
            if case == "sweep_mixed":
                exp.sweep_fit_best(factory, array(tr, 8), stream(va, 8),
                                   mm.Adam(0.01), "cross_entropy")
            else:
                exp.kfold_fit_best(factory, folds, mm.Adam(0.01),
                                   "cross_entropy", **kw)
    for mod, array, stream in ((jexps, JLoader, JStream),
                               (texps, TLoader, TStream)):
        ds = _dataset("torch")
        assert mod.is_streaming_loader(stream(ds, 8))
        assert not mod.is_streaming_loader(array(ds, 8))


def test_mesh_is_not_ported():
    """A seed mesh is ported (``test_torch_parallel.py`` runs it over ranks);
    one without the sweep axis raises JAX's ``ValueError``."""
    with pytest.raises(ValueError, match="mesh has no 'fold' axis"):
        texp.sweep_fit_best(_tfactory, *_pair("torch"), tmm.Adam(0.01),
                            mesh=object())
