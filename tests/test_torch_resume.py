"""The port's checkpoints and resumable fits on the CPU: optimizer states
round-trip through a checkpoint bit for bit (``Adam8bit``'s float8 codes as
uint8 views), ``CheckpointManager`` against the JAX package's, and
``fit_resumable`` / ``fit_best_resumable`` / ``fit_best_streaming``
interrupted (an exception in ``on_chunk``, or SIGKILL in a child process)
and resumed in a fresh model equal the uninterrupted run bit for bit, with
``Adam8bit``, dropout and shuffled ``ArrayLoader``s; and the guards.

Against the JAX package (transplanted weights, dropout 0, ``Adam``): XLA's
and PyTorch's CPU matrix products sum in different orders (~1e-7 relative),
which stays at float32 rounding over a few epochs: scores and parameters
agree to atol 1e-5, the best epoch exactly.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import checkpoint as tckpt
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
from multimodn_tpu_torch.data.streaming import (StreamingLoader,
                                                fit_best_streaming,
                                                fit_streaming)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS, S = (3, 4), 6
OPTIMIZERS = {
    "adam8bit_fp8": lambda: tmm.Adam8bit(1e-2),
    "adam8bit_int8": lambda: tmm.Adam8bit(1e-2, fmt="int8"),
    "adam": lambda: tmm.Adam(1e-2),
    "sgd": lambda: tmm.SGD(1e-2),
    "sgd_momentum": lambda: tmm.SGD(1e-2, momentum=0.9),
    "adamw": lambda: tmm.AdamW(1e-2),
}


def _dataset(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(WIDTHS))).astype(np.float32)
    X[rng.random(n) < 0.25, :WIDTHS[0]] = np.nan
    y = (np.nan_to_num(X[:, 3:]).sum(1) > 0).astype(np.int64)
    return PartitionDataset(X, y, list(WIDTHS))


def _model(seed=3, dropout=0.0, static=False):
    kw = {}
    if static:
        kw["init_state"] = tmm.StaticInitState(
            np.arange(3 * S, dtype=np.float32).reshape(3, S) / 10)
    return tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, (8,), dropout=dropout)
            for w in WIDTHS], [tdec.MLPDecoder(S, (8,), 2)], 1.0, 0.3,
        seed=seed, device="cpu", **kw)


def _bits(t):
    """The tensor's bits: NaNs compare equal, float8 codes compare."""
    return t.view({1: torch.uint8, 4: torch.int32}[t.element_size()])


def _leaf_pairs(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return zip(la, lb)


def _assert_same_state(a, b):
    """Parameters, optimizer states and counters bit-equal."""
    for x, y in _leaf_pairs(a.params, b.params):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    assert sorted(a.opt_state) == sorted(b.opt_state)
    for x, y in _leaf_pairs(a.opt_state, b.opt_state):
        if x is None:
            assert y is None
        else:
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    assert a._epoch_counter == b._epoch_counter
    assert a._cycle_offset == b._cycle_offset


def _assert_same_history(a, b):
    for field in ("loss", "accuracy", "balanced_accuracy"):
        ga, gb = getattr(a, field), getattr(b, field)
        assert sorted(ga) == sorted(gb)
        for tag in ga:
            np.testing.assert_array_equal(np.asarray(ga[tag]),
                                          np.asarray(gb[tag]))
    np.testing.assert_array_equal(np.asarray(a.state_change_loss),
                                  np.asarray(b.state_change_loss))


class Interrupt(Exception):
    pass


def _bomb(at):
    def on_chunk(done, total):
        if done == at:
            raise Interrupt
    return on_chunk


# --------------------------------------------------------------------------
# Optimizer states through a checkpoint
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_opt_state_round_trips_bit_for_bit(tmp_path, name):
    """save_checkpoint(include_opt_state=True) then a restore on a fresh
    model gives back every state leaf bit for bit (before the repair an
    Adam8bit fp8 state raised TypeError in the save), and training goes on
    from it exactly as the uninterrupted model does."""
    opt = OPTIMIZERS[name]()
    ds = _dataset()
    m = _model()
    m.fit(ArrayLoader(ds, 16), opt, epochs=1)
    path = str(tmp_path / "c.pkl")
    tckpt.save_checkpoint(path, m, 1, include_opt_state=True)
    payload = tckpt.load_checkpoint(path)
    if name == "adam8bit_fp8":
        codes = tree_leaves(payload["opt_state"]["mq"])
        assert all(c.dtype == np.uint8 for c in codes)
    fresh = _model(seed=9)
    fresh.load_state_dict(payload["model_state_dict"])
    opt2 = OPTIMIZERS[name]()
    tckpt._restore_opt_state(fresh, opt2, payload["opt_state"])
    fresh._epoch_counter = m._epoch_counter
    _assert_same_state(m, fresh)
    m.fit(ArrayLoader(ds, 16), opt, epochs=1)
    fresh.fit(ArrayLoader(ds, 16), opt2, epochs=1)
    _assert_same_state(m, fresh)


def test_opt_state_restore_refuses_another_optimizer(tmp_path):
    m = _model()
    m.fit(ArrayLoader(_dataset(), 16), tmm.Adam(1e-2))
    state = tckpt._to_numpy(m.opt_state)
    with pytest.raises(ValueError, match="holds"):
        tckpt.opt_state_from_numpy(tmm.Adam8bit(1e-2), state, m.params)
    with pytest.raises(ValueError, match="expected"):
        tckpt.opt_state_from_numpy(tmm.Adam(1e-2), state,
                                   _model_wide().params)
    fp8 = _model()
    fp8.fit(ArrayLoader(_dataset(), 16), tmm.Adam8bit(1e-2))
    with pytest.raises(ValueError, match="expected"):
        tckpt.opt_state_from_numpy(tmm.Adam8bit(1e-2, fmt="int8"),
                                   tckpt._to_numpy(fp8.opt_state),
                                   fp8.params)


def _model_wide():
    return tmm.MultiModN(
        S, [tenc.MIMICMLPEncoder(S, w, (9,), dropout=0.0) for w in WIDTHS],
        [tdec.MLPDecoder(S, (8,), 2)], 1.0, 0.3, device="cpu")


# --------------------------------------------------------------------------
# CheckpointManager
# --------------------------------------------------------------------------

class _Params:
    def __init__(self, value):
        self.params = {"w": np.full((2,), value, np.float32)}


@pytest.mark.parametrize("keep, mode", [(1, "max"), (2, "max"), (2, "min")])
def test_checkpoint_manager_matches_jax(tmp_path, keep, mode):
    """Best-k tracking, the NaN refusal and the same epoch saved twice give
    the JAX package's files, verdicts and best checkpoint."""
    from multimodn_tpu.checkpoint import CheckpointManager as JManager
    scores = [0.5, float("nan"), 0.7, 0.7, 0.2, 0.9, 0.1]
    epochs = [0, 1, 2, 2, 3, 4, 4]
    out = {}
    for name, cls in (("jax", JManager), ("port", tckpt.CheckpointManager)):
        d = tmp_path / name
        mgr = cls(str(d), keep=keep, mode=mode)
        verdicts = [mgr.save(_Params(s), e, s, fold=1)
                    for s, e in zip(scores, epochs)]
        out[name] = (verdicts, sorted(os.listdir(d)),
                     os.path.basename(mgr.best_path),
                     mgr.restore_best(None)["auc_bac_val_cum"])
    assert out["port"] == out["jax"]
    assert out["port"][0][1] is False               # NaN never saved
    assert len(out["port"][1]) == keep


def test_checkpoint_manager_restores_best_into_model(tmp_path):
    m = _model()
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=1)
    assert mgr.best_path is None and mgr.restore_best(m) is None
    assert mgr.save(m, 0, 1.0)
    saved = m.state_dict()
    m.fit(ArrayLoader(_dataset(), 16), tmm.Adam(1e-2))
    assert not mgr.save(m, 1, 0.5)
    payload = mgr.restore_best(m)
    assert payload["epoch"] == 0
    for a, b in zip(tree_leaves(m.state_dict()), tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        tckpt.CheckpointManager(str(tmp_path), mode="best")


# --------------------------------------------------------------------------
# fit_resumable
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("opt", ["adam8bit_fp8", "adam"])
def test_fit_resumable_interrupted_equals_uninterrupted(tmp_path, shuffle,
                                                        opt):
    """Interrupted after its second chunk and resumed by a fresh model,
    optimizer and loader, fit_resumable ends bit-equal to one uninterrupted
    fit: parameters, optimizer state (Adam8bit codes and scales), counters,
    history. Dropout is on, and a shuffled loader's order and generator
    ride the payload."""
    ds = _dataset()

    def loaders():
        return (ArrayLoader(ds, 16, shuffle=shuffle, seed=4),
                ArrayLoader(ds, 16))

    full = _model(dropout=0.2)
    h_full = tmm.MultiModNHistory(["y"])
    tr, va = loaders()
    full.fit(tr, OPTIMIZERS[opt](), epochs=5, history=h_full, val_loader=va)

    ckpt = str(tmp_path / "ck")
    tr, va = loaders()
    with pytest.raises(Interrupt):
        tckpt.fit_resumable(_model(dropout=0.2), tr, OPTIMIZERS[opt](),
                            epochs=5, checkpoint_dir=ckpt, chunk_epochs=2,
                            history=tmm.MultiModNHistory(["y"]),
                            val_loader=va, on_chunk=_bomb(4))
    revived, chunks = _model(dropout=0.2), []
    tr, va = loaders()
    h, ran = tckpt.fit_resumable(
        revived, tr, OPTIMIZERS[opt](), epochs=5, checkpoint_dir=ckpt,
        chunk_epochs=2, history=tmm.MultiModNHistory(["y"]), val_loader=va,
        on_chunk=lambda d, t: chunks.append((d, t)))
    assert ran == 1 and chunks == [(5, 5)]
    _assert_same_state(full, revived)
    _assert_same_history(h_full, h)


def test_fit_resumable_noop_when_complete(tmp_path):
    ds = _dataset()
    m = _model()
    tckpt.fit_resumable(m, ArrayLoader(ds, 16), tmm.Adam8bit(1e-2),
                        epochs=3, checkpoint_dir=str(tmp_path),
                        chunk_epochs=2)
    again = _model(seed=8)
    _, ran = tckpt.fit_resumable(again, ArrayLoader(ds, 16),
                                 tmm.Adam8bit(1e-2), epochs=3,
                                 checkpoint_dir=str(tmp_path))
    assert ran == 0
    _assert_same_state(m, again)


def test_fit_resumable_history_none_adopts_checkpoint_history(tmp_path):
    ds = _dataset()
    h1 = tmm.MultiModNHistory(["y"])
    tckpt.fit_resumable(_model(), ArrayLoader(ds, 16), tmm.Adam(1e-2),
                        epochs=2, checkpoint_dir=str(tmp_path),
                        history=h1, val_loader=ArrayLoader(ds, 16))
    h2, ran = tckpt.fit_resumable(_model(), ArrayLoader(ds, 16),
                                  tmm.Adam(1e-2), epochs=3,
                                  checkpoint_dir=str(tmp_path),
                                  val_loader=ArrayLoader(ds, 16))
    assert ran == 1
    assert len(h2.loss["train"]) == 3 and len(h2.loss["val"]) == 3
    for a, b in zip(h2.loss["train"][:2], h1.loss["train"]):
        np.testing.assert_array_equal(a, b)


def test_fit_resumable_streaming_chunks_equal_fit_streaming(tmp_path):
    """Over streaming loaders each chunk trains through fit_streaming; the
    resumed run equals one uninterrupted fit_streaming (and so fit)."""
    ds = _dataset()
    full = _model(dropout=0.2)
    h_full = fit_streaming(full, StreamingLoader(ds, 16), tmm.Adam8bit(1e-2),
                           epochs=4, history=tmm.MultiModNHistory(["y"]),
                           val_loader=StreamingLoader(ds, 16))
    part = _model(dropout=0.2)
    tckpt.fit_resumable(part, StreamingLoader(ds, 16), tmm.Adam8bit(1e-2),
                        epochs=3, checkpoint_dir=str(tmp_path),
                        chunk_epochs=2, history=tmm.MultiModNHistory(["y"]),
                        val_loader=StreamingLoader(ds, 16))
    revived = _model(dropout=0.2)
    h, ran = tckpt.fit_resumable(revived, StreamingLoader(ds, 16),
                                 tmm.Adam8bit(1e-2), epochs=4,
                                 checkpoint_dir=str(tmp_path),
                                 val_loader=StreamingLoader(ds, 16))
    assert ran == 1
    _assert_same_state(full, revived)
    _assert_same_history(h_full, h)


# --------------------------------------------------------------------------
# fit_best_resumable
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_fit_best_resumable_equals_one_fit_best(tmp_path, dropout):
    """Chunked, then killed after a chunk and resumed: the same best epoch,
    score, scores, final and best parameters as one fit_best call, with
    Adam8bit and a shuffled loader, and with dropout too (each epoch's
    dropout draws follow from the absolute epoch; in the JAX package they
    restart at every chunk)."""
    ds = _dataset(n=70)

    def loaders():
        return ArrayLoader(ds, 16, shuffle=True, seed=2), ArrayLoader(ds, 16)

    one = _model(dropout=dropout)
    tr, va = loaders()
    h_one = tmm.MultiModNHistory(["y"])
    want = one.fit_best(tr, tmm.Adam8bit(1e-2), epochs=5, val_loader=va,
                        history=h_one, restore_best=False)
    ckpt = str(tmp_path / "ck")
    tr, va = loaders()
    with pytest.raises(Interrupt):
        tckpt.fit_best_resumable(_model(dropout=dropout), tr,
                                 tmm.Adam8bit(1e-2), epochs=5,
                                 checkpoint_dir=ckpt, val_loader=va,
                                 chunk_epochs=2, on_chunk=_bomb(2),
                                 history=tmm.MultiModNHistory(["y"]))
    revived = _model(dropout=dropout)
    tr, va = loaders()
    got = tckpt.fit_best_resumable(revived, tr, tmm.Adam8bit(1e-2), epochs=5,
                                   checkpoint_dir=ckpt, val_loader=va,
                                   chunk_epochs=2, restore_best=False)
    assert got["epochs_run"] == 3
    assert got["best_epoch"] == want["best_epoch"]
    assert got["best_score"] == want["best_score"]
    np.testing.assert_array_equal(got["scores"], want["scores"])
    _assert_same_state(one, revived)
    _assert_same_history(h_one, got["history"])
    for a, b in zip(tree_leaves(got["best_params"]),
                    tree_leaves(want["best_params"])):
        np.testing.assert_array_equal(a, b)
    # restore_best puts the global best on the model's device.
    again = _model(dropout=dropout)
    tckpt.fit_best_resumable(again, ArrayLoader(ds, 16, shuffle=True,
                                                seed=2),
                             tmm.Adam8bit(1e-2), epochs=5,
                             checkpoint_dir=ckpt, val_loader=va)
    for a, b in zip(tree_leaves(again.params),
                    tree_leaves(want["best_params"])):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)


def test_fit_best_resumable_matches_jax(tmp_path):
    """The port's fit_best_resumable against the JAX package's on
    transplanted weights, dropout 0, Adam, chunks of 2 over 5 epochs."""
    import multimodn_tpu as jmm
    from multimodn_tpu import checkpoint as jckpt
    from multimodn_tpu import decoders as jdec
    from multimodn_tpu import encoders as jenc
    from multimodn_tpu.data import ArrayLoader as JLoader
    from multimodn_tpu.data import PartitionDataset as JDataset

    ds = _dataset(n=70)
    X = np.concatenate(ds.arrays()[0], axis=1)
    y = ds.arrays()[1]
    jm = jmm.MultiModN(
        S, [jenc.MIMICMLPEncoder(S, w, (8,), dropout=0.0) for w in WIDTHS],
        [jdec.MLPDecoder(S, (8,), 2)], 1.0, 0.3, seed=3)
    tm = _model()
    tm.load_state_dict(jm.state_dict())
    jl = JLoader(JDataset(X, y, list(WIDTHS)), 16)
    want = jckpt.fit_best_resumable(jm, jl, jmm.Adam(1e-2), epochs=5,
                                    checkpoint_dir=str(tmp_path / "j"),
                                    val_loader=jl, chunk_epochs=2)
    got = tckpt.fit_best_resumable(tm, ArrayLoader(ds, 16), tmm.Adam(1e-2),
                                   epochs=5,
                                   checkpoint_dir=str(tmp_path / "t"),
                                   val_loader=ArrayLoader(ds, 16),
                                   chunk_epochs=2)
    assert got["best_epoch"] == want["best_epoch"]
    assert got["epochs_run"] == want["epochs_run"] == 5
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
    for a, b in zip(tree_leaves(tm.state_dict()),
                    tree_leaves(tmm.params_from_jax(jm.state_dict(),
                                                    "cpu"))):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# fit_best_streaming's resume path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("static, every", [(False, 2), (True, 2),
                                           (False, 4)])
def test_fit_best_streaming_kill_and_resume_bit_equal(tmp_path, static,
                                                      every):
    """Interrupted after a checkpoint and resumed in a fresh model:
    bit-equal to the uninterrupted streamed run, which equals fit_best on
    ArrayLoaders (StaticInitState's cycle too)."""
    ds = _dataset(n=56)
    kw = dict(epochs=6)
    ref = _model(dropout=0.2, static=static)
    want = ref.fit_best(ArrayLoader(ds, 8), tmm.Adam8bit(1e-2),
                        val_loader=ArrayLoader(ds, 8), **kw)
    full = _model(dropout=0.2, static=static)
    r_full = fit_best_streaming(full, StreamingLoader(ds, 8),
                                tmm.Adam8bit(1e-2),
                                val_loader=StreamingLoader(ds, 8), **kw)
    ckpt = str(tmp_path / "ck")
    with pytest.raises(Interrupt):
        fit_best_streaming(_model(dropout=0.2, static=static),
                           StreamingLoader(ds, 8), tmm.Adam8bit(1e-2),
                           val_loader=StreamingLoader(ds, 8),
                           checkpoint_dir=ckpt, checkpoint_every=every,
                           on_chunk=_bomb(every), **kw)
    revived = _model(dropout=0.2, static=static)
    r_res = fit_best_streaming(revived, StreamingLoader(ds, 8),
                               tmm.Adam8bit(1e-2),
                               val_loader=StreamingLoader(ds, 8),
                               checkpoint_dir=ckpt, checkpoint_every=every,
                               **kw)
    for r in (r_full, r_res):
        assert r["best_epoch"] == want["best_epoch"]
        assert r["epochs_ran"] == want["epochs_ran"]
        np.testing.assert_array_equal(r["scores"], want["scores"])
    _assert_same_state(ref, full)
    _assert_same_state(ref, revived)


def test_fit_best_streaming_sigkill_resume(tmp_path):
    """A child process is SIGKILLed right after its epoch-2 checkpoint
    lands; a fresh model resumes from the payload bit-equal to the
    uninterrupted run."""
    ckpt = str(tmp_path / "ck")
    child = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {ROOT!r})
        sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
        import multimodn_tpu_torch as tmm
        from multimodn_tpu_torch.data.streaming import (StreamingLoader,
                                                        fit_best_streaming)
        from test_torch_resume import _dataset, _model
        def kill(done, total):
            if done == 2:
                os.kill(os.getpid(), signal.SIGKILL)
        ds = _dataset(n=56)
        fit_best_streaming(_model(dropout=0.2), StreamingLoader(ds, 8),
                           tmm.Adam8bit(1e-2), epochs=5,
                           val_loader=StreamingLoader(ds, 8),
                           checkpoint_dir={ckpt!r}, checkpoint_every=2,
                           on_chunk=kill)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", child], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert os.path.exists(os.path.join(ckpt, "resume_stream_latest.pkl"))
    ds = _dataset(n=56)
    full = _model(dropout=0.2)
    r_full = fit_best_streaming(full, StreamingLoader(ds, 8),
                                tmm.Adam8bit(1e-2), epochs=5,
                                val_loader=StreamingLoader(ds, 8))
    revived, chunks = _model(dropout=0.2), []
    r_res = fit_best_streaming(revived, StreamingLoader(ds, 8),
                               tmm.Adam8bit(1e-2), epochs=5,
                               val_loader=StreamingLoader(ds, 8),
                               checkpoint_dir=ckpt, checkpoint_every=2,
                               on_chunk=lambda d, t: chunks.append(d))
    assert chunks == [4, 5]
    assert r_res["best_epoch"] == r_full["best_epoch"]
    np.testing.assert_array_equal(r_res["scores"], r_full["scores"])
    _assert_same_state(full, revived)


# --------------------------------------------------------------------------
# Guards
# --------------------------------------------------------------------------

def _guard_cases():
    ds = _dataset(n=32)
    shuffled = StreamingLoader(ds, 8, shuffle=True)
    plain = StreamingLoader(ds, 8)
    return {
        # The JAX package rejects a shuffled streaming train loader but not
        # a shuffled val loader; the port rejects both.
        "shuffled_stream_train": (NotImplementedError, "REPLAY", lambda d:
            tckpt.fit_resumable(_model(), shuffled, tmm.Adam(1e-2),
                                epochs=2, checkpoint_dir=d)),
        "shuffled_stream_val": (NotImplementedError, "REPLAY", lambda d:
            tckpt.fit_resumable(_model(), plain, tmm.Adam(1e-2), epochs=2,
                                checkpoint_dir=d, val_loader=shuffled)),
        "mixed_loaders": (ValueError, "mixed", lambda d:
            tckpt.fit_resumable(_model(), plain, tmm.Adam(1e-2), epochs=2,
                                checkpoint_dir=d,
                                val_loader=ArrayLoader(ds, 8))),
        "chunk_epochs": (ValueError, "chunk_epochs", lambda d:
            tckpt.fit_resumable(_model(), ArrayLoader(ds, 8),
                                tmm.Adam(1e-2), epochs=2, checkpoint_dir=d,
                                chunk_epochs=0)),
        "best_needs_val": (ValueError, "val_loader", lambda d:
            tckpt.fit_best_resumable(_model(), ArrayLoader(ds, 8),
                                     tmm.Adam(1e-2), epochs=2,
                                     checkpoint_dir=d, val_loader=None)),
        "best_streaming_loader": (TypeError, "fit_best_streaming", lambda d:
            tckpt.fit_best_resumable(_model(), plain, tmm.Adam(1e-2),
                                     epochs=2, checkpoint_dir=d,
                                     val_loader=plain)),
        "stream_selection_shuffled": (NotImplementedError, "shuffle",
                                      lambda d: fit_best_streaming(
            _model(), plain, tmm.Adam(1e-2), epochs=2, val_loader=shuffled)),
        "checkpoint_every": (ValueError, "checkpoint_every", lambda d:
            fit_best_streaming(_model(), plain, tmm.Adam(1e-2), epochs=2,
                               val_loader=plain, checkpoint_dir=d,
                               checkpoint_every=0)),
    }


@pytest.mark.parametrize("case", sorted(_guard_cases()))
def test_resume_guards(tmp_path, case):
    exc, match, call = _guard_cases()[case]
    with pytest.raises(exc, match=match):
        call(str(tmp_path / "ck"))


def test_resume_guards_on_a_changed_call(tmp_path):
    """Fewer epochs than the checkpoint has trained (ported as the JAX
    package has it), a train loader of another size or shuffle kind."""
    ds = _dataset(n=32)
    ck = str(tmp_path / "s")
    fit_best_streaming(_model(), StreamingLoader(ds, 8), tmm.Adam(1e-2),
                       epochs=4, val_loader=StreamingLoader(ds, 8),
                       checkpoint_dir=ck, checkpoint_every=2)
    with pytest.raises(ValueError, match="already trained"):
        fit_best_streaming(_model(), StreamingLoader(ds, 8), tmm.Adam(1e-2),
                           epochs=2, val_loader=StreamingLoader(ds, 8),
                           checkpoint_dir=ck)
    ck = str(tmp_path / "a")
    tckpt.fit_resumable(_model(), ArrayLoader(ds, 8, shuffle=True),
                        tmm.Adam(1e-2), epochs=1, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="samples"):
        tckpt.fit_resumable(_model(),
                            ArrayLoader(_dataset(n=40), 8, shuffle=True),
                            tmm.Adam(1e-2), epochs=2, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="fixed-order"):
        tckpt.fit_resumable(_model(), ArrayLoader(ds, 8), tmm.Adam(1e-2),
                            epochs=2, checkpoint_dir=ck)


def test_fit_best_resume_paths_share_one_payload(tmp_path):
    """fit_best_resumable and fit_best_streaming write one payload format
    through one resume path: the same keys, the same best carry and
    scores, the counter the call started from; and both refuse a checkpoint
    that has trained more epochs than the call asks for (in the JAX
    package only fit_best_streaming does)."""
    import pickle
    ds = _dataset(n=32)
    a, s = str(tmp_path / "a"), str(tmp_path / "s")
    tckpt.fit_best_resumable(_model(), ArrayLoader(ds, 8), tmm.Adam8bit(1e-2),
                             epochs=3, checkpoint_dir=a,
                             val_loader=ArrayLoader(ds, 8), chunk_epochs=2)
    fit_best_streaming(_model(), StreamingLoader(ds, 8), tmm.Adam8bit(1e-2),
                       epochs=3, val_loader=StreamingLoader(ds, 8),
                       checkpoint_dir=s, checkpoint_every=2)
    with open(os.path.join(a, "resume_best_latest.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(s, "resume_stream_latest.pkl"), "rb") as f:
        ps = pickle.load(f)
    assert sorted(pa) == sorted(ps)
    assert (pa["epoch"], pa["epoch_counter"]) == (ps["epoch"],
                                                  ps["epoch_counter"]) \
        == (3, 0)
    assert pa["scores"] == ps["scores"] and len(pa["scores"]) == 3
    assert pa["best"]["epoch"] == ps["best"]["epoch"]
    for x, y in _leaf_pairs(pa["best"]["params"], ps["best"]["params"]):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="already trained"):
        tckpt.fit_best_resumable(_model(), ArrayLoader(ds, 8),
                                 tmm.Adam8bit(1e-2), epochs=2,
                                 checkpoint_dir=a,
                                 val_loader=ArrayLoader(ds, 8))
