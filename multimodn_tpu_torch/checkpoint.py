"""Checkpoints and resumable training (PyTorch twin of
``multimodn_tpu/checkpoint.py``).

A checkpoint is a pickle of numpy trees with the reference's best-model
payload keys (``{'epoch', 'model_state_dict', 'auc_bac_val_cum'}``,
``mimic_single_task_pipeline.py:151-158``), plus the optimizer state when
asked. The JAX package writes the same parameter payload, so a parameter
file written by either package loads in the other. Optimizer states cross as
numpy too; ``float8_e4m3fn`` moment codes (``Adam8bit``'s default) and
bfloat16 moments (``Adam(state_dtype=torch.bfloat16)``) are stored as
``uint8`` and ``uint16`` views, since numpy has no such types, and the
optimizer's state turns them back on load. Writes are atomic (a tmp file,
then ``os.replace``).

``CheckpointManager`` keeps the best k checkpoints by score.
``fit_resumable`` and ``fit_best_resumable`` write the whole training state
every ``chunk_epochs`` epochs (parameters, optimizer state, epoch counter,
init-state cycle, history, the train loader's shuffle state and, for the
latter, the best carry and scores); called again with the same directory,
they resume there. ``fit_best_resumable`` and the streamed
``fit_best_streaming`` share one payload and one resume path
(``_fit_best_checkpointed``). Every epoch's dropout generator follows from
the absolute epoch counter, as does every per-batch encoder order that
``shuffle_mode`` draws on a traced chain; a shuffled ``ArrayLoader``'s order
and generator state and the model's per-call order stream
(``random.Random``, ``chain_mode='unrolled'``) ride the payload. So a
chunked, killed and resumed run equals one uninterrupted ``fit`` or
``fit_best`` call bit for bit, dropout and shuffling included. The JAX
package's payload carries no order stream. The JAX package's ``OrbaxCheckpointer`` has no
counterpart: orbax is a JAX library.
"""
from __future__ import annotations

import math
import os
import pickle
from typing import Optional

import numpy as np
import torch

from multimodn_tpu_torch.convert import from_numpy_like, to_numpy
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.interop import adapt_loader, adapt_optimizer


def _to_numpy(tree):
    """Tensors -> numpy copies; float8 codes as uint8 views, bfloat16
    moments as uint16 views (``convert.VIEWED_DTYPES``)."""
    return tree_map(lambda t: to_numpy(t) if torch.is_tensor(t) else t, tree)


def _atomic_pickle(path: str, payload: dict, model=None):
    """Write ``payload`` to ``path`` through a tmp file and ``os.replace``,
    so a kill mid-write never leaves a torn checkpoint. For a meshed
    ``model`` the mesh's first rank writes and every rank returns once the
    file is there."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or mesh.everyone.index == 0:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
    if mesh is not None:
        mesh.everyone.barrier()


def _whole(model, attr: str):
    """``model.params`` or ``model.opt_state`` with whole leaves: a
    ``MultiModN`` gathers its pieces on a mesh (``_whole_params``,
    ``_whole_opt_state``); any other object with ``params`` (``HAIM``, or
    the stand-ins the JAX package's ``save_checkpoint`` also takes) holds
    them whole."""
    whole = getattr(model, f"_whole_{attr}", None)
    return getattr(model, attr) if whole is None else whole()


def save_checkpoint(path: str, model, epoch: int,
                    score: Optional[float] = None,
                    include_opt_state: bool = False,
                    extra: Optional[dict] = None) -> str:
    """Write ``model``'s parameters (a ``MultiModN`` or ``HAIM``) with the
    epoch and validation score, and its optimizer state when asked; returns
    ``path``."""
    payload = {
        "epoch": epoch,
        "model_state_dict": _to_numpy(_whole(model, "params")),
        "auc_bac_val_cum": score,
    }
    if include_opt_state and getattr(model, "opt_state", None) is not None:
        payload["opt_state"] = _to_numpy(_whole(model, "opt_state"))
    if extra:
        payload.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_pickle(path, payload, model)
    return path


def load_checkpoint(path: str, model=None) -> dict:
    """The payload; with ``model``, its parameters are loaded too."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if model is not None:
        model.load_state_dict(payload["model_state_dict"])
    return payload


def opt_state_from_numpy(optimizer, state: dict, params: dict) -> dict:
    """A numpy optimizer state (``_to_numpy``'s form) -> ``optimizer``'s
    state as tensors beside ``params``. Its keys, leaf shapes and types must
    be those of ``optimizer.init(params)``; an ``Adam8bit(fmt='fp8')``'s
    ``uint8`` code views become ``float8_e4m3fn`` again, an
    ``Adam(state_dtype=torch.bfloat16)``'s ``uint16`` moment views (or the
    JAX package's bfloat16 arrays) ``bfloat16``."""
    like = optimizer.init(params)
    if sorted(state) != sorted(like):
        raise ValueError(f"the stored optimizer state holds {sorted(state)}, "
                         f"{type(optimizer).__name__} holds {sorted(like)}")
    out = {}
    for key in like:
        want, got = tree_leaves(like[key]), tree_leaves(state[key])
        if len(want) != len(got):
            raise ValueError(f"optimizer state {key!r}: {len(got)} leaves "
                             f"stored, {len(want)} expected")
        leaves = []
        for w, g in zip(want, got):
            if w is None or g is None:
                if (w is None) != (g is None):
                    raise ValueError(f"optimizer state {key!r}: a leaf is "
                                     f"missing")
                leaves.append(None)
                continue
            t = from_numpy_like(g, w)
            if t.dtype != w.dtype or t.shape != w.shape:
                raise ValueError(
                    f"optimizer state {key!r}: a stored {tuple(t.shape)} "
                    f"{t.dtype} leaf where {tuple(w.shape)} {w.dtype} is "
                    f"expected")
            leaves.append(t)
        it = iter(leaves)
        out[key] = tree_map(lambda _leaf: next(it), like[key])
    return out


def _restore_opt_state(model, optimizer, opt_state_np):
    """Bind a checkpointed (numpy, whole-leaf) optimizer state to ``model``
    on its device, so that training with ``optimizer`` continues it; on a
    mesh it is placed like the parameters (``parallel.shard_opt_state``,
    JAX ``checkpoint.py:116-130``), whatever mesh wrote it."""
    if opt_state_np is None:
        return
    model.opt_state = model._place_opt_state(opt_state_from_numpy(
        optimizer, opt_state_np, model._whole_params()))
    model._opt = optimizer


def _merge_history(payload_history, history):
    """Adopt or merge a checkpointed history: the epochs it holds are never
    dropped on a ``history=None`` resume."""
    if payload_history is None:
        return history
    if history is None:
        return payload_history
    history.__dict__.update(payload_history.__dict__)
    return history


def _loader_state(loader) -> Optional[dict]:
    """A shuffled ``ArrayLoader``'s order and generator state (its next
    reshuffle depends on both); None for other loaders."""
    if not getattr(loader, "shuffle", False) or \
            not hasattr(loader, "stacks"):
        return None
    return {"n_samples": loader.n_samples, "order": loader._order.copy(),
            "rng": loader._rng.bit_generator.state}


def _restore_loader(loader, state: Optional[dict]):
    if (state is None) != (_loader_state(loader) is None):
        kinds = ("shuffled", "fixed-order")[::1 if state else -1]
        raise ValueError(
            f"the checkpoint's train loader was {kinds[0]}, this one is "
            f"{kinds[1]}; resuming would change the batches")
    if state is None:
        return
    if state["n_samples"] != loader.n_samples:
        raise ValueError(
            f"the checkpoint's train loader held {state['n_samples']} "
            f"samples, this one holds {loader.n_samples}")
    loader._order = np.array(state["order"])
    loader._rng.bit_generator.state = state["rng"]
    loader._host, loader._stacks, loader._batch_seq = None, {}, None


def _load_resume_payload(state_path, model, optimizer, history,
                         train_loader=None, max_epochs=None):
    """Restore parameters, optimizer state, counters, the train loader's
    shuffle state and history from a resume checkpoint. Returns ``(start
    epoch, payload, history)``; ``(0, None, history)`` when there is none.
    ``max_epochs``: refuse a checkpoint that has trained more epochs."""
    if not os.path.exists(state_path):
        return 0, None, history
    with open(state_path, "rb") as f:
        payload = pickle.load(f)
    if max_epochs is not None and payload["epoch"] > max_epochs:
        raise ValueError(
            f"this checkpoint has already trained {payload['epoch']} "
            f"epochs but the call asks for epochs={max_epochs}; resuming "
            f"would corrupt the epoch and cycle counters and reuse "
            f"consumed dropout draws. Pass epochs >= {payload['epoch']} "
            f"(or point checkpoint_dir elsewhere).")
    model.load_state_dict(payload["model_state_dict"])
    _restore_opt_state(model, optimizer, payload.get("opt_state"))
    model._epoch_counter = payload["epoch_counter"]
    model._cycle_offset = payload["cycle_offset"]
    if "shuffle_rng" in payload:        # absent from earlier payloads
        model._shuffle_rng.setstate(payload["shuffle_rng"])
    if train_loader is not None:
        _restore_loader(train_loader, payload.get("train_loader"))
    return int(payload["epoch"]), payload, _merge_history(
        payload.get("history"), history)


def _write_resume_payload(state_path, model, epoch, history,
                          train_loader=None, **extra):
    """Atomically write the whole resume state."""
    payload = {
        "epoch": epoch,
        "epoch_counter": model._epoch_counter,
        "cycle_offset": model._cycle_offset,
        "shuffle_rng": model._shuffle_rng.getstate(),
        "model_state_dict": _to_numpy(model._whole_params()),
        "opt_state": _to_numpy(model._whole_opt_state()),
        "history": history,
        "train_loader": _loader_state(train_loader),
    }
    payload.update(extra)
    _atomic_pickle(state_path, payload, model)


def _check_chunks(chunk_epochs: int, name: str = "chunk_epochs"):
    if chunk_epochs < 1:
        raise ValueError(f"{name} must be >= 1, got {chunk_epochs}")


def _fit_best_checkpointed(model, train_loader, optimizer, criterion, epochs,
                           val_loader, history, val_tag, restore_best,
                           state_path=None, every=1, on_chunk=None,
                           on_epoch=None):
    """``MultiModN._fit_best`` with its whole state (``_write_resume_payload``
    plus the best carry and the scores) written to ``state_path`` after
    every ``every``-th epoch and after the last; a payload already there is
    resumed first. The one resume path of ``fit_best_resumable`` and
    ``data.streaming.fit_best_streaming``. Within the call the model's
    epoch counter stays where the call started (``_fit_best`` adds the
    epochs at its end), so the payload holds that counter and the epochs
    done. ``on_epoch({"epoch", "score"})`` runs after each epoch's
    selection, ``on_chunk(epochs_done, epochs)`` after each write.

    Returns ``(info, history, start epoch)``."""
    from multimodn_tpu_torch.convert import params_from_jax

    start, payload, resume = 0, None, None
    if state_path is not None:
        start, payload, history = _load_resume_payload(
            state_path, model, optimizer, history, train_loader,
            max_epochs=epochs)
    if payload is not None:
        best = payload["best"]
        # The best carry is re-sharded for this run's mesh (JAX
        # data/streaming.py:765-771).
        resume = {"best": (model._pieces(params_from_jax(best["params"],
                                                         model.device)),
                           best["score"], best["epoch"]),
                  "scores": payload["scores"]}

    def after_epoch(e, best, scores):
        if on_epoch is not None:
            on_epoch({"epoch": e, "score": scores[-1]})
        if state_path is None or ((e + 1) % every and e + 1 != epochs):
            return
        bp, bs, be = best
        _write_resume_payload(
            state_path, model, e + 1, history, train_loader,
            best={"params": _to_numpy(model._whole(bp)), "score": bs,
                  "epoch": be},
            scores=list(scores))
        if on_chunk is not None:
            on_chunk(e + 1, epochs)

    info = model._fit_best(train_loader, optimizer, criterion, epochs,
                           val_loader, history, val_tag, restore_best, None,
                           resume=resume, after_epoch=after_epoch)[0]
    return info, history, start


class CheckpointManager:
    """The best ``keep`` checkpoints by score (``mode='max'`` keeps the
    highest), files ``<prefix>_epoch<epoch>_<n>.pkl`` in ``directory``."""

    def __init__(self, directory: str, prefix: str = "ckpt", keep: int = 1,
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.directory = directory
        self.prefix = prefix
        self.keep = keep
        self.sign = 1.0 if mode == "max" else -1.0
        self._tracked = []  # (signed score, epoch, path), best first
        self._n_saves = 0   # keeps paths unique when an epoch is saved twice
        os.makedirs(directory, exist_ok=True)

    def save(self, model, epoch: int, score: float, **extra) -> bool:
        """Write a checkpoint if ``score`` ranks among the best ``keep``
        (a NaN score never does); returns whether it was written."""
        if math.isnan(score):
            return False
        signed = self.sign * score
        if len(self._tracked) >= self.keep and \
                signed <= min(s for s, _, _ in self._tracked):
            return False
        self._n_saves += 1
        path = os.path.join(
            self.directory, f"{self.prefix}_epoch{epoch}_{self._n_saves}.pkl")
        save_checkpoint(path, model, epoch, score, extra=extra or None)
        self._tracked.append((signed, epoch, path))
        self._tracked.sort(reverse=True)
        while len(self._tracked) > self.keep:
            _, _, old = self._tracked.pop()
            if os.path.exists(old):
                os.remove(old)
        return True

    @property
    def best_path(self) -> Optional[str]:
        return self._tracked[0][2] if self._tracked else None

    def restore_best(self, model) -> Optional[dict]:
        if self.best_path is None:
            return None
        return load_checkpoint(self.best_path, model)


def fit_resumable(model, train_loader, optimizer, criterion=None, *,
                  epochs: int, checkpoint_dir: str, chunk_epochs: int = 10,
                  history=None, val_loader=None, val_tag: str = "val",
                  on_chunk=None):
    """``fit`` in chunks of ``chunk_epochs``, the whole training state
    written atomically to ``<checkpoint_dir>/resume_latest.pkl`` after each
    chunk; called again after an interruption, it resumes from there (and
    does nothing once ``epochs`` are done). ``on_chunk(epochs_done,
    epochs)`` runs after each chunk's checkpoint.

    Streaming loaders (``data.streaming``, ``data.disk``) train each chunk
    through ``fit_streaming``, epoch by epoch, so a model with the per-call
    shuffle cadence trains there too; train and val loaders must be of one
    kind,
    and neither may be a shuffled streaming loader (its permutation lives in
    the host loader, or its torch sampler, and is not in the payload).

    A torch optimizer or ``DataLoader`` is mapped onto the port's
    (``interop``), as in ``fit``.

    Returns ``(history, epochs run by this call)``."""
    train_loader, val_loader = adapt_loader(train_loader), \
        adapt_loader(val_loader)
    optimizer = adapt_optimizer(optimizer)
    streaming = hasattr(train_loader, "iter_batches")
    if val_loader is not None and \
            hasattr(val_loader, "iter_batches") != streaming:
        raise ValueError(
            "mixed loaders: train and val must both be streaming "
            "(iter_batches) or both ArrayLoaders.")
    if streaming and any(getattr(ldr, "shuffle", False)
                         for ldr in (train_loader, val_loader)):
        raise NotImplementedError(
            "fit_resumable cannot honour a shuffle=True streaming loader: "
            "its permutation lives in the host loader (or its torch "
            "sampler) and is not part of the resume payload, so a resumed "
            "process would REPLAY the early epochs' orders. Stream with "
            "shuffle=False, or use a shuffled ArrayLoader, whose order and "
            "generator state the payload carries.")
    _check_chunks(chunk_epochs)
    os.makedirs(checkpoint_dir, exist_ok=True)
    state_path = os.path.join(checkpoint_dir, "resume_latest.pkl")
    start, _, history = _load_resume_payload(state_path, model, optimizer,
                                             history, train_loader)
    ran = 0
    while start < epochs:
        n = min(chunk_epochs, epochs - start)
        if streaming:
            from multimodn_tpu_torch.data.streaming import fit_streaming
            history = fit_streaming(
                model, train_loader, optimizer, criterion, epochs=n,
                history=history, val_loader=val_loader, val_tag=val_tag)
        else:
            model.fit(train_loader, optimizer, criterion, epochs=n,
                      history=history, val_loader=val_loader,
                      val_tag=val_tag)
        start += n
        ran += n
        _write_resume_payload(state_path, model, start, history,
                              train_loader)
        if on_chunk is not None:
            on_chunk(start, epochs)
    return history, ran


def fit_best_resumable(model, train_loader, optimizer, criterion=None, *,
                       epochs: int, checkpoint_dir: str, val_loader,
                       chunk_epochs: int = 10, history=None,
                       val_tag: str = "val", restore_best: bool = True,
                       on_chunk=None) -> dict:
    """``fit_best`` with a resume checkpoint
    (``<checkpoint_dir>/resume_best_latest.pkl``) every ``chunk_epochs``
    epochs and after the last; the best carry (parameters, score, epoch) and
    every score ride the payload. Each epoch's dropout draws follow from the
    absolute epoch, so a killed and resumed run equals one ``fit_best`` call
    bit for bit, with dropout and a shuffled train ``ArrayLoader`` too. A
    checkpoint that has trained more than ``epochs`` is refused. Streaming
    loaders resume through ``fit_best_streaming(checkpoint_dir=)``. A torch
    optimizer or ``DataLoader`` is mapped onto the port's (``interop``), as
    in ``fit_best``.

    Returns ``{"best_epoch", "best_score", "best_params", "scores",
    "history", "epochs_run"}``; with ``restore_best`` the model's parameters
    become the global best epoch's."""
    if val_loader is None:
        raise ValueError("fit_best_resumable requires a val_loader")
    train_loader, val_loader = adapt_loader(train_loader), \
        adapt_loader(val_loader)
    optimizer = adapt_optimizer(optimizer)
    if any(hasattr(ldr, "iter_batches") for ldr in (train_loader,
                                                     val_loader)):
        raise TypeError(
            "fit_best_resumable trains ArrayLoaders; streaming loaders "
            "resume through data.streaming.fit_best_streaming("
            "checkpoint_dir=...)")
    _check_chunks(chunk_epochs)
    os.makedirs(checkpoint_dir, exist_ok=True)
    info, history, start = _fit_best_checkpointed(
        model, train_loader, optimizer, criterion, epochs, val_loader,
        history, val_tag, restore_best,
        os.path.join(checkpoint_dir, "resume_best_latest.pkl"),
        chunk_epochs, on_chunk)
    return {
        "best_epoch": info["best_epoch"],
        "best_score": info["best_score"],
        "best_params": info["best_params"],
        "scores": info["scores"],
        "history": history,
        "epochs_run": info["epochs_ran"] - start,
    }
