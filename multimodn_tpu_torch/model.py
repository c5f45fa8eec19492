"""The MultiModN model object (PyTorch twin of ``multimodn_tpu/model.py``).

A model holds static encoder, decoder and init-state configs plus one
parameter tree ``{"init_state", "encoders", "decoders"}`` of float32 tensors
on its device, in the JAX package's layout (per-encoder lists, dense weights
``(in, out)``), so ``state_dict`` / ``load_state_dict`` exchange weights with
the JAX package as plain copies.

Inference: ``predict`` / ``predict_proba`` on per-modality arrays or a
loader (no NaN skip, quirk #9), ``fused_forward`` through the fused-chain
CUDA kernel, and ``get_states``. Training: ``train_epoch``, ``test``, ``fit``
and ``fit_best``, one Python loop over batches per epoch with one host
transfer per epoch; the optimizer state lives in ``opt_state``. Every one
of them takes an ``ArrayLoader`` or a streaming loader (``data.streaming``,
``data.disk``), whose batches are copied to the device one ahead; a torch
optimizer, loss module or ``DataLoader`` is mapped onto the port's first
(``interop``), and ``parameters()`` lets a torch optimizer be built. The
``StaticInitState`` cycle continues across every call, as the reference's
shared ``itertools.cycle`` does.

The encoder order follows the JAX package: a loader's dataset may give
one encoder sequence or one per batch, a static order may repeat an encoder,
and ``shuffle_mode`` draws a fresh order per training batch on the traced
chains (``chain_mode`` 'auto', 'scan', 'switch'), or once per call with
``random.Random(seed)`` on an explicit ``chain_mode='unrolled'``.
"""
from __future__ import annotations

import itertools
import random
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from multimodn_tpu_torch.convert import params_from_jax, params_to_numpy, \
    stack_encoders
from multimodn_tpu_torch.core.fusion import default_order, \
    has_repeated_encoders
from multimodn_tpu_torch.core.scan_chain import encoders_homogeneous
from multimodn_tpu_torch.core.history import MultiModNHistory
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.metrics import get_performance_metrics
from multimodn_tpu_torch.core.nn import resolve_device
from multimodn_tpu_torch.core.state import (
    InitState,
    StaticInitState,
    TrainableInitState,
)
from multimodn_tpu_torch.core.step import (
    epoch_reduction,
    make_batch_loss_fn,
    make_forward_fn,
    make_selection_score,
    run_eval_epoch,
    run_train_epoch,
    stack_batches,
    to_host,
    update_best,
)
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.interop import adapt_loader, adapt_optimizer
from multimodn_tpu_torch.ops.fused_chain import ChainSpec, fused_chain_forward
from multimodn_tpu_torch.optim import Optimizer
from multimodn_tpu_torch.utils.summary import summarize_model

CHAIN_MODES = ("auto", "unrolled", "scan", "switch")
TRACED_CHAINS = ("scan", "switch")
# Keys the per-batch order permutations of a training epoch apart from its
# dropout draws (the JAX package folds the same constant into its batch key,
# core/step.py:221).
ORDER_FOLD = 982451653


class TrainingPlan(NamedTuple):
    """A training call's batch loss, whether its chain shuffles the order
    per batch, the static order, and whether orders come per batch."""
    loss_fn: Callable
    shuffle: bool
    order: tuple
    per_batch: bool


class MultiModN:
    """Sequential multimodal fusion over a shared state.

    ``device`` defaults to CUDA; without a GPU the caller must pass
    ``device="cpu"``. ``presence_dropout`` and ``presence_penalty`` are the
    MNAR mitigations of ``nan_skip='sample'``, active in training only
    (``core/step.py``).

    ``chain_mode`` picks the chain as the JAX package does
    (``_chain_plan``): 'unrolled' runs a static order; 'scan' (identical
    encoders only) and 'switch' take the order per batch, which
    ``shuffle_mode`` redraws for every training batch and a loader's
    per-batch sequences supply; 'auto' takes 'scan' for identical encoders
    when ``shuffle_mode`` is on or there are 16 or more, 'switch' for mixed
    encoders under ``shuffle_mode``, else 'unrolled'. With an explicit
    'unrolled', ``shuffle_mode`` shuffles the order once per training call
    with ``random.Random(seed)``, and ``fit`` / ``fit_best`` refuse it. All
    chains give the same results on the same order. Parameters stay in
    per-encoder storage whatever the chain. ``scan_unroll`` is stored and
    exported for the JAX package, where it unrolls the batch scan; it has
    no effect here."""

    def __init__(
        self,
        state_size: int,
        encoders: Sequence,
        decoders: Sequence,
        err_penalty: float,
        state_change_penalty: float,
        shuffle_mode: bool = False,
        init_state: Optional[InitState] = None,
        nan_skip: str = "sample",
        ones_initialized_counts: bool = True,
        seed: int = 0,
        presence_dropout: float = 0.0,
        presence_penalty: float = 0.0,
        chain_mode: str = "auto",
        scan_unroll=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.state_size = state_size
        self.encoders = list(encoders)
        self.decoders = list(decoders)
        for kind, modules in (("Encoder", self.encoders),
                              ("Decoder", self.decoders)):
            for i, m in enumerate(modules):
                if getattr(m, "state_size", state_size) != state_size:
                    raise ValueError(
                        f"{kind} {i} ({type(m).__name__}) has state_size "
                        f"{m.state_size}, model expects {state_size}")
        if nan_skip not in ("sample", "batch", "none"):
            raise ValueError(
                f"nan_skip must be 'sample', 'batch', or 'none', "
                f"got {nan_skip!r}")
        if not (0.0 <= float(presence_dropout) < 1.0):
            raise ValueError(
                f"presence_dropout must be in [0, 1), got {presence_dropout}")
        if float(presence_penalty) < 0.0:
            raise ValueError(
                f"presence_penalty must be >= 0, got {presence_penalty}")
        if (presence_dropout or presence_penalty) and nan_skip != "sample":
            raise ValueError(
                "presence_dropout/presence_penalty are sample-granularity "
                "MNAR mitigations; they require nan_skip='sample' ('batch' "
                "is already presence-robust, 'none' never skips).")
        if chain_mode not in CHAIN_MODES:
            raise ValueError(f"chain_mode must be one of {CHAIN_MODES}, got "
                             f"{chain_mode!r}")
        self.err_penalty = float(err_penalty)
        # The reference bakes a 0.01 factor into the constructor (quirk #1).
        self.state_change_penalty = 0.01 * float(state_change_penalty)
        self.shuffle_mode = shuffle_mode
        self.nan_skip = nan_skip
        self.ones_initialized_counts = ones_initialized_counts
        self.presence_dropout = float(presence_dropout)
        self.presence_penalty = float(presence_penalty)
        self.chain_mode = chain_mode
        self.scan_unroll = scan_unroll
        self._chain_plan()      # chain_mode='scan' needs identical encoders
        self._seed = seed
        # The per-call shuffle cadence's order stream (chain_mode='unrolled').
        self._shuffle_rng = random.Random(seed)
        self.init_state = (init_state if init_state is not None
                           else TrainableInitState(state_size))
        self.init_state.to(self.device)

        gen = torch.Generator().manual_seed(seed)
        self.params = {
            "init_state": self.init_state.init(gen, self.device),
            "encoders": [e.init(gen, self.device) for e in self.encoders],
            "decoders": [d.init(gen, self.device) for d in self.decoders],
        }
        self._chain_spec = None
        # Samples served by a StaticInitState so far: its round-robin phase
        # continues across calls, like the reference's shared
        # itertools.cycle.
        self._cycle_offset = 0
        self._opt = None            # the optimizer opt_state belongs to
        self.opt_state = None
        self._epoch_counter = 0     # seeds each training epoch's draws

    # ------------------------------------------------------------------
    # Cycle bookkeeping
    # ------------------------------------------------------------------
    def _static_cycle(self) -> bool:
        return isinstance(self.init_state, StaticInitState)

    def _cycle_base(self) -> int:
        if not self._static_cycle():
            return 0
        return self._cycle_offset % self.init_state.n_states

    def _advance_cycle(self, consumed: int):
        """Advance the cycle by the samples a call consumed; called after
        the call ran, so a call that raises does not shift the phase."""
        if self._static_cycle():
            self._cycle_offset = ((self._cycle_offset + consumed)
                                  % self.init_state.n_states)

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def _chain_plan(self):
        """``(chain, shuffles in the chain)`` from ``chain_mode`` (JAX
        ``model.py:237-256``)."""
        if self.chain_mode == "unrolled":
            return "unrolled", False
        homogeneous = encoders_homogeneous(self.encoders)
        if self.chain_mode == "scan":
            if not homogeneous:
                raise ValueError(
                    "chain_mode='scan' requires structurally identical "
                    "encoders (same class, dims, activation)")
            return "scan", self.shuffle_mode
        if self.chain_mode == "switch":
            return "switch", self.shuffle_mode
        if homogeneous and (self.shuffle_mode or len(self.encoders) >= 16):
            return "scan", self.shuffle_mode
        if not homogeneous and self.shuffle_mode:
            return "switch", True
        return "unrolled", False

    def _check_repeat_downgrade(self, for_eval: bool = False):
        """An order that repeats an encoder runs unrolled (JAX
        ``model.py:442-466``): refuse an explicit traced ``chain_mode``,
        and a training ``shuffle_mode`` the unrolled chain cannot redraw per
        batch."""
        if self.chain_mode != "auto":
            raise ValueError(
                "encoding sequences with REPEATED encoders need the "
                "unrolled chain (per-execution metric accumulation, "
                "multimodn.py:171-192); drop chain_mode="
                f"{self.chain_mode!r} or use 'auto'/'unrolled'.")
        if self.shuffle_mode and not for_eval:
            raise NotImplementedError(
                "shuffle_mode with a REPEATED encoding sequence cannot "
                "shuffle per batch (the traced chains reject repeats); "
                "construct the model with chain_mode='unrolled' for the "
                "per-call shuffle cadence.")

    def _validate_fused_shuffle(self):
        """``fit`` / ``fit_best`` would train every epoch on the one order
        the per-call cadence draws (JAX ``model.py:499-507``)."""
        if self.shuffle_mode and not self._chain_plan()[1]:
            raise NotImplementedError(
                "fit()/fit_best() cannot express the unrolled chain's "
                "per-call encoder-order shuffle (one order would be frozen "
                "for every epoch, unlike the reference's per-batch redraw); "
                "loop train_epoch() or use a homogeneous/scan or switch "
                "chain, which shuffles per batch.")

    def _validate_pairings(self, order, loader, seqs=None):
        """Every (modality, encoder) pairing that will run must agree in
        width, and per-batch sequences may not repeat an encoder (JAX
        ``model.py:531-565``). ``seqs`` holds per-batch rows; without it,
        ``order`` is checked."""
        widths = getattr(loader, "modality_widths", None)

        def check(pairs):
            if widths is None:
                return
            for k, e in pairs:
                nf = getattr(self.encoders[int(e)], "n_features", None)
                if nf is not None and widths[int(k)] != nf:
                    raise ValueError(
                        f"encoding sequence pairs modality {int(k)} (width "
                        f"{widths[int(k)]}) with encoder {int(e)} "
                        f"(n_features {nf}); widths must match.")

        if seqs is None:
            check(order)
            return
        for row in np.asarray(seqs):
            check(list(enumerate(row)))
            if len({int(v) for v in row}) < len(row):
                raise NotImplementedError(
                    "per-batch encoding sequences with REPEATED "
                    "encoders are not supported: the traced-order "
                    "chains keep one metric row per encoder and cannot "
                    "express the reference's per-execution accumulation "
                    "(multimodn.py:171-192). Uniform repeated sequences "
                    "work through the unrolled chain.")

    def _resolve_order(self, loader=None, encoder_sequence=None,
                       train: bool = False):
        """The static ``((data_idx, enc_idx), ...)`` order: the loader's
        (or the given) uniform sequence paired with modalities 0..L-1, else
        the identity. In training on the unrolled chain, ``shuffle_mode``
        shuffles it with the model's ``random.Random`` (once per call)."""
        if encoder_sequence is None and loader is not None:
            encoder_sequence = getattr(loader, "encoding_sequence", None)
        if encoder_sequence is None:
            order = list(default_order(len(self.encoders)))
        else:
            seq = np.asarray(encoder_sequence).reshape(-1)
            order = [(int(k), int(e)) for k, e in enumerate(seq)]
        if self.shuffle_mode and train and \
                self._chain_plan()[0] not in TRACED_CHAINS:
            self._shuffle_rng.shuffle(order)
        return tuple(order)

    @staticmethod
    def _batch_seqs(loader):
        """The loader's per-batch orders, or None (a uniform sequence, none,
        or a streaming loader)."""
        fn = getattr(loader, "batch_sequences", None)
        return fn() if fn is not None else None

    @staticmethod
    def _has_batch_seqs(loader) -> bool:
        fn = getattr(loader, "has_per_batch_sequences", None)
        return fn is not None and fn()

    def _uniform_order(self, loader) -> tuple:
        es = getattr(loader, "encoding_sequence", None)
        return tuple(int(v) for v in np.asarray(es).reshape(-1)) \
            if es is not None else tuple(range(len(self.encoders)))

    def _loader_seqs(self, loader) -> np.ndarray:
        """``(n_batches, L)`` orders for a traced run over ``loader``: its
        per-batch sequences, or its uniform order (the identity without
        one) in every batch; validated (``_validate_pairings``)."""
        seqs = self._batch_seqs(loader)
        if seqs is None:
            seqs = np.tile(np.asarray(self._uniform_order(loader)),
                           (loader.n_batches, 1))
        self._validate_pairings((), loader, seqs)
        return seqs

    def _fused_per_batch(self, train_loader, val_loader) -> bool:
        """Whether ``fit`` / ``fit_best`` run per-batch orders: a loader
        carries per-batch sequences, or the train and val loaders carry
        different uniform orders, which each keep (JAX ``_fused_seqs``,
        ``model.py:368-425``)."""
        if self._has_batch_seqs(train_loader) or (
                val_loader is not None and self._has_batch_seqs(val_loader)):
            return True
        return val_loader is not None and \
            self._uniform_order(train_loader) != \
            self._uniform_order(val_loader)

    def _forward_chain(self, order) -> str:
        """The chain a forward pass of ``order`` runs (JAX ``_forward_fn``):
        a repeated order runs unrolled where ``chain_mode`` allows it."""
        chain = self._chain_plan()[0]
        if chain in TRACED_CHAINS and has_repeated_encoders(order):
            self._check_repeat_downgrade(for_eval=True)
            chain = "unrolled"
        return chain

    def _forward(self, order, nan_skip):
        return make_forward_fn(self.encoders, self.decoders, self.init_state,
                               order, nan_skip, self._forward_chain(order))

    def _batch_forwards(self, loader, nan_skip):
        """An iterator of one forward function per batch of ``loader`` (its
        own order for per-batch sequences), the pairings validated now."""
        seqs = self._batch_seqs(loader)
        order = self._resolve_order(loader)
        self._validate_pairings(order, loader, seqs)
        if seqs is None:
            return itertools.repeat(self._forward(order, nan_skip))
        return (self._forward(tuple(enumerate(int(e) for e in row)),
                              nan_skip) for row in seqs)

    def _to_device(self, x: Sequence) -> tuple:
        return tuple(torch.as_tensor(np.asarray(m, np.float32)
                                     if not torch.is_tensor(m) else m,
                                     dtype=torch.float32, device=self.device)
                     for m in x)

    @staticmethod
    def _is_loader(x) -> bool:
        """An ``ArrayLoader`` or a streaming loader (a torch ``DataLoader``
        is adapted to an ``ArrayLoader`` before this check)."""
        return hasattr(x, "stacks") or MultiModN._streams(x)

    @staticmethod
    def _streams(loader) -> bool:
        """A streaming loader (``data.streaming``, ``data.disk``): host
        batches from ``iter_batches()``, no epoch stacks."""
        return hasattr(loader, "iter_batches")

    def _batches(self, loader):
        """``(batch, n_real)`` pairs of one pass over ``loader`` on this
        model's device: slices of an ``ArrayLoader``'s epoch stacks, or a
        streaming loader's batches copied one ahead of use."""
        if self._streams(loader):
            from multimodn_tpu_torch.data.streaming import device_batches
            return device_batches(loader, self.device)
        return stack_batches(loader.stacks(self.device),
                             loader.batch_counts())

    @torch.no_grad()
    def _predict(self, x: Sequence, encoder_sequence):
        data = self._to_device(x)
        n = data[0].shape[0]
        fwd = self._forward(self._resolve_order(None, encoder_sequence),
                            "none")
        preds, outputs, _, _ = fwd(
            self.params, data, torch.ones((n,), device=self.device),
            init_offset=self._cycle_base())
        self._advance_cycle(n)
        return preds, outputs

    @torch.no_grad()
    def _predict_loader(self, loader):
        """The no-skip forward over a loader's batches, padded rows
        dropped: ``(preds (E+1, D, N), outputs list of (E+1, N, C_d))``."""
        forwards = self._batch_forwards(loader, "none")
        start = offset = self._cycle_base()
        preds, outs = [], []
        for (data, _targets, mask), n_real in self._batches(loader):
            p, o, _, _ = next(forwards)(self.params, data, mask,
                                        init_offset=offset)
            offset += n_real
            preds.append(p[:, :, :n_real])
            outs.append([out[:, :n_real] for out in o])
        if not preds:
            raise ValueError("the loader yielded no batches")
        self._advance_cycle(offset - start)
        return (torch.cat(preds, dim=2),
                [torch.cat([o[d] for o in outs], dim=1)
                 for d in range(len(self.decoders))])

    @staticmethod
    def _no_sequence_with_loader(encoder_sequence):
        if encoder_sequence is not None:
            raise ValueError(
                "pass encoder sequences through the loader's dataset when "
                "predicting from a loader")

    def predict(self, x, encoder_sequence=None) -> np.ndarray:
        """(E+1, D, N) argmax class predictions after every step, from
        per-modality arrays or a loader (batch by batch).

        NaN inputs are NOT skipped here, matching the reference's predict
        (quirk #9): a NaN flows through the encoder into the state."""
        x = adapt_loader(x)
        if self._is_loader(x):
            self._no_sequence_with_loader(encoder_sequence)
            return self._predict_loader(x)[0].cpu().numpy()
        return self._predict(x, encoder_sequence)[0].cpu().numpy()

    def predict_proba(self, x, encoder_sequence=None) -> List[np.ndarray]:
        """Per-decoder (E+1, N, C_d) raw decoder outputs after every step,
        with ``predict``'s no-skip semantics."""
        x = adapt_loader(x)
        if self._is_loader(x):
            self._no_sequence_with_loader(encoder_sequence)
            outs = self._predict_loader(x)[1]
        else:
            outs = self._predict(x, encoder_sequence)[1]
        return [o.cpu().numpy() for o in outs]

    @torch.no_grad()
    def fused_forward(self, x: Sequence):
        """The whole encoder chain and every decoder head in one fused-chain
        kernel launch on a CUDA model (its plain PyTorch version on a CPU
        model), with per-sample NaN skip: a sample whose modality holds a
        NaN keeps its state for that step, whatever ``nan_skip`` says.

        Returns ``(states (E+1, N, S), outputs list of (E+1, N, C_d))`` as
        float32 tensors on the model's device."""
        if isinstance(self.init_state, StaticInitState) and \
                self.init_state.n_states > 1:
            raise NotImplementedError(
                "fused_forward broadcasts ONE initial-state row; a "
                "multi-row StaticInitState bank assigns different rows per "
                "sample — use predict()/predict_proba() for those models.")
        if self._chain_spec is None:
            self._chain_spec = ChainSpec(self.encoders, self.decoders,
                                         self.state_size)
        data = self._to_device(x)
        valid = torch.stack(
            [~torch.isnan(m).flatten(1).any(dim=1) for m in data],
            dim=1).float()
        data = tuple(torch.nan_to_num(m).contiguous() for m in data)
        init_row = self.init_state.apply(
            self.params["init_state"], 1, 0)[0].contiguous()
        return fused_chain_forward(self._chain_spec, self.params, data,
                                   valid, init_row)

    @torch.no_grad()
    def get_states(self, loader) -> List[np.ndarray]:
        """The final fusion state of every sample of ``loader``, with the
        model's NaN skip and the padded rows dropped (reference
        ``multimodn.py:460-492``); a ``StaticInitState`` cycle advances by
        the loader's samples, as in every other call."""
        loader = adapt_loader(loader)
        forwards = self._batch_forwards(loader, self.nan_skip)
        start = offset = self._cycle_base()
        states = []
        for (data, _targets, mask), n_real in self._batches(loader):
            final = next(forwards)(self.params, data, mask,
                                   init_offset=offset)[3]
            offset += n_real
            states.append(final[mask > 0])
        self._advance_cycle(offset - start)
        return list(torch.cat(states).cpu().numpy())

    # ------------------------------------------------------------------
    # Training / evaluation
    # ------------------------------------------------------------------
    def _loss_fn(self, criterion, order, per_batch: bool = False):
        """The batch loss on the planned chain (JAX ``model.py:260-289``):
        a static order that repeats an encoder runs unrolled, per-batch
        orders run a traced chain."""
        chain, shuffle = self._chain_plan()
        if not per_batch and chain in TRACED_CHAINS and \
                has_repeated_encoders(order):
            self._check_repeat_downgrade()
            chain, shuffle = "unrolled", False
        if per_batch and chain == "unrolled":
            chain = "scan" if encoders_homogeneous(self.encoders) \
                else "switch"
        loss_fn = make_batch_loss_fn(
            self.encoders, self.decoders, self.init_state, criterion,
            self.err_penalty, self.state_change_penalty, order, self.nan_skip,
            chain, presence_dropout=self.presence_dropout,
            presence_penalty=self.presence_penalty, shuffle=shuffle,
            per_batch_seq=per_batch)
        return loss_fn, shuffle

    def _use_optimizer(self, optimizer: Optimizer):
        """A new optimizer starts a new state; the same one continues."""
        if self._opt is not optimizer or self.opt_state is None:
            self._opt = optimizer
            self.opt_state = optimizer.init(self.params)

    def _generator(self, epoch: int) -> torch.Generator:
        """The dropout generator of this model's training epoch ``epoch``."""
        return torch.Generator(device=self.device).manual_seed(
            self._seed * 1_000_003 + epoch)

    def _order_perms(self, epoch: int, length: int):
        """The per-batch order permutations of training epoch ``epoch`` on a
        chain that shuffles: one ``torch.randperm(length)`` per batch from a
        CPU generator keyed on the seed and the absolute epoch, so every
        device draws the same orders and a resumed fit redraws them."""
        gen = torch.Generator().manual_seed(
            (self._seed + ORDER_FOLD) * 1_000_003 + epoch)
        while True:
            yield torch.randperm(length, generator=gen)

    def _train_pass(self, loader, optimizer, plan, epoch: int):
        """One training epoch of ``plan`` (``_plan_training``); returns its
        grid sums and batch log on the device and the batches run."""
        loader.reshuffle()
        seqs = self._loader_seqs(loader) if plan.per_batch else None
        perms = None
        if plan.shuffle:
            perms = self._order_perms(
                epoch, len(plan.order) if seqs is None else seqs.shape[1])
        start = self._cycle_base()
        self.opt_state, sums, batch_log, offset, n_batches = run_train_epoch(
            plan.loss_fn, optimizer, self.params, self.opt_state,
            self._batches(loader), self._generator(epoch), start, seqs,
            perms)
        self._advance_cycle(offset - start)
        return sums, batch_log, n_batches

    def _eval_pass(self, loader, loss_fn, per_batch: bool = False):
        """One evaluation epoch: ``(grid sums, final-row outputs, targets,
        sample mask)`` on the device and the batches run."""
        seqs = self._loader_seqs(loader) if per_batch else None
        start = self._cycle_base()
        sums, outputs, targets, mask, offset, n_batches = run_eval_epoch(
            loss_fn, self.params, self._batches(loader), start, seqs)
        self._advance_cycle(offset - start)
        return (sums, outputs, targets, mask), n_batches

    def _plan_training(self, criterion, train_loader, val_loader=None,
                       fused: bool = False) -> TrainingPlan:
        """Resolve a training call's order and chain before it trains.
        ``fused`` marks ``fit`` / ``fit_best``, which refuse the per-call
        shuffle cadence and run per-batch orders when the train and val
        orders differ."""
        if fused:
            self._validate_fused_shuffle()
        order = self._resolve_order(train_loader, train=True)
        if fused:
            per_batch = self._fused_per_batch(train_loader, val_loader)
        else:
            per_batch = self._has_batch_seqs(train_loader)
        if per_batch:
            for ldr in (train_loader, val_loader):
                if ldr is not None:
                    self._loader_seqs(ldr)
        if not self._has_batch_seqs(train_loader):
            self._validate_pairings(order, train_loader)
        loss_fn, shuffle = self._loss_fn(criterion, order, per_batch)
        return TrainingPlan(loss_fn, shuffle, order, per_batch)

    def _stats(self, host_sums: dict, n_batches: int) -> dict:
        return {k: v.numpy() for k, v in epoch_reduction(
            host_sums, n_batches, self.ones_initialized_counts).items()}

    def train_epoch(
        self,
        train_loader,
        optimizer: Optimizer,
        criterion: Union[str, Callable, None] = None,
        history: Optional[MultiModNHistory] = None,
        log_interval: Optional[int] = None,
        logger: Optional[Callable] = None,
        last_epoch: bool = False,
    ):
        """One training epoch over ``train_loader``. With ``last_epoch``
        it returns ``test`` on the training loader, as the reference does
        (multimodn.py:251, quirk #16)."""
        train_loader = adapt_loader(train_loader)
        optimizer = adapt_optimizer(optimizer)
        criterion = resolve_criterion(criterion)
        self._train_epoch(train_loader, optimizer, criterion, history,
                          log_interval, logger)
        if last_epoch:
            return self.test(train_loader, criterion, history=None)
        return None

    def _train_epoch(self, train_loader, optimizer, criterion, history,
                     log_interval=None, logger=None) -> dict:
        """``train_epoch`` without ``last_epoch``; returns the epoch's
        history metrics."""
        if log_interval and not logger:
            logger = print
        plan = self._plan_training(criterion, train_loader)
        self._use_optimizer(optimizer)
        sums, batch_log, n_batches = self._train_pass(
            train_loader, optimizer, plan, self._epoch_counter)
        self._epoch_counter += 1
        sums, batch_log = to_host([sums, batch_log])
        stats = self._stats(sums, n_batches)
        if log_interval:
            # The reference's in-loop log lines (multimodn.py:214-220),
            # written after the epoch from the per-batch values.
            for b in range(log_interval - 1, n_batches, log_interval):
                logger(f"Batch {b + 1}/{n_batches}\n"
                       f"\tLoss: {batch_log[b][0]:.4f}\n"
                       f"\tErr loss: {batch_log[b][1]:.4f}\n"
                       f"\tState change: {batch_log[b][2]:.4f}")
        if history is not None:
            history.append_epoch("train", stats,
                                 state_change=stats["state_change_loss"])
        return stats

    def test(
        self,
        test_loader,
        criterion: Union[str, Callable, None] = None,
        history: Optional[MultiModNHistory] = None,
        tag: str = "test",
        log_results: bool = False,
        logger: Optional[Callable] = None,
    ) -> list:
        """Evaluate on ``test_loader``; returns one 15-tuple of
        ``get_performance_metrics`` per decoder, from the final encoder
        row's outputs normalised by their row sums (not softmax, quirk
        #5)."""
        if log_results and not logger:
            logger = print
        test_loader = adapt_loader(test_loader)
        criterion = resolve_criterion(criterion)
        seqs = self._batch_seqs(test_loader)
        order = self._resolve_order(test_loader)
        self._validate_pairings(order, test_loader, seqs)
        loss_fn, _ = self._loss_fn(criterion, order, seqs is not None)
        (sums, outputs, targets, mask), n_batches = self._eval_pass(
            test_loader, loss_fn, seqs is not None)
        sums, outputs = to_host([sums, outputs])
        stats = self._stats(sums, n_batches)
        if log_results:
            logger(f"{tag.capitalize()} results\n"
                   f"\tAverage loss: {float(np.mean(stats['loss'])):.4f}\n"
                   f"\tAccuracy: {float(np.mean(stats['accuracy'])):.4f}")
        if history is not None:
            history.append_epoch(tag, stats)
        flat_mask = mask.cpu().numpy() > 0
        flat_targets = targets.cpu().numpy()[flat_mask]
        results = []
        for d, out in enumerate(outputs):
            out = out.numpy()[flat_mask]
            # A saturated row summing to 0 gives NaN, as in the reference.
            with np.errstate(invalid="ignore", divide="ignore"):
                out = out / out.sum(axis=1, keepdims=True)
            results.append(get_performance_metrics(
                flat_targets[:, d], out.argmax(axis=1), out[:, 1]))
        return results

    def fit(
        self,
        train_loader,
        optimizer: Optimizer,
        criterion: Union[str, Callable, None] = None,
        epochs: int = 1,
        history: Optional[MultiModNHistory] = None,
        val_loader=None,
        val_tag: str = "val",
    ):
        """Train ``epochs`` epochs, each followed by a validation pass when
        ``val_loader`` is given; the history gets each epoch's grids, as
        looped ``train_epoch`` / ``test`` calls would give."""
        train_loader = adapt_loader(train_loader)
        val_loader = adapt_loader(val_loader)
        optimizer = adapt_optimizer(optimizer)
        criterion = resolve_criterion(criterion)
        plan = self._plan_training(criterion, train_loader, val_loader,
                                   fused=True)
        self._use_optimizer(optimizer)
        for e in range(epochs):
            tsums, _, n_train = self._train_pass(
                train_loader, optimizer, plan, self._epoch_counter + e)
            sums = [tsums]
            if val_loader is not None:
                (vsums, *_), n_val = self._eval_pass(
                    val_loader, plan.loss_fn, plan.per_batch)
                sums.append(vsums)
            if history is not None:
                sums = to_host(sums)
                stats = self._stats(sums[0], n_train)
                history.append_epoch("train", stats,
                                     state_change=stats["state_change_loss"])
                if val_loader is not None:
                    history.append_epoch(val_tag, self._stats(sums[1],
                                                              n_val))
        self._epoch_counter += epochs
        return history

    def fit_best(
        self,
        train_loader,
        optimizer: Optimizer,
        criterion: Union[str, Callable, None] = None,
        epochs: int = 1,
        val_loader=None,
        history: Optional[MultiModNHistory] = None,
        val_tag: str = "val",
        restore_best: bool = True,
        patience: Optional[int] = None,
    ) -> dict:
        """Train ``epochs`` epochs and keep the parameters of the epoch with
        the best validation score: AUROC plus balanced accuracy summed over
        the binary decoders, the reference MIMIC rule
        (``mimic_single_task_pipeline.py:141-158``), strictly greater wins.

        ``patience``: stop once the score has not improved for ``patience``
        consecutive epochs (at least 1). The host reads the score once per
        epoch. Returns ``{"best_epoch", "best_score", "best_params",
        "scores", "epochs_ran"}``; with ``restore_best`` the model's
        parameters become the best epoch's."""
        return self._fit_best(adapt_loader(train_loader),
                              adapt_optimizer(optimizer), criterion, epochs,
                              adapt_loader(val_loader), history, val_tag,
                              restore_best, patience)[0]

    def _fit_best(self, train_loader, optimizer, criterion, epochs,
                  val_loader, history, val_tag, restore_best, patience,
                  resume: Optional[dict] = None,
                  after_epoch: Optional[Callable] = None):
        """``fit_best`` plus each executed epoch's training and validation
        grid sums (host tensors).

        ``resume`` continues an interrupted call (without ``patience``)
        from its selection state ``{"best": (params, score, epoch),
        "scores"}`` at epoch ``len(scores)``; the caller has restored the
        parameters, optimizer state, cycle and the epoch counter the call
        started from. ``after_epoch(epoch, best, scores)`` runs after each
        epoch's selection and history rows."""
        if val_loader is None:
            raise ValueError("fit_best requires a val_loader")
        binary = [d.n_classes == 2 for d in self.decoders]
        if not any(binary):
            raise ValueError(
                "fit_best requires at least one binary (n_classes==2) "
                "decoder: the AUROC+BAC selection score is undefined "
                "otherwise. Use fit() for non-binary models.")
        if patience is not None and patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        criterion = resolve_criterion(criterion)
        plan = self._plan_training(criterion, train_loader, val_loader,
                                   fused=True)
        self._use_optimizer(optimizer)
        score_fn = make_selection_score(binary)
        if resume is None:
            best = (tree_map(torch.clone, self.params), float("-inf"), -1)
            scores = []
        else:
            best, scores = resume["best"], list(resume["scores"])
        since, train_sums, val_sums = 0, [], []
        for e in range(len(scores), epochs):
            tsums, _, n_train = self._train_pass(
                train_loader, optimizer, plan, self._epoch_counter + e)
            (vsums, outputs, vtargets, vmask), n_val = self._eval_pass(
                val_loader, plan.loss_fn, plan.per_batch)
            tsums, vsums, score = to_host(
                [tsums, vsums, score_fn(outputs, vtargets, vmask)])
            train_sums.append(tsums)
            val_sums.append(vsums)
            scores.append(float(score))
            best, improved = update_best(best, self.params, scores[-1], e)
            since = 0 if improved else since + 1
            if history is not None:
                stats = self._stats(tsums, n_train)
                history.append_epoch("train", stats,
                                     state_change=stats["state_change_loss"])
                history.append_epoch(val_tag, self._stats(vsums, n_val))
            if after_epoch is not None:
                after_epoch(e, best, scores)
            if patience is not None and since >= patience:
                break
        self._epoch_counter += len(scores)
        best_params, best_score, best_epoch = best
        if restore_best:
            self.params = best_params
        info = {
            "best_epoch": best_epoch,
            "best_score": best_score,
            "best_params": params_to_numpy(best_params),
            "scores": np.asarray(scores, np.float32),
            "epochs_ran": len(scores),
        }
        return info, train_sums, val_sums

    # ------------------------------------------------------------------
    # Introspection and persistence
    # ------------------------------------------------------------------
    def display_arch(self, input=None):
        """Print the per-module parameter table (``utils.summary``);
        ``input`` is accepted for the reference's signature and unused."""
        print(summarize_model(self))

    def __getstate__(self):
        """Pickle support (the pipelines pickle whole models, as the
        reference's ``titanic_mlp_pipeline.py:96`` does): the kernel plan
        and the optimizer and its state stay behind, as in the JAX model,
        and the parameters travel as numpy arrays."""
        state = self.__dict__.copy()
        state["_chain_spec"] = None
        state["_opt"] = None
        state["opt_state"] = None
        state["params"] = params_to_numpy(self.params)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        # Models pickled before the order options existed ran unrolled.
        self.__dict__.setdefault("chain_mode", "unrolled")
        self.__dict__.setdefault("scan_unroll", None)
        self.__dict__.setdefault("_shuffle_rng", random.Random(self._seed))
        self.params = params_from_jax(self.params, self.device)

    def state_dict(self) -> dict:
        """The parameter tree as numpy arrays, in the JAX package's
        ``state_dict`` layout."""
        return params_to_numpy(self.params)

    def _jax_storage(self) -> dict:
        """``state_dict()`` in the storage the JAX package keeps for this
        model: a scan-planned model's encoders stacked, each leaf with a
        leading ``(E,)`` axis; per-encoder otherwise."""
        params = self.state_dict()
        if self._chain_plan()[0] == "scan":
            params["encoders"] = stack_encoders(params["encoders"])
        return params

    def parameters(self):
        """Detached copies of the parameter leaves on the model's device, in
        the count, order and shapes of the JAX package's ``parameters()``
        (JAX ``model.py:1312-1319``), so the reference's
        ``torch.optim.Adam(list(model.parameters()), lr)``
        (``titanic_mlp_pipeline.py:74``) builds. They are snapshots for the
        optimizer's constructor, as in the JAX package: training updates the
        model's own parameters through the port's optimizer
        (``interop.adapt_optimizer``), never these copies; read the live
        weights with ``state_dict()``."""
        return iter([torch.nn.Parameter(torch.as_tensor(leaf,
                                                        device=self.device))
                     for leaf in tree_leaves(self._jax_storage())])

    def load_state_dict(self, state: dict):
        """Load a parameter tree: this package's ``state_dict`` or the JAX
        package's (per-encoder or scan-stacked storage)."""
        params = params_from_jax(state, self.device)
        if len(params["encoders"]) != len(self.encoders) or \
                len(params["decoders"]) != len(self.decoders):
            raise ValueError(
                f"state holds {len(params['encoders'])} encoders and "
                f"{len(params['decoders'])} decoders, the model "
                f"{len(self.encoders)} and {len(self.decoders)}")
        self.params = params
