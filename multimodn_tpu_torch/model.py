"""The MultiModN model object (PyTorch twin of the inference surface of
``multimodn_tpu/model.py``).

A model holds static encoder, decoder and init-state configs plus one
parameter tree ``{"init_state", "encoders", "decoders"}`` of float32 tensors
on its device, in the JAX package's layout (per-encoder lists, dense weights
``(in, out)``), so ``state_dict`` / ``load_state_dict`` exchange weights with
the JAX package as plain copies.

This slice ports inference: ``predict`` / ``predict_proba`` on per-modality
arrays (no NaN skip, quirk #9), ``fused_forward`` through the fused-chain
CUDA kernel, and the ``StaticInitState`` cycle bookkeeping. Loader-based
inference, ``get_states`` and every training method come with later slices
(ROADMAP.md Queue A).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from multimodn_tpu_torch.convert import params_from_jax, params_to_numpy
from multimodn_tpu_torch.core.fusion import default_order
from multimodn_tpu_torch.core.nn import resolve_device
from multimodn_tpu_torch.core.state import (
    InitState,
    StaticInitState,
    TrainableInitState,
)
from multimodn_tpu_torch.core.step import make_forward_fn
from multimodn_tpu_torch.ops.fused_chain import ChainSpec, fused_chain_forward


class MultiModN:
    """Sequential multimodal fusion over a shared state.

    ``device`` defaults to CUDA; without a GPU the caller must pass
    ``device="cpu"``. Inference runs the unrolled chain, which gives the
    same results as the JAX package's scan and switch chains. Training
    options (``err_penalty``, ``state_change_penalty``, ``shuffle_mode``,
    ``ones_initialized_counts``, ``presence_*``) are checked and kept for
    the training slice and for ``export_model``."""

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
        self.err_penalty = float(err_penalty)
        # The reference bakes a 0.01 factor into the constructor (quirk #1).
        self.state_change_penalty = 0.01 * float(state_change_penalty)
        self.shuffle_mode = shuffle_mode
        self.nan_skip = nan_skip
        self.ones_initialized_counts = ones_initialized_counts
        self.presence_dropout = float(presence_dropout)
        self.presence_penalty = float(presence_penalty)
        self._seed = seed
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
    def _resolve_order(self, encoder_sequence=None):
        if encoder_sequence is None:
            return default_order(len(self.encoders))
        seq = np.asarray(encoder_sequence).reshape(-1)
        return tuple((int(k), int(e)) for k, e in enumerate(seq))

    def _to_device(self, x: Sequence) -> tuple:
        if self._is_loader(x):
            raise NotImplementedError(
                "inference from a loader is not ported yet (ROADMAP.md "
                "Queue A, 'Model surface'); pass per-modality arrays")
        return tuple(torch.as_tensor(np.asarray(m, np.float32)
                                     if not torch.is_tensor(m) else m,
                                     dtype=torch.float32, device=self.device)
                     for m in x)

    @staticmethod
    def _is_loader(x) -> bool:
        return hasattr(x, "stacks") or hasattr(x, "dataset")

    @torch.no_grad()
    def _predict(self, x: Sequence, encoder_sequence):
        data = self._to_device(x)
        n = data[0].shape[0]
        fwd = make_forward_fn(self.encoders, self.decoders, self.init_state,
                              self._resolve_order(encoder_sequence), "none")
        preds, outputs, _, _ = fwd(
            self.params, data, torch.ones((n,), device=self.device),
            init_offset=self._cycle_base())
        self._advance_cycle(n)
        return preds, outputs

    def predict(self, x: Sequence, encoder_sequence=None) -> np.ndarray:
        """(E+1, D, N) argmax class predictions after every step.

        NaN inputs are NOT skipped here, matching the reference's predict
        (quirk #9): a NaN flows through the encoder into the state."""
        return self._predict(x, encoder_sequence)[0].cpu().numpy()

    def predict_proba(self, x: Sequence, encoder_sequence=None
                      ) -> List[np.ndarray]:
        """Per-decoder (E+1, N, C_d) raw decoder outputs after every step,
        with ``predict``'s no-skip semantics."""
        return [o.cpu().numpy()
                for o in self._predict(x, encoder_sequence)[1]]

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

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The parameter tree as numpy arrays, in the JAX package's
        ``state_dict`` layout."""
        return params_to_numpy(self.params)

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
