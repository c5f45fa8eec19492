"""Encoder contract (PyTorch twin of ``multimodn_tpu/encoders/base.py``): an
encoder maps ``(state, modality_input) -> new_state``. Encoders are static
config objects; their parameters are a separate dict of tensors, so the
fusion core and the fused-chain kernel read one parameter tree."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import torch


class MultiModEncoder(ABC):
    """Abstract encoder: ``apply(params, state, x) -> state``."""

    def __init__(self, state_size: int, n_features: Optional[int] = None):
        self.state_size = state_size
        self.n_features = n_features

    @abstractmethod
    def init(self, generator: torch.Generator, device=None) -> dict:
        """Create this encoder's parameter dict."""

    @abstractmethod
    def apply(self, params: dict, state: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
        """Advance the (B, state_size) fusion state with one modality's
        (B, n_features) features, NaNs already zero-filled by the caller.
        Inference only: dropout is the identity here."""
