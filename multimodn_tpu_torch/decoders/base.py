"""Decoder contract (PyTorch twin of ``multimodn_tpu/decoders/base.py``): a
decoder maps ``state -> class scores`` and exposes ``n_classes``."""
from __future__ import annotations

from abc import ABC, abstractmethod

import torch


class MultiModDecoder(ABC):
    """Abstract decoder: ``apply(params, state) -> scores``."""

    n_classes: int

    def __init__(self, state_size: int):
        self.state_size = state_size

    @abstractmethod
    def init(self, generator: torch.Generator, device=None) -> dict:
        """Create this decoder's parameter dict."""

    @abstractmethod
    def apply(self, params: dict, state: torch.Tensor) -> torch.Tensor:
        """Map states to class scores. ``state`` may carry leading dims, so
        one call decodes the whole (E+1, B, S) state stack."""
