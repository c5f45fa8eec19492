"""Initial-state providers (PyTorch twin of ``multimodn_tpu/core/state.py``).

- ``TrainableInitState``: a ``(1, state_size)`` parameter, normal init,
  broadcast across the batch.
- ``StaticInitState``: a fixed bank of states handed out round-robin, one
  per sample: sample ``i`` of a call at cycle offset ``o`` gets row
  ``(o + i) % n``. The model keeps the offset across calls, like the
  reference's shared ``itertools.cycle``.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence

import numpy as np
import torch


class InitState(ABC):
    """Provides the state vector each sample starts the encoder chain with."""

    def __init__(self, state_size: int):
        self.state_size = state_size

    @abstractmethod
    def init(self, generator: torch.Generator, device=None) -> dict:
        """Create the (possibly empty) parameter dict."""

    @abstractmethod
    def apply(self, params: dict, batch_size: int, offset: int = 0
              ) -> torch.Tensor:
        """Return the (batch_size, state_size) initial state."""

    def to(self, device) -> "InitState":
        """Move any state the provider holds outside ``params``."""
        return self


class TrainableInitState(InitState):
    """Learnable (1, state_size) parameter tiled across the batch."""

    def init(self, generator, device=None) -> dict:
        value = torch.randn((1, self.state_size), generator=generator,
                            dtype=torch.float32)
        return {"value": value.to(device)}

    def apply(self, params, batch_size, offset=0):
        return params["value"].expand(batch_size, self.state_size)


class StaticInitState(InitState):
    """Cycles a fixed list of states; not a parameter."""

    def __init__(self, states: Sequence):
        bank = np.stack([np.asarray(s, dtype=np.float32).reshape(-1)
                         for s in states])
        super().__init__(bank.shape[1])
        self._bank = torch.from_numpy(bank)

    @property
    def n_states(self) -> int:
        return self._bank.shape[0]

    def bank(self) -> np.ndarray:
        """The (n_states, state_size) bank as a numpy array."""
        return self._bank.cpu().numpy()

    def to(self, device) -> "StaticInitState":
        self._bank = self._bank.to(device)
        return self

    def init(self, generator, device=None) -> dict:
        return {}

    def apply(self, params, batch_size, offset=0):
        idx = (int(offset) + torch.arange(batch_size,
                                          device=self._bank.device)) \
            % self.n_states
        return self._bank.index_select(0, idx)
