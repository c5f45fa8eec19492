"""Concrete decoders (PyTorch twin of ``multimodn_tpu/decoders/decoders.py``).
They output activated probabilities (sigmoid by default), as the reference
does."""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

from multimodn_tpu_torch.core.nn import dense_apply, mlp_init, resolve_activation
from multimodn_tpu_torch.decoders.base import MultiModDecoder


class ClassDecoder(MultiModDecoder):
    """Single linear layer + activation."""

    def __init__(self, state_size: int, n_classes: int,
                 activation: Union[str, Callable]):
        super().__init__(state_size)
        self.n_classes = n_classes
        self.activation = resolve_activation(activation)
        self._dims = [state_size, n_classes]

    def init(self, generator, device=None) -> dict:
        return {"layers": mlp_init(generator, self._dims, device)}

    def apply(self, params, state):
        return self.activation(dense_apply(params["layers"][0], state))


class LogisticDecoder(ClassDecoder):
    """Binary sigmoid decoder."""

    def __init__(self, state_size: int):
        super().__init__(state_size, 2, "sigmoid")


class MLPDecoder(MultiModDecoder):
    """Hidden layers (ReLU by default) + output activation (sigmoid)."""

    def __init__(
        self,
        state_size: int,
        hidden_layers: Union[Tuple[int, ...], Sequence[int]],
        n_classes: int = 2,
        output_activation: Union[str, Callable] = "sigmoid",
        hidden_activation: Union[str, Callable] = "relu",
    ):
        super().__init__(state_size)
        self.n_classes = n_classes
        self.hidden_layers = tuple(hidden_layers)
        self.output_activation = resolve_activation(output_activation)
        self.hidden_activation = resolve_activation(hidden_activation)
        self._dims = [state_size] + list(hidden_layers) + [n_classes]

    def init(self, generator, device=None) -> dict:
        return {"layers": mlp_init(generator, self._dims, device)}

    def apply(self, params, state):
        x = state
        for layer in params["layers"][:-1]:
            x = self.hidden_activation(dense_apply(layer, x))
        return self.output_activation(dense_apply(params["layers"][-1], x))
