"""MLP-family encoders (PyTorch twin of ``multimodn_tpu/encoders/mlp.py``).

- ``MLPEncoder``: features flow through the hidden stack; the state joins
  the input of the LAST layer, which has no activation.
- ``MIMICMLPEncoder``: the state joins the FIRST layer's input, and the
  activation runs on every layer including the last. Its dropout acts only
  in training, which this package does not run yet.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch

from multimodn_tpu_torch.core.nn import (
    dense_apply,
    dense_init,
    mlp_init,
    resolve_activation,
)
from multimodn_tpu_torch.encoders.base import MultiModEncoder


class MLPEncoder(MultiModEncoder):
    """MLP encoder with state concatenated at the last layer's input."""

    def __init__(
        self,
        state_size: int,
        n_features: int,
        hidden_layers: Union[Tuple[int, ...], Sequence[int]] = (),
        activation: Union[str, Callable] = "relu",
    ):
        super().__init__(state_size, n_features)
        self.hidden_layers = tuple(hidden_layers)
        self.activation = resolve_activation(activation)
        dims = [n_features] + list(self.hidden_layers) + [state_size]
        self._layer_dims = [
            (d_in + (state_size if i == len(dims) - 2 else 0), d_out)
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))
        ]

    def init(self, generator, device=None) -> dict:
        return {"layers": [dense_init(generator, i, o, device)
                           for i, o in self._layer_dims]}

    def apply(self, params, state, x):
        layers = params["layers"]
        for layer in layers[:-1]:
            x = self.activation(dense_apply(layer, x))
        return dense_apply(layers[-1], torch.cat([x, state], dim=-1))


class MLPFeatureEncoder(MLPEncoder):
    """Single-feature MLP encoder for featurewise fusion."""

    def __init__(self, state_size: int, hidden_size: int,
                 activation: Union[str, Callable] = "relu"):
        super().__init__(state_size, 1, (hidden_size,), activation)


class MIMICMLPEncoder(MultiModEncoder):
    """MIMIC variant: first-layer state concat, activation everywhere."""

    def __init__(
        self,
        state_size: int,
        n_features: int,
        hidden_layers: Union[Tuple[int, ...], Sequence[int]] = (),
        dropout: float = 0.2,
        activation: Union[str, Callable] = "relu",
    ):
        super().__init__(state_size, n_features)
        self.hidden_layers = tuple(hidden_layers)
        self.dropout_rate = float(dropout)
        self.activation = resolve_activation(activation)
        self._dims = [n_features + state_size] + list(self.hidden_layers) \
            + [state_size]

    def init(self, generator, device=None) -> dict:
        return {"layers": mlp_init(generator, self._dims, device)}

    def apply(self, params, state, x):
        x = torch.cat([x, state], dim=-1)
        for layer in params["layers"]:
            x = self.activation(dense_apply(layer, x))
        return x


MIMIC_MLPEncoder = MIMICMLPEncoder
