"""Single-layer perceptron encoders (PyTorch twin of
``multimodn_tpu/encoders/slp.py``).

With an empty hidden tuple, ``MLPEncoder`` never applies its activation: the
only layer is the unactivated output layer over ``[x, state]``. So
``SLPEncoder``'s and ``LogisticEncoder``'s sigmoid is accepted but inert, as
in the reference (``multimodn/encoders/slp_encoders.py:5-34``) and the JAX
package. It is kept for API parity and export, not "fixed". Being
``MLPEncoder``s, these encoders run through the fused-chain kernel.
"""
from __future__ import annotations

from typing import Callable, Union

from multimodn_tpu_torch.encoders.mlp import MLPEncoder


class SLPEncoder(MLPEncoder):
    """Single Layer Perceptron encoder."""

    def __init__(self, state_size: int, n_features: int,
                 activation: Union[str, Callable] = "sigmoid"):
        super().__init__(state_size, n_features, (), activation)


class LinearEncoder(SLPEncoder):
    """Linear encoder."""

    def __init__(self, state_size: int, n_features: int):
        super().__init__(state_size, n_features, "identity")


class LogisticEncoder(SLPEncoder):
    """Logistic encoder (its sigmoid is inert, see the module docstring)."""

    def __init__(self, state_size: int, n_features: int):
        super().__init__(state_size, n_features, "sigmoid")
