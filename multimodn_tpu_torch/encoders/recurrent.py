"""LSTM and RNN encoders (PyTorch twin of
``multimodn_tpu/encoders/recurrent.py``).

A stack of recurrent layers: the hidden layers transform the features and
take the activation; the fusion state joins the input of the last layer,
whose output is the new state and takes no activation (reference
``lstm_encoder.py`` / ``rnn_encoder.py``).

The cells are the JAX package's math, written as a loop over time on
tensors with gradients through autograd (not ``nn.LSTM`` / cuDNN, whose
sums run in another order): gates in the order i, f, g, o, the
pre-activation ``x @ w_ih + b_ih + h @ w_hh + b_hh`` added in that order,
weights stored ``(in, G*H)`` and ``(H, G*H)``, init U(-1/sqrt(H), +1/sqrt(H))
drawn in the order w_ih, w_hh, b_ih, b_hh. The input products of every time
step are one matrix product before the loop.

``unbatched_compat=True`` (the default, quirk #8): the reference's pipelines
feed 2-D ``(B, F)`` tensors to ``nn.LSTM(batch_first=True)``, which torch
treats as ONE unbatched sequence of length B, so the recurrence runs across
the batch rows. The padded rows of a loader's last batch sit at the end, so
they cannot reach a real row; rows that the NaN skip zero-filled still feed
the recurrence, as in the JAX package. ``unbatched_compat=False``: ``(B, F)``
is a length-1 sequence per sample, ``(B, T, F)`` is taken as it comes, and
the last time step's output is the state.

On a mesh's data axis (a ``"data_axis"`` tag in the parameters,
``parallel.dp_step.DataParallel.view``) each rank holds a block of the
batch's rows, and the one sequence is still the GLOBAL batch's: the
unbatched form gathers the input and state rows of every rank in rank
order (``parallel.collectives.GatherRows``, one collective per call), runs
the recurrence over them and keeps its own rows. The last rank's padding
rows come last, after every real row, as a loader's padded rows do. Every
rank runs the whole recurrence, as the JAX package's ``auto`` engine does
on its global arrays.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch

from multimodn_tpu_torch.core.nn import resolve_activation, uniform_init
from multimodn_tpu_torch.encoders.base import MultiModEncoder
from multimodn_tpu_torch.parallel.collectives import GatherRows


def _rnn_layer_init(generator, in_dim: int, hidden: int, gates: int,
                    device=None) -> dict:
    bound = 1.0 / (hidden ** 0.5)
    g = gates * hidden
    return {
        "w_ih": uniform_init(generator, (in_dim, g), bound, device),
        "w_hh": uniform_init(generator, (hidden, g), bound, device),
        "b_ih": uniform_init(generator, (g,), bound, device),
        "b_hh": uniform_init(generator, (g,), bound, device),
    }


def _lstm_seq(params, xs: torch.Tensor, hidden: int) -> torch.Tensor:
    """An LSTM over ``xs`` with time on axis 0: (T, ..., in) -> (T, ...,
    hidden)."""
    xw = torch.matmul(xs, params["w_ih"]) + params["b_ih"]
    h = c = xs.new_zeros(xs.shape[1:-1] + (hidden,))
    out = []
    for x_t in xw:
        gates = x_t + torch.matmul(h, params["w_hh"]) + params["b_hh"]
        i, f, g, o = torch.split(gates, hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


def _rnn_seq(params, xs: torch.Tensor, hidden: int) -> torch.Tensor:
    """A tanh RNN over ``xs`` with time on axis 0."""
    xw = torch.matmul(xs, params["w_ih"]) + params["b_ih"]
    h = xs.new_zeros(xs.shape[1:-1] + (hidden,))
    out = []
    for x_t in xw:
        h = torch.tanh(x_t + torch.matmul(h, params["w_hh"])
                       + params["b_hh"])
        out.append(h)
    return torch.stack(out)


class _RecurrentEncoder(MultiModEncoder):
    """The LSTM / RNN encoder stack; a subclass picks the cell with
    ``_GATES`` and ``_run_layer(params, xs, hidden)``."""

    _GATES: int = 1

    def __init__(
        self,
        state_size: int,
        n_features: int,
        hidden_layers: Union[Tuple[int, ...], Sequence[int]],
        activation: Union[str, Callable] = "relu",
        unbatched_compat: bool = True,
    ):
        super().__init__(state_size, n_features)
        self.hidden_layers = tuple(hidden_layers)
        self.activation = resolve_activation(activation)
        self.unbatched_compat = unbatched_compat
        dims = [n_features] + list(self.hidden_layers) + [state_size]
        self._layer_dims = [
            (d_in + (state_size if i == len(dims) - 2 else 0), d_out)
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))
        ]

    def init(self, generator, device=None) -> dict:
        return {"layers": [_rnn_layer_init(generator, d_in, d_out,
                                           self._GATES, device)
                           for d_in, d_out in self._layer_dims]}

    def apply(self, params, state, x, train=False, generator=None):
        layers = params["layers"]
        hidden = [hid for _, hid in self._layer_dims]
        if self.unbatched_compat and x.dim() == 2:
            # (B, F) is ONE sequence of length B: the global batch's.
            axis, rows = params.get("data_axis"), x.shape[0]
            if axis is not None:
                xs = GatherRows.apply(torch.cat([x, state], dim=-1), axis)
                x, state = xs.split([x.shape[1], state.shape[1]], dim=-1)
            for p, hid in zip(layers[:-1], hidden[:-1]):
                x = self.activation(self._run_layer(p, x, hid))
            out = self._run_layer(layers[-1], torch.cat([x, state], dim=-1),
                                  hidden[-1])
            return out if axis is None else \
                out.narrow(0, axis.index * rows, rows)
        seq = (x if x.dim() == 3 else x[:, None, :]).transpose(0, 1)
        for p, hid in zip(layers[:-1], hidden[:-1]):
            seq = self.activation(self._run_layer(p, seq, hid))
        state_seq = state[None].expand((seq.shape[0],) + tuple(state.shape))
        out = self._run_layer(layers[-1], torch.cat([seq, state_seq], dim=-1),
                              hidden[-1])
        return out[-1]


class LSTMEncoder(_RecurrentEncoder):
    """LSTM encoder (reference ``lstm_encoder.py:8-39``)."""

    _GATES = 4
    _run_layer = staticmethod(_lstm_seq)


class RNNEncoder(_RecurrentEncoder):
    """Vanilla (tanh) RNN encoder (reference ``rnn_encoder.py:8-39``)."""

    _GATES = 1
    _run_layer = staticmethod(_rnn_seq)


class LSTMFeatureEncoder(LSTMEncoder):
    """Single-feature LSTM encoder (reference ``lstm_encoder.py:41-53``)."""

    def __init__(self, state_size: int, hidden_size: int,
                 activation: Union[str, Callable] = "relu",
                 unbatched_compat: bool = True):
        super().__init__(state_size, 1, (hidden_size,), activation,
                         unbatched_compat)


class RNNFeatureEncoder(RNNEncoder):
    """Single-feature RNN encoder (reference ``rnn_encoder.py:41-53``)."""

    def __init__(self, state_size: int, hidden_size: int,
                 activation: Union[str, Callable] = "relu",
                 unbatched_compat: bool = True):
        super().__init__(state_size, 1, (hidden_size,), activation,
                         unbatched_compat)
