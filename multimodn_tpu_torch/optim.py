"""Optimizers (PyTorch twin of ``multimodn_tpu/optim.py``): ``Adam`` and
``Adam8bit`` with torch's default hyperparameters and torch's structural
skip, and ``SGD`` / ``AdamW`` with optax's arithmetic and no skip.

The reference builds ``torch.optim.Adam(model.parameters(), lr)`` and zeroes
gradients to None before each backward. An encoder that a batch NaN-skips
(``multimodn.py:167-169``) never enters that batch's graph, its ``.grad``
stays None, and torch's Adam skips it: no moment decay and no step-count
increment. Here every parameter is in the graph (the skip is a
``torch.where``), so a skipped encoder gets a zero gradient, not None; the
skip is driven instead by the chain's executed flags (``enc_gates``, one per
encoder, given under ``nan_skip='batch'``): a gated-off encoder keeps its
moments and its own step count. The other parameters form one group with
one step count.

An Adam optimizer's state is a dict of trees shaped like the parameters plus the
step counts ``t`` (0-D tensor) and ``t_enc`` (one 0-D tensor per encoder),
all on the parameters' device; the model owns it. The bias corrections are
computed on the device from those counts, so a step never reads the host.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from multimodn_tpu_torch.core.nn import resolve_dtype
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from multimodn_tpu_torch.ops import fused_adam as fa
from multimodn_tpu_torch.ops import fused_adam_fp32 as fa32


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _step_counts(params):
    """``(t, t_enc)`` zeros: one count for the non-encoder group, one per
    encoder (None without an encoder group)."""
    dev = _device(params)
    enc = params.get("encoders") if isinstance(params, dict) else None
    t_enc = None if enc is None else [torch.zeros((), device=dev)
                                      for _ in enc]
    return torch.zeros((), device=dev), t_enc


def _walk(op: Callable, trees: Sequence, n_out: int) -> List:
    """``op`` over the aligned leaves of ``trees``; returns ``n_out`` trees
    shaped like ``trees[0]``."""
    outs = [op(*leaves) for leaves in zip(*(tree_leaves(t) for t in trees))]
    return [tree_unflatten(trees[0], [o[i] for o in outs])
            for i in range(n_out)]


def _bias_corrections(b1: float, b2: float, t: torch.Tensor) -> torch.Tensor:
    """(2,) tensor ``(1 - b1^t, 1 - b2^t)`` in float32 on t's device."""
    return torch.stack([1 - torch.pow(b1, t), 1 - torch.pow(b2, t)])


def _drive(b1: float, b2: float, state: dict, enc_gates, op: Callable,
           trees: Sequence, n_out: int):
    """The step driver ``Adam`` and ``Adam8bit`` share: the step counts,
    the bias corrections and the structural skip. ``op(c12, gate,
    *leaves)`` updates one leaf (``gate`` None outside the gated encoder
    groups). Returns ``(n_out output trees, t, t_enc)``."""
    t_new = state["t"] + 1.0
    c12 = _bias_corrections(b1, b2, t_new)
    t_enc = state["t_enc"]
    if enc_gates is None or t_enc is None:
        outs = _walk(lambda *leaves: op(c12, None, *leaves), trees, n_out)
        return outs, t_new, None if t_enc is None else \
            [t + 1.0 for t in t_enc]
    rest = [{k: v for k, v in tree.items() if k != "encoders"}
            for tree in trees]
    outs = _walk(lambda *leaves: op(c12, None, *leaves), rest, n_out)
    enc_outs, te_new = [], []
    for e, te in enumerate(t_enc):
        gate = enc_gates[e]
        te = te + gate
        ec12 = _bias_corrections(b1, b2, torch.clamp_min(te, 1.0))
        enc_outs.append(_walk(
            lambda *leaves, _c=ec12, _g=gate: op(_c, _g, *leaves),
            [tree["encoders"][e] for tree in trees], n_out))
        te_new.append(te)
    for i, out in enumerate(outs):
        out["encoders"] = [eo[i] for eo in enc_outs]
    return outs, t_new, te_new


class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params=None,
    enc_gates=None) -> (updates, state)``; ``core.step.gated_update`` adds
    the updates to the parameters. An optimizer that writes the parameters
    itself also has ``fused_apply``."""

    def init(self, params: dict) -> dict:
        raise NotImplementedError

    def update(self, grads, state, params=None, enc_gates=None):
        raise NotImplementedError


class Adam(Optimizer):
    """``torch.optim.Adam`` with per-encoder-group structural skip (module
    docstring); with no skip its math is torch's: bias-corrected moments,
    eps outside the square root.

    ``state_dtype``: the storage dtype of the moments (e.g.
    ``torch.bfloat16``; None keeps the parameters' fp32, torch's math). A
    step reads each moment into the gradient's dtype, updates it there and
    stores it back in ``state_dtype`` (JAX ``optim.py:96-110``), which cuts
    the state's bytes at a small, not torch-exact, numerical difference.

    ``fused_apply`` updates every leaf and the moments in place through
    ``fused_adam_fp32.multi_leaf_update``: the hand-written kernel on a CUDA
    model, gated or not, and its plain version on a CPU model, both equal
    to ``update`` followed by adding the updates. ``update`` returns the
    updates without touching the parameters, for callers that apply
    updates themselves."""

    def __init__(self, learning_rate: float,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, state_dtype=None):
        self.lr, (self.b1, self.b2), self.eps = learning_rate, betas, eps
        self.state_dtype = resolve_dtype(state_dtype)

    def init(self, params):
        t, t_enc = _step_counts(params)

        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": t, "t_enc": t_enc}

    def _leaf(self, c12, gate, g, m_stored, v_stored):
        return fa32.moment_update(g, m_stored, v_stored, c12, gate, self.lr,
                                  self.b1, self.b2, self.eps)

    def update(self, grads, state, params=None, enc_gates=None):
        (upd, m, v), t, t_enc = _drive(
            self.b1, self.b2, state, enc_gates, self._leaf,
            [grads, state["m"], state["v"]], 3)
        return upd, {"m": m, "v": v, "t": t, "t_enc": t_enc}

    def fused_apply(self, grads, state, params, enc_gates=None,
                    cross_rank=None):
        """Update ``params`` and the moments ``state["m"]``, ``state["v"]``
        in place; returns the state with the new step counts. Every leaf
        goes into one ``fused_adam_fp32.multi_leaf_update`` call: one kernel
        launch per 512 leaves on a CUDA model (a gradient that is not
        contiguous, such as a permuted view, is copied first).
        ``cross_rank`` is taken and ignored: an elementwise update needs no
        reduction across a mesh's ranks."""
        leaves = []

        def op(c12, gate, p, g, m, v):
            leaves.append((p, g.contiguous(), m, v, c12, gate))
            return ()

        _, t, t_enc = _drive(self.b1, self.b2, state, enc_gates, op,
                             [params, grads, state["m"], state["v"]], 0)
        fa32.multi_leaf_update(leaves, lr=self.lr, b1=self.b1, b2=self.b2,
                               eps=self.eps)
        return dict(state, t=t, t_enc=t_enc)


class Adam8bit(Optimizer):
    """Adam with 8-bit blockwise-quantized moments (``ops/fused_adam.py``):
    per leaf, ``float8_e4m3fn`` (``fmt='fp8'``, the default) or ``int8``
    codes plus one float32 scale per row, about 2 bytes of state per
    parameter against fp32 Adam's 8. Not torch-exact: quantization error
    enters through the moment history (the first step is exact). The
    structural skip is ``Adam``'s.

    ``fused_apply`` updates every leaf in place through
    ``fused_adam.multi_leaf_update``: the hand-written kernel on a CUDA model,
    gated or not, and its plain version on a CPU model. ``update`` returns
    the updates without touching the parameters (the same math in plain
    PyTorch, for callers that apply updates themselves)."""

    def __init__(self, learning_rate: float,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, fmt: str = "fp8"):
        if fmt not in fa.FMT_CODES:
            raise ValueError(f"fmt must be 'fp8' or 'int8', got {fmt!r}")
        self.lr, (self.b1, self.b2), self.eps = learning_rate, betas, eps
        self.fmt = fmt

    def init(self, params):
        t, t_enc = _step_counts(params)
        qdt = fa.code_dtype(self.fmt)

        def codes(p):
            return torch.zeros(p.shape, dtype=qdt, device=p.device)

        def scales(p):
            return torch.zeros(fa.scale_shape(tuple(p.shape)),
                               device=p.device)

        return {"mq": tree_map(codes, params), "ms": tree_map(scales, params),
                "vq": tree_map(codes, params), "vs": tree_map(scales, params),
                "t": t, "t_enc": t_enc}

    def _trees(self, state):
        return [state[k] for k in ("mq", "ms", "vq", "vs")]

    def update(self, grads, state, params=None, enc_gates=None):
        def op(c12, gate, g, mq, ms, vq, vs):
            return fa.moment_update(g, mq, ms, vq, vs, c12[0], c12[1],
                                    self.lr, self.b1, self.b2, self.eps,
                                    gate=gate, fmt=self.fmt)

        (upd, mq, ms, vq, vs), t, t_enc = _drive(
            self.b1, self.b2, state, enc_gates, op,
            [grads] + self._trees(state), 5)
        return upd, {"mq": mq, "ms": ms, "vq": vq, "vs": vs, "t": t,
                     "t_enc": t_enc}

    def fused_apply(self, grads, state, params, enc_gates=None,
                    cross_rank=None):
        """Update ``params`` and the moment codes and scales in place;
        returns the state with the new step counts. Every leaf goes into
        one ``fused_adam.multi_leaf_update`` call: one kernel launch for the
        whole step on a CUDA model. ``cross_rank``: on a mesh's model axis,
        ``(sharded-leaf flags tree, model axis)``; a sharded leaf's rows are
        requantized by the whole row's absmax, a MAX across the axis (the
        kernel's cross-rank form, two launches)."""
        leaves, split = [], []
        flags = None if cross_rank is None else cross_rank[0]

        def op(c12, gate, p, g, mq, ms, vq, vs, *cut):
            leaves.append((p, g.contiguous(), mq, ms, vq, vs, c12, gate))
            split.append(bool(cut and cut[0]))
            return ()

        trees = [params, grads] + self._trees(state)
        _, t, t_enc = _drive(self.b1, self.b2, state, enc_gates, op,
                             trees if flags is None else trees + [flags], 0)
        fa.multi_leaf_update(
            leaves, lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps,
            fmt=self.fmt, split=split if cross_rank else None,
            row_group=None if cross_rank is None else cross_rank[1])
        return dict(state, t=t, t_enc=t_enc)


class SGD(Optimizer):
    """``optax.sgd``: the update is ``-lr * g``; with ``momentum`` a trace
    ``g + momentum * trace`` takes the gradient's place. Like every plain
    optax transformation in the JAX package (``core/step.py::_tx_update``),
    it takes no ``enc_gates``: an encoder that a batch skipped gets its zero
    gradient like any other parameter."""

    def __init__(self, learning_rate: float, momentum: float = 0.0):
        self.lr, self.momentum = learning_rate, momentum

    def init(self, params):
        return {"trace": tree_map(torch.zeros_like, params)} \
            if self.momentum else {}

    def update(self, grads, state, params=None, enc_gates=None):
        if not self.momentum:
            return tree_map(lambda g: -self.lr * g, grads), state
        trace = tree_map(lambda g, t: g + self.momentum * t, grads,
                         state["trace"])
        return tree_map(lambda t: -self.lr * t, trace), {"trace": trace}


class AdamW(Optimizer):
    """``optax.adamw``: Adam's moments ``(1 - b) * g^k + b * moment``, the
    bias-corrected ratio ``m_hat / (sqrt(v_hat) + eps)``, then ``+
    weight_decay * p``, then ``* -lr``. One step count ``count`` for every
    parameter, and no ``enc_gates``, as ``SGD``. The state's keys are
    optax's field names (``count``, ``mu``, ``nu``)."""

    def __init__(self, learning_rate: float,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01):
        self.lr, (self.b1, self.b2), self.eps = learning_rate, betas, eps
        self.weight_decay = weight_decay

    def init(self, params):
        return {"count": torch.zeros((), device=_device(params)),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params=None, enc_gates=None):
        if params is None:
            raise ValueError("AdamW's weight decay needs the parameters")
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1.0
        c1, c2 = _bias_corrections(b1, b2, count)

        def leaf(g, m, v, p):
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * g ** 2 + b2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            return -self.lr * (u + self.weight_decay * p), m, v

        upd, mu, nu = _walk(leaf, [grads, state["mu"], state["nu"], params],
                            3)
        return upd, {"count": count, "mu": mu, "nu": nu}
