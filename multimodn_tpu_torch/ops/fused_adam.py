"""One-pass 8-bit blockwise Adam update for one parameter leaf (port of the
Pallas TPU kernel ``multimodn_tpu/ops/fused_adam.py::_make_leaf_pallas``).

The moments ``m`` and ``v`` are stored as 8-bit codes (``float8_e4m3fn`` by
default, ``int8`` as an option) with one float32 absmax scale per row of the
leaf seen as ``(rows, cols)``. The kernel lives in ``csrc/fused_adam.cu``; its
source note says what bounds it on an H100 and how the design answers that.
This module holds:

- ``quantize_rows`` / ``dequantize`` / ``scale_shape`` / ``code_dtype`` and
  ``moment_update``: the update's math in plain PyTorch, in the JAX package's
  order of operations;
- ``leaf_update_ref``: the plain version of the kernel (twin of
  ``_leaf_update_xla``);
- ``leaf_update``: the wrapper. It updates ``p, mq, ms, vq, vs`` in place.
  CPU tensors take the plain version; CUDA tensors launch the kernel or
  raise, with no fallback. ``FUSED_ADAM.launches`` counts the launches.

Every step is float32, rounded on its own, in the JAX package's order; the
kernel computes the same and matches this version bit for bit. Three habits
of PyTorch would round differently and are avoided: ``scalar / tensor`` is
``tensor.reciprocal() * scalar``, and on CUDA ``tensor / scalar`` is
``tensor * (1 / scalar)`` (two roundings each), so every division here is
between two tensors; and a cast to ``float8_e4m3fn`` of a value past 448 is
not a saturation everywhere, so values are clipped first.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

Q_MAX = 127.0          # int8 linear code range
FP8_MAX = 448.0        # float8_e4m3fn max finite
FMT_CODES = {"fp8": 0, "int8": 1}   # must match csrc/fused_adam.cu


def rows_cols(shape):
    """Collapse a leaf to 2-D (rows, cols) keeping the minor dim: 0-D is
    (1, 1), 1-D is (1, n)."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return 1, shape[0]
    return math.prod(shape[:-1]), shape[-1]


def scale_shape(shape):
    """Per-row scale storage shape for a leaf: ``shape[:-1] + (1,)``; a 0-D
    leaf keeps a 0-D scale."""
    return tuple(shape[:-1]) + (1,) if len(shape) >= 1 else ()


def code_dtype(fmt: str) -> torch.dtype:
    if fmt not in FMT_CODES:
        raise ValueError(f"fmt must be 'fp8' or 'int8', got {fmt!r}")
    return torch.int8 if fmt == "int8" else torch.float8_e4m3fn


def quantize_rows(x: torch.Tensor, fmt: str = "fp8"):
    """Blockwise absmax 8-bit quantization along the last axis: returns
    ``(codes like x, float32 scales of scale_shape(x.shape))``; dequantize
    with ``codes * scales``. Zero rows get scale 0 and codes 0.

    A NaN or Inf in a row fails the ``absmax > 0`` test, so the row's finite
    elements code to 0 and its scale becomes NaN or Inf: the whole row
    dequantizes to NaN on the next step, as in the JAX package. An int8 code
    of a NaN is 0 (XLA's float-to-int conversion)."""
    x = x.float()
    if x.dim() == 0:
        q, s = quantize_rows(x.reshape(1), fmt)
        return q.reshape(()), s.reshape(())
    q_top = Q_MAX if fmt == "int8" else FP8_MAX
    absmax = x.abs().amax(dim=-1, keepdim=True)
    inv = torch.where(absmax > 0,
                      torch.div(torch.full_like(absmax, q_top), absmax),
                      torch.zeros_like(absmax))
    scaled = x * inv
    if fmt == "int8":
        scaled = torch.round(scaled)
    scaled = torch.clamp(scaled, -q_top, q_top)
    if fmt == "int8":
        scaled = torch.nan_to_num(scaled, nan=0.0)
    return scaled.to(code_dtype(fmt)), absmax / torch.full_like(absmax,
                                                                q_top)


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def moment_update(g, mq, ms, vq, vs, c1, c2, lr, b1, b2, eps, gate=None,
                  fmt: str = "fp8"):
    """The kernel's math, returning ``(update, mq', ms', vq', vs')`` without
    touching the parameter. ``gate`` (a 0/1 scalar tensor) gives the
    structural skip: frozen moments and a zero update where it is 0.
    ``c1`` / ``c2`` are the bias corrections ``1 - b^t``."""
    g = g.float()
    c1, c2 = (torch.as_tensor(c, dtype=torch.float32, device=g.device)
              for c in (c1, c2))
    m = dequantize(mq, ms)
    v = dequantize(vq, vs)
    if gate is None:
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        upd = -lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    else:
        m_new = m + gate * (1.0 - b1) * (g - m)
        v_new = v + gate * (1.0 - b2) * (g * g - v)
        upd = -lr * gate * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    mq_new, ms_new = quantize_rows(m_new, fmt)
    vq_new, vs_new = quantize_rows(v_new, fmt)
    return upd, mq_new, ms_new, vq_new, vs_new


def leaf_update_ref(p, g, mq, ms, vq, vs, c1, c2, lr, b1, b2, eps,
                    gate=None, fmt: str = "fp8"):
    """Plain version of the kernel (twin of the JAX package's
    ``_leaf_update_xla``): returns new ``(p', mq', ms', vq', vs')``."""
    upd, mq_new, ms_new, vq_new, vs_new = moment_update(
        g, mq, ms, vq, vs, c1, c2, lr, b1, b2, eps, gate=gate, fmt=fmt)
    p_new = (p.float() + upd).to(p.dtype)
    return p_new, mq_new, ms_new, vq_new, vs_new


class FusedAdamKernel:
    """The built kernel library and its launch count. ``launches`` goes up
    by one where the kernel is launched, and nowhere else."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            from multimodn_tpu_torch.ops.build import build_library
            lib = build_library("fused_adam.cu")
            lib.mmn_fused_adam_update.argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int]
                + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p])
            lib.mmn_fused_adam_update.restype = ctypes.c_int
            lib.mmn_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mmn_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, p, g, mq, ms, vq, vs, c12, gate, *, lr, b1, b2, eps,
               fmt):
        """One launch on PyTorch's current stream, on tensors that
        ``_check_leaf`` accepted. ``c12`` holds ``(c1, c2)`` and ``gate`` is
        a 0-D tensor or None; both stay on the device."""
        lib = self.library()
        rows, cols = rows_cols(tuple(p.shape))
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            # 1 - b is rounded to float32 from the double, like a Python
            # scalar in a float32 product in either framework.
            err = lib.mmn_fused_adam_update(
                p.data_ptr(), g.data_ptr(), mq.data_ptr(), ms.data_ptr(),
                vq.data_ptr(), vs.data_ptr(), c12.data_ptr(),
                None if gate is None else gate.data_ptr(), rows, cols, lr,
                b1, 1.0 - b1, b2, 1.0 - b2, eps, FMT_CODES[fmt], stream)
        if err != 0:
            raise RuntimeError("fused_adam kernel launch failed: "
                               + lib.mmn_cuda_error_string(err).decode())
        self.launches += 1


FUSED_ADAM = FusedAdamKernel()


def _check_leaf(p, g, mq, ms, vq, vs, c12, gate, fmt):
    shape = tuple(p.shape)
    qdt = code_dtype(fmt)
    expected = [(g, shape, torch.float32, "g"), (mq, shape, qdt, "mq"),
                (ms, scale_shape(shape), torch.float32, "ms"),
                (vq, shape, qdt, "vq"),
                (vs, scale_shape(shape), torch.float32, "vs"),
                (c12, (2,), torch.float32, "c12")]
    if gate is not None:
        expected.append((gate, (), torch.float32, "gate"))
    if p.dtype != torch.float32:
        raise TypeError(f"p must be float32, got {p.dtype}")
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    for t, want_shape, dtype, name in expected:
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want_shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def leaf_update(p, g, mq, ms, vq, vs, c12, *, lr, b1, b2, eps,
                gate: Optional[torch.Tensor] = None, fmt: str = "fp8"):
    """8-bit Adam update of one leaf, in place on ``p, mq, ms, vq, vs``.

    ``c12`` is a (2,) float32 tensor ``(1 - b1^t, 1 - b2^t)`` on the leaf's
    device; ``gate`` an optional 0-D float32 tensor (1 runs the step, 0
    freezes the moments and the parameter). On the CPU this is the plain
    version; on a CUDA device it is the kernel."""
    _check_leaf(p, g, mq, ms, vq, vs, c12, gate, fmt)
    if p.device.type == "cpu":
        new = leaf_update_ref(p, g, mq, ms, vq, vs, c12[0], c12[1], lr, b1,
                              b2, eps, gate=gate, fmt=fmt)
        for dst, src in zip((p, mq, ms, vq, vs), new):
            dst.copy_(src)
        return
    if p.device.type != "cuda":
        raise ValueError(f"leaf_update runs on cpu or cuda, not {p.device}")
    if p.numel() == 0:
        return
    FUSED_ADAM.launch(p, g, mq, ms, vq, vs, c12, gate, lr=lr, b1=b1, b2=b2,
                      eps=eps, fmt=fmt)
