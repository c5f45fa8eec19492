"""One fp32 Adam step over many parameter leaves in one launch (K3).

K3 replaces no TPU kernel: the JAX package's fp32 ``Adam`` is plain jnp,
which XLA fuses. It replaces the port's per-leaf update (``optim.Adam``'s
math followed by ``core.step.gated_update``'s ``p.add_``), 14 kernel
launches per leaf, by one launch per ``MAX_LEAVES`` leaves. The kernel lives
in ``csrc/fused_adam_fp32.cu``; its source note says what bounds it on an
H100 and how the design answers that. This module holds:

- ``moment_update``: the update's math in plain PyTorch (``optim.Adam``
  computes with it), each float32 operation rounded on its own;
- ``leaf_update_ref`` / ``multi_leaf_update_ref``: the plain version of the
  kernel, in place, leaf by leaf;
- ``chunk_table``: how a list of leaf shapes is cut into chunks of
  ``CHUNK`` elements and grouped into launches (the kernel reads it);
- ``multi_leaf_update``: the wrapper. CPU tensors take the plain version;
  CUDA tensors launch the kernel or raise, with no fallback.
  ``FUSED_ADAM_FP32.launches`` counts the launches.

Parameters and gradients are float32; the moments float32 or bfloat16
(``Adam(state_dtype=torch.bfloat16)``), read into float32 and stored back
rounded to nearest even. The kernel equals the per-leaf PyTorch update on
the card bit for bit: every division here is between two tensors (on CUDA
``tensor / Python scalar`` is a product with the reciprocal), and the
kernel rounds each operation on its own in this order.
"""
from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from multimodn_tpu_torch.ops.fused_adam import _check_step_scalars, \
    _check_tensor

# Must match csrc/fused_adam_fp32.cu.
THREADS, VEC, RUNS = 256, 4, 4
CHUNK = THREADS * VEC * RUNS        # elements a block updates
MAX_LEAVES = 512                    # leaves per launch
STATE_TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ELEMENTS = 2 ** 31 - 1          # per leaf (the kernel's int sizes)


def moment_update(g, m_stored, v_stored, c12, gate, lr, b1, b2, eps):
    """One leaf's step without touching the parameter: ``(update, m', v')``
    with the moments in their stored dtype. ``c12`` is the (2,) tensor
    ``(1 - b1^t, 1 - b2^t)``; ``gate`` None, or a 0-D 0/1 tensor that
    freezes the moments and zeroes the update where it is 0."""
    c1, c2 = c12[0], c12[1]
    m, v = m_stored.to(g.dtype), v_stored.to(g.dtype)
    if gate is None:
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        upd = -lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    else:
        # m + gate*(1-b1)*(g-m) == gate ? b1*m + (1-b1)*g : m
        m_new = m + gate * (1 - b1) * (g - m)
        v_new = v + gate * (1 - b2) * (g * g - v)
        upd = -lr * gate * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    return upd, m_new.to(m_stored.dtype), v_new.to(v_stored.dtype)


def leaf_update_ref(p, g, m, v, c12, gate, *, lr, b1, b2, eps):
    """Plain version of the kernel on one leaf: ``moment_update``, then
    ``p += update`` and the new moments written into ``m`` and ``v``."""
    upd, m_new, v_new = moment_update(g, m, v, c12, gate, lr, b1, b2, eps)
    p.add_(upd)
    m.copy_(m_new)
    v.copy_(v_new)


def multi_leaf_update_ref(leaves, *, lr, b1, b2, eps):
    """Plain version of one update: ``leaf_update_ref`` over ``leaves``,
    each ``(p, g, m, v, c12, gate)``, in order."""
    for leaf in leaves:
        leaf_update_ref(*leaf, lr=lr, b1=b1, b2=b2, eps=eps)


class LaunchGroup(NamedTuple):
    """Up to ``MAX_LEAVES`` leaves updated by one launch. ``leaves`` holds
    their indices into the shapes; ``geom`` per leaf its elements and its
    first chunk (int32, read by the kernel); ``blocks`` is the launch's
    grid, one block per chunk."""
    leaves: np.ndarray
    geom: np.ndarray
    blocks: int


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)         # shared by every caller of the cache
    return a


@functools.lru_cache(maxsize=64)
def chunk_table(shapes: Tuple[Tuple[int, ...], ...]
                ) -> Tuple[LaunchGroup, ...]:
    """The launch groups of a list of leaf shapes: the non-empty leaves in
    order, ``MAX_LEAVES`` a launch, each cut into chunks of ``CHUNK``
    elements (the last one ragged), numbered from 0 in each launch."""
    live = [i for i, s in enumerate(shapes) if math.prod(s) > 0]
    groups = []
    for g0 in range(0, len(live), MAX_LEAVES):
        idx = live[g0:g0 + MAX_LEAVES]
        geom, blocks = [], 0
        for i in idx:
            n = math.prod(shapes[i])
            if n > MAX_ELEMENTS:
                raise ValueError(f"a leaf of {n} elements is past the "
                                 f"kernel's {MAX_ELEMENTS}")
            geom.append((n, blocks))
            blocks += -(-n // CHUNK)
        groups.append(LaunchGroup(
            _frozen(np.asarray(idx, dtype=np.intp)),
            _frozen(np.asarray(geom, dtype=np.int32).reshape(-1, 2)),
            blocks))
    return tuple(groups)


def launches_per_update(shapes) -> int:
    """Kernel launches that ``multi_leaf_update`` makes for these leaf
    shapes on a CUDA device: one per ``MAX_LEAVES`` non-empty leaves."""
    return len(chunk_table(tuple(tuple(s) for s in shapes)))


class FusedAdamFp32Kernel:
    """The built kernel library and its launch count. ``launches`` goes up
    by one where the kernel is launched, and nowhere else."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        # Per shapes: weak references to the parameter and moment tensors
        # that passed every check, and the moments' type; while the same
        # tensors come back, only those that are new on every step (g, c12,
        # gate) are checked again.
        self.checked = {}

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            from multimodn_tpu_torch.ops.build import build_library
            lib = build_library("fused_adam_fp32.cu")
            lib.mmn_adam_fp32_multi.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int] + [ctypes.c_float] * 6
                + [ctypes.c_int, ctypes.c_void_p])
            lib.mmn_adam_fp32_multi.restype = ctypes.c_int
            lib.mmn_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mmn_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, leaves, shapes, state_type, *, lr, b1, b2, eps):
        """The launches of one update on PyTorch's current stream, on leaves
        that ``check_leaves`` accepted; ``shapes`` are their parameters'
        shapes. ``c12`` and ``gate`` stay on the device."""
        lib = self.library()
        dev = leaves[0][0].device
        ptrs = np.fromiter((0 if t is None else t.data_ptr()
                            for leaf in leaves for t in leaf),
                           dtype=np.int64, count=6 * len(leaves)
                           ).reshape(-1, 6)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for grp in chunk_table(shapes):
                rows = ptrs[grp.leaves]
                # 1 - b is rounded to float32 from the double, as a Python
                # scalar in a float32 product is.
                err = lib.mmn_adam_fp32_multi(
                    rows.ctypes.data, grp.geom.ctypes.data, len(grp.leaves),
                    grp.blocks, lr, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                    state_type, stream)
                if err != 0:
                    raise RuntimeError(
                        "fused_adam_fp32 kernel launch failed: "
                        + lib.mmn_cuda_error_string(err).decode())
                self.launches += 1


FUSED_ADAM_FP32 = FusedAdamFp32Kernel()


def check_leaves(leaves, shapes=None) -> int:
    """Raise unless the kernel takes ``leaves`` (each ``(p, g, m, v, c12,
    gate)``): every tensor on the first parameter's device and contiguous,
    ``p`` and ``g`` float32, ``m`` and ``v`` shaped like ``p`` and all of
    one type of ``STATE_TYPES``, ``c12`` a (2,) and ``gate`` None or a 0-D
    float32 tensor. Returns the moments' ``STATE_TYPES`` code."""
    shapes = shapes or tuple(tuple(leaf[0].shape) for leaf in leaves)
    device = leaves[0][0].device
    state = [t for leaf in leaves for t in (leaf[0], leaf[2], leaf[3])]
    hit = FUSED_ADAM_FP32.checked.get(shapes)
    if hit is not None and all(r() is t for r, t in zip(hit[0], state)):
        # Leaves of one group share their c12 and gate: check each pair
        # once (the objects are alive for the whole call).
        scalars = {}
        for (_p, g, _m, _v, c12, gate), shape in zip(leaves, shapes):
            _check_tensor(g, device, shape, torch.float32, "g")
            scalars[(id(c12), id(gate))] = (c12, gate)
        for c12, gate in scalars.values():
            _check_step_scalars(device, c12, gate)
        return hit[1]
    state_dtype = leaves[0][2].dtype
    if state_dtype not in STATE_TYPES:
        raise TypeError(f"m must be {' or '.join(map(str, STATE_TYPES))}, "
                        f"got {state_dtype}")
    for (p, g, m, v, c12, gate), shape in zip(leaves, shapes):
        _check_tensor(p, device, shape, torch.float32, "p")
        _check_tensor(m, device, shape, state_dtype, "m")
        _check_tensor(v, device, shape, state_dtype, "v")
        _check_tensor(g, device, shape, torch.float32, "g")
        _check_step_scalars(device, c12, gate)
    FUSED_ADAM_FP32.checked[shapes] = (
        [weakref.ref(t) for t in state], STATE_TYPES[state_dtype])
    return STATE_TYPES[state_dtype]


def multi_leaf_update(leaves: Sequence, *, lr, b1, b2, eps):
    """fp32 Adam update of every leaf in ``leaves``, in place on each ``p,
    m, v``; an entry is ``(p, g, m, v, c12, gate)``.

    ``c12`` is a (2,) float32 tensor ``(1 - b1^t, 1 - b2^t)`` on the leaf's
    device and ``gate`` None or a 0-D float32 tensor (1 runs the step, 0
    freezes the moments and the parameter), both per leaf. On the CPU this
    is the plain version; on a CUDA device it is the kernel, one launch per
    ``MAX_LEAVES`` non-empty leaves."""
    leaves = [tuple(leaf) for leaf in leaves]
    if not leaves:
        return
    device = leaves[0][0].device
    if device.type == "cpu":
        multi_leaf_update_ref(leaves, lr=lr, b1=b1, b2=b2, eps=eps)
        return
    if device.type != "cuda":
        raise ValueError(f"multi_leaf_update runs on cpu or cuda, not "
                         f"{device}")
    shapes = tuple(tuple(leaf[0].shape) for leaf in leaves)
    state_type = check_leaves(leaves, shapes)
    FUSED_ADAM_FP32.launch(leaves, shapes, state_type, lr=lr, b1=b1, b2=b2,
                           eps=eps)
