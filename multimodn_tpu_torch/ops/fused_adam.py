"""One-pass 8-bit blockwise Adam update of many parameter leaves in one
launch (port of the Pallas TPU kernel
``multimodn_tpu/ops/fused_adam.py::_make_leaf_pallas``).

The moments ``m`` and ``v`` are stored as 8-bit codes (``float8_e4m3fn`` by
default, ``int8`` as an option) with one float32 absmax scale per row of the
leaf seen as ``(rows, cols)``. The kernel lives in ``csrc/fused_adam.cu``; its
source note says what bounds it on an H100 and how the design answers that.
This module holds:

- ``quantize_rows`` / ``dequantize`` / ``scale_shape`` / ``code_dtype`` and
  ``moment_update``: the update's math in plain PyTorch, in the JAX package's
  order of operations;
- ``leaf_update_ref`` / ``multi_leaf_update_ref``: the plain version of the
  kernel (twin of ``_leaf_update_xla``), for one leaf and for a list;
- ``leaf_table``: how a list of leaf shapes is laid out over launches and
  blocks (the kernel reads it);
- ``multi_leaf_update`` and its one-leaf case ``leaf_update``: the wrapper.
  It updates ``p, mq, ms, vq, vs`` in place. CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise, with no fallback.
  ``FUSED_ADAM.launches`` counts the launches.

The cross-rank form: under a mesh's ``model`` axis a leaf may be a column
piece of a whole leaf, so each of its rows is split across ranks and the
row's absmax (the JAX package's, which GSPMD reduces over the whole row) is
a MAX across the axis. Such a leaf (``split``) takes the kernel's split-row
path whatever its width: pass 1 writes ``p'`` and each chunk's absmax into
the row's int32 scratch words (the bits of non-negative floats, so an
integer max is the float max and a NaN still wins), an ``all_reduce(MAX)``
over the model axis (``row_group``) runs on those words between the two
launches, and pass 2 requantizes by the whole row's absmax. The plain
version takes the same MAX of its row absmax (``quantize_rows``); both
equal ``multi_leaf_update_ref`` on the whole leaf, sliced.

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
import functools
import math
import weakref
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

Q_MAX = 127.0          # int8 linear code range
FP8_MAX = 448.0        # float8_e4m3fn max finite
# Must match csrc/fused_adam.cu.
FMT_CODES = {"fp8": 0, "int8": 1}
THREADS, VEC, FIT_GROUPS = 256, 4, 4
FIT_COLS = THREADS * VEC * FIT_GROUPS      # widest row one block holds
SPLIT_COLS = THREADS * VEC                 # columns per block of a wider row
MAX_LEAVES = 40                            # leaves per launch
SCRATCH_WORDS = 4                          # per split row


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


def row_absmax_max(absmax: torch.Tensor, row_group) -> torch.Tensor:
    """The MAX over ``row_group`` (a mesh axis, ``parallel.collectives.
    AxisGroup``) of per-row absmax values, taken on their int32 bits."""
    bits = absmax.contiguous().view(torch.int32)
    return row_group.all_reduce(bits, "max").view(torch.float32)


def quantize_rows(x: torch.Tensor, fmt: str = "fp8", row_group=None):
    """Blockwise absmax 8-bit quantization along the last axis: returns
    ``(codes like x, float32 scales of scale_shape(x.shape))``; dequantize
    with ``codes * scales``. Zero rows get scale 0 and codes 0.

    A NaN or Inf in a row fails the ``absmax > 0`` test, so the row's finite
    elements code to 0 and its scale becomes NaN or Inf: the whole row
    dequantizes to NaN on the next step, as in the JAX package. An int8 code
    of a NaN is 0 (XLA's float-to-int conversion).

    ``row_group``: ``x`` holds the rank's columns of rows split across a
    mesh axis; the absmax is the whole row's (``row_absmax_max``)."""
    x = x.float()
    if x.dim() == 0:
        q, s = quantize_rows(x.reshape(1), fmt)
        return q.reshape(()), s.reshape(())
    q_top = Q_MAX if fmt == "int8" else FP8_MAX
    absmax = x.abs().amax(dim=-1, keepdim=True)
    if row_group is not None:
        absmax = row_absmax_max(absmax, row_group)
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
                  fmt: str = "fp8", row_group=None):
    """The kernel's math, returning ``(update, mq', ms', vq', vs')`` without
    touching the parameter. ``gate`` (a 0/1 scalar tensor) gives the
    structural skip: frozen moments and a zero update where it is 0.
    ``c1`` / ``c2`` are the bias corrections ``1 - b^t``; ``row_group``
    the cross-rank form's axis (``quantize_rows``)."""
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
    mq_new, ms_new = quantize_rows(m_new, fmt, row_group)
    vq_new, vs_new = quantize_rows(v_new, fmt, row_group)
    return upd, mq_new, ms_new, vq_new, vs_new


def leaf_update_ref(p, g, mq, ms, vq, vs, c1, c2, lr, b1, b2, eps,
                    gate=None, fmt: str = "fp8", row_group=None):
    """Plain version of the kernel (twin of the JAX package's
    ``_leaf_update_xla``): returns new ``(p', mq', ms', vq', vs')``."""
    upd, mq_new, ms_new, vq_new, vs_new = moment_update(
        g, mq, ms, vq, vs, c1, c2, lr, b1, b2, eps, gate=gate, fmt=fmt,
        row_group=row_group)
    p_new = (p.float() + upd).to(p.dtype)
    return p_new, mq_new, ms_new, vq_new, vs_new


def multi_leaf_update_ref(leaves, *, lr, b1, b2, eps, fmt: str = "fp8",
                          split=None, row_group=None):
    """Plain version of one launch: ``leaf_update_ref`` over ``leaves``,
    each ``(p, g, mq, ms, vq, vs, c12, gate)``; returns the new
    ``(p', mq', ms', vq', vs')`` of each. ``split[i]`` marks a leaf of the
    cross-rank form over ``row_group``."""
    split = split or (False,) * len(leaves)
    return [leaf_update_ref(p, g, mq, ms, vq, vs, c12[0], c12[1], lr, b1, b2,
                            eps, gate=gate, fmt=fmt,
                            row_group=row_group if cut else None)
            for (p, g, mq, ms, vq, vs, c12, gate), cut in zip(leaves, split)]


def row_lanes(rows: int, cols: int, busy_blocks: int) -> int:
    """Threads the kernel gives one row of a (rows, cols) leaf: a power of
    two, or 0 for a row wider than ``FIT_COLS``, which is split across
    blocks. ``busy_blocks`` is the blocks that keep the card busy (2 per
    SM). A lane holds one run of ``VEC`` elements unless the leaf fills
    ``busy_blocks`` with up to ``FIT_GROUPS`` runs per lane, which gives
    each thread more loads in flight."""
    if cols > FIT_COLS:
        return 0
    one_run = min(THREADS, _pow2(-(-cols // VEC)))
    four_runs = _pow2(-(-cols // (VEC * FIT_GROUPS)))
    if -(-rows // (THREADS // four_runs)) >= busy_blocks:
        return four_runs
    return one_run


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class LaunchGroup(NamedTuple):
    """Up to ``MAX_LEAVES`` leaves updated by one launch (two when a row is
    split). ``geom`` holds per leaf ``rows, cols, lanes, first block of pass
    1, first block of pass 2, first split row`` (int32, read by the kernel);
    ``blocks`` / ``blocks2`` are the two passes' grids and ``split_rows`` the
    rows that need scratch."""
    leaves: Tuple[int, ...]
    geom: np.ndarray
    blocks: int
    blocks2: int
    split_rows: int


@functools.lru_cache(maxsize=64)
def leaf_table(shapes: Tuple[Tuple[int, ...], ...], busy_blocks: int,
               split: Optional[Tuple[bool, ...]] = None
               ) -> Tuple[LaunchGroup, ...]:
    """The launch groups of a list of leaf shapes (a leaf is an index into
    ``shapes``; empty leaves are left out) on a card that ``busy_blocks``
    keep busy. Rows that fit a block take ``THREADS // lanes`` rows per
    block; a wider row, and every row of a leaf that ``split`` marks (the
    cross-rank form), takes one block per ``SPLIT_COLS`` columns in each of
    two passes."""
    split = split or (False,) * len(shapes)
    live = [i for i, s in enumerate(shapes) if math.prod(s) > 0]
    groups = []
    for g0 in range(0, len(live), MAX_LEAVES):
        idx = tuple(live[g0:g0 + MAX_LEAVES])
        geom, blocks, blocks2, split_rows = [], 0, 0, 0
        for i in idx:
            rows, cols = rows_cols(shapes[i])
            lanes = 0 if split[i] else row_lanes(rows, cols, busy_blocks)
            geom.append((rows, cols, lanes, blocks, blocks2, split_rows))
            if lanes:
                blocks += -(-rows // (THREADS // lanes))
            else:
                n = rows * -(-cols // SPLIT_COLS)
                blocks, blocks2 = blocks + n, blocks2 + n
                split_rows += rows
        geom = np.asarray(geom, dtype=np.int32)
        geom.setflags(write=False)      # shared by every caller of the cache
        groups.append(LaunchGroup(idx, geom, blocks, blocks2, split_rows))
    return tuple(groups)


def launches_per_update(shapes, split=None) -> int:
    """Kernel launches that ``multi_leaf_update`` makes for these leaf
    shapes on a CUDA device: one per ``MAX_LEAVES`` non-empty leaves, two
    where one of them has a row wider than ``FIT_COLS`` or is a leaf of the
    cross-rank form (``split``)."""
    split = split or (False,) * len(shapes)
    live = [(s, cut) for s, cut in zip(shapes, split) if math.prod(s) > 0]
    return sum(1 + any(rows_cols(s)[1] > FIT_COLS or cut
                       for s, cut in live[g0:g0 + MAX_LEAVES])
               for g0 in range(0, len(live), MAX_LEAVES))


class FusedAdamKernel:
    """The built kernel library and its launch count. ``launches`` goes up
    by one where the kernel is launched, and nowhere else."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._busy_blocks = {}      # per device: 2 blocks per SM
        # Per (fmt, shapes): weak references to the parameter and state
        # tensors that passed every check; while the same tensors come back,
        # only the tensors that are new on every step (g, c12, gate) are
        # checked again.
        self.checked = {}

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            from multimodn_tpu_torch.ops.build import build_library
            lib = build_library("fused_adam.cu")
            lib.mmn_fused_adam_multi.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                + [ctypes.c_void_p] + [ctypes.c_float] * 6
                + [ctypes.c_int, ctypes.c_void_p])
            lib.mmn_fused_adam_multi.restype = ctypes.c_int
            lib.mmn_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mmn_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def busy_blocks(self, dev) -> int:
        if dev not in self._busy_blocks:
            self._busy_blocks[dev] = 2 * torch.cuda.get_device_properties(
                dev).multi_processor_count
        return self._busy_blocks[dev]

    def launch(self, leaves, shapes, *, lr, b1, b2, eps, fmt,
               busy_blocks=None, split=None, row_group=None):
        """The launches of one update on PyTorch's current stream, on leaves
        that ``_check_leaves`` accepted; ``shapes`` are their parameters'
        shapes. ``c12`` and ``gate`` stay on the device. ``busy_blocks``
        (default: 2 per SM of the leaves' card) picks the lanes per row.
        ``split`` / ``row_group``: the cross-rank form (module docstring):
        the scratch words are MAX-reduced over ``row_group`` between the
        passes."""
        lib = self.library()
        dev = leaves[0][0].device
        if busy_blocks is None:
            busy_blocks = self.busy_blocks(dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for grp in leaf_table(shapes, busy_blocks, split):
                ptrs = np.array([[0 if t is None else t.data_ptr()
                                  for t in leaves[i]] for i in grp.leaves],
                                dtype=np.int64)
                scratch = None if not grp.split_rows else torch.zeros(
                    grp.split_rows * SCRATCH_WORDS, dtype=torch.int32,
                    device=dev)
                for pass_, blocks in ((1, grp.blocks), (2, grp.blocks2)):
                    if blocks == 0:
                        continue
                    if pass_ == 2 and row_group is not None:
                        scratch.copy_(row_group.all_reduce(scratch, "max"))
                    # 1 - b is rounded to float32 from the double, like a
                    # Python scalar in a float32 product in either framework.
                    err = lib.mmn_fused_adam_multi(
                        ptrs.ctypes.data, grp.geom.ctypes.data,
                        len(grp.leaves), pass_, blocks,
                        None if scratch is None else scratch.data_ptr(), lr,
                        b1, 1.0 - b1, b2, 1.0 - b2, eps, FMT_CODES[fmt],
                        stream)
                    if err != 0:
                        raise RuntimeError(
                            "fused_adam kernel launch failed: "
                            + lib.mmn_cuda_error_string(err).decode())
                    self.launches += 1


FUSED_ADAM = FusedAdamKernel()


def _check_tensor(t, device, shape, dtype, name):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, p on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_leaf(p, g, mq, ms, vq, vs, c12, gate, fmt):
    shape = tuple(p.shape)
    qdt = code_dtype(fmt)
    if p.dtype != torch.float32:
        raise TypeError(f"p must be float32, got {p.dtype}")
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    for t, want_shape, dtype, name in (
            (g, shape, torch.float32, "g"), (mq, shape, qdt, "mq"),
            (ms, scale_shape(shape), torch.float32, "ms"),
            (vq, shape, qdt, "vq"),
            (vs, scale_shape(shape), torch.float32, "vs")):
        _check_tensor(t, p.device, want_shape, dtype, name)
    _check_step_scalars(p.device, c12, gate)


def _check_step_scalars(device, c12, gate):
    _check_tensor(c12, device, (2,), torch.float32, "c12")
    if gate is not None:
        _check_tensor(gate, device, (), torch.float32, "gate")


def _check_leaves(leaves, shapes, fmt):
    device = leaves[0][0].device
    state = [t for leaf in leaves for t in (leaf[0],) + tuple(leaf[2:6])]
    refs = FUSED_ADAM.checked.get((fmt, shapes))
    if refs is not None and all(r() is t for r, t in zip(refs, state)):
        # Leaves of one group share their c12 and gate: check each pair
        # once (the objects are alive for the whole call).
        scalars = {}
        for p, g, _mq, _ms, _vq, _vs, c12, gate in leaves:
            _check_tensor(g, device, tuple(p.shape), torch.float32, "g")
            scalars[(id(c12), id(gate))] = (c12, gate)
        for c12, gate in scalars.values():
            _check_step_scalars(device, c12, gate)
        return
    for leaf in leaves:
        if leaf[0].device != device:
            raise ValueError(f"p is on {leaf[0].device}, the first leaf on "
                             f"{device}")
        _check_leaf(*leaf, fmt)
    FUSED_ADAM.checked[(fmt, shapes)] = [weakref.ref(t) for t in state]


def multi_leaf_update(leaves: Sequence, *, lr, b1, b2, eps,
                      fmt: str = "fp8", split=None, row_group=None):
    """8-bit Adam update of every leaf in ``leaves``, in place on each
    ``p, mq, ms, vq, vs``; an entry is ``(p, g, mq, ms, vq, vs, c12,
    gate)``.

    ``c12`` is a (2,) float32 tensor ``(1 - b1^t, 1 - b2^t)`` on the leaf's
    device and ``gate`` None or a 0-D float32 tensor (1 runs the step, 0
    freezes the moments and the parameter), both per leaf. On the CPU this
    is the plain version; on a CUDA device it is the kernel, one launch per
    ``MAX_LEAVES`` leaves (two where a row is wider than ``FIT_COLS``).
    ``split`` (one flag per leaf) and ``row_group`` give the cross-rank form
    (module docstring)."""
    leaves = [tuple(leaf) for leaf in leaves]
    if not leaves:
        return
    if split is not None:
        split = tuple(bool(c) for c in split)
        if not any(split):
            split = None
        elif row_group is None:
            raise ValueError("split leaves need the row_group their rows "
                             "are split across")
    device = leaves[0][0].device
    if device.type == "cpu":
        for leaf in leaves:
            _check_leaf(*leaf, fmt)
        new = multi_leaf_update_ref(leaves, lr=lr, b1=b1, b2=b2, eps=eps,
                                    fmt=fmt, split=split, row_group=row_group)
        for leaf, out in zip(leaves, new):
            for dst, src in zip((leaf[0],) + leaf[2:6], out):
                dst.copy_(src)
        return
    if device.type != "cuda":
        raise ValueError(f"leaf_update runs on cpu or cuda, not {device}")
    shapes = tuple(tuple(leaf[0].shape) for leaf in leaves)
    _check_leaves(leaves, shapes, fmt)
    FUSED_ADAM.launch(leaves, shapes, lr=lr, b1=b1, b2=b2, eps=eps, fmt=fmt,
                      split=split,
                      row_group=None if split is None else row_group)


def leaf_update(p, g, mq, ms, vq, vs, c12, *, lr, b1, b2, eps,
                gate: Optional[torch.Tensor] = None, fmt: str = "fp8"):
    """8-bit Adam update of one leaf, in place on ``p, mq, ms, vq, vs``:
    ``multi_leaf_update`` of a list of one."""
    multi_leaf_update([(p, g, mq, ms, vq, vs, c12, gate)], lr=lr, b1=b1,
                      b2=b2, eps=eps, fmt=fmt)
