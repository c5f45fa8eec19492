"""The whole MultiModN forward in one CUDA kernel (port of the Pallas TPU
kernel ``multimodn_tpu/ops/fused_chain.py::make_fused_chain_forward``).

The kernel lives in ``csrc/fused_chain.cu``; its source note says what
bounds it on an H100 and how the design answers that. This module holds:

- ``ChainSpec``: the static plan of a model (per-layer source, dims,
  activation code and weight offsets) as a small int32 array, and the
  flattening of the parameters into one float32 buffer in plan order;
- ``fused_chain_forward_ref``: the plain PyTorch version, the twin of
  ``make_xla_chain_forward``;
- ``fused_chain_forward``: the wrapper. CPU tensors take the plain version;
  CUDA tensors launch the kernel or raise, with no fallback.
  ``FUSED_CHAIN.launches`` counts the launches.

Supported module set, as in the TPU kernel: MLP-family encoders
(``MLPEncoder`` last-layer concat, ``MIMICMLPEncoder`` first-layer concat,
inference mode) and dense decoders (``ClassDecoder`` / ``LogisticDecoder`` /
``MLPDecoder``). Data arrives NaN-zeroed with a (B, E) validity mask.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from multimodn_tpu_torch.core.nn import activation_name
from multimodn_tpu_torch.decoders.decoders import ClassDecoder, MLPDecoder
from multimodn_tpu_torch.encoders.mlp import MIMICMLPEncoder, MLPEncoder

# Must match csrc/fused_chain.cu.
ACT_CODES = {"identity": 0, "none": 0, "relu": 1, "sigmoid": 2, "tanh": 3,
             "gelu": 4, "softmax": 5}
SRC_DATA, SRC_PREV, SRC_STATE = 0, 1, 2
TILE, CHUNK = 32, 32
MAX_PLAN, MAX_ENC, MAX_DEC = 768, 32, 32
MAX_SHARED_BYTES = 232448   # what one block may use on sm_90


class ChainSpec:
    """Static plan of an MLP-family model for the fused-chain kernel.

    ``enc_plans`` / ``dec_plans`` follow the TPU kernel's ChainSpec;
    ``layers`` holds, in kernel order (encoders, then decoders), one
    ``(source, K, N, act_code, has_state)`` record per dense layer, where
    ``K`` is the width of the layer's main input and a concat layer's weight
    splits as ``w[:K]`` (main input) and ``w[K:]`` (state)."""

    def __init__(self, encoders: Sequence, decoders: Sequence,
                 state_size: int):
        S = state_size
        self.encoders, self.decoders = list(encoders), list(decoders)
        self.state_size = S
        self.enc_plans, self.dec_plans = [], []
        self.layers: List[Tuple[int, int, int, int, bool]] = []
        enc_records, dec_records = [], []
        for enc in self.encoders:
            if not isinstance(enc, (MIMICMLPEncoder, MLPEncoder)):
                raise TypeError(
                    f"fused chain kernel supports MLP-family encoders only, "
                    f"got {type(enc).__name__}")
            act = activation_name(enc.activation)
            first = len(self.layers)
            if isinstance(enc, MIMICMLPEncoder):
                dims = enc._dims
                self.enc_plans.append(("first_concat", act, len(dims) - 1))
                for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
                    self.layers.append(
                        (SRC_DATA, k - S, n, ACT_CODES[act], True) if i == 0
                        else (SRC_PREV, k, n, ACT_CODES[act], False))
            else:
                ldims = enc._layer_dims
                self.enc_plans.append(("last_concat", act, len(ldims)))
                for i, (k, n) in enumerate(ldims):
                    last = i == len(ldims) - 1
                    self.layers.append(
                        (SRC_DATA if i == 0 else SRC_PREV,
                         k - S if last else k, n,
                         ACT_CODES["identity" if last else act], last))
            enc_records.append((first, len(self.layers) - first,
                                enc.n_features))
        for dec in self.decoders:
            first = len(self.layers)
            if isinstance(dec, MLPDecoder):
                hact = activation_name(dec.hidden_activation)
                oact = activation_name(dec.output_activation)
                dims = dec._dims
                self.dec_plans.append(("mlp", hact, oact, len(dims) - 1,
                                       dec.n_classes))
                for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
                    act = oact if i == len(dims) - 2 else hact
                    self.layers.append((SRC_STATE if i == 0 else SRC_PREV,
                                        k, n, ACT_CODES[act], False))
            elif isinstance(dec, ClassDecoder):
                act = activation_name(dec.activation)
                self.dec_plans.append(("class", "identity", act, 1,
                                       dec.n_classes))
                self.layers.append((SRC_STATE, S, dec.n_classes,
                                    ACT_CODES[act], False))
            else:
                raise TypeError(
                    f"fused chain kernel supports dense decoders only, got "
                    f"{type(dec).__name__}")
            dec_records.append((first, len(self.layers) - first,
                                dec.n_classes))

        layer_records, off = [], 0
        for src, k, n, act, has_state in self.layers:
            w_off = off
            ws_off = w_off + k * n if has_state else -1
            off += (k + (S if has_state else 0)) * n
            layer_records.append((src, k, n, act, w_off, ws_off, off))
            off += n
        self.n_weights = off
        self.hidden_width = max(n for _s, _k, n, _a, _h in self.layers)
        header = (len(self.encoders), len(self.decoders), S,
                  len(self.layers), self.hidden_width, self.n_weights)
        self.plan = np.asarray(
            header + sum(enc_records + dec_records + layer_records, ()),
            dtype=np.int32)
        self.shared_bytes = 4 * (TILE * (S + 1) + 2 * TILE *
                                 (self.hidden_width + 1) + TILE * (CHUNK + 1))

    def flatten_params(self, params: dict) -> torch.Tensor:
        """One contiguous float32 buffer in plan order: per layer ``w``
        (``(in, out)``, so a concat layer's ``w[:K]`` and ``w[K:]`` are
        already its two contiguous halves), then ``b``."""
        layers = [layer for p in params["encoders"] for layer in p["layers"]]
        layers += [layer for p in params["decoders"] for layer in p["layers"]]
        if len(layers) != len(self.layers):
            raise ValueError(f"params hold {len(layers)} dense layers, the "
                             f"plan {len(self.layers)}")
        flat = []
        for (_src, k, n, _a, has_state), layer in zip(self.layers, layers):
            rows = k + (self.state_size if has_state else 0)
            if tuple(layer["w"].shape) != (rows, n):
                raise ValueError(f"weight shape {tuple(layer['w'].shape)} "
                                 f"does not match the plan's {(rows, n)}")
            flat += [layer["w"].reshape(-1), layer["b"].reshape(-1)]
        return torch.cat(flat).float().contiguous()


def fused_chain_forward_ref(spec: ChainSpec, params: dict, data, valid,
                            init_row):
    """Plain PyTorch version of the kernel (twin of the JAX package's
    ``make_xla_chain_forward``): returns ``(states (E+1, B, S), outputs list
    of (E+1, B, C_d))``."""
    B = data[0].shape[0]
    state = init_row.reshape(1, spec.state_size).expand(B, spec.state_size)
    states = [state]
    for e, enc in enumerate(spec.encoders):
        new_state = enc.apply(params["encoders"][e], state, data[e])
        state = torch.where(valid[:, e:e + 1] > 0, new_state, state)
        states.append(state)
    states = torch.stack(states)
    outs = [dec.apply(params["decoders"][d], states)
            for d, dec in enumerate(spec.decoders)]
    return states, outs


class FusedChainKernel:
    """The built kernel library and its launch count. ``launches`` goes up
    by one where the kernel is launched, and nowhere else."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            from multimodn_tpu_torch.ops.build import build_library
            lib = build_library("fused_chain.cu")
            lib.mmn_fused_chain_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p]
            lib.mmn_fused_chain_forward.restype = ctypes.c_int
            lib.mmn_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mmn_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, spec: ChainSpec, weights, data, valid, init_row):
        """One launch on PyTorch's current stream, on inputs that
        ``_check_inputs`` accepted and ``weights`` from
        ``spec.flatten_params``; outputs come from ``torch.empty``."""
        lib = self.library()
        B = data[0].shape[0]
        dev = valid.device
        states = torch.empty((len(data) + 1, B, spec.state_size),
                             dtype=torch.float32, device=dev)
        outs = [torch.empty((len(data) + 1, B, p[-1]), dtype=torch.float32,
                            device=dev) for p in spec.dec_plans]
        if B == 0:
            return states, outs
        data_ptrs = (ctypes.c_void_p * max(len(data), 1))(
            *[d.data_ptr() for d in data])
        out_ptrs = (ctypes.c_void_p * max(len(outs), 1))(
            *[o.data_ptr() for o in outs])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mmn_fused_chain_forward(
                spec.plan.ctypes.data, len(spec.plan), weights.data_ptr(),
                ctypes.cast(data_ptrs, ctypes.c_void_p), valid.data_ptr(),
                init_row.data_ptr(), states.data_ptr(),
                ctypes.cast(out_ptrs, ctypes.c_void_p), B, stream)
        if err != 0:
            raise RuntimeError("fused_chain kernel launch failed: "
                               + lib.mmn_cuda_error_string(err).decode())
        self.launches += 1
        return states, outs


FUSED_CHAIN = FusedChainKernel()


def _check_inputs(spec: ChainSpec, weights, data, valid, init_row):
    E, S = len(spec.encoders), spec.state_size
    if len(data) != E:
        raise ValueError(f"expected {E} modality arrays, got {len(data)}")
    B = data[0].shape[0]
    expected = [((B, enc.n_features), f"data[{e}]")
                for e, enc in enumerate(spec.encoders)]
    expected += [((B, E), "valid"), ((S,), "init_row"),
                 ((spec.n_weights,), "weights")]
    for t, (shape, name) in zip(list(data) + [valid, init_row, weights],
                                expected):
        if t.device != valid.device:
            raise ValueError(f"{name} is on {t.device}, valid on "
                             f"{valid.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len(spec.plan) > MAX_PLAN or E > MAX_ENC or \
            len(spec.decoders) > MAX_DEC:
        raise NotImplementedError(
            f"model too large for the kernel's plan: {len(spec.plan)} plan "
            f"entries (max {MAX_PLAN}), {E} encoders (max {MAX_ENC}), "
            f"{len(spec.decoders)} decoders (max {MAX_DEC})")
    if spec.shared_bytes > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"layer width {spec.hidden_width} needs {spec.shared_bytes} bytes "
            f"of shared memory per block, more than {MAX_SHARED_BYTES}")


def fused_chain_forward(spec: ChainSpec, params: dict, data, valid,
                        init_row):
    """``(states (E+1, B, S), outputs list of (E+1, B, C_d))`` for NaN-zeroed
    ``data`` (E tensors of (B, F_e)), ``valid`` (B, E) and the init-state
    row (S,). On the CPU this is the plain version; on a CUDA device it is
    the kernel."""
    device = valid.device
    if device.type == "cpu":
        return fused_chain_forward_ref(spec, params, data, valid, init_row)
    if device.type != "cuda":
        raise ValueError(f"fused_chain_forward runs on cpu or cuda, not "
                         f"{device}")
    weights = spec.flatten_params(params)
    _check_inputs(spec, weights, data, valid, init_row)
    return FUSED_CHAIN.launch(spec, weights, data, valid, init_row)
