"""The whole MultiModN forward as two CUDA stages (port of the Pallas TPU
kernel ``multimodn_tpu/ops/fused_chain.py::make_fused_chain_forward``).

The kernels live in ``csrc/fused_chain.cu``; its source note says what
bounds them on an H100 and how the design answers that. Stage A computes
every product that does not read the state (each concat layer's x-part, and
a last-concat encoder's hidden layers before it) as a batched GEMM spread
over the card; Stage B runs the state chain and every decoder per batch
tile, with the state-path weights in shared memory. This module holds:

- ``ChainSpec``: the static plan of a model: Stage A's jobs, which read
  their weights in the parameter tensors; Stage A's copies, which pack the
  state-path weights into one float32 region padded to 4 columns (its plain
  version is ``flatten_params``); and Stage B's int32 plan (per-layer
  source, dims, activation code and weight offsets in that region);
- ``fused_chain_forward_ref``: the plain PyTorch version, the twin of
  ``make_xla_chain_forward``;
- ``fused_chain_forward``: the wrapper. CPU tensors take the plain version;
  CUDA tensors launch the kernels or raise, with no fallback.
  ``FUSED_CHAIN.launches`` counts the launches (``ChainSpec.launches`` per
  call);
- the JAX module's three builders, each returning ``forward(params, data,
  valid, init_row) -> (states, outputs)``: ``make_xla_chain_forward`` (the
  plain version), ``make_fused_chain_forward`` (the wrapper) and
  ``make_fused_chain_vjp`` (the wrapper's forward with the plain chain's
  gradient, so that K1 can sit inside a loss that is differentiated).

Supported module set, as in the TPU kernel: MLP-family encoders
(``MLPEncoder`` last-layer concat, ``MIMICMLPEncoder`` first-layer concat,
inference mode) and dense decoders (``ClassDecoder`` / ``LogisticDecoder`` /
``MLPDecoder``). Data arrives NaN-zeroed with a (B, E) validity mask.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from multimodn_tpu_torch.core.nn import activation_name
from multimodn_tpu_torch.decoders.decoders import ClassDecoder, MLPDecoder
from multimodn_tpu_torch.encoders.mlp import MIMICMLPEncoder, MLPEncoder

# Must match csrc/fused_chain.cu.
ACT_CODES = {"identity": 0, "none": 0, "relu": 1, "sigmoid": 2, "tanh": 3,
             "gelu": 4, "softmax": 5}
SRC_DATA, SRC_PREV, SRC_STATE = 0, 1, 2
BM, BN, BK = 128, 32, 32           # Stage A block tile
STAGE_B_TILE = 16                  # Stage B's smallest batch tile
MAX_SPLIT = 32                     # partial sums per projection
MAX_PLAN, MAX_ENC, MAX_DEC = 640, 32, 32
JOB_FIELDS = 15
MAX_COPIES, COPY_FIELDS = 24, 6    # copies per Stage A launch
COPY_SPAN = 4096                   # floats one copy block writes
MAX_SHARED_BYTES = 232448   # what one block may use on sm_90


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _row_stride(width: int) -> int:
    """Row stride of a Stage B tile: a multiple of 4 floats (16-byte rows)
    and an odd number of 16-byte groups, so rows fall on distinct banks."""
    ld = _round4(width)
    return ld + 4 if (ld // 4) % 2 == 0 else ld


class StageAJob(NamedTuple):
    """One state-independent product of encoder ``enc`` at ``depth``: the
    input is the encoder's data (depth 0) or the job at depth - 1; the
    weights are the first ``K`` rows of dense layer ``layer``'s ``w`` (a
    projection: no bias or activation, and K may split) or its ``w`` and
    ``b``."""
    enc: int
    depth: int
    K: int
    N: int
    act: int
    layer: int
    proj: bool


class StateCopy(NamedTuple):
    """One state-path layer packed by Stage A: rows ``row0 .. row0 + K`` of
    dense layer ``layer``'s ``w`` (N columns) and its ``b``, written at
    ``dst`` floats into the region as (round4(K), round4(N)) then
    round4(N), zeros in the pads."""
    layer: int
    row0: int
    K: int
    N: int
    dst: int


class ChainSpec:
    """Static plan of an MLP-family model for the fused-chain kernels.

    ``enc_plans`` / ``dec_plans`` follow the TPU kernel's ChainSpec;
    ``layers`` holds, in model order (encoders, then decoders), one
    ``(source, K, N, act_code, has_state)`` record per dense layer, where
    ``K`` is the width of the layer's main input and a concat layer's weight
    splits as ``w[:K]`` (main input) and ``w[K:]`` (state).

    Stage A: ``a_jobs``, every encoder's data-only layers and the x-part of
    its concat layer, in ``a_depth`` dependent launches (plus one row pass
    per softmax hidden layer); ``copies``, the state-path layers that its
    first launch packs (``MAX_COPIES`` per launch, more in launches of their
    own). Stage B: ``plan``, the state chain, reading the packed region
    (``region_len`` floats: (round4(K), round4(N)) matrices and round4(N)
    biases with zero pads). ``n_proj_weights`` and ``n_state_weights`` count
    the parameters of each part."""

    def __init__(self, encoders: Sequence, decoders: Sequence,
                 state_size: int):
        S = state_size
        self.encoders, self.decoders = list(encoders), list(decoders)
        self.state_size = S
        self.enc_plans, self.dec_plans = [], []
        self.layers: List[Tuple[int, int, int, int, bool]] = []
        enc_layers = []
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
            enc_layers.append(range(first, len(self.layers)))
        dec_layers = []
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
            dec_layers.append(range(first, len(self.layers)))
        self._lay_out(enc_layers, dec_layers)

    def _lay_out(self, enc_layers, dec_layers):
        """Stage A's jobs and copies and Stage B's plan."""
        S = self.state_size
        self.a_jobs: List[StageAJob] = []
        n_proj = 0
        for e, lays in enumerate(enc_layers):
            for depth, l in enumerate(lays):
                _src, k, n, act, has_state = self.layers[l]
                self.a_jobs.append(StageAJob(e, depth, k, n, act, l,
                                             has_state))
                if has_state:          # the concat layer's x-part
                    n_proj += k * n
                    break
                n_proj += k * n + n
        self.n_proj_weights = n_proj
        self.a_depth = 1 + max((j.depth for j in self.a_jobs), default=-1)

        # Stage B: per encoder its concat layer (state part plus Stage A's
        # projection) and the layers after it; every decoder layer.
        b_off, n_state = 0, 0
        b_records, copies = [], []

        def add_b(l, src, K, N, act, add_proj, row0=0):
            nonlocal b_off, n_state
            w_off, bias_off = b_off, b_off + _round4(K) * _round4(N)
            b_off = bias_off + _round4(N)
            n_state += K * N + N
            b_records.append((src, K, N, act, w_off, bias_off, add_proj))
            copies.append(StateCopy(l, row0, K, N, w_off))

        enc_records = []
        for lays in enc_layers:
            first = len(b_records)
            for l in lays:
                src, k, n, act, has_state = self.layers[l]
                if has_state:
                    add_b(l, SRC_STATE, S, n, act, 1, row0=k)
                elif not any(j.layer == l for j in self.a_jobs):
                    add_b(l, SRC_PREV, k, n, act, 0)   # after the concat
            enc_records.append((first, len(b_records) - first))
        dec_records = []
        for d, lays in enumerate(dec_layers):
            first = len(b_records)
            for l in lays:
                src, k, n, act, _h = self.layers[l]
                add_b(l, src, k, n, act, 0)
            dec_records.append((first, len(b_records) - first,
                                self.decoders[d].n_classes))
        self.n_state_weights = n_state
        self.n_weights = self.n_proj_weights + self.n_state_weights
        self.region_len = b_off
        self.copies = copies
        self.state_stride = _row_stride(S)
        self.hidden_stride = _row_stride(max(r[2] for r in b_records))
        header = (len(self.encoders), len(self.decoders), S, len(b_records),
                  self.state_stride, self.hidden_stride, b_off)
        self.plan = np.asarray(
            header + sum(enc_records + dec_records + b_records, ()),
            dtype=np.int32)
        self.softmax_jobs = [j for j in self.a_jobs
                             if j.act == ACT_CODES["softmax"]]
        self.copy_groups = self._copy_groups()
        self.launches = (self.a_depth + len(self.softmax_jobs)
                         + len(self.copy_groups) - (self.a_depth > 0) + 1)
        # Stage B's least shared memory: the small tiles and their
        # validity mask (the weights and projections go through L2).
        self.shared_bytes = 4 * (STAGE_B_TILE * (self.state_stride
                                                 + 2 * self.hidden_stride)
                                 + _round4(STAGE_B_TILE * len(self.encoders)))
        self._a_plans = {}

    def _copy_groups(self):
        """The copies in launches of at most ``MAX_COPIES``: per launch
        ``(copies, int64 rows, blocks)``, a row ``w, b, dst, K, N, first
        block`` with its pointer columns left 0 for the caller. The first
        rides on Stage A's first launch; the others are launches of their
        own."""
        groups = []
        for c0 in range(0, len(self.copies), MAX_COPIES):
            copies, rows, blocks = self.copies[c0:c0 + MAX_COPIES], [], 0
            for c in copies:
                n = _round4(c.N)
                rows.append([0, 0, 0, c.K, c.N, blocks])
                blocks += -(-(_round4(c.K) * n + n) // COPY_SPAN)
            rows = np.asarray(rows, dtype=np.int64)
            rows.setflags(write=False)    # callers fill in copies
            groups.append((copies, rows, blocks))
        return groups

    def layer_params(self, params: dict):
        """``(w, b)`` of every dense layer in plan order, shapes checked
        against the plan."""
        layers = [layer for p in params["encoders"] for layer in p["layers"]]
        layers += [layer for p in params["decoders"] for layer in p["layers"]]
        if len(layers) != len(self.layers):
            raise ValueError(f"params hold {len(layers)} dense layers, the "
                             f"plan {len(self.layers)}")
        out = []
        for (_src, k, n, _a, has_state), layer in zip(self.layers, layers):
            rows = k + (self.state_size if has_state else 0)
            w, b = layer["w"], layer["b"]
            if tuple(w.shape) != (rows, n) or tuple(b.shape) != (n,):
                raise ValueError(
                    f"weight shapes {tuple(w.shape)}, {tuple(b.shape)} do "
                    f"not match the plan's {(rows, n)}, {(n,)}")
            out.append((w, b))
        return out

    def flatten_params(self, params: dict) -> torch.Tensor:
        """The packed state-path region (``region_len`` float32) as Stage
        A's copy blocks write it: the plain version of the copies."""
        layers = self.layer_params(params)
        region = torch.zeros(self.region_len, dtype=torch.float32,
                             device=layers[0][0].device)
        for c in self.copies:
            w, b = layers[c.layer]
            kp, np_ = _round4(c.K), _round4(c.N)
            region[c.dst:c.dst + kp * np_].view(kp, np_)[:c.K, :c.N] = \
                w[c.row0:c.row0 + c.K]
            region[c.dst + kp * np_:c.dst + kp * np_ + c.N] = b
        return region

    def stage_a_plan(self, B: int, n_sm: int):
        """Stage A's launches at batch ``B`` on a card of ``n_sm`` SMs:
        ``(levels, workspace floats, job outputs, tickets)``. A level is
        ``(jobs, int64 rows, blocks)`` with one row of ``JOB_FIELDS`` per
        job, its pointer columns (in, out, w, bias, counters) left 0 for
        the caller; a job's output is ``(workspace offset, ksplit, first
        ticket)``: a job that splits K writes ``ksplit`` partials, and the
        last block of each output tile to take its ticket (an int32 counter
        that starts at 0, and that this block sets back to 0) sums them
        into the first. At small B a projection's K chunks
        are split (into at most ``MAX_SPLIT`` partials) so the level has up to
        ~2 blocks per SM."""
        key = (B, n_sm)
        if key not in self._a_plans:
            if len(self._a_plans) > 64:
                self._a_plans.clear()
            self._a_plans[key] = self._make_a_plan(B, n_sm)
        return self._a_plans[key]

    def _make_a_plan(self, B, n_sm):
        m_tiles = -(-B // BM)
        levels, outputs, ws, tickets = [], [None] * len(self.a_jobs), 0, 0
        for depth in range(self.a_depth):
            idx = [i for i, j in enumerate(self.a_jobs) if j.depth == depth]
            work = sum(m_tiles * -(-self.a_jobs[i].N // BN)
                       * -(-self.a_jobs[i].K // BK) for i in idx)
            per_block = max(1, -(-work // (2 * n_sm)))
            rows, blocks = [], 0
            for i in idx:
                j = self.a_jobs[i]
                n_tiles, chunks = -(-j.N // BN), -(-j.K // BK)
                cps = min(max(per_block, -(-chunks // MAX_SPLIT)), chunks) \
                    if j.proj else chunks
                ksplit = -(-chunks // cps)
                stride = B * j.N
                # The input is the data or the job before: K wide either
                # way. A softmax layer's GEMM writes logits; a row pass
                # follows.
                act = 0 if j.act == ACT_CODES["softmax"] else j.act
                rows.append([0, 0, 0, 0, 0, j.K, j.K, j.N, act, ksplit, cps,
                             m_tiles, n_tiles, blocks, stride])
                outputs[i] = (ws, ksplit, tickets)
                ws += ksplit * stride
                blocks += m_tiles * n_tiles * ksplit
                if ksplit > 1:
                    tickets += m_tiles * n_tiles
            rows = np.asarray(rows, dtype=np.int64)
            rows.setflags(write=False)    # callers fill in copies
            levels.append((idx, rows, blocks))
        return levels, ws, outputs, tickets


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
    by one where a kernel is launched, and nowhere else."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._n_sm = {}
        # Stage A's tickets per (device, stream): zeroed once, and every
        # launch leaves them at 0 again.
        self._tickets = {}

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            from multimodn_tpu_torch.ops.build import build_library
            lib = build_library("fused_chain.cu")
            lib.mmn_chain_stage_a.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.mmn_chain_softmax.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.mmn_chain_stage_b.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            for fn in (lib.mmn_chain_stage_a, lib.mmn_chain_softmax,
                       lib.mmn_chain_stage_b):
                fn.restype = ctypes.c_int
            lib.mmn_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mmn_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _check(self, err):
        if err != 0:
            raise RuntimeError("fused_chain kernel launch failed: "
                               + self._lib.mmn_cuda_error_string(err)
                               .decode())
        self.launches += 1

    def launch(self, spec: ChainSpec, layers, data, valid, init_row,
               large_tiles=True):
        """``spec.launches`` launches on PyTorch's current stream, on inputs
        that ``_check_inputs`` accepted; ``layers`` from
        ``spec.layer_params``. Outputs and one workspace (Stage A's partial
        sums, then the packed state-path region) come from ``torch.empty``.
        ``large_tiles=False`` keeps Stage B on its 16-row tiles."""
        lib = self.library()
        B = data[0].shape[0]
        dev = valid.device
        states = torch.empty((len(data) + 1, B, spec.state_size),
                             dtype=torch.float32, device=dev)
        outs = [torch.empty((len(data) + 1, B, p[-1]), dtype=torch.float32,
                            device=dev) for p in spec.dec_plans]
        if B == 0:
            return states, outs
        if dev not in self._n_sm:
            self._n_sm[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        levels, ws_len, outputs, n_tickets = spec.stage_a_plan(
            B, self._n_sm[dev])
        region_off = _round4(ws_len)
        ws = torch.empty(region_off + spec.region_len, dtype=torch.float32,
                         device=dev)
        ws0 = ws.data_ptr()
        region = ws0 + 4 * region_off
        copy_launches = []
        for copies, rows, blocks in spec.copy_groups:
            rows = rows.copy()
            for r, c in enumerate(copies):
                w, b = layers[c.layer]
                rows[r, :3] = (w.data_ptr() + 4 * c.row0 * c.N, b.data_ptr(),
                               region + 4 * c.dst)
            copy_launches.append((rows, blocks))
        proj = [0] * len(data)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            key = (dev, stream)
            if n_tickets and (key not in self._tickets
                              or len(self._tickets[key]) < n_tickets):
                self._tickets[key] = torch.zeros(n_tickets, dtype=torch.int32,
                                                 device=dev)
            tickets = self._tickets.get(key)
            for level, (idx, rows, blocks) in enumerate(levels):
                jobs = rows.copy()
                for r, i in enumerate(idx):
                    j = spec.a_jobs[i]
                    out, ksplit, ticket = outputs[i]
                    w, b = layers[j.layer]
                    jobs[r, 0] = data[j.enc].data_ptr() if j.depth == 0 \
                        else ws0 + 4 * outputs[i - 1][0]
                    jobs[r, 1] = ws0 + 4 * out
                    jobs[r, 2] = w.data_ptr()
                    jobs[r, 3] = 0 if j.proj else b.data_ptr()
                    jobs[r, 4] = 0 if ksplit == 1 else \
                        tickets.data_ptr() + 4 * ticket
                    if j.proj:
                        proj[j.enc] = ws0 + 4 * out
                copies, copy_blocks = copy_launches.pop(0) \
                    if level == 0 and copy_launches else (None, 0)
                self._check(lib.mmn_chain_stage_a(
                    jobs.ctypes.data, len(idx), blocks,
                    None if copies is None else copies.ctypes.data,
                    0 if copies is None else len(copies), copy_blocks, B,
                    stream))
                for i in idx:
                    j = spec.a_jobs[i]
                    if j.act == ACT_CODES["softmax"]:
                        self._check(lib.mmn_chain_softmax(
                            ws0 + 4 * outputs[i][0], B, j.N, stream))
            for copies, copy_blocks in copy_launches:
                self._check(lib.mmn_chain_stage_a(
                    None, 0, 0, copies.ctypes.data, len(copies), copy_blocks,
                    B, stream))
            proj_ptrs = (ctypes.c_void_p * max(len(proj), 1))(*proj)
            out_ptrs = (ctypes.c_void_p * max(len(outs), 1))(
                *[o.data_ptr() for o in outs])
            self._check(lib.mmn_chain_stage_b(
                spec.plan.ctypes.data, len(spec.plan),
                ctypes.cast(proj_ptrs, ctypes.c_void_p), region,
                valid.data_ptr(), init_row.data_ptr(), states.data_ptr(),
                ctypes.cast(out_ptrs, ctypes.c_void_p), B, int(large_tiles),
                stream))
        return states, outs


FUSED_CHAIN = FusedChainKernel()


def _check_inputs(spec: ChainSpec, layers, data, valid, init_row):
    E, S = len(spec.encoders), spec.state_size
    if len(data) != E:
        raise ValueError(f"expected {E} modality arrays, got {len(data)}")
    B = data[0].shape[0]
    expected = [((B, enc.n_features), f"data[{e}]")
                for e, enc in enumerate(spec.encoders)]
    expected += [((B, E), "valid"), ((S,), "init_row")]
    tensors = list(data) + [valid, init_row]
    for l, (w, b) in enumerate(layers):
        expected += [(tuple(w.shape), f"layer {l}'s w"),
                     (tuple(b.shape), f"layer {l}'s b")]
        tensors += [w, b]
    for t, (shape, name) in zip(tensors, expected):
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
            f"state width {S} and layer width {spec.hidden_stride} need "
            f"{spec.shared_bytes} bytes of shared memory per block, more "
            f"than {MAX_SHARED_BYTES}")


def fused_chain_forward(spec: ChainSpec, params: dict, data, valid,
                        init_row):
    """``(states (E+1, B, S), outputs list of (E+1, B, C_d))`` for NaN-zeroed
    ``data`` (E tensors of (B, F_e)), ``valid`` (B, E) and the init-state
    row (S,). On the CPU this is the plain version; on a CUDA device it is
    the kernels."""
    device = valid.device
    if device.type == "cpu":
        return fused_chain_forward_ref(spec, params, data, valid, init_row)
    if device.type != "cuda":
        raise ValueError(f"fused_chain_forward runs on cpu or cuda, not "
                         f"{device}")
    layers = spec.layer_params(params)
    _check_inputs(spec, layers, data, valid, init_row)
    return FUSED_CHAIN.launch(spec, layers, data, valid, init_row)


def _chain_forward(fn, encoders, decoders, state_size: int):
    spec = ChainSpec(encoders, decoders, state_size)

    def forward(params, data, valid, init_row):
        return fn(spec, params, data, valid, init_row)

    return forward


def make_xla_chain_forward(encoders, decoders, state_size: int):
    """``forward(params, data, valid, init_row) -> (states (E+1, B, S),
    outputs list of (E+1, B, C_d))`` in plain PyTorch ops: the JAX module's
    function of this name, the backward of ``make_fused_chain_vjp`` and the
    baseline it is timed against. Takes the kernel's module set."""
    return _chain_forward(fused_chain_forward_ref, encoders, decoders,
                          state_size)


def make_fused_chain_forward(encoders, decoders, state_size: int):
    """The same function through ``fused_chain_forward``: K1's two stages
    on a CUDA device, the plain version on the CPU. The JAX builder's
    ``batch_tile`` and ``interpret`` have no counterpart here: Stage B picks
    its own tile from the batch, and the kernel has no interpret mode."""
    return _chain_forward(fused_chain_forward, encoders, decoders,
                          state_size)


def _chain_inputs(spec: ChainSpec, inputs):
    """``(params, data, valid, init_row)`` from the flat inputs of
    ``_FusedChainVJP``: every dense layer's ``w`` and ``b`` in
    ``ChainSpec.layer_params`` order, the data, ``valid``, ``init_row``."""
    n = 2 * len(spec.layers)
    it = iter(inputs[:n])
    modules = [{"layers": [{"w": next(it), "b": next(it)}
                           for _ in range(p[2])]} for p in spec.enc_plans]
    modules += [{"layers": [{"w": next(it), "b": next(it)}
                            for _ in range(p[3])]} for p in spec.dec_plans]
    E = len(spec.encoders)
    params = {"encoders": modules[:E], "decoders": modules[E:]}
    return params, inputs[n:-2], inputs[-2], inputs[-1]


class _FusedChainVJP(torch.autograd.Function):
    """K1's forward; the backward differentiates the plain chain re-run on
    the saved inputs (JAX: ``jax.vjp`` of ``make_xla_chain_forward``)."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        states, outs = fused_chain_forward(spec, *_chain_inputs(spec, inputs))
        # The residuals are the inputs, as in JAX: no activation is kept.
        ctx.save_for_backward(*inputs)
        ctx.spec = spec
        return (states, *outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in
                      zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
            states, outs = fused_chain_forward_ref(
                ctx.spec, *_chain_inputs(ctx.spec, inputs))
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [states, *outs], wrt, cotangents, allow_unused=True))
        return (None, *[next(grads) if t.requires_grad else None
                        for t in inputs])


def make_fused_chain_vjp(encoders, decoders, state_size: int):
    """Trainable K1 (JAX ``make_fused_chain_vjp``): ``forward(params, data,
    valid, init_row) -> (states, outputs)`` whose forward is
    ``fused_chain_forward`` (K1 on a CUDA device; it raises where K1 would)
    and whose backward re-runs the plain chain on the saved inputs and
    differentiates it. The residuals are the inputs alone: the backward
    redoes the forward's products instead of keeping activations.

    ``params`` holds ``"encoders"`` and ``"decoders"`` (other keys are not
    read); gradients reach every dense layer's ``w`` and ``b``, the data
    and ``init_row``, and none reaches ``valid``. The backward is plain
    PyTorch, as JAX's is plain XLA outside the Pallas kernel. Training
    through ``MultiModN`` differentiates the plain chain, as the JAX
    package's does; this is the kernel's trainable form at the ops level."""
    spec = ChainSpec(encoders, decoders, state_size)

    def forward(params, data, valid, init_row):
        leaves = [t for layer in spec.layer_params(params) for t in layer]
        out = _FusedChainVJP.apply(spec, *leaves, *data, valid, init_row)
        return out[0], list(out[1:])

    return forward
