"""The whole MultiModN forward as CUDA stages (port of the Pallas TPU kernel
``multimodn_tpu/ops/fused_chain.py::make_fused_chain_forward``).

The kernels live in ``csrc/fused_chain.cu``; its source note says what
bounds them on an H100 and how the design answers that. Stage A computes
every product that does not read the state (each concat layer's x-part, and
a last-concat encoder's hidden layers before it) as a batched GEMM spread
over the card; Stage B runs the state chain and every decoder. This module
holds:

- ``ChainSpec``: the static plan of a model, in the tables the kernels read
  from device memory: Stage A's jobs (per batch size, addressing the data,
  the workspace and the layers by offsets and indices) and copies, which
  pack the state-path weights into one float32 region padded to 4 columns
  (its plain version is ``flatten_params``); Stage B's int32 plan
  (per-encoder, per-decoder and per-layer records, offsets into that
  region); and ``stage_b_config``, which picks Stage B's variant for a
  batch on a card;
- ``fused_chain_forward_ref``: the plain PyTorch version, the twin of
  ``make_xla_chain_forward``;
- ``fused_chain_forward``: the wrapper. CPU tensors take the plain version;
  CUDA tensors launch the kernels or raise, with no fallback.
  ``FUSED_CHAIN.launches`` counts the launches (``ChainSpec.launches`` per
  call, whatever the number of encoders);
- the JAX module's three builders, each returning ``forward(params, data,
  valid, init_row) -> (states, outputs)``: ``make_xla_chain_forward`` (the
  plain version), ``make_fused_chain_forward`` (the wrapper) and
  ``make_fused_chain_vjp`` (the wrapper's forward with the plain chain's
  gradient, so that K1 can sit inside a loss that is differentiated).

Supported module set, as in the TPU kernel: MLP-family encoders
(``MLPEncoder`` last-layer concat, ``MIMICMLPEncoder`` first-layer concat,
inference mode) and dense decoders (``ClassDecoder`` / ``LogisticDecoder`` /
``MLPDecoder``), any number of each and any layer width. Data arrives
NaN-zeroed with a (B, E) validity mask, as E tensors or packed into one
(B, ``data_ld``) tensor by ``ChainSpec.pack_data``.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from multimodn_tpu_torch.core.nn import activation_name
from multimodn_tpu_torch.decoders.decoders import ClassDecoder, MLPDecoder
from multimodn_tpu_torch.encoders.mlp import MIMICMLPEncoder, MLPEncoder
from multimodn_tpu_torch.utils.profiling import span

# Must match csrc/fused_chain.cu.
ACT_CODES = {"identity": 0, "none": 0, "relu": 1, "sigmoid": 2, "tanh": 3,
             "gelu": 4, "softmax": 5}
SRC_DATA, SRC_PREV, SRC_STATE = 0, 1, 2
BM, BN, BK = 128, 32, 32           # Stage A block tile
STAGE_B_TILE = 16                  # Stage B's small batch tile
LARGE_TILE = 128                   # Stage B's large batch tile
MAX_SPLIT = 32                     # partial sums per projection
JOB_FIELDS = 17
COPY_FIELDS = 6
INLINE_JOBS = 32       # jobs a Stage A launch carries in its parameters
COPY_SPAN = 4096                   # floats one copy block writes
HEADER, ENC_FIELDS, DEC_FIELDS, LAYER_FIELDS = 10, 6, 4, 7
V_CHUNK = 32          # validity columns a Stage B tile holds at a time
RING_STAGES = (4, 3, 2)            # encoder blocks in flight, best first
MAX_CHUNK = 32        # state slots between decoder passes on the ring
# Stage B's variants (csrc/fused_chain.cu: StageBVariant).
LARGE, BATCHED, INTERLEAVED, INTERLEAVED_L2, RING, LAYERED = range(6)
VARIANTS = ("large", "batched", "interleaved", "interleaved_l2", "ring",
            "layered")


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _row_stride(width: int) -> int:
    """Row stride of a Stage B tile: a multiple of 4 floats (16-byte rows)
    and an odd number of 16-byte groups, so rows fall on distinct banks."""
    ld = _round4(width)
    return ld + 4 if (ld // 4) % 2 == 0 else ld


def _upload(array: np.ndarray, device) -> torch.Tensor:
    """A host table on the card: copied from pinned memory, so the host
    does not wait for the stream (PyTorch keeps the pinned block until the
    copy is done)."""
    return torch.from_numpy(np.array(array, order="C")).pin_memory().to(
        device, non_blocking=True)


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

    Layouts, all static: the data packed as (B, ``data_ld``) with modality
    e at column ``data_cols[e]`` (a block of a width that is a multiple of
    4 starts on a multiple of 4); Stage A's projections as (B,
    ``proj_width``) floats at the workspace's start, encoder e's (B, N) at
    ``B * proj_cols[e]``; the decoder outputs as one buffer, decoder d's
    (E+1, B, C_d) at ``(E+1) * B * dec_cols[d]``.

    Stage A: ``a_jobs``, every encoder's data-only layers and the x-part of
    its concat layer, in ``a_depth`` dependent launches (plus one row pass
    per depth that holds a softmax hidden layer); ``copies``, the
    state-path layers, packed by the first launch's copy blocks. Stage B:
    ``plan``, the state chain, reading the packed region (``region_len``
    floats: (round4(K), round4(N)) matrices and round4(N) biases with zero
    pads; each encoder's layers one contiguous block). ``launches`` counts
    the launches per call; it does not depend on the number of encoders.
    ``n_proj_weights`` and ``n_state_weights`` count the parameters of each
    part."""

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
        """Stage A's jobs and copies, Stage B's plan and the layouts, in one
        pass over the layers."""
        S = self.state_size
        self.a_jobs: List[StageAJob] = []
        self.levels: List[List[int]] = []      # job indices per depth
        in_a = set()
        n_proj = 0
        for e, lays in enumerate(enc_layers):
            for depth, l in enumerate(lays):
                _src, k, n, act, has_state = self.layers[l]
                if depth == len(self.levels):
                    self.levels.append([])
                self.levels[depth].append(len(self.a_jobs))
                self.a_jobs.append(StageAJob(e, depth, k, n, act, l,
                                             has_state))
                in_a.add(l)
                if has_state:          # the concat layer's x-part
                    n_proj += k * n
                    break
                n_proj += k * n + n
        self.n_proj_weights = n_proj
        self.a_depth = len(self.levels)

        # Stage B: per encoder its concat layer (state part plus Stage A's
        # projection) and the layers after it, one contiguous block of the
        # region; every decoder layer after them.
        b_off, n_state = 0, 0
        b_records, copies = [], []

        def add_b(l, src, K, N, act, add_proj, row0=0):
            nonlocal b_off, n_state
            w_off, bias_off = b_off, b_off + _round4(K) * _round4(N)
            b_off = bias_off + _round4(N)
            n_state += K * N + N
            b_records.append((src, K, N, act, w_off, bias_off, add_proj))
            copies.append(StateCopy(l, row0, K, N, w_off))

        enc_records, proj_col, data_col, proj_max = [], 0, 0, 0
        self.data_cols, self.proj_cols = [], []
        for e, lays in enumerate(enc_layers):
            first, block = len(b_records), b_off
            F = self.encoders[e].n_features
            data_col = _round4(data_col) if F % 4 == 0 else data_col
            self.data_cols.append(data_col)
            data_col += F
            proj_n = 0
            for l in lays:
                src, k, n, act, has_state = self.layers[l]
                if has_state:
                    add_b(l, SRC_STATE, S, n, act, 1, row0=k)
                    proj_n = n
                elif l not in in_a:
                    add_b(l, SRC_PREV, k, n, act, 0)   # after the concat
            self.proj_cols.append(proj_col)
            enc_records.append((first, len(b_records) - first, proj_col,
                                block, b_off - block, proj_n))
            proj_col += _round4(proj_n)
            proj_max = max(proj_max, _round4(proj_n))
        self.data_ld = _round4(data_col)
        self.proj_width = proj_col
        dec_records, class_col = [], 0
        self.dec_cols = []
        for d, lays in enumerate(dec_layers):
            first = len(b_records)
            for l in lays:
                src, k, n, act, _h = self.layers[l]
                add_b(l, src, k, n, act, 0)
            C = self.decoders[d].n_classes
            self.dec_cols.append(class_col)
            dec_records.append((first, len(b_records) - first, C, class_col))
            class_col += C
        self.n_classes_total = class_col
        self.n_state_weights = n_state
        self.n_weights = self.n_proj_weights + self.n_state_weights
        self.region_len = b_off
        self.copies = copies
        self.state_stride = _row_stride(S)
        self.hidden_stride = _row_stride(max(r[2] for r in b_records))
        self.enc_block_max = max((r[4] for r in enc_records), default=0)
        self.proj_max = proj_max
        # A ring stage's copy of an encoder's records (ints).
        self.enc_records_max = _round4(ENC_FIELDS + LAYER_FIELDS * max(
            (r[1] for r in enc_records), default=0))
        header = (len(self.encoders), len(self.decoders), S, len(b_records),
                  self.state_stride, self.hidden_stride, b_off,
                  self.enc_block_max, proj_max, self.enc_records_max)
        self.plan = np.asarray(
            header + sum(enc_records + dec_records + b_records, ()),
            dtype=np.int32)
        # The ring's copy of each encoder's records: its own, then its
        # layers', padded to enc_records_max ints (16-byte rows).
        self.ring_records = np.zeros((len(enc_records),
                                      self.enc_records_max), np.int32)
        for e, rec in enumerate(enc_records):
            flat = rec + sum(b_records[rec[0]:rec[0] + rec[1]], ())
            self.ring_records[e, :len(flat)] = flat
        self.b_layers = b_records
        self.enc_records = enc_records
        # Copy rows: layer, row0, K, N, region offset, first copy block.
        rows, blocks = [], 0
        for c in copies:
            rows.append((c.layer, c.row0, c.K, c.N, c.dst, blocks))
            blocks += -(-(_round4(c.K) * _round4(c.N) + _round4(c.N))
                        // COPY_SPAN)
        self.copy_rows = np.asarray(rows, dtype=np.int64).reshape(
            -1, COPY_FIELDS)
        self.copy_blocks = blocks
        self.softmax_levels = sum(
            any(self._softmax_job(self.a_jobs[i]) for i in idx)
            for idx in self.levels)
        self.launches = (max(self.a_depth, 1 if copies else 0)
                         + self.softmax_levels + 1)
        self._a_plans, self._device, self._pointers = {}, {}, {}
        self._segments = {}

    # -- the data's layout ------------------------------------------------
    def data_columns(self, e: int) -> slice:
        return slice(self.data_cols[e],
                     self.data_cols[e] + self.encoders[e].n_features)

    def pack_data(self, data):
        """The modalities (E arrays or tensors of (B, F_e)) as one (B,
        ``data_ld``) array or tensor of the same kind, zeros in the pads."""
        if len(data) != len(self.encoders):
            raise ValueError(f"expected {len(self.encoders)} modality "
                             f"arrays, got {len(data)}")
        tensor = torch.is_tensor(data[0])
        B = data[0].shape[0]

        def zeros(n):
            if tensor:
                return torch.zeros((B, n), dtype=data[0].dtype,
                                   device=data[0].device)
            return np.zeros((B, n), dtype=np.float32)

        pieces, col = [], 0
        for e, d in enumerate(data):
            if self.data_cols[e] > col:
                pieces.append(zeros(self.data_cols[e] - col))
            pieces.append(d.reshape(B, self.encoders[e].n_features))
            col = self.data_cols[e] + self.encoders[e].n_features
        if self.data_ld > col:
            pieces.append(zeros(self.data_ld - col))
        if tensor:
            return torch.cat(pieces, dim=1) if len(pieces) > 1 else \
                pieces[0].contiguous()
        return np.concatenate(pieces, axis=1) if len(pieces) > 1 else \
            np.ascontiguousarray(pieces[0])

    def unpack_data(self, packed: torch.Tensor) -> list:
        """The E modality views of a packed (B, ``data_ld``) tensor."""
        return [packed[:, self.data_columns(e)]
                for e in range(len(self.encoders))]

    def segment_ids(self, device) -> torch.Tensor:
        """Each packed column's modality (E for a pad column), on
        ``device``; built once per device."""
        if device not in self._segments:
            seg = np.full(self.data_ld, len(self.encoders), dtype=np.int64)
            for e in range(len(self.encoders)):
                seg[self.data_columns(e)] = e
            self._segments[device] = torch.as_tensor(seg, device=device)
        return self._segments[device]

    # -- parameters -------------------------------------------------------
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
            if w.shape != (rows, n) or b.shape != (n,):
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

    # -- Stage A ----------------------------------------------------------
    def stage_a_plan(self, B: int, n_sm: int):
        """Stage A's launches at batch ``B`` on a card of ``n_sm`` SMs:
        ``(levels, workspace floats, job outputs, tickets)``. A level is
        ``(jobs, int64 rows, blocks, softmax segments)`` with one row of
        ``JOB_FIELDS`` per job: input source (0 the packed data, 1 the
        workspace) and offset (a data column or a workspace float), output
        offset, first partial's offset, layer, ticket (-1: none), input
        row stride, K, N, activation, bias (0 for a projection), ksplit,
        chunks per split, m tiles, n tiles, first block, split stride. A
        job that splits K writes its first partial at the output and the
        others from the partial offset on, and the last block of each
        output tile to take its ticket (an int32 counter that starts at 0,
        and that this block sets back to 0) sums them into the output. At
        small B a projection's K chunks are split (into at most
        ``MAX_SPLIT`` partials) so the level has up to ~2 blocks per SM.
        A softmax segment ``(offset, N)`` is a job's (B, N) logits, which
        a row pass turns into probabilities before the next level."""
        key = (B, n_sm)
        if key not in self._a_plans:
            if len(self._a_plans) > 64:
                self._a_plans.clear()
                self._device = {k: v for k, v in self._device.items()
                                if len(k) == 1}
            self._a_plans[key] = self._make_a_plan(B, n_sm)
        return self._a_plans[key]

    @staticmethod
    def _softmax_job(job: StageAJob) -> bool:
        """A data-only softmax layer, whose logits a row pass turns into
        probabilities. A projection is never one: its layer's softmax
        (a first-concat encoder's) follows the state part in Stage B."""
        return job.act == ACT_CODES["softmax"] and not job.proj

    def _make_a_plan(self, B, n_sm):
        m_tiles = -(-B // BM)
        outputs = [None] * len(self.a_jobs)
        ws, tickets = B * self.proj_width, 0
        levels = []
        for depth, idx in enumerate(self.levels):
            work = sum(m_tiles * -(-self.a_jobs[i].N // BN)
                       * -(-self.a_jobs[i].K // BK) for i in idx)
            per_block = max(1, -(-work // (2 * n_sm)))
            rows, blocks, segments = [], 0, []
            for i in idx:
                j = self.a_jobs[i]
                n_tiles, chunks = -(-j.N // BN), -(-j.K // BK)
                cps = min(max(per_block, -(-chunks // MAX_SPLIT)), chunks) \
                    if j.proj else chunks
                ksplit = -(-chunks // cps)
                stride = B * j.N
                if j.proj:
                    out = B * self.proj_cols[j.enc]
                else:
                    out, ws = ws, ws + stride
                part, ws = ws, ws + (ksplit - 1) * stride
                src, off, ld = (0, self.data_cols[j.enc], self.data_ld) \
                    if depth == 0 else (1, outputs[i - 1][0], j.K)
                ticket = tickets if ksplit > 1 else -1
                # A softmax layer's GEMM writes logits; a row pass follows.
                softmax = self._softmax_job(j)
                if softmax:
                    segments.append((out, j.N))
                rows.append([src, off, out, part, j.layer, ticket, ld, j.K,
                             j.N, 0 if softmax else j.act, int(not j.proj),
                             ksplit, cps, m_tiles, n_tiles, blocks, stride])
                outputs[i] = (out, ksplit, ticket)
                blocks += m_tiles * n_tiles * ksplit
                if ksplit > 1:
                    tickets += m_tiles * n_tiles
            rows = np.asarray(rows, dtype=np.int64).reshape(-1, JOB_FIELDS)
            rows.setflags(write=False)
            levels.append((idx, rows, blocks, segments))
        return levels, ws, outputs, tickets

    # -- Stage B ----------------------------------------------------------
    def _tile_bytes(self, T: int, slots: int) -> int:
        """Stage B's shared memory besides the weights: ``slots`` state
        tiles of T rows, two hidden buffers of as many rows and T x
        min(E, V_CHUNK) validity cells."""
        vc = min(len(self.encoders), V_CHUNK)
        return 4 * (T * slots * (self.state_stride + 2 * self.hidden_stride)
                    + _round4(T * vc))

    def ring_stage_floats(self) -> int:
        """One ring stage: an encoder's block of the region, its
        projection's 16-row tile and its plan records."""
        return self.enc_block_max + STAGE_B_TILE * self.proj_max \
            + self.enc_records_max

    def stage_b_config(self, B: int, n_sm: int, max_smem: int,
                       large_tiles: bool = True):
        """Stage B's launch at batch ``B`` on a card of ``n_sm`` SMs and
        ``max_smem`` bytes of shared memory per block: ``(variant, shared
        bytes, chunk, ring stages)``. In order of preference: 128-row tiles
        when they alone fill the card (``large_tiles``), 16-row tiles with
        every state tile and the region in shared memory (decoders once per
        tile, ``chunk`` = E), with one state tile (decoders after every
        encoder), the region streamed one encoder block at a time through a
        ring of ``ring stages`` (decoders every ``chunk`` encoders), the
        region read through L2, and the layered form (every layer one
        product over the whole batch, the card in step)."""
        E, w = len(self.encoders), 4 * self.region_len
        T = STAGE_B_TILE
        if large_tiles and -(-B // LARGE_TILE) >= n_sm and \
                self._tile_bytes(LARGE_TILE, 1) + w <= max_smem:
            return LARGE, self._tile_bytes(LARGE_TILE, 1) + w, 1, 0
        if self._tile_bytes(T, E + 1) + w <= max_smem:
            return BATCHED, self._tile_bytes(T, E + 1) + w, max(E, 1), 0
        if self._tile_bytes(T, 1) + w <= max_smem:
            return INTERLEAVED, self._tile_bytes(T, 1) + w, 1, 0
        if E > 0:
            stage = 4 * self.ring_stage_floats()
            for stages in RING_STAGES:
                chunk = min(E, MAX_CHUNK)
                while chunk >= 1 and \
                        self._tile_bytes(T, chunk + 1) + stages * stage \
                        > max_smem:
                    chunk //= 2
                if chunk >= 1:
                    return (RING, self._tile_bytes(T, chunk + 1)
                            + stages * stage, chunk, stages)
        if self._tile_bytes(T, 1) <= max_smem:
            return INTERLEAVED_L2, self._tile_bytes(T, 1), 1, 0
        return LAYERED, 0, 1, 0

    def layered_scratch(self, B: int) -> int:
        """Floats of one of the layered form's two activation buffers: the
        widest layer's output over its rows (B for an encoder layer, (E+1)
        B for a decoder layer)."""
        E = len(self.encoders)
        n_enc = sum(r[1] for r in self.enc_records)
        return max([B * _round4(r[2]) for r in self.b_layers[:n_enc]]
                   + [(E + 1) * B * _round4(r[2])
                      for r in self.b_layers[n_enc:]] + [4])

    # -- device tables ----------------------------------------------------
    def device_tables(self, device, B: int = None, n_sm: int = None):
        """The tables the kernels read, uploaded once per device (and per
        batch size for Stage A's jobs) and kept: ``{"plan", "copies",
        "copy_map"}``, or per (B, n_sm) ``{"jobs", "maps", "softmax"}``,
        one entry per level."""
        key = (device,) if B is None else (device, B, n_sm)
        if key not in self._device:
            if B is None:
                self._device[key] = {
                    "plan": _upload(self.plan, device),
                    "ring": _upload(self.ring_records, device),
                    "copies": _upload(self.copy_rows, device),
                    "copy_map": _upload(self._copy_map(), device)}
            else:
                levels = self.stage_a_plan(B, n_sm)[0]
                self._device[key] = {
                    "jobs": [_upload(rows, device) for _i, rows, _b, _s
                             in levels],
                    "maps": [_upload(np.repeat(
                        np.arange(len(rows), dtype=np.int32),
                        rows[:, 11] * rows[:, 13] * rows[:, 14]), device)
                        for _i, rows, _b, _s in levels],
                    "softmax": [_upload(np.asarray(s, np.int64).reshape(
                        -1, 2), device) if s else None
                        for _i, _r, _b, s in levels]}
        return self._device[key]

    def _copy_map(self) -> np.ndarray:
        """Each copy block's copy row."""
        sizes = np.diff(np.append(self.copy_rows[:, 5], self.copy_blocks))
        return np.repeat(np.arange(len(self.copy_rows), dtype=np.int32),
                         sizes).astype(np.int32)

    def layer_pointers(self, layers, device):
        """Every dense layer's ``w`` and ``b`` device pointers as int64
        tables ``(host, device)``, the device one uploaded again only when
        a pointer moved (then the layers are checked first)."""
        ptrs = np.fromiter((t.data_ptr() for pair in layers for t in pair),
                           dtype=np.int64, count=2 * len(layers))
        cached = self._pointers.get(device)
        if cached is None or not np.array_equal(cached[0], ptrs):
            _check_layers(layers, device)
            cached = (ptrs, _upload(ptrs, device))
            self._pointers[device] = cached
        return cached

    def inline_levels(self, B: int, n_sm: int) -> bool:
        """Whether every Stage A launch at batch ``B`` carries its jobs in
        its parameters (at most ``INLINE_JOBS`` each); then unpacked
        modalities are read where they lie."""
        return all(len(rows) <= INLINE_JOBS
                   for _i, rows, _b, _s in self.stage_a_plan(B, n_sm)[0])


def fused_chain_forward_ref(spec: ChainSpec, params: dict, data, valid,
                            init_row):
    """Plain PyTorch version of the kernel (twin of the JAX package's
    ``make_xla_chain_forward``): returns ``(states (E+1, B, S), outputs list
    of (E+1, B, C_d))``. ``data`` is E tensors or the packed tensor."""
    if torch.is_tensor(data):
        data = spec.unpack_data(data)
    B = valid.shape[0]
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
        self._card = {}
        # Stage A's tickets and the layered form's barrier words per
        # (device, stream): zeroed once; every launch leaves the tickets at
        # 0 and the barrier's arrival count at 0.
        self._tickets = {}
        self._barriers = {}

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            from multimodn_tpu_torch.ops.build import build_library
            lib = build_library("fused_chain.cu")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.mmn_chain_stage_a.argtypes = [p, p, i, p, p, i, p, p, p, p,
                                              p, i, p, p, i, p, p]
            lib.mmn_chain_softmax.argtypes = [p, p, i, i, p]
            lib.mmn_chain_stage_b.argtypes = [
                p, p, p, p, p, p, p, p, p, p, ctypes.c_longlong, p, i, i, i,
                i, i, p]
            for fn in (lib.mmn_chain_stage_a, lib.mmn_chain_softmax,
                       lib.mmn_chain_stage_b):
                fn.restype = ctypes.c_int
            lib.mmn_chain_max_smem.argtypes = []
            lib.mmn_chain_max_smem.restype = ctypes.c_int
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

    def card(self, device):
        """``(SMs, shared bytes a block may opt in to)`` of ``device``."""
        if device not in self._card:
            lib = self.library()
            with torch.cuda.device(device):
                max_smem = lib.mmn_chain_max_smem()
            if max_smem <= 0:
                raise RuntimeError("cannot read the card's shared memory")
            self._card[device] = (torch.cuda.get_device_properties(
                device).multi_processor_count, max_smem)
        return self._card[device]

    def stage_b_config(self, spec: ChainSpec, B: int, device,
                       large_tiles=True):
        """Stage B's launch for ``spec`` at batch ``B`` on ``device``."""
        n_sm, max_smem = self.card(device)
        return spec.stage_b_config(B, n_sm, max_smem, large_tiles)

    def _zeroed(self, cache, key, n, device):
        if key not in cache or len(cache[key]) < n:
            cache[key] = torch.zeros(n, dtype=torch.int32, device=device)
        return cache[key]

    def launch(self, spec: ChainSpec, layers, data, valid, init_row,
               large_tiles=True):
        """``spec.launches`` launches on PyTorch's current stream, on inputs
        that ``_check_inputs`` accepted; ``layers`` from
        ``spec.layer_params``, ``data`` packed (``ChainSpec.pack_data``).
        ``data`` may also be the E modality tensors where
        ``spec.inline_levels`` holds: each level's jobs then ride in the
        launch's parameters and read the modalities where they lie.
        Outputs, one workspace (Stage A's projections and partial sums, the
        packed state-path region) and the layered form's activations come
        from ``torch.empty``. ``large_tiles=False`` keeps Stage B off its
        128-row tiles."""
        lib = self.library()
        B, E = valid.shape
        dev = valid.device
        states = torch.empty((E + 1, B, spec.state_size),
                             dtype=torch.float32, device=dev)
        dec_buf = torch.empty((E + 1) * B * spec.n_classes_total,
                              dtype=torch.float32, device=dev)
        outs = [dec_buf[(E + 1) * B * c:(E + 1) * B * (c + p[-1])]
                .view(E + 1, B, p[-1])
                for c, p in zip(spec.dec_cols, spec.dec_plans)]
        if B == 0:
            return states, outs
        n_sm, _max_smem = self.card(dev)
        levels, ws_len, _outputs, n_tickets = spec.stage_a_plan(B, n_sm)
        variant, smem, chunk, stages = self.stage_b_config(
            spec, B, dev, large_tiles)
        scratch_half = spec.layered_scratch(B) if variant == LAYERED else 0
        region_off = _round4(ws_len + 4)   # 4 floats a ring copy may read
        ws = torch.empty(region_off + spec.region_len + 2 * scratch_half,
                         dtype=torch.float32, device=dev)
        ws0 = ws.data_ptr()
        region = ws0 + 4 * region_off
        scratch = region + 4 * spec.region_len
        static = spec.device_tables(dev)
        tables = spec.device_tables(dev, B, n_sm)
        host_ptrs, ptrs = spec.layer_pointers(layers, dev)
        inline = spec.inline_levels(B, n_sm)
        if torch.is_tensor(data):
            data_ptr, job_in = data.data_ptr(), None
        else:
            if not inline:
                raise ValueError("unpacked modalities need every Stage A "
                                 "level within INLINE_JOBS jobs; pack them "
                                 "with ChainSpec.pack_data")
            mods = [d.data_ptr() for d in data]
            data_ptr = None
            job_in = [np.array([mods[spec.a_jobs[j].enc] if rows[r, 0] == 0
                                else 0 for r, j in enumerate(idx)],
                               dtype=np.int64)
                      for idx, rows, _b, _s in levels]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            key = (dev, stream)
            tickets = self._zeroed(self._tickets, key, max(n_tickets, 1),
                                   dev)
            for level in range(max(len(levels), 1)):
                if level < len(levels):
                    _idx, rows, blocks, segments = levels[level]
                    jobs, block_map = tables["jobs"][level], \
                        tables["maps"][level]
                else:                 # copies alone (a model with no jobs)
                    rows, blocks, segments = (), 0, ()
                    jobs = block_map = None
                first = level == 0 and spec.copy_blocks > 0
                self._check(lib.mmn_chain_stage_a(
                    None if jobs is None else jobs.data_ptr(),
                    None if block_map is None else block_map.data_ptr(),
                    blocks,
                    static["copies"].data_ptr() if first else None,
                    static["copy_map"].data_ptr() if first else None,
                    spec.copy_blocks if first else 0,
                    ptrs.data_ptr(), data_ptr, ws0,
                    tickets.data_ptr(), region, B, stream,
                    rows.ctypes.data if inline and blocks else None,
                    len(rows), host_ptrs.ctypes.data,
                    job_in[level].ctypes.data
                    if job_in is not None and blocks else None))
                if segments:
                    self._check(lib.mmn_chain_softmax(
                        tables["softmax"][level].data_ptr(), ws0,
                        len(segments), B, stream))
            barrier = self._zeroed(self._barriers, key, 2, dev) \
                if variant == LAYERED else None
            self._check(lib.mmn_chain_stage_b(
                spec.plan.ctypes.data, static["plan"].data_ptr(),
                static["ring"].data_ptr(), ws0,
                region, valid.data_ptr(), init_row.data_ptr(),
                states.data_ptr(), dec_buf.data_ptr(),
                scratch if variant == LAYERED else None, scratch_half,
                None if barrier is None else barrier.data_ptr(), B,
                variant, smem, chunk, stages, stream))
        return states, outs


FUSED_CHAIN = FusedChainKernel()


def _check_tensor(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, valid on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layers(layers, device):
    for l, (w, b) in enumerate(layers):
        _check_tensor(w, f"layer {l}'s w", tuple(w.shape), device)
        _check_tensor(b, f"layer {l}'s b", tuple(b.shape), device)


def _check_inputs(spec: ChainSpec, layers, data, valid, init_row):
    """The inputs' devices, dtypes, shapes and contiguity: ``data`` as E
    modality tensors or packed; ``valid`` (B, E); ``init_row`` (S,). The
    layers are checked where their pointers are uploaded."""
    E, S = len(spec.encoders), spec.state_size
    device = valid.device
    if torch.is_tensor(data):
        B = data.shape[0]
        _check_tensor(data, "packed data", (B, spec.data_ld), device)
    else:
        if len(data) != E:
            raise ValueError(f"expected {E} modality arrays, got "
                             f"{len(data)}")
        B = data[0].shape[0]
        for e, (t, enc) in enumerate(zip(data, spec.encoders)):
            _check_tensor(t, f"data[{e}]", (B, enc.n_features), device)
    _check_tensor(valid, "valid", (B, E), device)
    _check_tensor(init_row, "init_row", (S,), device)


def fused_chain_forward(spec: ChainSpec, params: dict, data, valid,
                        init_row):
    """``(states (E+1, B, S), outputs list of (E+1, B, C_d))`` for NaN-zeroed
    ``data`` (E tensors of (B, F_e), or one tensor packed by
    ``ChainSpec.pack_data``), ``valid`` (B, E) and the init-state row (S,).
    On the CPU this is the plain version; on a CUDA device it is the
    kernels."""
    device = valid.device
    if device.type == "cpu":
        return fused_chain_forward_ref(spec, params, data, valid, init_row)
    if device.type != "cuda":
        raise ValueError(f"fused_chain_forward runs on cpu or cuda, not "
                         f"{device}")
    with span("k1.enqueue") as s:
        launches = FUSED_CHAIN.launches
        layers = spec.layer_params(params)
        _check_inputs(spec, layers, data, valid, init_row)
        if not torch.is_tensor(data):
            data = list(data)
            n_sm, _max_smem = FUSED_CHAIN.card(device)
            if not spec.inline_levels(valid.shape[0], n_sm):
                data = spec.pack_data(data)
        out = FUSED_CHAIN.launch(spec, layers, data, valid, init_row)
        s.set(launches=FUSED_CHAIN.launches - launches)
    return out


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
    """The same function through ``fused_chain_forward``: K1's stages on a
    CUDA device, the plain version on the CPU. The JAX builder's
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
