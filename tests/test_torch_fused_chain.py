"""The fused-chain kernel's plain PyTorch version and plan against the JAX
package's Pallas kernel (interpret mode) and its XLA twin, on the CPU.

The CUDA kernel itself cannot run here; its arithmetic is held on the CPU
three ways: the plain version against the Pallas kernel and the XLA twin,
and a numpy interpreter of what the kernels read (Stage A's jobs and
copies, Stage B's int32 plan and packed weights), against the plain
version. ``test_torch_cuda.py`` holds the kernel against the plain version
on a GPU.

Tolerance: XLA's and PyTorch's CPU matrix products sum in different orders
(fp32, K <= 1074 at MIMIC width), which moves results by ~1e-7 relative;
atol 1e-5 leaves headroom through 4 chained encoders and 3 decoder layers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodn_tpu import MultiModN as JMultiModN
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.ops.fused_chain import (
    make_fused_chain_forward,
    make_xla_chain_forward,
)
from multimodn_tpu_torch import MultiModN
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.encoders.base import MultiModEncoder
from multimodn_tpu_torch.ops import fused_chain as fc

ATOL = 1e-5

SMALL_CASES = {
    # The Pallas test's sizes (tests/test_pallas.py): S=8, widths 12 and 20.
    "mimic_first_concat": (
        8, lambda m: [m.MIMICMLPEncoder(8, w, (16, 16), dropout=0.0)
                      for w in (12, 20)],
        lambda m: [m.MLPDecoder(8, (16,), 2), m.LogisticDecoder(8)]),
    "mlp_last_concat": (
        8, lambda m: [m.MLPEncoder(8, w, (16,)) for w in (12, 20)],
        lambda m: [m.MLPDecoder(8, (16,), 2), m.LogisticDecoder(8)]),
    "mixed_gelu_tanh_softmax": (
        8, lambda m: [m.MLPEncoder(8, 12, (16,), "gelu"),
                      m.MIMICMLPEncoder(8, 20, (16,), 0.0, "tanh"),
                      m.MLPEncoder(8, 5, ())],
        lambda m: [m.ClassDecoder(8, 3, "softmax"),
                   m.MLPDecoder(8, (16,), 4, "softmax", "gelu")]),
}
# The MIMIC multi-task model at pipelines/mimic/common.py's defaults.
MIMIC_CASE = (
    50, lambda m: [m.MIMICMLPEncoder(50, w, (32, 32), dropout=0.2)
                   for w in (10, 1024, 768, 99)],
    lambda m: [m.MLPDecoder(50, (32, 32), 2) for _ in range(2)])
ALL_CASES = dict(SMALL_CASES, mimic=MIMIC_CASE)
# A last-concat encoder whose hidden layers are softmax (Stage A's row pass)
# beside one with two hidden layers (two dependent Stage A launches).
# Another has 27 state-path layers, all packed by the first Stage A launch.
# First-concat softmax encoders: the concat layer's softmax follows the
# state part in Stage B, so its Stage A projection takes no row pass.
# Then the domain past the old caps: 33 and 65 encoders, 33 decoders.
PLAN_CASES = dict(ALL_CASES, softmax_hidden=(
    8, lambda m: [m.MLPEncoder(8, 6, (12, 10), "softmax"),
                  m.MLPEncoder(8, 9, (5,), "sigmoid")],
    lambda m: [m.LogisticDecoder(8)]), softmax_first_concat=(
    8, lambda m: [m.MIMICMLPEncoder(8, 12, (10,), 0.0, "softmax"),
                  m.MLPEncoder(8, 5, (6,), "softmax"),
                  m.MIMICMLPEncoder(8, 3, (), 0.0, "softmax")],
    lambda m: [m.ClassDecoder(8, 3, "softmax")]), many_layers=(
    8, lambda m: [m.MIMICMLPEncoder(8, 3 + w, (8, 8, 8), dropout=0.0)
                  for w in range(6)],
    lambda m: [m.MLPDecoder(8, (8, 8), 2)]), encoders_33=(
    8, lambda m: [m.MLPFeatureEncoder(8, 4) if e % 2 else
                  m.MIMICMLPEncoder(8, 1 + e % 5, (6,), dropout=0.0)
                  for e in range(33)],
    lambda m: [m.MLPDecoder(8, (4,), 2)]), encoders_65=(
    8, lambda m: [m.MLPEncoder(8, 1 + e % 3, (5,), "tanh")
                  for e in range(65)],
    lambda m: [m.LogisticDecoder(8), m.ClassDecoder(8, 3, "softmax")]),
    decoders_33=(
    8, lambda m: [m.MIMICMLPEncoder(8, w, (6,), dropout=0.0)
                  for w in (3, 4)],
    lambda m: [m.MLPDecoder(8, (4,), 2) if d % 3 else
               m.ClassDecoder(8, 1 + d % 4, "softmax") for d in range(33)]))
# The H100's shared memory per block (opt-in), for Stage B's choice.
H100_SMEM, H100_SMS = 232448, 132


def _pair(S, make_enc, make_dec, seed=0):
    """A JAX model and the port's twin holding the same weights."""
    jm = JMultiModN(S, make_enc(jenc), make_dec(jdec), 1.0, 0.0, seed=seed)
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0,
                   device="cpu")
    tm.load_state_dict(jm.state_dict())
    return jm, tm


def _inputs(encoders, B, seed=0):
    rng = np.random.default_rng(seed)
    data = [rng.normal(size=(B, e.n_features)).astype(np.float32)
            for e in encoders]
    valid = (rng.random((B, len(encoders))) > 0.3).astype(np.float32)
    return data, valid


def _port_forward(tm, data, valid, fn=fc.fused_chain_forward_ref):
    spec = fc.ChainSpec(tm.encoders, tm.decoders, tm.state_size)
    return fn(spec, tm.params, [torch.as_tensor(d) for d in data],
              torch.as_tensor(valid), tm.params["init_state"]["value"][0])


def _assert_close(got, want, atol):
    states, outs = got
    np.testing.assert_allclose(np.asarray(states), np.asarray(want[0]),
                               rtol=0, atol=atol)
    assert len(outs) == len(want[1])
    for o, w in zip(outs, want[1]):
        np.testing.assert_allclose(np.asarray(o), np.asarray(w), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("case", sorted(SMALL_CASES))
def test_plain_version_matches_pallas_interpret(case):
    S, make_enc, make_dec = SMALL_CASES[case]
    jm, tm = _pair(S, make_enc, make_dec)
    data, valid = _inputs(jm.encoders, 16)
    fwd = make_fused_chain_forward(jm.encoders, jm.decoders, S,
                                   interpret=True)
    want = fwd(jm.params, tuple(jnp.asarray(d) for d in data),
               jnp.asarray(valid), jm.params["init_state"]["value"][0])
    _assert_close(_port_forward(tm, data, valid), want, ATOL)
    # On CPU tensors the wrapper is the plain version.
    _assert_close(_port_forward(tm, data, valid, fc.fused_chain_forward),
                  want, ATOL)


def test_plain_version_matches_xla_twin_at_mimic_width():
    jm, tm = _pair(*MIMIC_CASE)
    data, valid = _inputs(jm.encoders, 16, seed=1)
    fwd = make_xla_chain_forward(jm.encoders, jm.decoders, 50)
    want = fwd(jm.params, tuple(jnp.asarray(d) for d in data),
               jnp.asarray(valid), jm.params["init_state"]["value"][0])
    _assert_close(_port_forward(tm, data, valid), want, ATOL)


# ---------------------------------------------------------------------------
# The plan the kernel reads
# ---------------------------------------------------------------------------

def _act(code, v):
    if code == fc.ACT_CODES["relu"]:
        return np.maximum(v, 0.0)
    if code == fc.ACT_CODES["sigmoid"]:
        return 1.0 / (1.0 + np.exp(-v))
    if code == fc.ACT_CODES["tanh"]:
        return np.tanh(v)
    if code == fc.ACT_CODES["gelu"]:
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (v + 0.044715 * v ** 3)))
    if code == fc.ACT_CODES["softmax"]:
        e = np.exp(v - v.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    assert code == fc.ACT_CODES["identity"]
    return v


def _stage_a(spec, layers, packed, B, n_sm):
    """Stage A's jobs as the kernels run them, on a float64 workspace that
    starts as NaN: per level, each job reads the packed data or the
    workspace at its offsets, splits its K chunks as ``stage_a_plan`` says
    (the first partial at its output, the others from its partial offset),
    and the partials are summed in split order into the output; a level's
    softmax segments then become probabilities. Returns the workspace."""
    levels, ws_len, outputs, tickets = spec.stage_a_plan(B, n_sm)
    assert tickets == sum(r[13] * r[14] for _i, rows, _b, _s in levels
                          for r in rows if r[11] > 1)
    ws = np.full(ws_len + 4, np.nan)
    for idx, rows, blocks, segments in levels:
        assert blocks == sum(r[11] * r[13] * r[14] for r in rows)
        assert [int(r[15]) for r in rows] == list(np.cumsum(
            [0] + [r[11] * r[13] * r[14] for r in rows[:-1]]))
        for i, row in zip(idx, rows):
            (src, off, out, part, layer, ticket, ld, K, N, act, bias, ksplit,
             cps, _mt, _nt, _first, stride) = (int(v) for v in row)
            j = spec.a_jobs[i]
            assert (layer, K, N, bool(bias)) == (j.layer, j.K, j.N,
                                                 not j.proj)
            assert outputs[i] == (out, ksplit, ticket)
            if src == 0:
                assert ld == spec.data_ld and j.depth == 0
                x = packed[:, off:off + K]
            else:
                assert ld == K and j.depth > 0
                x = ws[off:off + B * K].reshape(B, K)
            assert not np.isnan(x).any()
            w, b = layers[layer]
            w = w[:K]
            parts = [x[:, k0:k0 + cps * fc.BK] @ w[k0:k0 + cps * fc.BK]
                     for k0 in range(0, ksplit * cps * fc.BK, cps * fc.BK)]
            covered = sum(min(cps * fc.BK, max(K - k0, 0))
                          for k0 in range(0, ksplit * cps * fc.BK,
                                          cps * fc.BK))
            assert covered == K and len(parts) == ksplit
            assert j.proj or ksplit == 1
            if j.proj:
                assert out == B * spec.proj_cols[j.enc]
            for s, p in enumerate(parts):
                at = out if s == 0 else part + (s - 1) * stride
                ws[at:at + B * N] = p.reshape(-1)
            y = sum(ws[(out if s == 0 else part + (s - 1) * stride):][:B * N]
                    .reshape(B, N) for s in range(ksplit))
            if bias:
                y = _act(act, y + b)
            ws[out:out + B * N] = y.reshape(-1)
        for off, N in segments:
            ws[off:off + B * N] = _act(fc.ACT_CODES["softmax"], ws[
                off:off + B * N].reshape(B, N)).reshape(-1)
    return ws


def _pack(spec, layers):
    """The packed state-path region as Stage A's copy blocks write it, all
    in the first launch: copy block ``i`` writes ``COPY_SPAN`` floats of
    the copy row that the copy map names, from that row's first block on.
    Every float of the region is written exactly once."""
    region = np.full(spec.region_len, np.nan)
    written = np.zeros(spec.region_len, dtype=int)
    rows, copy_map = spec.copy_rows, spec._copy_map()
    assert len(rows) == len(spec.copies)
    assert len(copy_map) == spec.copy_blocks
    for blk in range(spec.copy_blocks):
        c = copy_map[blk]
        layer, row0, K, N, dst, first = (int(v) for v in rows[c])
        cp = spec.copies[c]
        assert (layer, row0, K, N, dst) == tuple(cp)
        kp, np_ = -(-K // 4) * 4, -(-N // 4) * 4
        w, b = layers[layer]
        for d in range((blk - first) * fc.COPY_SPAN,
                       min((blk - first + 1) * fc.COPY_SPAN,
                           kp * np_ + np_)):
            if d < kp * np_:
                r, col = divmod(d, np_)
                v = w[row0 + r, col] if r < K and col < N else 0.0
            else:
                v = b[d - kp * np_] if d - kp * np_ < N else 0.0
            region[dst + d] = v
            written[dst + d] += 1
    assert (written == 1).all()
    return region


def _run_plan(spec, layers, data, valid, init, n_sm=132):
    """What csrc/fused_chain.cu computes, read from the tables it reads
    (Stage A's jobs and copies, Stage B's int32 plan) and the buffers it
    writes (the workspace, the packed region, one decoder buffer), in
    float64 numpy. The state-path matrices are read padded, and their pads
    must be zero; each encoder's layers lie in its block of the region."""
    plan = spec.plan
    (E, D, S, L, ld_s, ld_h, region, blk_max, proj_max,
     rec_max) = (int(v) for v in plan[:fc.HEADER])
    enc = plan[fc.HEADER:fc.HEADER + fc.ENC_FIELDS * E].reshape(E, -1)
    dec = plan[fc.HEADER + fc.ENC_FIELDS * E:fc.HEADER + fc.ENC_FIELDS * E
               + fc.DEC_FIELDS * D].reshape(D, -1)
    lay = plan[fc.HEADER + fc.ENC_FIELDS * E + fc.DEC_FIELDS * D:].reshape(
        L, fc.LAYER_FIELDS)
    assert region == spec.region_len and region % 4 == 0
    assert ld_s % 4 == 0 and ld_h % 4 == 0 and ld_s >= S
    assert blk_max % 4 == 0 and proj_max % 4 == 0 and rec_max % 4 == 0
    B = data[0].shape[0]
    packed = spec.pack_data(data)
    assert packed.shape == (B, spec.data_ld) and spec.data_ld % 4 == 0
    ws = _stage_a(spec, layers, packed, B, n_sm)
    wb = _pack(spec, layers)

    def r4(x):
        return -(-x // 4) * 4

    def mat(off, K, N):
        m = wb[off:off + r4(K) * r4(N)].reshape(r4(K), r4(N))
        assert not m[K:].any() and not m[:, N:].any()
        return m[:K, :N]

    def run_layers(first, n, state, proj, block=None):
        prev = None
        for src, K, N, act, w_off, b_off, add in lay[first:first + n]:
            assert N <= ld_h
            if block is not None:      # a ring stage holds the block
                assert block[0] <= w_off < b_off + r4(N) <= block[1]
            inp = state if src == fc.SRC_STATE else prev
            y = inp @ mat(w_off, K, N) + wb[b_off:b_off + N]
            assert not wb[b_off + N:b_off + r4(N)].any()
            if add:
                y = y + proj
            prev = _act(act, y)
        return prev

    state = np.broadcast_to(init, (B, S))
    states, blocks = [state], 0
    for e, (first, n, pcol, blk, blk_len, N) in enumerate(enc):
        assert blk == blocks and blk_len <= blk_max and pcol % 4 == 0
        assert N == lay[first][2] and fc.ENC_FIELDS + 7 * n <= rec_max
        # The ring's copy of the records: the encoder's, then its layers'.
        ring = spec.ring_records[e]
        assert len(ring) == rec_max and not ring[fc.ENC_FIELDS + 7 * n:].any()
        np.testing.assert_array_equal(ring[:fc.ENC_FIELDS + 7 * n], np.r_[
            enc[e], lay[first:first + n].reshape(-1)])
        blocks += blk_len
        proj = ws[B * pcol:B * pcol + B * N].reshape(B, N)
        new = run_layers(first, n, state, proj, (blk, blk + blk_len))
        state = np.where(valid[:, e:e + 1] > 0, new, state)
        states.append(state)
    out_buf = np.full((E + 1) * B * spec.n_classes_total, np.nan)
    for first, n, C, col in dec:
        y = np.stack([run_layers(first, n, s, None) for s in states])
        out_buf[(E + 1) * B * col:(E + 1) * B * (col + C)] = y.reshape(-1)
    assert not np.isnan(out_buf).any()
    outs = [out_buf[(E + 1) * B * col:(E + 1) * B * (col + C)].reshape(
        E + 1, B, C) for _f, _n, C, col in dec]
    return np.stack(states), outs


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("B,n_sm", [(9, 132), (300, 4)])
def test_kernel_plan_reproduces_plain_version(case, B, n_sm):
    """The plan at a batch that splits K across blocks (9 rows on 132 SMs)
    and at one that does not (300 rows on 4 SMs)."""
    S, make_enc, make_dec = PLAN_CASES[case]
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0, seed=3,
                   device="cpu")
    data, valid = _inputs(tm.encoders, B, seed=2)
    spec = fc.ChainSpec(tm.encoders, tm.decoders, S)
    layers = [(w.double().numpy(), b.double().numpy())
              for w, b in spec.layer_params(tm.params)]
    init = tm.params["init_state"]["value"][0].double().numpy()
    want = _port_forward(tm, data, valid)
    _assert_close(_run_plan(spec, layers,
                            [d.astype(np.float64) for d in data], valid,
                            init, n_sm), want, ATOL)


def test_mimic_plan_sizes():
    S, make_enc, make_dec = MIMIC_CASE
    spec = fc.ChainSpec(make_enc(tenc), make_dec(tdec), S)
    # 4 encoders x 3 layers + 2 decoders x 3 layers.
    assert len(spec.layers) == 18
    # Stage A: the x-parts of the 4 first layers over widths
    # {10, 1024, 768, 99} -> 32, one launch.
    assert [(j.K, j.N, j.proj) for j in spec.a_jobs] == \
        [(10, 32, True), (1024, 32, True), (768, 32, True), (99, 32, True)]
    assert spec.n_proj_weights == 60832           # ~243 KB of fp32
    # Stage B: per encoder s@Ws (50x32), 32x32, 32x50; 2 decoders of
    # 50x32, 32x32, 32x2; with biases.
    assert spec.n_state_weights == 22860          # ~91 KB of fp32
    assert spec.n_weights == 83692
    assert len(spec.plan) == fc.HEADER + fc.ENC_FIELDS * 4 \
        + fc.DEC_FIELDS * 2 + fc.LAYER_FIELDS * (4 * 3 + 2 * 3)
    # Stage A's launch packs the 18 state-path layers, one block each.
    assert len(spec.copies) == 18 and spec.copy_blocks == 18
    assert spec.launches == 2 and spec.a_depth == 1
    # The padded state-path region fits one block's shared memory beside
    # the 128-row tiles: large tiles at large B, every state tile at small.
    region = 4 * spec.region_len
    assert region < 96 * 1024
    assert region + 4 * 128 * (spec.state_stride + 2 * spec.hidden_stride) \
        <= H100_SMEM
    assert spec.stage_b_config(65536, H100_SMS, H100_SMEM)[0] == fc.LARGE
    assert spec.stage_b_config(16, H100_SMS, H100_SMEM)[:3:2] == \
        (fc.BATCHED, 4)


def test_copies_past_one_launch_take_their_own():
    """27 state-path layers (the old kernel's 24 copies per launch gave the
    last 3 a launch of their own): every copy now rides on Stage A's first
    launch, from the device table."""
    S, make_enc, make_dec = PLAN_CASES["many_layers"]
    spec = fc.ChainSpec(make_enc(tenc), make_dec(tdec), S)
    assert len(spec.copies) == 27 and len(spec.copy_rows) == 27
    assert spec.copy_blocks == 27 and len(spec._copy_map()) == 27
    # Stage A with the 27 copies, Stage B.
    assert spec.launches == 2


def test_stage_a_spreads_a_small_batch_over_the_card():
    """At B=16 Stage A splits the MIMIC projections' K chunks into 61
    blocks; at B=65536 it tiles rows and does not split."""
    spec = fc.ChainSpec(MIMIC_CASE[1](tenc), MIMIC_CASE[2](tdec),
                        MIMIC_CASE[0])
    (small,), ws_small, out_small, tickets = spec.stage_a_plan(16, 132)
    # The projections' area (B x 4 x 32) and their 0 + 31 + 23 + 3
    # further partials.
    assert small[2] == 61 and [k for _o, k, _t in out_small] == \
        [1, 32, 24, 4]
    assert ws_small == 16 * 32 * 61 and tickets == 3
    (large,), ws_large, out_large, tickets = spec.stage_a_plan(65536, 132)
    assert large[2] == 4 * 512 and all(k == 1 for _o, k, _t in out_large)
    assert ws_large == 65536 * 32 * 4 and tickets == 0


def test_flatten_params_places_every_parameter_once():
    """Parameters numbered 1, 2, ...: the packed region holds every
    state-path parameter once, Stage A's jobs read the others in place, and
    the pads are 0. Stage A's copy blocks write the same region."""
    S, make_enc, make_dec = SMALL_CASES["mixed_gelu_tanh_softmax"]
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0, seed=3,
                   device="cpu")
    spec = fc.ChainSpec(tm.encoders, tm.decoders, S)
    layers, n = [], 0
    for w, b in spec.layer_params(tm.params):
        pair = []
        for t in (w, b):
            pair.append(torch.arange(n + 1, n + 1 + t.numel(),
                                     dtype=torch.float32).reshape(t.shape))
            n += t.numel()
        layers.append(tuple(pair))
    params = {"encoders": [], "decoders": []}
    it = iter(layers)
    for part, mods in (("encoders", tm.params["encoders"]),
                       ("decoders", tm.params["decoders"])):
        for p in mods:
            params[part].append({"layers": [
                dict(zip("wb", next(it))) for _ in p["layers"]]})
    buf = spec.flatten_params(params)
    assert buf.shape == (spec.region_len,) and spec.region_len % 4 == 0
    in_a = [w[:j.K] if j.proj else torch.cat([w.reshape(-1), b])
            for j in spec.a_jobs for w, b in [layers[j.layer]]]
    vals = torch.cat([buf[buf > 0]] + [t.reshape(-1) for t in in_a])
    assert len(buf[buf > 0]) == spec.n_state_weights
    assert sorted(vals.tolist()) == list(range(1, spec.n_weights + 1)) \
        and spec.n_weights == n
    np.testing.assert_array_equal(
        _pack(spec, [(w.numpy(), b.numpy()) for w, b in layers]),
        buf.numpy())


def test_chain_spec_rejects_other_encoders():
    class Recurrent(MultiModEncoder):
        def init(self, generator, device=None):
            return {}

        def apply(self, params, state, x):
            return state

    with pytest.raises(TypeError, match="MLP-family"):
        fc.ChainSpec([Recurrent(4, 3)], [tdec.LogisticDecoder(4)], 4)


def test_flatten_params_rejects_mismatched_trees():
    tm = MultiModN(8, [tenc.MLPEncoder(8, 5, (4,))],
                   [tdec.LogisticDecoder(8)], 1.0, 0.0, device="cpu")
    spec = fc.ChainSpec(tm.encoders, tm.decoders, 8)
    params = dict(tm.params, decoders=[])
    with pytest.raises(ValueError, match="dense layers"):
        spec.flatten_params(params)


def test_wrapper_input_checks():
    """What the wrapper checks before a CUDA launch, on CPU tensors."""
    tm = MultiModN(8, [tenc.MLPEncoder(8, 5, (4,))],
                   [tdec.LogisticDecoder(8)], 1.0, 0.0, device="cpu")
    spec = fc.ChainSpec(tm.encoders, tm.decoders, 8)
    w = spec.layer_params(tm.params)
    data, valid, init = [torch.zeros(3, 5)], torch.ones(3, 1), torch.zeros(8)
    fc._check_inputs(spec, w, data, valid, init)
    with pytest.raises(TypeError, match="float32"):
        fc._check_inputs(spec, w, [data[0].double()], valid, init)
    with pytest.raises(ValueError, match="shape"):
        fc._check_inputs(spec, w, [torch.zeros(3, 6)], valid, init)
    with pytest.raises(ValueError, match="contiguous"):
        fc._check_inputs(spec, w, [torch.zeros(5, 3).t()], valid, init)
    with pytest.raises(ValueError, match="modality arrays"):
        fc._check_inputs(spec, w, data * 2, valid, init)


def test_wrapper_refuses_other_devices():
    tm = MultiModN(8, [tenc.MLPEncoder(8, 5, (4,))],
                   [tdec.LogisticDecoder(8)], 1.0, 0.0, device="cpu")
    spec = fc.ChainSpec(tm.encoders, tm.decoders, 8)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fc.fused_chain_forward(spec, tm.params, [torch.zeros(3, 5,
                                                             device=meta)],
                               torch.ones(3, 1, device=meta),
                               torch.zeros(8, device=meta))


# ---------------------------------------------------------------------------
# The whole domain: long chains, many decoders, wide layers
# ---------------------------------------------------------------------------

def _featurewise(E, S=8, hidden=4):
    """The featurewise chain's shape (RESULTS.md: one MLPFeatureEncoder
    per feature, one MLPDecoder) at E features."""
    return (S, lambda m: [m.MLPFeatureEncoder(S, hidden) for _ in range(E)],
            lambda m: [m.MLPDecoder(S, (hidden,) * 2, 2)])


def _wide(hidden, S=50, widths=(10, 1024, 768, 99), dec_hidden=32):
    """The MIMIC widths with wide encoder layers."""
    return (S, lambda m: [m.MIMICMLPEncoder(S, w, (hidden,) * 2, 0.0)
                          for w in widths],
            lambda m: [m.MLPDecoder(S, (dec_hidden,) * 2, 2)
                       for _ in range(2)])


def _spec(case):
    S, make_enc, make_dec = case
    return fc.ChainSpec(make_enc(tenc), make_dec(tdec), S)


LONG_PLAN_CASES = {
    # E = 1901 at S = 8, hidden 4; B = 9 rows.
    "featurewise": (_featurewise(1901), 9),
    # A Stage B layer of 1800 columns (the 16-row tiles hold 1788 at
    # state 50): the layered variant's shape.
    "wide_1800": (_wide(1800, widths=(3, 6), dec_hidden=4), 5),
}


@pytest.mark.parametrize("case", sorted(LONG_PLAN_CASES))
def test_kernel_plan_reproduces_plain_version_past_the_old_caps(case):
    (S, make_enc, make_dec), B = LONG_PLAN_CASES[case]
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0, seed=3,
                   device="cpu")
    data, valid = _inputs(tm.encoders, B, seed=2)
    spec = fc.ChainSpec(tm.encoders, tm.decoders, S)
    layers = [(w.double().numpy(), b.double().numpy())
              for w, b in spec.layer_params(tm.params)]
    init = tm.params["init_state"]["value"][0].double().numpy()
    want = _port_forward(tm, data, valid)
    _assert_close(_run_plan(spec, layers,
                            [d.astype(np.float64) for d in data], valid,
                            init), want, ATOL)


def test_launches_do_not_grow_with_encoders():
    """Two Stage A depths and Stage B, at 4, 33 and 1901 encoders, and
    for the MIMIC-width model at hidden 32 and 2048."""
    launches = {E: _spec(_featurewise(E, 50, 32)).launches
                for E in (4, 33, 1901)}
    assert launches == {4: 3, 33: 3, 1901: 3}
    assert _spec(_wide(2048)).launches == _spec(MIMIC_CASE).launches == 2


def test_stage_b_variant_choice():
    """Stage B's variant on an H100 (132 SMs, 232,448 bytes per block):
    the shapes that ran before keep theirs; the featurewise chain streams
    its region through the ring; past 1788 columns at state 50 the
    layered variant takes over."""
    def variant(case, B):
        return fc.VARIANTS[_spec(case).stage_b_config(B, H100_SMS,
                                                      H100_SMEM)[0]]
    assert [variant(MIMIC_CASE, B) for B in (1, 16, 1000, 65536)] == \
        ["batched"] * 3 + ["large"]
    scaled = _wide(1024, S=256, widths=(1024,) * 4, dec_hidden=1024)
    assert variant(scaled, 512) == "interleaved_l2"
    assert variant(_featurewise(4, 50, 32), 64) == "batched"
    for E in (33, 1901):
        for B in (1, 64):
            assert variant(_featurewise(E, 50, 32), B) == "ring"
    assert variant(_wide(1788), 16) == "interleaved_l2"
    for B in (16, 4096):
        assert variant(_wide(1792), B) == variant(_wide(2048), B) == \
            "layered"
    spec = _spec(_featurewise(1901, 50, 32))
    kind, smem, chunk, stages = spec.stage_b_config(64, H100_SMS, H100_SMEM)
    assert smem <= H100_SMEM and chunk >= 1 and 2 <= stages <= 4
    # One ring stage: an encoder's block (52 x 52 + 52 floats) and its
    # projection's 16-row tile.
    assert spec.enc_block_max == 52 * 52 + 52
    assert spec.ring_stage_floats() == 52 * 52 + 52 + 16 * 52 + 16


def test_lay_out_is_linear_in_encoders():
    """The plan grows by the same amount per encoder: 6 ints per encoder
    record and 7 per Stage B layer."""
    lengths = [len(_spec(_featurewise(E)).plan) for E in (100, 200, 400)]
    assert lengths[1] - lengths[0] == 100 * (fc.ENC_FIELDS
                                             + fc.LAYER_FIELDS)
    assert lengths[2] - lengths[1] == 200 * (fc.ENC_FIELDS
                                             + fc.LAYER_FIELDS)


def test_packed_data_layout():
    """Blocks whose width is a multiple of 4 start on a multiple of 4, so
    Stage A reads them 16 bytes at a time; the rest pack tightly."""
    spec = _spec(MIMIC_CASE)
    assert spec.data_cols == [0, 12, 1036, 1804] and spec.data_ld == 1904
    rng = np.random.default_rng(0)
    data = [rng.normal(size=(3, e.n_features)).astype(np.float32)
            for e in spec.encoders]
    packed = spec.pack_data(data)
    assert packed.shape == (3, 1904) and not packed[:, 10:12].any()
    for e, d in enumerate(data):
        np.testing.assert_array_equal(packed[:, spec.data_columns(e)], d)
    views = spec.unpack_data(torch.as_tensor(packed))
    assert all(np.array_equal(v.numpy(), d) for v, d in zip(views, data))
    t = spec.pack_data([torch.as_tensor(d) for d in data])
    np.testing.assert_array_equal(t.numpy(), packed)


def test_stage_a_jobs_ride_in_the_parameters_of_small_models():
    """Levels of at most INLINE_JOBS jobs (every level of the MIMIC model,
    at any batch) are resolved into the launch's parameters, which is also
    what lets unpacked modalities be read where they lie; the featurewise
    chain's 1,901-job levels are read from their device table."""
    spec = _spec(MIMIC_CASE)
    assert all(spec.inline_levels(B, H100_SMS) for B in (1, 16, 65536))
    assert not _spec(_featurewise(33)).inline_levels(16, H100_SMS)
    assert not _spec(_featurewise(1901)).inline_levels(1, H100_SMS)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_fused_forward_leaves_the_request_unchanged(as_tensor):
    """One encoder of 4 features: the packed request is the caller's own
    buffer, and its NaNs stay where they were."""
    S = 8
    tm = MultiModN(S, [tenc.MLPEncoder(S, 4, (6,))],
                   [tdec.LogisticDecoder(S)], 1.0, 0.0, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    x[1] = np.nan
    x[3, 2] = np.nan
    request = [torch.as_tensor(x.copy()) if as_tensor else x.copy()]
    first = tm.fused_forward(request)
    kept = request[0].numpy() if as_tensor else request[0]
    np.testing.assert_array_equal(kept, x)
    again = tm.fused_forward(request)
    _assert_close(again, first, 0.0)


def _nan_request(encoders, B, seed):
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(B, e.n_features)).astype(np.float32)
         for e in encoders]
    for e in range(0, len(x), 3):
        x[e][rng.integers(B)] = np.nan
    return x


def test_fused_forward_matches_pallas_interpret_at_33_encoders():
    """The port's CPU ``fused_forward`` (packed request, one segmented NaN
    reduction, the plain chain) against JAX's ``fused_forward`` through
    the Pallas kernel in interpret mode, 33 encoders, NaN rows in every
    third modality."""
    S, make_enc, make_dec = _featurewise(33)
    jm, tm = _pair(S, make_enc, make_dec)
    x = _nan_request(jm.encoders, 16, seed=4)
    want = jm.fused_forward(x, use_interpret=True)
    got = tm.fused_forward(x)
    _assert_close(got, want, ATOL)


def test_fused_forward_matches_xla_chain_at_1901_encoders():
    """The featurewise chain: JAX's ``make_xla_chain_forward`` run eagerly
    (``jax.disable_jit``) on the JAX model's per-encoder weights against
    the port's CPU ``fused_forward`` on the same weights, carried across by
    ``convert.py`` from the JAX model's scan-stacked storage."""
    import jax

    from multimodn_tpu_torch.convert import params_from_jax
    S, make_enc, make_dec = _featurewise(1901)
    jm = JMultiModN(S, make_enc(jenc), make_dec(jdec), 1.0, 0.0, seed=0)
    assert isinstance(jm.params["encoders"], dict)     # scan-stacked
    tm = MultiModN(S, make_enc(tenc), make_dec(tdec), 1.0, 0.0,
                   device="cpu")
    tm.params = params_from_jax(jm.state_dict(), "cpu")
    x = _nan_request(jm.encoders, 8, seed=5)
    valid = np.stack([~np.isnan(m).any(axis=1) for m in x], 1).astype(
        np.float32)
    params = dict(jm.params, encoders=[
        jax.tree_util.tree_map(lambda s, i=i: s[i], jm.params["encoders"])
        for i in range(1901)])
    with jax.disable_jit():
        want = make_xla_chain_forward(jm.encoders, jm.decoders, S)(
            params, tuple(jnp.asarray(np.nan_to_num(m)) for m in x),
            jnp.asarray(valid), jm.params["init_state"]["value"][0])
    got = tm.fused_forward(x)
    _assert_close(got, want, ATOL)
