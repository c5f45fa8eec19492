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
# Another has 27 state-path layers: more copies than one Stage A launch
# takes, so the rest get a launch of their own.
PLAN_CASES = dict(ALL_CASES, softmax_hidden=(
    8, lambda m: [m.MLPEncoder(8, 6, (12, 10), "softmax"),
                  m.MLPEncoder(8, 9, (5,), "sigmoid")],
    lambda m: [m.LogisticDecoder(8)]), many_layers=(
    8, lambda m: [m.MIMICMLPEncoder(8, 3 + w, (8, 8, 8), dropout=0.0)
                  for w in range(6)],
    lambda m: [m.MLPDecoder(8, (8, 8), 2)]))


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


def _stage_a(spec, layers, data, B, n_sm):
    """Stage A's jobs as the kernels run them: per level, each job's K
    chunks split as ``stage_a_plan`` says, one partial sum per split, the
    partials summed in split order into one projection per encoder."""
    levels, _ws, outputs, tickets = spec.stage_a_plan(B, n_sm)
    assert tickets == sum(r[11] * r[12] for _i, rows, _b in levels
                          for r in rows if r[9] > 1)
    out, proj = {}, [None] * len(spec.encoders)
    for idx, rows, blocks in levels:
        assert blocks == sum(r[11] * r[12] * r[9] for r in rows)
        for i, row in zip(idx, rows):
            j = spec.a_jobs[i]
            ksplit, cps = int(row[9]), int(row[10])
            assert outputs[i][1] == ksplit
            x = data[j.enc] if j.depth == 0 else out[i - 1]
            w, b = layers[j.layer]
            w = w[:j.K]
            parts = [x[:, k0:k0 + cps * fc.BK] @ w[k0:k0 + cps * fc.BK]
                     for k0 in range(0, ksplit * cps * fc.BK, cps * fc.BK)]
            covered = sum(min(cps * fc.BK, max(j.K - k0, 0))
                          for k0 in range(0, ksplit * cps * fc.BK,
                                          cps * fc.BK))
            assert covered == j.K and len(parts) == ksplit
            assert j.proj or ksplit == 1
            y = sum(parts[1:], parts[0])
            if j.proj:
                proj[j.enc] = y
            else:
                y = _act(j.act, y + b)
            out[i] = y
    return proj


def _pack(spec, layers):
    """The packed state-path region as Stage A's copy blocks write it, in
    launches of ``MAX_COPIES`` copies: block ``i`` of a launch writes
    ``COPY_SPAN`` floats of the last copy whose first block is ``<= i``.
    Every float of the region is written exactly once."""
    region = np.full(spec.region_len, np.nan)
    written = np.zeros(spec.region_len, dtype=int)
    assert len(spec.copy_groups) == -(-len(spec.copies) // fc.MAX_COPIES)
    for copies, rows, blocks in spec.copy_groups:
        assert len(copies) == len(rows) <= fc.MAX_COPIES
        firsts = rows[:, 5].tolist()
        for blk in range(blocks):
            c = max(i for i, f in enumerate(firsts) if f <= blk)
            cp = copies[c]
            K, N = int(rows[c, 3]), int(rows[c, 4])
            assert (K, N) == (cp.K, cp.N)
            kp, np_ = -(-K // 4) * 4, -(-N // 4) * 4
            w, b = layers[cp.layer]
            for d in range((blk - firsts[c]) * fc.COPY_SPAN,
                           min((blk - firsts[c] + 1) * fc.COPY_SPAN,
                               kp * np_ + np_)):
                if d < kp * np_:
                    r, col = divmod(d, np_)
                    v = w[cp.row0 + r, col] if r < K and col < N else 0.0
                else:
                    v = b[d - kp * np_] if d - kp * np_ < N else 0.0
                region[cp.dst + d] = v
                written[cp.dst + d] += 1
    assert (written == 1).all()
    return region


def _run_plan(spec, layers, data, valid, init, n_sm=132):
    """What csrc/fused_chain.cu computes, read from Stage A's jobs and
    copies, Stage B's int32 plan and the packed region, in float64 numpy.
    The state-path matrices are read padded, and their pads must be zero."""
    plan = spec.plan
    E, D, S, L, ld_s, ld_h, region = (int(v) for v in plan[:7])
    enc = plan[7:7 + 2 * E].reshape(E, 2)
    dec = plan[7 + 2 * E:7 + 2 * E + 3 * D].reshape(D, 3)
    lay = plan[7 + 2 * E + 3 * D:].reshape(L, 7)
    assert region == spec.region_len and region % 4 == 0
    assert ld_s % 4 == 0 and ld_h % 4 == 0 and ld_s >= S
    B = data[0].shape[0]
    proj = _stage_a(spec, layers, data, B, n_sm)
    wb = _pack(spec, layers)

    def r4(x):
        return -(-x // 4) * 4

    def mat(off, K, N):
        m = wb[off:off + r4(K) * r4(N)].reshape(r4(K), r4(N))
        assert not m[K:].any() and not m[:, N:].any()
        return m[:K, :N]

    def run_layers(first, n, state, e):
        prev = None
        for src, K, N, act, w_off, b_off, add in lay[first:first + n]:
            assert N <= ld_h
            inp = state if src == fc.SRC_STATE else prev
            y = inp @ mat(w_off, K, N) + wb[b_off:b_off + N]
            assert not wb[b_off + N:b_off + r4(N)].any()
            if add:
                y = y + proj[e]
            prev = _act(act, y)
        return prev

    state = np.broadcast_to(init, (B, S))
    states = [state]
    for e, (first, n) in enumerate(enc):
        new = run_layers(first, n, state, e)
        state = np.where(valid[:, e:e + 1] > 0, new, state)
        states.append(state)
    outs = [np.stack([run_layers(first, n, s, None) for s in states])
            for first, n, _c in dec]
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
    assert len(spec.plan) == 7 + 2 * 4 + 3 * 2 + 7 * (4 * 3 + 2 * 3)
    # Stage A's launch packs the 18 state-path layers, one block each.
    assert len(spec.copies) == 18 and len(spec.copy_groups) == 1
    assert spec.copy_groups[0][2] == 18
    assert spec.launches == 2 and spec.a_depth == 1
    # The padded state-path region fits one block's shared memory beside
    # the 128-row tiles.
    region = 4 * spec.region_len
    assert region < 96 * 1024
    assert region + 4 * 128 * (spec.state_stride + 2 * spec.hidden_stride) \
        <= fc.MAX_SHARED_BYTES
    assert spec.shared_bytes <= fc.MAX_SHARED_BYTES


def test_copies_past_one_launch_take_their_own():
    S, make_enc, make_dec = PLAN_CASES["many_layers"]
    spec = fc.ChainSpec(make_enc(tenc), make_dec(tdec), S)
    assert len(spec.copies) == 27 > fc.MAX_COPIES
    assert [len(c) for c, _r, _b in spec.copy_groups] == [fc.MAX_COPIES, 3]
    # Stage A with the first 24 copies, 3 copies alone, Stage B.
    assert spec.launches == 3


def test_stage_a_spreads_a_small_batch_over_the_card():
    """At B=16 Stage A splits the MIMIC projections' K chunks into 61
    blocks; at B=65536 it tiles rows and does not split."""
    spec = fc.ChainSpec(MIMIC_CASE[1](tenc), MIMIC_CASE[2](tdec),
                        MIMIC_CASE[0])
    (small,), ws_small, out_small, tickets = spec.stage_a_plan(16, 132)
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
