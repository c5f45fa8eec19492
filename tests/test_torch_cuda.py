"""The CUDA kernels against their plain PyTorch versions, on a GPU: the
fused chain (K1, at the MIMIC, small and Titanic shapes) and the fused
8-bit Adam update (K2); the card against the CPU for training, the
recurrent encoders, ``SGD`` and ``AdamW``, and two Titanic pipelines; and
streamed batches (pinned, copied one ahead) and a killed and resumed
``Adam8bit`` fit on the card, bit-equal to their ArrayLoader and
uninterrupted twins; shuffled and sequenced training on the card against
the CPU, and K2's launches at a featurewise chain's leaf count; torch
objects (optimizer, ``DataLoader``, loss) training on the card bit-equal to
the port's own, and their ``F.relu`` model served through K1; an
``Adam8bit`` seed sweep through K2 bit-equal to each seed's ``fit_best``,
and an ahead-of-time artifact on the card against K1; K2 on the 102 leaves
of a ResNet-18, bf16 and fp16 GEMMs against the float form, and one step of
a bf16 MIMIC model and of a ResNet model on the card against the CPU; K1
with a gradient (``make_fused_chain_vjp``) at ``bench_pallas.py``'s two
shapes against autograd through the plain chain.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports neither JAX nor the JAX package, so it runs on a GPU machine
that has neither, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: the kernel sums each dot product with fp32 FMAs in k order and
cuBLAS's fp32 GEMM in its own order; over K <= 1074 that moves a sum by
~1e-6, carried through up to 4 chained encoders and 3 decoder layers.
atol 1e-4 leaves ~100x headroom and still catches indexing or masking
faults, which give O(0.1) errors. The Adam kernel rounds every float32
operation on its own in the plain version's order, so its parameters, codes
and scales must be bit-equal.
"""
import numpy as np
import pytest
import torch

from multimodn_tpu_torch import SGD, Adam, Adam8bit, AdamW, MultiModN
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
from multimodn_tpu_torch.ops import fused_adam as fa
from multimodn_tpu_torch.ops import fused_adam_fp32 as fa32
from multimodn_tpu_torch.ops import fused_chain as fc

ATOL = 1e-4

CASES = {
    "mimic": (50, lambda: [tenc.MIMICMLPEncoder(50, w, (32, 32))
                           for w in (10, 1024, 768, 99)],
              lambda: [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)]),
    "mlp_last_concat": (8, lambda: [tenc.MLPEncoder(8, w, (16,))
                                    for w in (12, 20)],
                        lambda: [tdec.MLPDecoder(8, (16,), 2),
                                 tdec.LogisticDecoder(8)]),
    "mixed_gelu_tanh_softmax": (
        24, lambda: [tenc.MLPEncoder(24, 40, (64,), "gelu"),
                     tenc.MIMICMLPEncoder(24, 7, (16, 16), 0.0, "tanh"),
                     tenc.MLPEncoder(24, 13, ())],
        lambda: [tdec.ClassDecoder(24, 5, "softmax"),
                 tdec.MLPDecoder(24, (16,), 3, "softmax", "gelu")]),
    # Softmax hidden layers in Stage A (a row pass after each GEMM).
    "softmax_hidden": (8, lambda: [tenc.MLPEncoder(8, 6, (12, 10), "softmax"),
                                   tenc.MLPEncoder(8, 9, (5,), "sigmoid")],
                       lambda: [tdec.LogisticDecoder(8)]),
    # 27 state-path layers: Stage A packs 24 with its GEMM, 3 in a launch
    # of their own.
    "many_layers": (8, lambda: [tenc.MIMICMLPEncoder(8, 3 + w, (8, 8, 8),
                                                     0.0) for w in range(6)],
                    lambda: [tdec.MLPDecoder(8, (8, 8), 2)]),
    # State-path weights (~1.3 MB) that do not fit in shared memory: Stage
    # B reads them through L2.
    "wide_state": (256, lambda: [tenc.MIMICMLPEncoder(256, w, (256, 256))
                                 for w in (40, 300)],
                   lambda: [tdec.MLPDecoder(256, (256,), 3)]),
    # The Titanic pipelines' models: the quick-start at state 1 (a state
    # row of one float, a concat layer 1 wide), two partitions of 3 and 2
    # features, and six 1-feature modalities (K=1 inputs, 7 states decoded).
    "titanic_mlp": (1, lambda: [tenc.MLPEncoder(1, 6, (5, 5))],
                    lambda: [tdec.LogisticDecoder(1)]),
    "titanic_partitioned": (5, lambda: [tenc.MLPEncoder(5, n, (5, 5))
                                        for n in (3, 2)],
                            lambda: [tdec.LogisticDecoder(5)]),
    "titanic_featurewise": (5, lambda: [tenc.MLPFeatureEncoder(5, 5)
                                        for _ in range(6)],
                            lambda: [tdec.LogisticDecoder(5)]),
}
TITANIC = ("titanic_mlp", "titanic_partitioned", "titanic_featurewise")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU; chip_smoke.py runs "
                    "it against the plain version on one")
    # fp32 everywhere, as the plain versions and the CPU compute it: no TF32
    # in cuBLAS or in cuDNN's convolutions (PyTorch allows it in cuDNN by
    # default), as chip_smoke.py's exact_math does.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(case, device):
    S, make_enc, make_dec = CASES[case]
    return MultiModN(S, make_enc(), make_dec(), 1.0, 0.0, seed=4,
                     device=device)


def _close(got, want):
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


def _chain_inputs(model, B, device):
    gen = torch.Generator(device=device).manual_seed(B)
    data = [torch.randn((B, e.n_features), generator=gen, device=device)
            for e in model.encoders]
    valid = (torch.rand((B, len(data)), generator=gen, device=device)
             >= 0.3).float()
    return data, valid, model.params["init_state"]["value"][0].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("B", [1, 16, 33, 1000])
def test_kernel_matches_plain(cuda, case, B):
    model = _model(case, cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    data, valid, init = _chain_inputs(model, B, cuda)
    before = fc.FUSED_CHAIN.launches
    got = fc.fused_chain_forward(spec, model.params, data, valid, init)
    want = fc.fused_chain_forward_ref(spec, model.params, data, valid, init)
    torch.cuda.synchronize()
    assert fc.FUSED_CHAIN.launches == before + spec.launches
    _close(got, want)


# The domain past the old kernel's caps (32 encoders, 32 decoders, a 640-int
# plan, Stage B's shared memory): the featurewise MIMIC chain (1901
# one-feature encoders; Stage B streams its region through the ring), 33
# decoders, and the MIMIC widths at hidden 2048 (the layered variant).
LONG_CASES = {
    "featurewise_1901": (
        50, lambda: [tenc.MLPFeatureEncoder(50, 32) for _ in range(1901)],
        lambda: [tdec.MLPDecoder(50, (32, 32), 2)], (1, 37, 64)),
    "decoders_33": (
        8, lambda: [tenc.MIMICMLPEncoder(8, w, (6,), 0.0) for w in (3, 4)],
        lambda: [tdec.MLPDecoder(8, (4,), 2) if d % 3 else
                 tdec.ClassDecoder(8, 1 + d % 4, "softmax")
                 for d in range(33)], (16, 1000)),
    "wide_2048": (
        50, lambda: [tenc.MIMICMLPEncoder(50, w, (2048, 2048), 0.0)
                     for w in (10, 1024, 768, 99)],
        lambda: [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)],
        (16, 4096)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,B", [(c, B) for c in sorted(LONG_CASES)
                                    for B in LONG_CASES[c][3]])
def test_kernel_matches_plain_past_the_old_caps(cuda, case, B):
    """Within ATOL of the largest value (the long chain carries rounding
    through 1901 steps), with the plan's launches, as many as at E = 4."""
    S, make_enc, make_dec, _batches = LONG_CASES[case]
    model = MultiModN(S, make_enc(), make_dec(), 1.0, 0.0, seed=6,
                      device=cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    data, valid, init = _chain_inputs(model, B, cuda)
    before = fc.FUSED_CHAIN.launches
    got = fc.fused_chain_forward(spec, model.params, data, valid, init)
    want = fc.fused_chain_forward_ref(spec, model.params, data, valid, init)
    torch.cuda.synchronize()
    assert fc.FUSED_CHAIN.launches == before + spec.launches
    assert spec.launches == fc.ChainSpec(
        model.encoders[:4], model.decoders, S).launches
    scale = max(w.abs().max().item() for w in [want[0], *want[1]])
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL * max(scale, 1))


# The ring and layered variants on other module mixes: softmax and gelu
# state-path layers (the ring's unfused last layer, the layered row pass
# with and without the select), a last-concat encoder whose hidden layers
# Stage A computes (one with a softmax hidden layer: a segment_softmax
# launch), several decoders in chunked passes (E = 33 > the ring's chunk)
# with softmax ones among them. And 16 encoders at state 64, whose state
# tiles do not all fit beside the region: the small-plan kernel with the
# decoders after every encoder, on 16-row and on 128-row tiles. And 40
# encoders, past the small-plan kernel's 32: the general kernel's tile
# variants, the validity mask refilled after 32 encoders.
_FORTY = (8, lambda: [tenc.MIMICMLPEncoder(8, 1 + e % 5, (6,), 0.0)
                      for e in range(40)],
          lambda: [tdec.MLPDecoder(8, (4,), 2),
                   tdec.ClassDecoder(8, 3, "softmax")])
_SIXTEEN = (64, lambda: [tenc.MIMICMLPEncoder(64, 3 + e % 4, (4,), 0.0,
                                              "tanh") for e in range(16)],
            lambda: [tdec.MLPDecoder(64, (8,), 2),
                     tdec.ClassDecoder(64, 3, "softmax")])
MIXED_CASES = {
    "interleaved_16": (*_SIXTEEN, fc.INTERLEAVED, (16, 40)),
    "large_16": (*_SIXTEEN, fc.LARGE, (20000,)),
    "batched_40": (*_FORTY, fc.BATCHED, (16, 33)),
    "large_40": (*_FORTY, fc.LARGE, (20000,)),
    "ring_mixed": (
        50, lambda: [tenc.MLPFeatureEncoder(50, 32, "tanh") if e % 2 else
                     tenc.MIMICMLPEncoder(50, 2, (32,), 0.0, "softmax")
                     for e in range(33)],
        lambda: [tdec.MLPDecoder(50, (16,), 2),
                 tdec.ClassDecoder(50, 5, "softmax"),
                 tdec.LogisticDecoder(50),
                 tdec.MLPDecoder(50, (12, 8), 3, "softmax", "gelu")],
        fc.RING, (16, 37)),
    "layered_mixed": (
        50, lambda: [tenc.MIMICMLPEncoder(50, 10, (2048, 2048), 0.0,
                                          "softmax"),
                     tenc.MLPEncoder(50, 24, (64, 32), "tanh"),
                     tenc.MLPEncoder(50, 7, (16,), "softmax"),
                     tenc.MIMICMLPEncoder(50, 99, (1800,), 0.0, "gelu")],
        lambda: [tdec.MLPDecoder(50, (32,), 3, "softmax", "gelu"),
                 tdec.ClassDecoder(50, 4, "softmax"),
                 tdec.LogisticDecoder(50)],
        fc.LAYERED, (16, 300)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,B", [(c, B) for c in sorted(MIXED_CASES)
                                    for B in MIXED_CASES[c][4]])
def test_stage_b_variants_on_mixed_modules(cuda, case, B):
    """Each variant as the plan picks it, within ATOL of the largest value
    of the plain chain, with the plan's launches."""
    S, make_enc, make_dec, variant, _batches = MIXED_CASES[case]
    model = MultiModN(S, make_enc(), make_dec(), 1.0, 0.0, seed=7,
                      device=cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    assert fc.FUSED_CHAIN.stage_b_config(spec, B, cuda)[0] == variant
    data, valid, init = _chain_inputs(model, B, cuda)
    before = fc.FUSED_CHAIN.launches
    got = fc.fused_chain_forward(spec, model.params, data, valid, init)
    want = fc.fused_chain_forward_ref(spec, model.params, data, valid, init)
    torch.cuda.synchronize()
    assert fc.FUSED_CHAIN.launches == before + spec.launches
    scale = max(w.abs().max().item() for w in [want[0], *want[1]])
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL * max(scale, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TITANIC)
@pytest.mark.parametrize("B", [139, 178, 712])
def test_kernel_matches_plain_at_titanic_sizes(cuda, case, B):
    """The Titanic splits' sizes: 139 and 178 validation rows, 712
    training rows."""
    model = _model(case, cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    data, valid, init = _chain_inputs(model, B, cuda)
    got = fc.fused_chain_forward(spec, model.params, data, valid, init)
    want = fc.fused_chain_forward_ref(spec, model.params, data, valid, init)
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.cuda
def test_kernel_matches_plain_when_state_tiles_do_not_fit(cuda):
    """Eight encoders at state 256: the tiles of all nine states do not fit
    in shared memory, so Stage B runs every decoder after every encoder,
    with the weights read through L2."""
    model = MultiModN(256, [tenc.MIMICMLPEncoder(256, 20 + w, (256,))
                            for w in range(8)],
                      [tdec.MLPDecoder(256, (64,), 2)], 1.0, 0.0, seed=5,
                      device=cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    data, valid, init = _chain_inputs(model, 40, cuda)
    got = fc.fused_chain_forward(spec, model.params, data, valid, init)
    want = fc.fused_chain_forward_ref(spec, model.params, data, valid, init)
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 20000])
def test_kernel_is_deterministic(cuda, B):
    """Two calls on the same input are bit-equal: Stage A's K splits write
    separate partials that Stage B sums in a fixed order (B=16), and large
    batches take 128-row tiles (B=20000)."""
    model = _model("mimic", cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    data, valid, init = _chain_inputs(model, B, cuda)
    a = fc.fused_chain_forward(spec, model.params, data, valid, init)
    b = fc.fused_chain_forward(spec, model.params, data, valid, init)
    want = fc.fused_chain_forward_ref(spec, model.params, data, valid, init)
    torch.cuda.synchronize()
    for x, y in zip([a[0], *a[1]], [b[0], *b[1]]):
        assert torch.equal(x, y)
    _close(a, want)


@pytest.mark.cuda
def test_fused_forward_on_cuda_matches_cpu_model(cuda):
    """The same weights answer the same NaN-holding request on both
    devices: kernel on the card, plain version on the CPU."""
    gpu = _model("mimic", cuda)
    cpu = _model("mimic", "cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(0)
    x = [rng.normal(size=(16, e.n_features)).astype(np.float32)
         for e in gpu.encoders]
    x[1][[3, 7]] = np.nan
    x[2][5, 0] = np.nan
    got = gpu.fused_forward(x)
    want = cpu.fused_forward(x)
    _close((got[0].cpu(), [o.cpu() for o in got[1]]), want)


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    model = _model("mlp_last_concat", cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    before = fc.FUSED_CHAIN.launches
    states, outs = fc.fused_chain_forward(
        spec, model.params, [torch.zeros(0, 12, device=cuda),
                             torch.zeros(0, 20, device=cuda)],
        torch.ones(0, 2, device=cuda), torch.zeros(8, device=cuda))
    assert states.shape == (3, 0, 8) and [o.shape for o in outs] == \
        [(3, 0, 2), (3, 0, 2)]
    assert fc.FUSED_CHAIN.launches == before


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_cuda(cuda):
    model = _model("mlp_last_concat", cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    data = [torch.zeros(4, 12, device=cuda), torch.zeros(4, 20, device=cuda)]
    valid = torch.ones(4, 2, device=cuda)
    init = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fc.fused_chain_forward(spec, model.params,
                               [data[0].double(), data[1]], valid, init)
    with pytest.raises(ValueError, match="is on"):
        fc.fused_chain_forward(spec, model.params, [data[0].cpu(), data[1]],
                               valid, init)


# bench_pallas.py's two configurations (bench_pallas.py:40-45): widths,
# state, hidden widths, batch.
BENCH_PALLAS = {"shipped": ((10, 1024, 768, 99), 50, (32, 32), 1024),
                "scaled": ((1024,) * 4, 256, (1024, 1024), 512)}


def _vjp_grads(fwd, model, data, valid, init):
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      {"encoders": model.params["encoders"],
                       "decoders": model.params["decoders"]})
    xs = [d.clone().requires_grad_(True) for d in data]
    row = init.detach().clone().requires_grad_(True)
    states, outs = fwd(params, xs, valid, row)
    loss = (states ** 2).mean() + sum(o.mean() for o in outs)
    return (states, outs), loss, torch.autograd.grad(
        loss, tree_leaves(params) + xs + [row])


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(BENCH_PALLAS))
def test_vjp_on_cuda_matches_the_plain_chain(cuda, config):
    """K1 with a gradient at bench_pallas.py's shapes, ~30% of valid cells
    0: its forward within ATOL of the plain chain's relative to the largest
    value, the loss within 1e-5 relative, and every gradient (layers, data,
    init row) within 1e-4 of its leaf's largest magnitude. Both backwards
    are the same plain ops; they differ only through the loss's cotangent,
    read from K1's forward on one side."""
    widths, S, hidden, B = BENCH_PALLAS[config]
    model = MultiModN(S, [tenc.MIMICMLPEncoder(S, w, hidden, dropout=0.0)
                          for w in widths],
                      [tdec.MLPDecoder(S, hidden, 2)], 1.0, 0.0, seed=0,
                      device=cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, S)
    data, valid, init = _chain_inputs(model, B, cuda)
    args = (model.encoders, model.decoders, S)
    before = fc.FUSED_CHAIN.launches
    got, loss, grads = _vjp_grads(fc.make_fused_chain_vjp(*args), model,
                                  data, valid, init)
    torch.cuda.synchronize()
    assert fc.FUSED_CHAIN.launches == before + spec.launches
    want, want_loss, want_grads = _vjp_grads(
        fc.make_xla_chain_forward(*args), model, data, valid, init)
    pairs = list(zip([got[0], *got[1]], [want[0], *want[1]]))
    scale = max(w.abs().max().item() for _g, w in pairs)
    for g, w in pairs:
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL * max(scale, 1))
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())


LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _adam_leaf(shape, fmt, device, seed):
    """A leaf after two plain steps from zero moments, a fresh gradient
    whose rows mix magnitudes, and the third step's bias corrections."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def grad():
        g = torch.randn(shape, generator=gen, device=device)
        if len(shape) >= 1:
            g[..., ::2] *= 1e-4
        return g

    qdt = fa.code_dtype(fmt)
    p = torch.randn(shape, generator=gen, device=device)
    mq = torch.zeros(shape, dtype=qdt, device=device)
    vq = torch.zeros(shape, dtype=qdt, device=device)
    ms = torch.zeros(fa.scale_shape(shape), device=device)
    vs = torch.zeros(fa.scale_shape(shape), device=device)
    for t in (1, 2):
        c = torch.tensor([1 - B1 ** t, 1 - B2 ** t], device=device)
        p, mq, ms, vq, vs = fa.leaf_update_ref(p, grad(), mq, ms, vq, vs,
                                               c[0], c[1], LR, B1, B2, EPS,
                                               fmt=fmt)
    c12 = torch.tensor([1 - B1 ** 3, 1 - B2 ** 3], device=device)
    return [p, grad(), mq, ms, vq, vs, c12]


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else \
        t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["fp8", "int8"])
@pytest.mark.parametrize("gate", [None, 0.0, 1.0])
@pytest.mark.parametrize("shape", [(1074, 32), (32,), (1, 50), (),
                                   (3, 10, 7), (65536,), (130, 1500)])
def test_fused_adam_kernel_matches_plain_bit_for_bit(cuda, fmt, gate, shape):
    """Narrow rows packed several to a warp, rows held by a whole block
    (1500 columns), rows split across blocks (a wide 1-D leaf), 0-D and 3-D
    leaves."""
    p, g, mq, ms, vq, vs, c12 = _adam_leaf(shape, fmt, cuda, len(shape))
    gate_t = None if gate is None else torch.tensor(gate, device=cuda)
    want = fa.leaf_update_ref(p, g, mq, ms, vq, vs, c12[0], c12[1], LR, B1,
                              B2, EPS, gate=gate_t, fmt=fmt)
    got = [t.clone() for t in (p, mq, ms, vq, vs)]
    before = fa.FUSED_ADAM.launches
    fa.leaf_update(got[0], g, *got[1:], c12, lr=LR, b1=B1, b2=B2, eps=EPS,
                   gate=gate_t, fmt=fmt)
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches == before + fa.launches_per_update([shape])
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def _same_or_both_nan(a, b):
    """Bit-equal, where a NaN counts as equal to any NaN."""
    if a.element_size() == 1:
        return torch.equal(_bits(a), _bits(b))
    return bool(((_bits(a) == _bits(b)) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_multi_leaf_kernel_matches_plain_across_groups(cuda, fmt):
    """One call over leaves of three groups, each with its own bias
    corrections and gate (ungated, gate 1, gate 0), mixing narrow, wide and
    split rows, a 0-D leaf and a NaN in a split row."""
    shapes = [(50, 32), (32,), (1, 50), (), (4096, 33), (2, 9000), (7, 3, 5),
              (65536,)]
    leaves, c12s = [], [torch.tensor([1 - B1 ** t, 1 - B2 ** t], device=cuda)
                        for t in (3, 5, 2)]
    gates = [None, torch.tensor(1.0, device=cuda),
             torch.tensor(0.0, device=cuda)]
    for i, shape in enumerate(shapes):
        p, g, mq, ms, vq, vs, _c = _adam_leaf(shape, fmt, cuda, 10 + i)
        leaves.append((p, g, mq, ms, vq, vs, c12s[i % 3], gates[i % 3]))
    leaves[5][1][1, 7000] = float("nan")
    want = fa.multi_leaf_update_ref(leaves, lr=LR, b1=B1, b2=B2, eps=EPS,
                                    fmt=fmt)
    got = [(l[0].clone(), l[1], *[t.clone() for t in l[2:6]], *l[6:])
           for l in leaves]
    before = fa.FUSED_ADAM.launches
    fa.multi_leaf_update(got, lr=LR, b1=B1, b2=B2, eps=EPS, fmt=fmt)
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches == before + 2   # a split row: two passes
    assert fa.launches_per_update(shapes) == 2
    for leaf, w in zip(got, want):
        for a, b in zip((leaf[0],) + leaf[2:6], w):
            assert _same_or_both_nan(a, b)
    assert torch.isnan(got[5][3][1, 0]) and torch.isfinite(got[5][3][0, 0])


@pytest.mark.cuda
def test_fused_adam_nan_gradient_poisons_its_row(cuda):
    p, g, mq, ms, vq, vs, c12 = _adam_leaf((4, 40), "fp8", cuda, 0)
    g[2, 5] = float("nan")
    fa.leaf_update(p, g, mq, ms, vq, vs, c12, lr=LR, b1=B1, b2=B2, eps=EPS)
    torch.cuda.synchronize()
    assert torch.isnan(ms[2, 0]) and torch.isfinite(ms[[0, 1, 3], 0]).all()


@pytest.mark.cuda
def test_fused_adam_wrapper_rejects_bad_leaves_on_cuda(cuda):
    p, g, mq, ms, vq, vs, c12 = _adam_leaf((8, 16), "fp8", cuda, 0)
    before = fa.FUSED_ADAM.launches
    with pytest.raises(ValueError, match="is on"):
        fa.leaf_update(p, g.cpu(), mq, ms, vq, vs, c12, lr=LR, b1=B1, b2=B2,
                       eps=EPS)
    with pytest.raises(ValueError, match="is on"):
        fa.leaf_update(p, g, mq, ms, vq, vs, c12.cpu(), lr=LR, b1=B1, b2=B2,
                       eps=EPS)
    with pytest.raises(TypeError, match="mq must be"):
        fa.leaf_update(p, g, mq.view(torch.int8), ms, vq, vs, c12, lr=LR,
                       b1=B1, b2=B2, eps=EPS)
    with pytest.raises(ValueError, match="contiguous"):
        fa.leaf_update(p.t(), g.t(), mq, ms, vq, vs, c12, lr=LR, b1=B1,
                       b2=B2, eps=EPS)
    assert fa.FUSED_ADAM.launches == before


@pytest.mark.cuda
def test_training_step_on_cuda_matches_cpu_model(cuda):
    """The same weights take one Adam8bit step on the same batch on both
    devices (dropout off): the card through both kernels' paths, the CPU
    through the plain versions. cuBLAS and the CPU sum each product in
    another order; after one step the parameters agree within 2 lr (a
    near-zero gradient may round to the other sign) and almost all within
    1e-6."""
    def model(device):
        return MultiModN(
            50, [tenc.MIMICMLPEncoder(50, w, (32, 32), 0.0)
                 for w in (10, 1024, 768, 99)],
            [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)], 1.0, 0.0,
            seed=4, device=device)
    gpu, cpu = model(cuda), model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(0)
    X = rng.normal(size=(16, 1901)).astype(np.float32)
    X[::4, 10:1034] = np.nan
    y = (X[:, :2] > 0).astype(np.int64)
    ds = PartitionDataset(X, y, [10, 1024, 768, 99])
    before = fa.FUSED_ADAM.launches
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(ds, 16), Adam8bit(LR), "cross_entropy")
    torch.cuda.synchronize()
    shapes = [tuple(t.shape) for t in tree_leaves(gpu.params)]
    assert len(shapes) == 37 and fa.launches_per_update(shapes) == 1
    assert fa.FUSED_ADAM.launches == before + 1
    diffs = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(
        tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict()))])
    assert diffs.max() <= 2 * LR
    assert np.mean(diffs > 1e-6) < 1e-3


@pytest.mark.cuda
def test_multi_task_pipeline_on_cuda(cuda, tmp_path, monkeypatch):
    """The port's MIMIC multi-task pipeline at full width, 2 folds, 1 epoch,
    on the card: every MultiModN and HAIM parameter lives there, the results
    CSV (in this test's own storage, with its own cache) gets 2 MultiModN and
    2 HAIM rows per fold, and every AUROC is in [0, 1]. It launches neither
    K1 nor K2: the protocol trains with Adam (through K3) and tests through
    the plain chain, as the JAX package's does."""
    import csv
    from multimodn_tpu_torch.data import mimic
    from multimodn_tpu_torch.pipelines.mimic import common
    from multimodn_tpu_torch.pipelines.mimic import \
        mimic_multi_task_pipeline as multi

    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    monkeypatch.setenv("MULTIMODN_STORAGE", str(tmp_path / "store"))
    monkeypatch.setattr(mimic, "DEFAULT_CACHE_ROOT", str(tmp_path / "cache"))
    models = []
    build = common.build_modn

    def recording_build(*args, **kwargs):
        models.append(build(*args, **kwargs))
        return models[-1]

    class RecordingHAIM(common.HAIM):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            models.append(self)

    monkeypatch.setattr(common, "build_modn", recording_build)
    monkeypatch.setattr(common, "HAIM", RecordingHAIM)
    launches = (fc.FUSED_CHAIN.launches, fa.FUSED_ADAM.launches)
    rows = multi.main(["-e", "1"], common.MimicConfig(nfold=2,
                                                      synthetic_patients=40))
    assert len(rows) == 8 and len(models) == 2 + 4
    for m in models:
        assert all(t.is_cuda for t in tree_leaves(m.params))
    path = tmp_path / "store" / "nips" / "results" / \
        "mimic_multi_task_(auc + bac).csv"
    with open(path, newline="") as f:
        table = list(csv.DictReader(f))
    assert len(table) == 8
    assert all(0.0 <= float(r["auc"]) <= 1.0 for r in table)
    assert (fc.FUSED_CHAIN.launches, fa.FUSED_ADAM.launches) == launches


def _recurrent_model(device):
    return MultiModN(
        3, [tenc.LSTMEncoder(3, 4, (5,)), tenc.RNNFeatureEncoder(3, 4),
            tenc.LSTMEncoder(3, 2, (3,), "tanh", unbatched_compat=False)],
        [tdec.LogisticDecoder(3)], 0.7, 0.3, seed=2, device=device)


def _pair_step(make_model, make_optimizer, widths, steps=3):
    """The same weights take ``steps`` steps on the same batches on the
    card and on the CPU; returns the max abs parameter difference."""
    gpu, cpu = make_model("cuda"), make_model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    X = rng.normal(size=(8 * steps, sum(widths))).astype(np.float32)
    X[::5, :widths[0]] = np.nan
    y = (X[:, -1:] > 0).astype(np.int64)
    ds = PartitionDataset(X, y, list(widths))
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(ds, 8), make_optimizer(), "cross_entropy")
    for t in tree_leaves(gpu.params):
        assert t.is_cuda
    return max(float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict())))


@pytest.mark.cuda
def test_recurrent_encoders_on_cuda_match_cpu(cuda):
    """A model of LSTM and RNN encoders in both recurrence modes answers the
    same on both devices (outputs within 1e-5) and takes 3 Adam steps:
    cuBLAS and the CPU sum in other orders, and Adam may move a near-zero
    gradient's parameter by up to lr per step the other way (3 lr)."""
    gpu, cpu = _recurrent_model(cuda), _recurrent_model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(0)
    x = [rng.normal(size=(12, w)).astype(np.float32) for w in (4, 1, 2)]
    for g, c in zip(gpu.predict_proba(x), cpu.predict_proba(x)):
        np.testing.assert_allclose(g, c, rtol=0, atol=ATOL)
    err = _pair_step(_recurrent_model, lambda: Adam(0.01), (4, 1, 2))
    assert err <= 3 * 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw"])
def test_sgd_and_adamw_steps_on_cuda_match_cpu(cuda, name):
    """3 steps of each optimizer on both devices. SGD's step is linear in
    the gradient, so the parameters stay within 1e-5; AdamW's may move a
    near-zero gradient's parameter the other way by up to lr per step."""
    make = {"sgd": lambda: SGD(0.05),
            "sgd_momentum": lambda: SGD(0.05, momentum=0.9),
            "adamw": lambda: AdamW(0.01, weight_decay=0.1)}[name]

    def model(device):
        return MultiModN(5, [tenc.MLPEncoder(5, 3, (5, 5)),
                             tenc.SLPEncoder(5, 2)],
                         [tdec.LogisticDecoder(5)], 0.7, 0.3, seed=3,
                         device=device)

    err = _pair_step(model, make, (3, 2))
    assert err <= (3 * 0.01 if name == "adamw" else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["titanic_mlp", "titanic_lstm"])
def test_titanic_pipeline_on_cuda(cuda, name, tmp_path, monkeypatch):
    """One epoch of a Titanic pipeline on the card, with its results CSV:
    every parameter lives there, losses are finite, and no kernel launches
    (training and validation run the plain chain, as in the JAX
    package)."""
    import importlib
    mod = importlib.import_module(
        f"multimodn_tpu_torch.pipelines.titanic.{name}_pipeline")
    monkeypatch.setattr(mod, "__file__", str(tmp_path / f"{name}_pipeline.py"))
    launches = (fc.FUSED_CHAIN.launches, fa.FUSED_ADAM.launches)
    model, history = mod.main(["-e", "1", "-m", "false", "-y", "false",
                               "-p", "false"])
    assert all(t.is_cuda for t in tree_leaves(model.params))
    assert np.isfinite(history.loss["train"][0]).all()
    assert (tmp_path / "results" / f"{name}.csv").exists()
    assert (fc.FUSED_CHAIN.launches, fa.FUSED_ADAM.launches) == launches


@pytest.mark.cuda
def test_presence_penalty_loss_and_gradients_on_cuda_match_cpu(cuda):
    """The penalised loss (lambda 25, with injected presence dropout) and
    every gradient leaf of the MIMIC model on both devices, from the same
    weights, batch, padded tail and dropout mask: cuBLAS and the CPU sum
    each product in another order (~1e-7 relative), so the loss agrees to
    1e-6 relative and the gradients to 1e-5."""
    from multimodn_tpu_torch.core import step
    from multimodn_tpu_torch.core.losses import resolve_criterion
    from multimodn_tpu_torch.core.tree import tree_map

    def model(device):
        return MultiModN(
            50, [tenc.MIMICMLPEncoder(50, w, (32, 32), 0.0)
                 for w in (10, 1024, 768, 99)],
            [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)], 1.0, 0.5,
            seed=6, presence_dropout=0.3, presence_penalty=25.0,
            device=device)

    gpu, cpu = model(cuda), model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(2)
    X = rng.normal(size=(16, 1901)).astype(np.float32)
    X[::3, 10:1034] = np.nan
    X[1::5, 1034:1802] = np.nan
    y = (X[:, :2] > 0).astype(np.int64)
    mask = np.ones(16, np.float32)
    mask[13:] = 0.0
    drop = step.draw_presence_dropout(torch.Generator().manual_seed(0), 16,
                                      4, 0.3, "cpu")
    out = {}
    for m in (gpu, cpu):
        dev = m.device
        fn = step.make_batch_loss_fn(
            m.encoders, m.decoders, m.init_state, resolve_criterion(None),
            m.err_penalty, m.state_change_penalty,
            tuple((i, i) for i in range(4)), "sample",
            presence_dropout=0.3, presence_penalty=25.0)
        live = tree_map(lambda t: t.detach().requires_grad_(), m.params)
        data = tuple(torch.as_tensor(X[:, a:b], device=dev) for a, b in
                     ((0, 10), (10, 1034), (1034, 1802), (1802, 1901)))
        loss, _ = fn(live, data, torch.as_tensor(y, device=dev),
                     torch.as_tensor(mask, device=dev), None, 0, True,
                     drop=drop.to(dev))
        grads = torch.autograd.grad(loss, tree_leaves(live))
        out[dev.type] = (loss.item(), [g.cpu().numpy() for g in grads])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-6)
    assert len(out["cuda"][1]) == 37
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_transformer_training_on_cuda_matches_cpu(cuda):
    """A MultiModN of transformer encoders at the MIMIC transformer
    pipeline's widths (embed 128, 4 heads, 2 layers, chunk 64; sources of
    10, 1024 and 99 features) answers the same on both devices (1e-5) and
    takes 3 Adam steps with a NaN modality (Adam may move a near-zero
    gradient's parameter by up to lr per step the other way: 3 lr)."""
    widths = (10, 1024, 99)

    def model(device):
        return MultiModN(
            50, [tenc.TransformerEncoder(50, w, embed_dim=128, n_heads=4,
                                         n_layers=2, chunk=min(64, w))
                 for w in widths],
            [tdec.MLPDecoder(50, (32, 32), 2)], 1.0, 0.0, seed=2,
            device=device)

    gpu, cpu = model(cuda), model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(3)
    x = [rng.normal(size=(6, w)).astype(np.float32) for w in widths]
    for g, c in zip(gpu.predict_proba(x), cpu.predict_proba(x)):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-5)
    launches = (fc.FUSED_CHAIN.launches, fa.FUSED_ADAM.launches)
    err = _pair_step(model, lambda: Adam(1e-3), widths)
    assert err <= 3 * 1e-3
    assert (fc.FUSED_CHAIN.launches, fa.FUSED_ADAM.launches) == launches
    with pytest.raises(TypeError, match="MLP-family"):
        gpu.fused_forward(x)


def _mimic_stream_case(device, dropout=0.2):
    model = MultiModN(
        50, [tenc.MIMICMLPEncoder(50, w, (32, 32), dropout)
             for w in (10, 1024, 768, 99)],
        [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)], 1.0, 0.0,
        seed=6, device=device)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(72, 1901)).astype(np.float32)
    X[rng.random(72) < 0.3, 10:1034] = np.nan
    y = (X[:, :2] > 0).astype(np.int64)
    return model, PartitionDataset(X, y, [10, 1024, 768, 99])


def _same_bits(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x is not None:
            bits = {1: torch.uint8, 4: torch.int32}[x.element_size()]
            assert torch.equal(x.view(bits), y.view(bits))


@pytest.mark.cuda
def test_device_batches_copy_pinned_one_ahead_on_cuda(cuda):
    """Each streamed batch arrives on the card equal to its host batch, its
    copy made from a pinned buffer on a side stream that the consumer
    stream waits on."""
    from multimodn_tpu_torch.data.streaming import (StreamingLoader,
                                                    device_batches)
    _, ds = _mimic_stream_case(cuda)
    host = list(StreamingLoader(ds, 16).iter_batches())
    got = list(device_batches(StreamingLoader(ds, 16), cuda))
    assert [n for _, n in got] == [16, 16, 16, 16, 8]
    for ((data, targets, mask), _), (hd, ht, hm) in zip(got, host):
        assert data[1].is_cuda and targets.dtype == torch.int64
        for d, h in zip(data, hd):
            np.testing.assert_array_equal(d.cpu().numpy(), h)
        np.testing.assert_array_equal(mask.cpu().numpy(), hm)


@pytest.mark.cuda
def test_streamed_fit_best_on_cuda_equals_array_loader(cuda):
    """fit_best over StreamingLoaders on the card equals it over
    ArrayLoaders bit for bit (Adam8bit through K2, dropout on), one K2
    launch per step."""
    from multimodn_tpu_torch.data.streaming import (StreamingLoader,
                                                    fit_best_streaming)
    a, ds = _mimic_stream_case(cuda)
    b, _ = _mimic_stream_case(cuda)
    want = a.fit_best(ArrayLoader(ds, 16), Adam8bit(LR), epochs=3,
                      val_loader=ArrayLoader(ds, 16))
    before = fa.FUSED_ADAM.launches
    got = fit_best_streaming(b, StreamingLoader(ds, 16), Adam8bit(LR),
                             epochs=3, val_loader=StreamingLoader(ds, 16))
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches - before == 3 * 5
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_array_equal(got["scores"], want["scores"])
    _same_bits(a.params, b.params)
    _same_bits(a.opt_state, b.opt_state)


@pytest.mark.cuda
def test_fit_best_resumable_on_cuda_kill_and_resume(cuda, tmp_path):
    """Killed after its first chunk and resumed by a fresh model, the
    resumable fit on the card equals one fit_best: parameters, fp8 codes
    and scales bit for bit, K2 launched once per step taken."""
    from multimodn_tpu_torch import checkpoint

    class Interrupt(Exception):
        pass

    def bomb(done, total):
        if done == 1:
            raise Interrupt

    one, ds = _mimic_stream_case(cuda)
    want = one.fit_best(ArrayLoader(ds, 16), Adam8bit(LR), epochs=3,
                        val_loader=ArrayLoader(ds, 16), restore_best=False)
    before = fa.FUSED_ADAM.launches
    with pytest.raises(Interrupt):
        checkpoint.fit_best_resumable(
            _mimic_stream_case(cuda)[0], ArrayLoader(ds, 16), Adam8bit(LR),
            epochs=3, checkpoint_dir=str(tmp_path), val_loader=ArrayLoader(
                ds, 16), chunk_epochs=1, on_chunk=bomb)
    revived = _mimic_stream_case(cuda)[0]
    got = checkpoint.fit_best_resumable(
        revived, ArrayLoader(ds, 16), Adam8bit(LR), epochs=3,
        checkpoint_dir=str(tmp_path), val_loader=ArrayLoader(ds, 16),
        chunk_epochs=1, restore_best=False)
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches - before == 3 * 5
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_array_equal(got["scores"], want["scores"])
    _same_bits(one.params, revived.params)
    _same_bits(one.opt_state, revived.opt_state)


def _sequenced(X, y, widths, batch, seed):
    """A dataset whose every batch of ``batch`` rows carries its own
    permutation of the encoders."""
    rng = np.random.default_rng(seed)
    per_batch = [rng.permutation(len(widths))
                 for _ in range(-(-len(X) // batch))]
    seqs = np.stack([per_batch[i // batch] for i in range(len(X))])

    class Sequenced(PartitionDataset):
        def arrays(self):
            xs, t, _ = super().arrays()
            return xs, t, seqs

    return Sequenced(X, y, list(widths))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shuffle_scan", "shuffle_switch",
                                  "sequences"])
def test_encoding_orders_train_on_cuda_like_cpu(cuda, case):
    """``Adam8bit`` steps with a fresh order per batch (the scan chain for
    identical encoders, the switch chain for mixed ones; both devices draw
    the same permutations) and with per-batch dataset sequences, on the
    card and the CPU: K2 once per step, parameters within 3 lr (a
    near-zero gradient's Adam step may go the other way on either
    device)."""
    if case == "shuffle_scan":
        widths = (3, 3, 3, 3)

        def make(device):
            return MultiModN(6, [tenc.MIMICMLPEncoder(6, 3, (8,), 0.0)
                                 for _ in widths],
                             [tdec.MLPDecoder(6, (8,), 2)], 1.0, 0.3, seed=2,
                             shuffle_mode=True, device=device)
    else:
        widths = (3, 3, 3) if case == "sequences" else (3, 5, 4)

        def make(device):
            encs = [tenc.MIMICMLPEncoder(6, widths[0], (8,), 0.0),
                    tenc.MLPEncoder(6, widths[1], (8,)),
                    tenc.MIMICMLPEncoder(6, widths[2], (5,), 0.0)]
            return MultiModN(6, encs, [tdec.MLPDecoder(6, (8,), 2)], 1.0,
                             0.3, seed=2, shuffle_mode=case != "sequences",
                             device=device)
    rng = np.random.default_rng(5)
    X = rng.normal(size=(24, sum(widths))).astype(np.float32)
    X[::4, :widths[0]] = np.nan
    y = (X[:, -1:] > 0).astype(np.int64)
    ds = _sequenced(X, y, widths, 8, 6) if case == "sequences" else \
        PartitionDataset(X, y, list(widths))
    gpu, cpu = make(cuda), make("cpu")
    cpu.load_state_dict(gpu.state_dict())
    before = fa.FUSED_ADAM.launches
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(ds, 8), Adam8bit(0.01), "cross_entropy")
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches - before == 3
    err = max(float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict())))
    assert err <= 3 * 0.01


@pytest.mark.cuda
def test_featurewise_adam8bit_launches_follow_the_leaf_table(cuda):
    """A featurewise chain of 100 one-feature encoders (per-encoder storage,
    401 leaves) trained with ``shuffle_mode``: K2 launches per step equal
    ``launches_per_update`` of the leaf shapes."""
    model = MultiModN(8, [tenc.MLPFeatureEncoder(8, 4) for _ in range(100)],
                      [tdec.MLPDecoder(8, (4,), 2)], 1.0, 0.3, seed=1,
                      shuffle_mode=True, device=cuda)
    assert model._chain_plan() == ("scan", True)
    shapes = [tuple(t.shape) for t in tree_leaves(model.params)]
    per_step = fa.launches_per_update(shapes)
    assert per_step == -(-len(shapes) // fa.MAX_LEAVES) > 1
    rng = np.random.default_rng(2)
    X = rng.normal(size=(32, 100)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    y = (np.nansum(X[:, :5], 1) > 0).astype(np.int64)
    before = fa.FUSED_ADAM.launches
    model.train_epoch(ArrayLoader(PartitionDataset(X, y, [1] * 100), 16),
                      Adam8bit(0.01), "cross_entropy")
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches - before == 2 * per_step


@pytest.mark.cuda
def test_torch_objects_train_and_serve_on_cuda(cuda):
    """The drop-in surface on the card: torch Adam over ``parameters()``, a
    shuffled ``DataLoader`` and ``nn.CrossEntropyLoss()`` through
    ``train_epoch`` + ``test`` equal the port's own Adam and ArrayLoader bit
    for bit, and the model, built with ``F.relu``, serves through K1 within
    ATOL of the plain chain."""
    import torch.nn as nn
    import torch.nn.functional as F
    import torch.utils.data as tud
    rng = np.random.default_rng(4)
    X = rng.normal(size=(64, 9)).astype(np.float32)
    X[rng.random(64) < 0.3, :4] = np.nan
    y = (np.nansum(X, 1) > 0).astype(np.int64)
    ds = PartitionDataset(X, y, [4, 5])
    models = []
    for torch_objects in (True, False):
        model = MultiModN(6, [tenc.MLPEncoder(6, w, (8,), F.relu)
                              for w in (4, 5)],
                          [tdec.MLPDecoder(6, (8,), 2)], 1.0, 0.2, seed=2,
                          device=cuda)
        if torch_objects:
            opt = torch.optim.Adam(list(model.parameters()), 0.01)
            train = tud.DataLoader(ds, 16, shuffle=True)
            val, criterion = tud.DataLoader(ds, 16), nn.CrossEntropyLoss()
        else:
            opt, criterion = Adam(0.01), "cross_entropy"
            train = ArrayLoader(ds, 16, shuffle=True, seed=0)
            val = ArrayLoader(ds, 16)
        for _ in range(2):
            model.train_epoch(train, opt, criterion)
            model.test(val, criterion)
        models.append(model)
    for a, b in zip(tree_leaves(models[0].params),
                    tree_leaves(models[1].params)):
        assert torch.equal(a, b)
    xs = [X[:16, :4], X[:16, 4:]]
    before = fc.FUSED_CHAIN.launches
    states, outs = models[0].fused_forward(xs)
    torch.cuda.synchronize()
    assert fc.FUSED_CHAIN.launches > before
    want = models[0].predict_proba([np.nan_to_num(m) for m in xs])
    valid = ~np.isnan(xs[0]).any(1)
    got = outs[0].cpu().numpy()
    assert np.abs(got[:, valid] - want[0][:, valid]).max() <= ATOL


@pytest.mark.cuda
def test_adam8bit_sweep_on_cuda_equals_each_fit_best(cuda):
    """``sweep_fit_best`` with ``Adam8bit`` on the card: K2 once per step
    of every seed, and each seed bit-equal to its own ``fit_best`` (moment
    codes and scales too) on the same shuffled loader state."""
    from multimodn_tpu_torch.experiments import sweep_fit_best
    _, ds = _mimic_stream_case(cuda)

    def factory(seed):
        return MultiModN(
            50, [tenc.MIMICMLPEncoder(50, w, (32, 32), 0.2)
                 for w in (10, 1024, 768, 99)],
            [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)], 1.0, 0.0,
            seed=seed, device=cuda)

    before = fa.FUSED_ADAM.launches
    got = sweep_fit_best(factory, ArrayLoader(ds, 16, shuffle=True, seed=3),
                         ArrayLoader(ds, 16), Adam8bit(LR), epochs=2,
                         seeds=[0, 5])
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches - before == 2 * 2 * 5
    for seed, res in zip([0, 5], got):
        model = factory(seed)
        want = model.fit_best(ArrayLoader(ds, 16, shuffle=True, seed=3),
                              Adam8bit(LR), epochs=2,
                              val_loader=ArrayLoader(ds, 16))
        assert res["best_epoch"] == want["best_epoch"]
        np.testing.assert_array_equal(res["scores"], want["scores"])
        _same_bits(res["model"].params, model.params)
        _same_bits(res["model"].opt_state, model.opt_state)


@pytest.mark.cuda
def test_compiled_artifact_on_cuda_matches_k1(cuda, tmp_path):
    """A MIMIC-width artifact, exported on the CPU from a model on the card
    and loaded onto the card (the default device), answers batches of 1,
    16 and 33 with NaN rows within ATOL of K1's ``fused_forward``."""
    from multimodn_tpu_torch import export_compiled, load_compiled
    model = _model("mimic", cuda)
    run = load_compiled(export_compiled(model, str(tmp_path / "m.pt2")))
    rng = np.random.default_rng(5)
    for B in (1, 16, 33):
        xs = [rng.normal(size=(B, e.n_features)).astype(np.float32)
              for e in model.encoders]
        for m, x in enumerate(xs):
            x[rng.random(B) < 0.3] = np.nan
            x[0, m] = np.nan
        got = run(*xs)
        before = fc.FUSED_CHAIN.launches
        _states, want = model.fused_forward(xs)
        torch.cuda.synchronize()
        assert fc.FUSED_CHAIN.launches > before
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


def _resnet_leaves(device, fmt):
    """K2's leaves for one Adam8bit step of a ResNet-18 encoder (state 50):
    every weight after two plain steps with a fresh gradient, and the
    BatchNorm statistics as training gives them, with zero gradients and
    zero moments."""
    params = tenc.ResNet(state_size=50).init(torch.Generator().manual_seed(0),
                                             device)
    stats = {id(bn[k]) for bn in _bn_dicts(params) for k in ("mean", "var")}
    c12 = torch.tensor([1 - B1 ** 3, 1 - B2 ** 3], device=device)
    leaves = []
    for i, leaf in enumerate(tree_leaves(params)):
        shape = tuple(leaf.shape)
        if id(leaf) in stats:
            qdt = fa.code_dtype(fmt)
            zeros = [torch.zeros(shape, dtype=qdt, device=device),
                     torch.zeros(fa.scale_shape(shape), device=device)] * 2
            leaves.append((leaf.clone(), torch.zeros_like(leaf), *zeros, c12,
                           None))
        else:
            p, g, mq, ms, vq, vs, _c = _adam_leaf(shape, fmt, device, i)
            leaves.append((p, g, mq, ms, vq, vs, c12, None))
    return leaves, [id(leaf) in stats for leaf in tree_leaves(params)]


def _bn_dicts(params):
    yield params["stem"]["bn"]
    for blocks in params["stages"]:
        for block in blocks:
            for conv in block.values():
                yield conv["bn"]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_fused_adam_matches_plain_on_resnet_leaves(cuda, fmt):
    """One ``multi_leaf_update`` over the 102 leaves of a ResNet-18 encoder:
    4-D HWIO kernels up to (3, 3, 512, 512) (4,608 rows of 512), the 1-D
    BatchNorm leaves and the head, in 3 launches of up to 40 leaves; every
    parameter, code and scale bit-equal to the plain version, and the
    statistics (zero gradient, zero moments) left exactly as they were."""
    leaves, is_stat = _resnet_leaves(cuda, fmt)
    shapes = [tuple(leaf[0].shape) for leaf in leaves]
    assert len(shapes) == 102 and (3, 3, 512, 512) in shapes
    want = fa.multi_leaf_update_ref(leaves, lr=LR, b1=B1, b2=B2, eps=EPS,
                                    fmt=fmt)
    got = [(l[0].clone(), l[1], *[t.clone() for t in l[2:6]], *l[6:])
           for l in leaves]
    before = fa.FUSED_ADAM.launches
    fa.multi_leaf_update(got, lr=LR, b1=B1, b2=B2, eps=EPS, fmt=fmt)
    torch.cuda.synchronize()
    assert fa.FUSED_ADAM.launches - before == \
        fa.launches_per_update(shapes) == 3
    for leaf, w, orig, stat in zip(got, want, leaves, is_stat):
        for a, b in zip((leaf[0],) + leaf[2:6], w):
            assert torch.equal(_bits(a), _bits(b))
        if stat:
            assert torch.equal(_bits(leaf[0]), _bits(orig[0]))


def _cell_params(device):
    """The parameter tree of the benchmark's image-model cell
    (``mimic-cxr-resnet18``: a ResNet-18 and three MLP encoders, two
    decoders, the initial state), 133 leaves from its reference's list."""
    import json
    import os
    from benchmark.harness import weights
    from benchmark.reference import chain
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "mimic-cxr-resnet18.json")) as f:
        specs = chain.leaves(json.load(f))
    return weights.make_tree(specs, 7, device)


def _mixed_grads(params, gen):
    """Gradients whose last axis mixes magnitudes 1e-4 apart."""
    def grad(p):
        g = torch.randn(p.shape, generator=gen, device=p.device)
        if g.dim() >= 1:
            g[..., ::2] *= 1e-4
        return g
    return tree_map(grad, params)


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", [None, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_fused_adam_fp32_matches_per_leaf_update_on_cell_leaves(
        cuda, state_dtype, gated):
    """K3 through ``Adam.fused_apply`` against ``Adam.update`` followed by
    ``add_`` (the per-leaf PyTorch update on the card) over 3 steps on the
    133 leaves of the image-model cell: parameters and moments bit-equal,
    one launch a step; gated, encoder 1 is off after the first step and
    keeps its parameters and moments."""
    params = _cell_params(cuda)
    shapes = [tuple(t.shape) for t in tree_leaves(params)]
    assert len(shapes) == 133 and fa32.launches_per_update(shapes) == 1
    p_k, p_u = tree_map(torch.clone, params), tree_map(torch.clone, params)
    fused = Adam(LR, state_dtype=state_dtype)
    s_k, s_u = fused.init(p_k), fused.init(p_u)
    gen = torch.Generator(device=cuda).manual_seed(3)
    steps = [None, [1.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0]] if gated \
        else [None] * 3
    for i, gates in enumerate(steps):
        g = _mixed_grads(params, gen)
        tg = None if gates is None else torch.tensor(gates, device=cuda)
        if i == 1:
            off = [t.clone() for t in tree_leaves(
                [p_k["encoders"][1], s_k["m"]["encoders"][1],
                 s_k["v"]["encoders"][1]])]
        before = fa32.FUSED_ADAM_FP32.launches
        s_k = fused.fused_apply(g, s_k, p_k, enc_gates=tg)
        torch.cuda.synchronize()
        assert fa32.FUSED_ADAM_FP32.launches == before + 1
        upd, s_u = fused.update(g, s_u, p_u, enc_gates=tg)
        tree_map(lambda p, u: p.add_(u), p_u, upd)
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves([p_k, s_k["m"], s_k["v"]]),
                    tree_leaves([p_u, s_u["m"], s_u["v"]])):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16 if a.element_size() == 2 else torch.int32),
            b.view(torch.int16 if b.element_size() == 2 else torch.int32))
    assert s_k["t"].item() == 3.0
    if gated:
        assert [t.item() for t in s_k["t_enc"]] == [2.0, 1.0, 3.0, 3.0]
        for a, b in zip(off, tree_leaves(
                [p_k["encoders"][1], s_k["m"]["encoders"][1],
                 s_k["v"]["encoders"][1]])):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_adam_fp32_many_leaves_groups_and_ragged_ends(cuda):
    """One ``multi_leaf_update`` over 1,200 leaves (1,081 not empty: 3
    launches of up to 512)
    of three groups (ungated, gate 1, gate 0, each with its own bias
    corrections), empty, 0-D and ragged leaves, leaves off the 16-byte
    alignment (element by element), bf16 moments, and a NaN gradient:
    bit-equal to the plain version on the card, a NaN equal to any NaN."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    c12s = [torch.tensor([1 - B1 ** t, 1 - B2 ** t], device=cuda)
            for t in (3, 5, 2)]
    gates = [None, torch.tensor(1.0, device=cuda),
             torch.tensor(0.0, device=cuda)]
    sizes = [0, 1, 3, 4, 5, 4095, 4096, 4097, 9000, 37]
    for dtype in (torch.float32, torch.bfloat16):
        leaves = []
        for i in range(1200):
            n = sizes[i % len(sizes)]
            shape = () if i % 97 == 1 else (n,)
            k = 1 if shape == () else n
            # Every third leaf starts one element into its storage.
            off = 1 if i % 3 == 0 else 0
            p = torch.randn(k + off, generator=gen, device=cuda)[off:]
            m = (0.1 * torch.randn(k + off, generator=gen, device=cuda)
                 )[off:].to(dtype)
            v = torch.rand(k + off, generator=gen, device=cuda)[off:].to(
                dtype)
            g = torch.randn(k, generator=gen, device=cuda)
            leaves.append((p.reshape(shape), g.reshape(shape),
                           m.reshape(shape), v.reshape(shape), c12s[i % 3],
                           gates[i % 3]))
        leaves[8][1][100] = float("nan")
        shapes = [tuple(leaf[0].shape) for leaf in leaves]
        want = [tuple(t.clone() if torch.is_tensor(t) and j in (0, 2, 3)
                      else t for j, t in enumerate(leaf)) for leaf in leaves]
        fa32.multi_leaf_update_ref(want, lr=LR, b1=B1, b2=B2, eps=EPS)
        before = fa32.FUSED_ADAM_FP32.launches
        fa32.multi_leaf_update(leaves, lr=LR, b1=B1, b2=B2, eps=EPS)
        torch.cuda.synchronize()
        assert fa32.FUSED_ADAM_FP32.launches - before == \
            fa32.launches_per_update(shapes) == 3
        for leaf, w in zip(leaves, want):
            for j in (0, 2, 3):
                a, b = leaf[j], w[j]
                same = a.view(torch.int16 if a.element_size() == 2
                              else torch.int32) == \
                    b.view(torch.int16 if b.element_size() == 2
                           else torch.int32)
                assert bool((same | (a.isnan() & b.isnan())).all())
        assert torch.isnan(leaves[8][0][100])


@pytest.mark.cuda
def test_fused_adam_fp32_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.randn(8, 16, device=cuda)
    c12 = torch.tensor([1 - B1, 1 - B2], device=cuda)
    leaf = [p, torch.randn_like(p), torch.zeros_like(p), torch.zeros_like(p),
            c12, None]
    before = fa32.FUSED_ADAM_FP32.launches
    for at, bad, err in ((1, leaf[1].cpu(), ValueError),
                         (0, p.double(), TypeError),
                         (2, leaf[2].half(), TypeError),
                         (1, leaf[1].t(), ValueError),
                         (4, c12.cpu(), ValueError)):
        args = list(leaf)
        args[at] = bad
        with pytest.raises(err):
            fa32.multi_leaf_update([tuple(args)], lr=LR, b1=B1, b2=B2,
                                   eps=EPS)
    assert fa32.FUSED_ADAM_FP32.launches == before


@pytest.mark.cuda
def test_adam_fit_on_cuda_goes_through_k3(cuda):
    """One ``fit`` epoch of a small MIMIC-style model with ``Adam`` on the
    card: one K3 launch a step, and the parameters equal those of the same
    epoch on the CPU within 2 lr a step (the card-against-CPU tolerance of
    the other tests: a near-zero gradient may round to the other sign)."""
    def model(device):
        return MultiModN(
            8, [tenc.MIMICMLPEncoder(8, w, (16,), 0.0) for w in (3, 5)],
            [tdec.MLPDecoder(8, (16,), 2)], 1.0, 0.0, seed=5, device=device)
    gpu, cpu = model(cuda), model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    X[::5, :3] = np.nan
    y = (X[:, 3:4] > 0).astype(np.int64)
    ds = PartitionDataset(X, y, [3, 5])
    before = fa32.FUSED_ADAM_FP32.launches
    for m in (gpu, cpu):
        m.fit(ArrayLoader(ds, 16), Adam(LR), "cross_entropy", epochs=1)
    torch.cuda.synchronize()
    assert fa32.FUSED_ADAM_FP32.launches - before == 4
    diffs = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(
        tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict()))])
    assert diffs.max() <= 2 * 4 * LR


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_gemm_on_cuda_matches_the_float_form(cuda, dtype):
    """``dense_apply`` on bf16 (fp16) operands on the card runs one
    half-precision GEMM with fp32 accumulation: the entry point turned the
    reduced-precision reductions off, and the product equals the fp32
    product of the upcast operands, cast, within the two roundings' sum:
    one spacing of the half type (2**-7 relative for bf16, 2**-10 for
    fp16) plus what two fp32 summation orders can differ by, 2 K 2**-24
    times the sum of the terms' magnitudes (which dominates near 0); most
    elements are equal. Half-precision accumulation over K = 1024 would
    break that bound by orders of magnitude. The bias is added after the
    cast, in the half type."""
    from multimodn_tpu_torch.core import nn as tnn
    assert tnn.resolve_device("cuda").type == "cuda"
    assert not torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul \
        .allow_fp16_reduced_precision_reduction
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1024, 1024), generator=gen, device=cuda).to(dtype)
    w = torch.randn((1024, 256), generator=gen, device=cuda).to(dtype)
    b = torch.randn((256,), generator=gen, device=cuda).to(dtype)
    product = tnn.dense_apply({"w": w, "b": torch.zeros_like(b)}, x)
    want = torch.matmul(x.float(), w.float()).to(dtype)
    assert product.dtype == dtype
    spacing = 2.0 ** (-7 if dtype == torch.bfloat16 else -10)
    magnitude = torch.matmul(x.float().abs(), w.float().abs())
    bound = spacing * want.float().abs() + 2 * 1024 * 2.0 ** -24 * magnitude
    assert ((product.float() - want.float()).abs() <= bound).all()
    assert (product == want).float().mean() > 0.9
    assert torch.equal(tnn.dense_apply({"w": w, "b": b}, x), product + b)


@pytest.mark.cuda
def test_bf16_training_step_on_cuda_matches_cpu(cuda):
    """The MIMIC model with ``compute_dtype='bfloat16'``: one Adam8bit step
    from the same weights on the same batch on both devices. The card runs
    bf16 GEMMs and K2, the CPU the upcast products and K2's plain version;
    both accumulate in fp32 and round to bf16, so an activation may round
    to the neighbouring bf16 number, and a gradient near 0 may take
    opposite signs. The first step moves a parameter by lr * m_hat /
    sqrt(v_hat): lr in fp32, up to 1.1 lr through the fp8 codes (m rounded
    by up to 2**-4, sqrt(v) by 2**-5), so parameters agree within 2.2 lr,
    and the masters stay fp32."""
    def model(device):
        return MultiModN(
            50, [tenc.MIMICMLPEncoder(50, w, (32, 32), 0.0)
                 for w in (10, 1024, 768, 99)],
            [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)], 1.0, 0.0,
            seed=4, device=device, compute_dtype="bfloat16")
    gpu, cpu = model(cuda), model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    X = rng.normal(size=(16, 1901)).astype(np.float32)
    X[::4, 10:1034] = np.nan
    y = (X[:, :2] > 0).astype(np.int64)
    ds = PartitionDataset(X, y, [10, 1024, 768, 99])
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(ds, 16), Adam8bit(LR), "cross_entropy")
    torch.cuda.synchronize()
    assert all(p.dtype == torch.float32 for p in tree_leaves(gpu.params))
    diffs = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(
        tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict()))])
    assert diffs.max() <= 2.2 * LR


@pytest.mark.cuda
def test_resnet_model_step_on_cuda_matches_cpu(cuda):
    """A ResNet-18 (64 x 64 images, a NaN image, a padded row) beside an
    MLP encoder: one Adam step on both devices in fp32 (cuDNN and the CPU
    convolve in other orders, so a gradient near 0 may take opposite
    signs; the first step moves a parameter by at most lr, so parameters
    agree within 2 lr plus the rounding of the parameters' own update,
    < 1e-6), the statistics untouched on the card, and, before the step,
    evaluation-mode ``predict_proba`` within 1e-4."""
    def model(device):
        return MultiModN(8, [tenc.ResNet(state_size=8),
                             tenc.MLPEncoder(8, 6, (16,))],
                         [tdec.LogisticDecoder(8)], 1.0, 0.0, seed=4,
                         device=device)
    gpu, cpu = model(cuda), model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(2)

    class Images:
        img = rng.normal(size=(7, 64, 64, 3)).astype(np.float32)
        img[2, 5, 5, 0] = np.nan
        x = rng.normal(size=(7, 6)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.int64)[:, None]

        def __len__(self):
            return 7

        def arrays(self):
            return [self.img, self.x], self.y, None

    def stem_mean():
        return gpu.params["encoders"][0]["stem"]["bn"]["mean"]

    x = [Images.img[[0, 1, 3]], Images.x[[0, 1, 3]]]
    for g, c in zip(gpu.predict_proba(x), cpu.predict_proba(x)):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4)
    before = stem_mean().clone()
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(Images(), 8), Adam(LR), "cross_entropy")
    torch.cuda.synchronize()
    assert torch.equal(stem_mean(), before)
    diffs = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(
        tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict()))])
    assert diffs.max() <= 2 * LR + 1e-6


# ---------------------------------------------------------------------------
# Two ranks on the card over gloo (NCCL refuses two ranks on one device),
# started by parallel.dryrun.spawn; the rank functions live at module level
# so the ranks can import them.
# ---------------------------------------------------------------------------

def _cross_rank_rank(rank, world):
    """K2's cross-rank form on this rank's column piece of every sharded
    MIMIC leaf and of (4096, 1024), against the plain update of the whole
    leaf, sliced: mismatching elements and launches."""
    from multimodn_tpu_torch.parallel import make_mesh
    device = torch.device("cuda", 0)
    axis = make_mesh((1, world), ("data", "model"), device=device).axis(
        "model")
    gen = torch.Generator(device=device).manual_seed(5)
    shapes = [tuple(t.shape) for t in tree_leaves(_model("mimic",
                                                         device).params)]
    shapes = [s for s in shapes if s[-1] % world == 0] + [(4096, 1024)]
    whole = []
    for s in shapes:
        p = torch.randn(s, generator=gen, device=device)
        g = torch.randn(s, generator=gen, device=device) * 1e-2
        mq, ms = fa.quantize_rows(torch.randn(s, generator=gen,
                                              device=device) * 1e-2)
        vq, vs = fa.quantize_rows(torch.rand(s, generator=gen,
                                             device=device) * 1e-4)
        whole.append((p, g, mq, ms, vq, vs,
                      torch.tensor([0.1, 0.01], device=device), None))
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, fmt="fp8")
    want = fa.multi_leaf_update_ref(whole, **kw)

    def cut(t):
        k = t.shape[-1] // world
        return t[..., rank * k:(rank + 1) * k].contiguous()

    pieces = [(cut(w[0]), cut(w[1]), cut(w[2]), w[3].clone(), cut(w[4]),
               w[5].clone(), w[6], None) for w in whole]
    before = fa.FUSED_ADAM.launches
    fa.multi_leaf_update(pieces, split=[True] * len(pieces), row_group=axis,
                         **kw)
    torch.cuda.synchronize()
    def bits(t):
        return t.view(torch.uint8) if t.element_size() == 1 else \
            t.view(torch.int32)

    bad = 0
    for piece, w in zip(pieces, want):
        for a, b in ((piece[0], cut(w[0])), (piece[2], cut(w[1])),
                     (piece[3], w[2]), (piece[4], cut(w[3])),
                     (piece[5], w[4])):
            bad += int((bits(a) != bits(b)).sum())
    return bad, fa.FUSED_ADAM.launches - before, fa.launches_per_update(
        [tuple(p[0].shape) for p in pieces], [True] * len(pieces))


@pytest.mark.cuda
def test_fused_adam_cross_rank_form_matches_plain_on_two_ranks(cuda):
    """Two ranks on the card: each updates its column piece of the sharded
    MIMIC leaves and of (4096, 1024) through the kernel's cross-rank form
    (rows split across the ranks, the absmax a MAX over them), bit-equal
    to the plain update of the whole leaf, sliced."""
    from multimodn_tpu_torch.parallel.dryrun import spawn
    for bad, launches, want in spawn(_cross_rank_rank, 2, "gloo", "cuda:0"):
        assert bad == 0
        assert launches == want == 2


def _cross_rank_resnet_rank(rank, world):
    """K2's cross-rank form on one optimizer step of a ResNet-18 encoder's
    102 leaves (state 50) on a model axis of ``world``: the BatchNorm
    vectors and the head split (this rank's columns), the 4-D kernels whole
    in the same call, against the plain update of the whole leaves, sliced:
    mismatching elements, launches and the leaf table's launches."""
    from multimodn_tpu_torch.parallel import make_mesh
    from multimodn_tpu_torch.parallel.sharding import leaf_spec
    device = torch.device("cuda", 0)
    mesh = make_mesh((1, world), ("data", "model"), device=device)
    axis = mesh.axis("model")
    gen = torch.Generator(device=device).manual_seed(7)
    shapes = [tuple(t.shape) for t in tree_leaves(tenc.ResNet(
        state_size=50).init(torch.Generator().manual_seed(0)))]
    split = [leaf_spec(s, mesh).split_dim() is not None for s in shapes]
    whole = []
    for s in shapes:
        p = torch.randn(s, generator=gen, device=device)
        g = torch.randn(s, generator=gen, device=device) * 1e-2
        mq, ms = fa.quantize_rows(torch.randn(s, generator=gen,
                                              device=device) * 1e-2)
        vq, vs = fa.quantize_rows(torch.rand(s, generator=gen,
                                             device=device) * 1e-4)
        whole.append((p, g, mq, ms, vq, vs,
                      torch.tensor([0.1, 0.01], device=device), None))
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, fmt="fp8")
    want = fa.multi_leaf_update_ref(whole, **kw)

    def cut(t):
        k = t.shape[-1] // world
        return t[..., rank * k:(rank + 1) * k].contiguous()

    pieces = [(cut(w[0]), cut(w[1]), cut(w[2]), w[3].clone(), cut(w[4]),
               w[5].clone(), w[6], None) if c else
              (w[0].clone(), w[1], w[2].clone(), w[3].clone(), w[4].clone(),
               w[5].clone(), w[6], None) for w, c in zip(whole, split)]
    before = fa.FUSED_ADAM.launches
    fa.multi_leaf_update(pieces, split=split, row_group=axis, **kw)
    torch.cuda.synchronize()

    def bits(t):
        return t.view(torch.uint8) if t.element_size() == 1 else \
            t.view(torch.int32)

    bad = 0
    for piece, w, c in zip(pieces, want, split):
        take = cut if c else (lambda t: t)
        for a, b in ((piece[0], take(w[0])), (piece[2], take(w[1])),
                     (piece[3], w[2]), (piece[4], take(w[3])),
                     (piece[5], w[4])):
            bad += int((bits(a) != bits(b)).sum())
    return bad, sum(split), fa.FUSED_ADAM.launches - before, \
        fa.launches_per_update([tuple(p[0].shape) for p in pieces], split)


@pytest.mark.cuda
def test_fused_adam_cross_rank_form_on_resnet_leaves(cuda):
    """Two ranks on the card, one optimizer step of a ResNet-18's 102
    leaves in one call: the split BatchNorm vectors (narrower than a block's
    lanes) and head through the kernel's cross-rank form beside whole 4-D
    kernels, bit-equal to the plain update of the whole leaves, sliced;
    launches as the leaf table says (two per group of 40 leaves)."""
    from multimodn_tpu_torch.parallel.dryrun import spawn
    for bad, n_split, launches, want in spawn(_cross_rank_resnet_rank, 2,
                                              "gloo", "cuda:0"):
        assert bad == 0
        assert n_split > 40
        assert launches == want == 6


def _dp_step_rank(rank, world, shape):
    """One training epoch of 2 batches of 16 with ``Adam`` on the MIMIC
    model (dropout 0.2) on a data mesh of ``shape`` (None: mesh-free) on the
    card; returns the loss grids and the whole parameters."""
    from multimodn_tpu_torch import MultiModNHistory
    from multimodn_tpu_torch.parallel import make_mesh
    mesh = None if shape is None else make_mesh(shape, ("data",),
                                                device="cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    X = rng.normal(size=(32, 1901)).astype(np.float32)
    X[rng.random(32) < 0.3, 10:1034] = np.nan
    y = (np.nan_to_num(X[:, :8]).sum(1, keepdims=True) > 0).astype(np.int64)
    y = np.concatenate([y, 1 - y], axis=1)
    encs = [tenc.MIMICMLPEncoder(50, w, (32, 32)) for w in (10, 1024, 768,
                                                           99)]
    decs = [tdec.MLPDecoder(50, (32, 32), 2) for _ in range(2)]
    model = MultiModN(50, encs, decs, 1.0, 0.0,
                      device="cuda:0" if mesh is None else None, mesh=mesh)
    h = MultiModNHistory(["a", "b"])
    model.train_epoch(ArrayLoader(PartitionDataset(
        X, y, [10, 1024, 768, 99]), 16), Adam(1e-3), "cross_entropy", h)
    return np.asarray(h.loss["train"][0]), model.state_dict()


@pytest.mark.cuda
def test_two_rank_data_parallel_step_matches_one_rank(cuda):
    """A 2-rank data-parallel epoch on the card (each rank 8 rows of every
    batch, dropout drawn at the global batch shape) against the mesh-free
    epoch: loss grids within rtol 1e-5 (the gradient sums of two ranks in
    another order), parameters within 2 lr (Adam's first steps move a
    parameter by ~lr times the sign of its gradient, which a near-zero
    gradient may round to either side); the ranks' replicas bit-equal."""
    from multimodn_tpu_torch.parallel.dryrun import spawn
    one = spawn(_dp_step_rank, 1, "gloo", "cuda:0", None)[0]
    two = spawn(_dp_step_rank, 2, "gloo", "cuda:0", (2,))
    np.testing.assert_allclose(two[0][0], one[0], rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(two[0][1]), tree_leaves(one[1])):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    for a, b in zip(tree_leaves(two[0][1]), tree_leaves(two[1][1])):
        np.testing.assert_array_equal(a, b)
