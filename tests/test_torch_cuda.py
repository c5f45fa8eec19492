"""The CUDA kernels against their plain PyTorch versions, on a GPU: the
fused chain (K1, at the MIMIC, small and Titanic shapes) and the fused
8-bit Adam update (K2); the card against the CPU for training, the
recurrent encoders, ``SGD`` and ``AdamW``, and two Titanic pipelines; and
streamed batches (pinned, copied one ahead) and a killed and resumed
``Adam8bit`` fit on the card, bit-equal to their ArrayLoader and
uninterrupted twins; shuffled and sequenced training on the card against
the CPU, and K2's launches at a featurewise chain's leaf count; torch
objects (optimizer, ``DataLoader``, loss) training on the card bit-equal to
the port's own, and their ``F.relu`` model served through K1.

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
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
from multimodn_tpu_torch.ops import fused_adam as fa
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
    torch.backends.cuda.matmul.allow_tf32 = False
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
    kernel: the protocol trains with Adam and tests through the plain chain,
    as the JAX package's does."""
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
