"""The fused-chain CUDA kernel against its plain PyTorch version, on a GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports neither JAX nor the JAX package, so it runs on a GPU machine
that has neither, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: the kernel sums each dot product with fp32 FMAs in k order and
cuBLAS's fp32 GEMM in its own order; over K <= 1074 that moves a sum by
~1e-6, carried through up to 4 chained encoders and 3 decoder layers.
atol 1e-4 leaves ~100x headroom and still catches indexing or masking
faults, which give O(0.1) errors.
"""
import numpy as np
import pytest
import torch

from multimodn_tpu_torch import MultiModN
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
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
}


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("B", [1, 33, 1000])
def test_kernel_matches_plain(cuda, case, B):
    model = _model(case, cuda)
    spec = fc.ChainSpec(model.encoders, model.decoders, model.state_size)
    gen = torch.Generator(device=cuda).manual_seed(B)
    data = [torch.randn((B, e.n_features), generator=gen, device=cuda)
            for e in model.encoders]
    valid = (torch.rand((B, len(data)), generator=gen, device=cuda)
             >= 0.3).float()
    init = model.params["init_state"]["value"][0].contiguous()
    before = fc.FUSED_CHAIN.launches
    got = fc.fused_chain_forward(spec, model.params, data, valid, init)
    want = fc.fused_chain_forward_ref(spec, model.params, data, valid, init)
    torch.cuda.synchronize()
    assert fc.FUSED_CHAIN.launches == before + 1
    _close(got, want)


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
