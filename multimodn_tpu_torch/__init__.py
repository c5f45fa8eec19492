"""MultiModN on PyTorch and CUDA: the port of ``multimodn_tpu`` to one
NVIDIA H100.

The JAX package stays the reference; this package imports ``torch`` and
numpy only, never JAX and nothing of ``multimodn_tpu``. Module names mirror
the JAX package's. Entry points run on CUDA unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written kernel or raises.

This slice ports the serving path: the MLP-family encoders, dense decoders,
init states, the unrolled fusion chain, ``MultiModN`` inference
(``predict``, ``predict_proba``, ``fused_forward``), ``InferenceSession``,
``export_model`` / ``load_model``, and the fused-chain kernel
(``csrc/fused_chain.cu``). Training comes with the next slice.
"""
from multimodn_tpu_torch.convert import params_from_jax
from multimodn_tpu_torch.core.state import (
    InitState,
    StaticInitState,
    TrainableInitState,
)
from multimodn_tpu_torch.model import MultiModN
from multimodn_tpu_torch.serving import (
    InferenceSession,
    export_model,
    load_model,
)

__version__ = "0.1.0"

__all__ = [
    "MultiModN",
    "InitState",
    "TrainableInitState",
    "StaticInitState",
    "InferenceSession",
    "export_model",
    "load_model",
    "params_from_jax",
]
