"""MultiModN on PyTorch and CUDA: the port of ``multimodn_tpu`` to one
NVIDIA H100.

The JAX package stays the reference; this package imports ``torch`` and
numpy only, never JAX and nothing of ``multimodn_tpu``. Module names mirror
the JAX package's. Entry points run on CUDA unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written kernel or raises.

Ported so far: the MLP-family encoders, dense decoders, init states, the
unrolled fusion chain, ``MultiModN`` inference (``predict``,
``predict_proba``, ``fused_forward`` through ``csrc/fused_chain.cu``) and
training (``train_epoch``, ``test``, ``fit``, ``fit_best``) with ``Adam`` and
``Adam8bit`` (whose update is ``csrc/fused_adam.cu``), ``ArrayLoader``,
``MultiModNHistory``, ``InferenceSession`` and ``export_model`` /
``load_model``; and the MIMIC experiment protocol without pandas or
scikit-learn: ``data.mimic`` / ``data.synth`` / ``data.kfold``, the HAIM
baseline (``baselines``), ``experiments.kfold_fit_best``, ``checkpoint``
and the three MIMIC pipelines (``pipelines.mimic``).
"""
from multimodn_tpu_torch.convert import opt_state_from_jax, params_from_jax
from multimodn_tpu_torch.core.history import MultiModNHistory
from multimodn_tpu_torch.core.state import (
    InitState,
    StaticInitState,
    TrainableInitState,
)
from multimodn_tpu_torch.model import MultiModN
from multimodn_tpu_torch.optim import Adam, Adam8bit, Optimizer
from multimodn_tpu_torch.serving import (
    InferenceSession,
    export_model,
    load_model,
)

__version__ = "0.1.0"

__all__ = [
    "MultiModN",
    "MultiModNHistory",
    "InitState",
    "TrainableInitState",
    "StaticInitState",
    "Optimizer",
    "Adam",
    "Adam8bit",
    "InferenceSession",
    "export_model",
    "load_model",
    "params_from_jax",
    "opt_state_from_jax",
]
