"""MultiModN on PyTorch and CUDA: the port of ``multimodn_tpu`` to one
NVIDIA H100.

The JAX package stays the reference; this package imports ``torch`` and
numpy only, never JAX and nothing of ``multimodn_tpu``. Module names mirror
the JAX package's. Entry points run on CUDA unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written kernel or raises.

Ported so far: the MLP-family, SLP and recurrent (LSTM, RNN) encoders,
dense decoders, init states, the unrolled fusion chain, ``MultiModN``
inference (``predict``, ``predict_proba``, ``fused_forward`` through
``csrc/fused_chain.cu``, ``get_states``), training (``train_epoch``,
``test``, ``fit``, ``fit_best``) with ``Adam``, ``Adam8bit`` (whose update
is ``csrc/fused_adam.cu``), ``SGD`` and ``AdamW``, ``ArrayLoader``,
``MultiModNHistory``, ``InferenceSession``, ``export_model`` /
``load_model`` and pickled models; the MIMIC experiment protocol
(``data.mimic`` / ``data.synth`` / ``data.kfold``, the HAIM baseline in
``baselines``, ``experiments.kfold_fit_best``, ``checkpoint``, the three
MIMIC pipelines in ``pipelines.mimic``) and the Titanic data and six
Titanic pipelines (``data.titanic``, ``pipelines.titanic``), without pandas
or scikit-learn; resumable fits (``checkpoint.fit_resumable``,
``fit_best_resumable``, ``CheckpointManager``) and the streaming and disk
loaders (``data.streaming``, ``data.disk`` over the native reader of
``data.native``), which the MIMIC pipelines' ``resume_dir`` and
``stream_folds`` use; the drop-in torch surface: torch ``Adam`` /
``AdamW`` / ``SGD``, loss modules and ``DataLoader`` at every entry point
(``interop``), ``MultiModN.parameters()``, and the reference's import paths
(``multimodn.*``, ``datasets.*``, ``pipelines.utils``) under
``compat.reference_paths`` / ``compat.run_script``.
"""
from multimodn_tpu_torch.convert import opt_state_from_jax, params_from_jax
from multimodn_tpu_torch.core.history import MultiModNHistory
from multimodn_tpu_torch.core.losses import CrossEntropyLoss, \
    cross_entropy_loss
from multimodn_tpu_torch.core.metrics import get_performance_metrics, \
    performance_metrics
from multimodn_tpu_torch.core.state import (
    InitState,
    StaticInitState,
    TrainableInitState,
)
from multimodn_tpu_torch.model import MultiModN
from multimodn_tpu_torch.optim import SGD, Adam, Adam8bit, AdamW, Optimizer
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
    "cross_entropy_loss",
    "CrossEntropyLoss",
    "get_performance_metrics",
    "performance_metrics",
    "Optimizer",
    "Adam",
    "Adam8bit",
    "AdamW",
    "SGD",
    "InferenceSession",
    "export_model",
    "load_model",
    "params_from_jax",
    "opt_state_from_jax",
]
