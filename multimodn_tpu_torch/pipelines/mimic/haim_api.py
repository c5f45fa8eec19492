"""HAIM parallel-fusion baseline at the pipeline-local import point of the
reference layout (PyTorch twin of ``pipelines/mimic/haim_api.py``). The
implementation lives in ``multimodn_tpu_torch.baselines.haim``."""
from multimodn_tpu_torch.baselines.haim import HAIM, HAIMDecoder  # noqa: F401
from multimodn_tpu_torch.core.metrics import get_performance_metrics  # noqa: F401
