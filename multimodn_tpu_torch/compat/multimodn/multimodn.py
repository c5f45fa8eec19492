"""Reference path ``multimodn/multimodn.py``: the model and the metric
helpers."""
from multimodn_tpu_torch import compat
from multimodn_tpu_torch.core.metrics import (  # noqa: F401
    compute_metrics,
    get_performance_metrics,
    performance_metrics,
)
from multimodn_tpu_torch.model import MultiModN as _MultiModN


class MultiModN(_MultiModN):
    """The port's ``MultiModN``. A reference body builds it without a
    device; it then runs on the device ``compat.reference_paths`` names (the
    card by default)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=compat.default_device()
                         if device is None else device, **kwargs)
