"""Reference path ``multimodn/history.py``."""
from multimodn_tpu_torch.core.history import (  # noqa: F401
    MultiModNHistory,
    display_title,
)
