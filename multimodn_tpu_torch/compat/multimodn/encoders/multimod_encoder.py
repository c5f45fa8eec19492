"""Reference path ``multimodn/encoders/multimod_encoder.py``."""
from multimodn_tpu_torch.encoders.base import MultiModEncoder  # noqa: F401
