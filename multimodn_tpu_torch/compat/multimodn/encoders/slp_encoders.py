"""Reference path ``multimodn/encoders/slp_encoders.py``."""
from multimodn_tpu_torch.encoders import (  # noqa: F401
    LinearEncoder,
    LogisticEncoder,
    SLPEncoder,
)
