"""Reference path ``multimodn/encoders/mlp_encoder.py``."""
from multimodn_tpu_torch.encoders import (  # noqa: F401
    MIMIC_MLPEncoder,
    MIMICMLPEncoder,
    MLPEncoder,
    MLPFeatureEncoder,
)
