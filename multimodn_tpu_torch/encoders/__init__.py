from multimodn_tpu_torch.encoders.base import MultiModEncoder
from multimodn_tpu_torch.encoders.mlp import (
    MIMICMLPEncoder,
    MIMIC_MLPEncoder,
    MLPEncoder,
    MLPFeatureEncoder,
)

__all__ = [
    "MultiModEncoder",
    "MLPEncoder",
    "MLPFeatureEncoder",
    "MIMICMLPEncoder",
    "MIMIC_MLPEncoder",
]
