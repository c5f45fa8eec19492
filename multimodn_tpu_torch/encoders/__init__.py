from multimodn_tpu_torch.encoders.attention import (
    TransformerEncoder,
    ViTEncoder,
)
from multimodn_tpu_torch.encoders.base import MultiModEncoder
from multimodn_tpu_torch.encoders.mlp import (
    MIMICMLPEncoder,
    MIMIC_MLPEncoder,
    MLPEncoder,
    MLPFeatureEncoder,
)
from multimodn_tpu_torch.encoders.recurrent import (
    LSTMEncoder,
    LSTMFeatureEncoder,
    RNNEncoder,
    RNNFeatureEncoder,
)
from multimodn_tpu_torch.encoders.resnet import ResNet
from multimodn_tpu_torch.encoders.slp import (
    LinearEncoder,
    LogisticEncoder,
    SLPEncoder,
)

__all__ = [
    "MultiModEncoder",
    "MLPEncoder",
    "MLPFeatureEncoder",
    "MIMICMLPEncoder",
    "MIMIC_MLPEncoder",
    "SLPEncoder",
    "LinearEncoder",
    "LogisticEncoder",
    "LSTMEncoder",
    "RNNEncoder",
    "LSTMFeatureEncoder",
    "RNNFeatureEncoder",
    "ResNet",
    "TransformerEncoder",
    "ViTEncoder",
]
