"""Reference path ``multimodn/encoders/rnn_encoder.py``."""
from multimodn_tpu_torch.encoders import (  # noqa: F401
    RNNEncoder,
    RNNFeatureEncoder,
)
