"""Reference path ``multimodn/encoders/lstm_encoder.py``."""
from multimodn_tpu_torch.encoders import (  # noqa: F401
    LSTMEncoder,
    LSTMFeatureEncoder,
)
