"""Reference path ``multimodn/encoders/resnet_encoder.py``."""
from multimodn_tpu_torch.encoders import ResNet  # noqa: F401
