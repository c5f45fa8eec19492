"""Reference path ``multimodn/decoders/decoders.py``."""
from multimodn_tpu_torch.decoders import (  # noqa: F401
    ClassDecoder,
    LogisticDecoder,
    MLPDecoder,
)
