from multimodn_tpu_torch.decoders.base import MultiModDecoder
from multimodn_tpu_torch.decoders.decoders import (
    ClassDecoder,
    LogisticDecoder,
    MLPDecoder,
)

__all__ = ["MultiModDecoder", "ClassDecoder", "LogisticDecoder", "MLPDecoder"]
