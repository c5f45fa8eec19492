"""Reference path ``multimodn/decoders/multimod_decoder.py``."""
from multimodn_tpu_torch.decoders.base import MultiModDecoder  # noqa: F401
