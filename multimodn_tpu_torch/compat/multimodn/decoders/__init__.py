"""Reference path ``multimodn/decoders``."""
from multimodn_tpu_torch.decoders import *  # noqa: F401,F403
from multimodn_tpu_torch.decoders import __all__  # noqa: F401
