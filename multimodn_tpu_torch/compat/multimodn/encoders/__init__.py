"""Reference path ``multimodn/encoders``."""
from multimodn_tpu_torch.encoders import *  # noqa: F401,F403
from multimodn_tpu_torch.encoders import __all__  # noqa: F401
