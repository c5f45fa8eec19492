"""Reference path ``multimodn/state.py``."""
from multimodn_tpu_torch.core.state import (  # noqa: F401
    InitState,
    StaticInitState,
    TrainableInitState,
)
