"""Reference path ``multimodn``: the model, its history and init states."""
from multimodn_tpu_torch.compat.multimodn.multimodn import MultiModN
from multimodn_tpu_torch.core.history import MultiModNHistory
from multimodn_tpu_torch.core.state import (
    InitState,
    StaticInitState,
    TrainableInitState,
)

__all__ = ["MultiModN", "MultiModNHistory", "InitState",
           "TrainableInitState", "StaticInitState"]
