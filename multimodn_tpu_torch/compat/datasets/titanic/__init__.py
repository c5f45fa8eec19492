"""Reference path ``datasets/titanic``."""
from multimodn_tpu_torch.data.titanic import (  # noqa: F401
    TitanicDataset,
    titanic_preprocessing,
)
