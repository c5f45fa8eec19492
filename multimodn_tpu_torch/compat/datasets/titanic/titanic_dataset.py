"""Reference path ``datasets/titanic/titanic_dataset.py``."""
from multimodn_tpu_torch.data.titanic import (  # noqa: F401
    TitanicDataset,
    titanic_preprocessing,
)
