"""Reference path ``datasets/multimod_dataset.py``."""
from multimodn_tpu_torch.data.dataset import (  # noqa: F401
    FeatureWiseDataset,
    JointDatasets,
    MultiModDataset,
    PartitionDataset,
    Subset,
)
