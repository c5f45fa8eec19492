from multimodn_tpu_torch.data.dataset import (
    MultiModDataset,
    PartitionDataset,
    Subset,
)
from multimodn_tpu_torch.data.loader import ArrayLoader
from multimodn_tpu_torch.data.mimic import MIMICDataset

__all__ = ["MultiModDataset", "PartitionDataset", "Subset", "ArrayLoader",
           "MIMICDataset"]
