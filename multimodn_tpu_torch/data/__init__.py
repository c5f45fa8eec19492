from multimodn_tpu_torch.data.dataset import (
    FeatureWiseDataset,
    JointDatasets,
    MultiModDataset,
    PartitionDataset,
    Subset,
    split_into_partition_datasets,
)
from multimodn_tpu_torch.data.loader import ArrayLoader
from multimodn_tpu_torch.data.mimic import MIMICDataset
from multimodn_tpu_torch.data.titanic import TitanicDataset

__all__ = ["MultiModDataset", "PartitionDataset", "FeatureWiseDataset",
           "JointDatasets", "Subset", "split_into_partition_datasets",
           "ArrayLoader", "MIMICDataset", "TitanicDataset"]
