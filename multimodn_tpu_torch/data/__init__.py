from multimodn_tpu_torch.data.dataset import (
    FeatureWiseDataset,
    JointDatasets,
    MultiModDataset,
    PartitionDataset,
    Subset,
    split_into_partition_datasets,
)
from multimodn_tpu_torch.data.disk import (
    CSVStreamingLoader,
    NpyStreamingLoader,
    export_streaming_matrix,
)
from multimodn_tpu_torch.data.loader import ArrayLoader, DataLoader
from multimodn_tpu_torch.data.mimic import MIMICDataset, load_mimic_data
from multimodn_tpu_torch.data.streaming import (
    StreamingLoader,
    TorchStreamingLoader,
    fit_best_streaming,
    fit_streaming,
    predict_proba_streaming,
    predict_streaming,
    test_epoch_streaming,
    train_epoch_streaming,
)
from multimodn_tpu_torch.data.titanic import TitanicDataset, \
    titanic_preprocessing

__all__ = ["MultiModDataset", "PartitionDataset", "FeatureWiseDataset",
           "JointDatasets", "Subset", "split_into_partition_datasets",
           "ArrayLoader", "DataLoader", "MIMICDataset", "load_mimic_data",
           "TitanicDataset", "titanic_preprocessing",
           "StreamingLoader", "TorchStreamingLoader", "CSVStreamingLoader",
           "NpyStreamingLoader", "export_streaming_matrix",
           "fit_best_streaming", "fit_streaming", "predict_proba_streaming",
           "predict_streaming", "test_epoch_streaming",
           "train_epoch_streaming"]
