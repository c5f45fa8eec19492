"""Reference path ``datasets/mimic``."""
from multimodn_tpu_torch.data.mimic import (  # noqa: F401
    MIMICDataset,
    load_mimic_data,
    source_dict,
    source_names,
    source_size,
)
