"""Reference path ``pipelines/utils.py``: the pipelines' command line."""
from multimodn_tpu_torch.pipelines.utils import (  # noqa: F401
    extract_pipeline_name,
    get_display_name,
    get_logger,
    parse_args,
    string_to_bool,
)
