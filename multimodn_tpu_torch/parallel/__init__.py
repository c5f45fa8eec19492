"""Multi-device training over ``torch.distributed`` (PyTorch twin of
``multimodn_tpu/parallel``): one process per device, a ``Mesh`` of ranks
(``mesh``), placement rules (``sharding``), the explicit-collective step
(``dp_step``) and a multi-process launcher with a dry run (``dryrun``)."""
from multimodn_tpu_torch.parallel.mesh import make_mesh
from multimodn_tpu_torch.parallel.sharding import (
    batch_sharding,
    replicate,
    shard_opt_state,
    shard_params,
)

__all__ = ["make_mesh", "batch_sharding", "replicate", "shard_params",
           "shard_opt_state"]
