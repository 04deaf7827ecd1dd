"""Multi-device training over ``torch.distributed`` (port of
gcnbmp_tpu/parallel/, all but ``commbudget``): process groups and device
meshes (``mesh``), data plus tensor parallelism for the padded predictor
(``dp``), graph-sharded training over the packed layouts, wire-compact
COO or dense (``edgeshard``), the collectives they differentiate through
(``collectives``) and multi-host bring-up (``multihost``).  One process
drives one device: NCCL between cards, gloo between CPU processes.
"""

from gcnbmp_tpu_torch.parallel.mesh import (
    batch_sharding, make_mesh, replicated)
from gcnbmp_tpu_torch.parallel.dp import make_sharded_train_step, shard_params

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "make_sharded_train_step",
    "shard_params",
]
