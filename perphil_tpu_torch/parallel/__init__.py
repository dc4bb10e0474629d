"""Parallelism: device meshes over ``torch.distributed`` ranks, sharded
solves, explicit halo exchange, the multi-process runtime (counterpart of
``perphil_tpu/parallel``)."""

from perphil_tpu_torch.parallel.distributed import (
    global_device_mesh,
    initialize_from_env,
    is_initialized,
)
from perphil_tpu_torch.parallel.sharding import (
    device_mesh,
    field_spec,
    shard_grid,
    shard_stacked,
    sharded_solve_dpp,
)

__all__ = [
    "device_mesh",
    "field_spec",
    "global_device_mesh",
    "initialize_from_env",
    "is_initialized",
    "shard_grid",
    "shard_stacked",
    "sharded_solve_dpp",
]
