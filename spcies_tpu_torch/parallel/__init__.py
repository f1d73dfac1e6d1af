"""Scenario-batch scale-out: meshes of devices, per-shard solves and fleet
metrics, in one process (mesh) and over torch.distributed (distributed).
Port of spcies_tpu/parallel/."""

from spcies_tpu_torch.parallel.mesh import (
    Mesh,
    batch_mesh,
    shard_batch,
    sharded_solver,
    fleet_metrics,
)
from spcies_tpu_torch.parallel.distributed import (
    initialize,
    is_distributed,
    host_chip_mesh,
    batch_spec,
    from_process_local,
    shard_map_solver,
    global_fleet_metrics,
)

__all__ = ["batch_mesh", "shard_batch", "sharded_solver", "fleet_metrics",
           "initialize", "is_distributed", "host_chip_mesh", "batch_spec",
           "from_process_local", "shard_map_solver",
           "global_fleet_metrics", "Mesh"]
