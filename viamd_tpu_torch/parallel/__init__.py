"""Multi-device evaluation on torch.distributed.

Counterpart of viamd_tpu/parallel: the reference's single-node
parallelism (frame-range tasks, main.cpp:981-985, and atom-range tasks,
viamd.cpp:1712) as a mesh of ranks, one process and one device each:
frames shard over the "frames" axis, the cell-list RDF's A rows over the
"atoms" axis, and accumulators are summed across. `launch.spawn` starts
the ranks; `dryrun.dryrun_multichip` drives every sharded path.
"""

from viamd_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    frames_mesh,
    mesh_devices,
    replicated,
    shard_batch,
)

__all__ = ["Mesh", "current_mesh", "frames_mesh", "mesh_devices", "replicated", "shard_batch"]
