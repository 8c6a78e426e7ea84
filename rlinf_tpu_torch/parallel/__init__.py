"""Meshes over ranks, component placement, sharding rules, collectives and
weight sync: the port of ``rlinf_tpu/parallel/`` on ``torch.distributed``
(one process per device, explicit collectives), with the context axis
(``ops/ring_attention.py``). Expert parallelism, ``dynamic_scheduler`` and
``channel`` are not ported yet (ROADMAP.md §A.9b.3-5)."""

from rlinf_tpu_torch.parallel.mesh import (
    AxisNames,
    ComponentPlacement,
    Mesh,
    MeshConfig,
    PlacementMode,
    current_mesh,
    make_mesh,
    use_mesh,
)
from rlinf_tpu_torch.parallel.sharding import (
    P,
    PartitionRules,
    logical_to_mesh_axes,
    match_partition_rules,
    shard_pytree,
)

__all__ = [
    "AxisNames",
    "ComponentPlacement",
    "Mesh",
    "MeshConfig",
    "PlacementMode",
    "current_mesh",
    "make_mesh",
    "use_mesh",
    "P",
    "PartitionRules",
    "logical_to_mesh_axes",
    "match_partition_rules",
    "shard_pytree",
]
