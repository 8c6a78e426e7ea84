"""Meshes over ranks, component placement, sharding rules, collectives and
weight sync: the port of ``rlinf_tpu/parallel/`` on ``torch.distributed``
(one process per device, explicit collectives), with the context axis
(``ops/ring_attention.py``), the expert axis (``ops.moe``, the sized
``collectives.all_to_all``), the dynamic scheduler with its state
migration (``dynamic_scheduler``) and named channels (``channel``)."""

from rlinf_tpu_torch.parallel.channel import Channel
from rlinf_tpu_torch.parallel.dynamic_scheduler import (
    DynamicScheduler,
    Migration,
    StandbyMigrator,
    migrate_sharded_state,
    reshard_delta,
    submesh,
)

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
    "Channel",
    "DynamicScheduler",
    "Migration",
    "StandbyMigrator",
    "migrate_sharded_state",
    "reshard_delta",
    "submesh",
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
