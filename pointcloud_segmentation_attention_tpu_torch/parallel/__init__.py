"""Data parallelism of the port: meshes, the data-parallel step context,
rank processes, multi-host initialisation and counted collectives."""
from pointcloud_segmentation_attention_tpu_torch.parallel.collectives import (
    collective_stats,
    reset_collective_stats,
)
from pointcloud_segmentation_attention_tpu_torch.parallel.dist import (
    host_shard,
    initialize_distributed,
    node_count,
    node_index,
)
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import (
    Mesh,
    RankPool,
    World,
    active_mesh,
    all_reduce_gradients,
    check_world,
    data_parallel,
    enter_world,
    lane_replicas,
    local_mesh,
    make_mesh,
    replicate,
    shard_batch,
    spawn,
)

__all__ = [
    "Mesh",
    "RankPool",
    "World",
    "active_mesh",
    "all_reduce_gradients",
    "check_world",
    "collective_stats",
    "data_parallel",
    "enter_world",
    "host_shard",
    "initialize_distributed",
    "lane_replicas",
    "local_mesh",
    "make_mesh",
    "node_count",
    "node_index",
    "replicate",
    "reset_collective_stats",
    "shard_batch",
    "spawn",
]
