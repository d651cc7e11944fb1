"""Data and tensor parallelism of the port: meshes (1-D data, 2-D data x
model), the data-parallel and tensor-parallel step contexts, rank
processes, multi-host initialisation and counted collectives."""
from pointcloud_segmentation_attention_tpu_torch.parallel.act_sharding import (
    activation_sharding,
    constrain_channels,
)
from pointcloud_segmentation_attention_tpu_torch.parallel.collectives import (
    collective_stats,
    full_kernel_allgathers,
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
from pointcloud_segmentation_attention_tpu_torch.parallel.tp import (
    make_mesh_2d,
    model_parallel,
    shard_state,
    state_sharding,
    unshard_state,
)

__all__ = [
    "Mesh",
    "RankPool",
    "World",
    "activation_sharding",
    "active_mesh",
    "all_reduce_gradients",
    "check_world",
    "collective_stats",
    "constrain_channels",
    "data_parallel",
    "enter_world",
    "full_kernel_allgathers",
    "host_shard",
    "initialize_distributed",
    "lane_replicas",
    "local_mesh",
    "make_mesh",
    "make_mesh_2d",
    "model_parallel",
    "node_count",
    "node_index",
    "replicate",
    "reset_collective_stats",
    "shard_batch",
    "shard_state",
    "spawn",
    "state_sharding",
    "unshard_state",
]
