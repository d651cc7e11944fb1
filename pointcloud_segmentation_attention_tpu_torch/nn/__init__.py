"""Layers and PointNet++ modules of the port."""
from pointcloud_segmentation_attention_tpu_torch.nn.layers import (
    Dropout,
    PointConv,
    ScheduledBatchNorm,
    SharedMLP,
)
from pointcloud_segmentation_attention_tpu_torch.nn.modules import (
    FeaturePropagation,
    SetAbstraction,
    sample_and_group,
)

__all__ = [
    "Dropout", "FeaturePropagation", "PointConv", "ScheduledBatchNorm",
    "SetAbstraction", "SharedMLP", "sample_and_group",
]
