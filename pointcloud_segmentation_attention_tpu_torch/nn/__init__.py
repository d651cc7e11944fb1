"""Layers, attention layers and PointNet++ modules of the port."""
from pointcloud_segmentation_attention_tpu_torch.nn.attention import (
    AttentionPool,
    FeedForward,
    InnerAttention,
    InnerAttentionBlock,
)
from pointcloud_segmentation_attention_tpu_torch.nn.layers import (
    Dense,
    Dropout,
    PointConv,
    ScheduledBatchNorm,
    SharedMLP,
)
from pointcloud_segmentation_attention_tpu_torch.nn.modules import (
    POOLINGS,
    FeaturePropagation,
    SetAbstraction,
    sample_and_group,
)

__all__ = [
    "AttentionPool", "Dense", "Dropout", "FeaturePropagation", "FeedForward",
    "InnerAttention", "InnerAttentionBlock", "POOLINGS", "PointConv",
    "ScheduledBatchNorm", "SetAbstraction", "SharedMLP", "sample_and_group",
]
