"""Geometry ops: plain PyTorch versions (``geometry``) and the public
dispatching functions (``dispatch``), which send CUDA tensors to the
hand-written kernels in ``ops/cuda/``."""
from pointcloud_segmentation_attention_tpu_torch.ops.geometry import (
    gather_point,
    group_point,
    interpolation_weights,
    prob_sample,
)
from pointcloud_segmentation_attention_tpu_torch.ops.dispatch import (
    ball_query,
    farthest_point_sample,
    group_point_with_counts,
    knn_point,
    three_interpolate,
    three_nn,
)

__all__ = [
    "ball_query",
    "farthest_point_sample",
    "gather_point",
    "group_point",
    "group_point_with_counts",
    "interpolation_weights",
    "knn_point",
    "prob_sample",
    "three_interpolate",
    "three_nn",
]
