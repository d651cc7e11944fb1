"""Public geometry ops: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.

There is no backend switch and no fallback: a CUDA tensor always goes to its
kernel in ``ops/cuda/``, and a kernel that fails to build or launch raises.
The gather and the interpolation go through autograd functions whose
backward is a kernel as well, so training on the card gets its gradients
from ``csrc/*_bwd.cu``; on the CPU, autograd differentiates the plain
version.
The plain versions in ``ops/geometry.py`` serve CPU tensors (the tests) and
are the oracles the kernels are held against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops import geometry


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    if _on_cuda(xyz):
        from pointcloud_segmentation_attention_tpu_torch.ops.cuda import fps

        return fps.farthest_point_sample(xyz, npoint)
    return geometry.farthest_point_sample(xyz, npoint)


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cuda(xyz):
        from pointcloud_segmentation_attention_tpu_torch.ops.cuda import ball_query

        return ball_query.ball_query(xyz, new_xyz, radius, nsample)
    return geometry.ball_query(xyz, new_xyz, radius, nsample)


def group_point_with_counts(points: torch.Tensor, idx: torch.Tensor,
                            cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``group_point``; ``cnt`` is accepted for the JAX package's signature.
    The CUDA gather copies every slot, which given ball-query output equals
    the count-aware TPU gather."""
    del cnt
    if _on_cuda(points):
        from pointcloud_segmentation_attention_tpu_torch.ops.cuda import group_gather

        return group_gather.GroupPoint.apply(points, idx)
    return geometry.group_point(points, idx)


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cuda(xyz1):
        from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_nn

        return three_nn.three_nn(xyz1, xyz2)
    return geometry.three_nn(xyz1, xyz2)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    if _on_cuda(points):
        from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
            three_interpolate,
        )

        return three_interpolate.ThreeInterpolate.apply(points, idx, weight)
    return geometry.three_interpolate(points, idx, weight)
