"""PointNet++ set-abstraction and feature-propagation modules.

Counterparts of the JAX package's ``nn/modules.py`` for the slice the port
covers: single-scale grouping with max pooling.  The other poolings,
``sample_and_group_all`` and multi-scale grouping come in a later slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch import ops
from pointcloud_segmentation_attention_tpu_torch.nn.layers import SharedMLP


def sample_and_group(npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
                     points: Optional[torch.Tensor]):
    """FPS -> ball query -> group -> centre-relative xyz -> concat features.

    One gather of ``cat([xyz, points])``, xyz first; the centre is subtracted
    from the first three channels only.  Returns (new_xyz (B,np,3),
    new_points (B,np,ns,3+C), idx (B,np,ns), grouped_xyz (B,np,ns,3)).
    """
    fps_idx = ops.farthest_point_sample(xyz, npoint)
    new_xyz = ops.gather_point(xyz, fps_idx)
    idx, cnt = ops.ball_query(xyz, new_xyz, radius, nsample)
    centre = new_xyz[:, :, None, :]
    if points is not None:
        grouped = ops.group_point_with_counts(
            torch.cat([xyz, points.to(xyz.dtype)], dim=-1), idx, cnt)
        grouped_xyz = grouped[..., :3] - centre
        new_points = torch.cat([grouped_xyz, grouped[..., 3:]], dim=-1)
    else:
        grouped_xyz = ops.group_point_with_counts(xyz, idx, cnt) - centre
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz


class SetAbstraction(nn.Module):
    """PointNet++ SA module; ``c_in`` is the feature channel count (0 for
    none), grouped with the centred xyz in front.  Only ``pooling='max'`` is
    in this slice."""

    def __init__(self, npoint: int, radius: float, nsample: int, c_in: int,
                 mlp: Sequence[int], pooling: str = "max"):
        super().__init__()
        if pooling != "max":
            raise NotImplementedError(
                f"SetAbstraction pooling {pooling!r} is ported in a later slice")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp = SharedMLP(3 + c_in, mlp)
        self.out_channels = self.mlp.out_channels

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                bn_momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        new_xyz, new_points, idx, _ = sample_and_group(
            self.npoint, self.radius, self.nsample, xyz, points)
        new_points = self.mlp(new_points, bn_momentum=bn_momentum)
        return new_xyz, new_points.amax(dim=2), idx


class FeaturePropagation(nn.Module):
    """FP module: 3-NN inverse-distance interpolation + skip concat + MLP;
    ``c_in`` counts the interpolated plus the skip channels."""

    def __init__(self, c_in: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(c_in, mlp)
        self.out_channels = self.mlp.out_channels

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor], points2: torch.Tensor,
                bn_momentum: float = 0.9) -> torch.Tensor:
        dist, idx = ops.three_nn(xyz1, xyz2)
        weight = ops.interpolation_weights(dist)
        interpolated = ops.three_interpolate(points2, idx, weight)
        if points1 is not None:
            interpolated = torch.cat([interpolated, points1], dim=-1)
        return self.mlp(interpolated, bn_momentum=bn_momentum)
