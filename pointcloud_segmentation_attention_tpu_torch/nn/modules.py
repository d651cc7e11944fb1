"""PointNet++ set-abstraction and feature-propagation modules.

Counterparts of the JAX package's ``nn/modules.py``: single-scale grouping
by ball query, with every pooling of the JAX ``SetAbstraction``:

  'max' | 'avg' | 'weighted_avg' | 'max_and_avg'
  'attention'            AttentionPool(4, 4, C // 4) queried by the group's
                         first element after the MLP, then ``attention_bn``
  'attention_and_pool'   that attention output plus the max
  'attention_centroid'   the attention queried by the group's centre xyz

and the optional ``mlp2`` stage after the pooling; kNN grouping
(``knn``), grouping without the centred xyz (``use_xyz=False``), the
whole cloud as one group (``group_all``, ``sample_and_group_all``), and
multi-scale grouping (``SetAbstractionMSG``, which gathers [features, xyz]
with xyz LAST, as the reference does).  Each module passes its
``compute_dtype`` to its MLPs and attention poolings; the geometry and
every kernel input stay float32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch import ops
from pointcloud_segmentation_attention_tpu_torch.nn.attention import AttentionPool
from pointcloud_segmentation_attention_tpu_torch.nn.layers import ScheduledBatchNorm, SharedMLP

POOLINGS = ("max", "avg", "weighted_avg", "max_and_avg", "attention", "attention_and_pool",
            "attention_centroid")


def sample_and_group(npoint: int, radius: Optional[float], nsample: int, xyz: torch.Tensor,
                     points: Optional[torch.Tensor], knn: bool = False, use_xyz: bool = True):
    """FPS -> ball query (or the ``nsample`` nearest, with ``knn``) -> group
    -> centre-relative xyz -> concat features.

    One gather of ``cat([xyz, points])``, xyz first; the centre is subtracted
    from the first three channels only, which ``use_xyz=False`` then drops.
    Returns (new_xyz (B,np,3), new_points (B,np,ns,[3+]C), idx (B,np,ns),
    grouped_xyz (B,np,ns,3)).
    """
    fps_idx = ops.farthest_point_sample(xyz, npoint)
    new_xyz = ops.gather_point(xyz, fps_idx)
    if knn:
        _, idx = ops.knn_point(nsample, xyz, new_xyz)
        cnt = None
    else:
        idx, cnt = ops.ball_query(xyz, new_xyz, radius, nsample)
    centre = new_xyz[:, :, None, :]
    if points is not None:
        grouped = ops.group_point_with_counts(
            torch.cat([xyz, points.to(xyz.dtype)], dim=-1), idx, cnt)
        grouped_xyz = grouped[..., :3] - centre
        new_points = (torch.cat([grouped_xyz, grouped[..., 3:]], dim=-1) if use_xyz
                      else grouped[..., 3:])
    else:
        grouped_xyz = ops.group_point_with_counts(xyz, idx, cnt) - centre
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor],
                         use_xyz: bool = True):
    """The whole cloud as one group around the centroid (0,0,0): no kernel.
    Returns (new_xyz zeros (B,1,3), new_points (B,1,N,[3+]C), idx arange
    (B,1,N) int32, grouped_xyz (B,1,N,3))."""
    b, n, _ = xyz.shape
    new_xyz = xyz.new_zeros((b, 1, 3))
    idx = torch.arange(n, dtype=torch.int32, device=xyz.device).expand(b, 1, n)
    grouped_xyz = xyz[:, None]
    if points is None:
        new_points = grouped_xyz
    elif use_xyz:
        new_points = torch.cat([xyz, points], dim=-1)[:, None]
    else:
        new_points = points[:, None]
    return new_xyz, new_points, idx, grouped_xyz


def _group_channels(c_in: int, use_xyz: bool) -> int:
    """Channels of a group: the centred xyz alone without features, else the
    features with (``use_xyz``) or without the centred xyz."""
    return 3 if c_in == 0 else c_in + 3 * use_xyz


class SetAbstraction(nn.Module):
    """PointNet++ SA module; ``c_in`` is the feature channel count (0 for
    none), grouped with the centred xyz in front (``use_xyz``).  ``pooling``
    is one of ``POOLINGS``; ``mlp2``, when given, is a shared MLP over the
    pooled features.  ``group_all`` takes the whole cloud as one group
    (``npoint``, ``radius`` and ``nsample`` are then ``None``); ``knn``
    groups the ``nsample`` nearest points instead of a ball.  Returns
    (new_xyz (B,np,3), new_points (B,np,out_channels), idx (B,np,nsample))."""

    def __init__(self, npoint: Optional[int], radius: Optional[float], nsample: Optional[int],
                 c_in: int, mlp: Sequence[int], pooling: str = "max",
                 mlp2: Optional[Sequence[int]] = None, group_all: bool = False,
                 knn: bool = False, use_xyz: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling: {pooling}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.pooling = pooling
        self.group_all, self.knn, self.use_xyz = group_all, knn, use_xyz
        self.mlp = SharedMLP(_group_channels(c_in, use_xyz), mlp, compute_dtype)
        c = self.mlp.out_channels
        if pooling.startswith("attention"):
            if c % 4:
                raise ValueError(f"attention pooling needs mlp[-1] divisible by 4 "
                                 f"(heads = C/4 x key_dim 4); got {c}")
            self.attention_pool = AttentionPool(
                c, 3 if pooling == "attention_centroid" else c, output_dim=4, key_dim=4,
                num_heads=c // 4, compute_dtype=compute_dtype)
            self.attention_bn = ScheduledBatchNorm(c)
        if pooling == "max_and_avg":
            c *= 2
        self.mlp2 = SharedMLP(c, mlp2, compute_dtype) if mlp2 else None
        self.out_channels = self.mlp2.out_channels if mlp2 else c

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                bn_momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.group_all:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group_all(
                xyz, points, self.use_xyz)
        else:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points, self.knn, self.use_xyz)
        new_points = self.mlp(new_points, bn_momentum=bn_momentum)
        pooled = self._pool(new_xyz, new_points, grouped_xyz, bn_momentum)
        if self.mlp2 is not None:
            pooled = self.mlp2(pooled, bn_momentum=bn_momentum)
        return new_xyz, pooled, idx

    def _pool(self, new_xyz, new_points, grouped_xyz, bn_momentum: float) -> torch.Tensor:
        """(B, np, ns, C) -> (B, np, C'), over the group axis.  BN and mlp2
        run on (B, np, C), which has the statistics of the JAX package's
        (B, np, 1, C)."""
        pooling = self.pooling
        if pooling == "max":
            return new_points.amax(dim=2)
        if pooling == "avg":
            return new_points.mean(dim=2)
        if pooling == "weighted_avg":
            # exp(-5 |centred xyz|), normalised over the group
            exp_dists = torch.exp(-5.0 * torch.linalg.norm(grouped_xyz, dim=-1, keepdim=True))
            return (new_points * (exp_dists / exp_dists.sum(dim=2, keepdim=True))).sum(dim=2)
        if pooling == "max_and_avg":
            return torch.cat([new_points.mean(dim=2), new_points.amax(dim=2)], dim=-1)
        query = (new_xyz[:, :, None, :] if pooling == "attention_centroid"
                 else new_points[:, :, :1, :])
        att = self.attention_bn(self.attention_pool(new_points, query), momentum=bn_momentum)
        return att + new_points.amax(dim=2) if pooling == "attention_and_pool" else att


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping SA: one FPS, then per (radius, nsample) branch a
    ball query, a gather of ``cat([points, xyz])`` (xyz LAST, the opposite
    of the single-scale order; the centre is subtracted from the last three
    channels), a shared MLP named ``branch{i}`` and a max over the group;
    the branch outputs are concatenated.  Returns (new_xyz (B,np,3),
    new_points (B,np,sum of mlp[-1]))."""

    def __init__(self, npoint: int, radius_list: Sequence[float], nsample_list: Sequence[int],
                 c_in: int, mlp_list: Sequence[Sequence[int]], use_xyz: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = tuple(radius_list), tuple(nsample_list)
        self.use_xyz = use_xyz
        c = _group_channels(c_in, use_xyz)
        for i, mlp in enumerate(mlp_list):
            self.add_module(f"branch{i}", SharedMLP(c, mlp, compute_dtype))
        self.out_channels = sum(mlp[-1] for mlp in mlp_list)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                bn_momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor]:
        fps_idx = ops.farthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_point(xyz, fps_idx)
        centre = new_xyz[:, :, None, :]
        both = None if points is None else torch.cat([points.to(xyz.dtype), xyz], dim=-1)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list, self.nsample_list)):
            idx, cnt = ops.ball_query(xyz, new_xyz, radius, nsample)
            if both is not None:
                grouped = ops.group_point_with_counts(both, idx, cnt)
                grouped_xyz = grouped[..., -3:] - centre
                grouped = (torch.cat([grouped[..., :-3], grouped_xyz], dim=-1) if self.use_xyz
                           else grouped[..., :-3])
            else:
                grouped = ops.group_point_with_counts(xyz, idx, cnt) - centre
            grouped = getattr(self, f"branch{i}")(grouped, bn_momentum=bn_momentum)
            outs.append(grouped.amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """FP module: 3-NN inverse-distance interpolation + skip concat + MLP;
    ``c_in`` counts the interpolated plus the skip channels."""

    def __init__(self, c_in: int, mlp: Sequence[int],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = SharedMLP(c_in, mlp, compute_dtype)
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
