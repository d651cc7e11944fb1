"""ShapeNet part-segmentation models (50 part classes over 16 object
categories): the counterparts of the JAX package's ``models/part_seg.py``.

- ``PartSegSSG``: input (B,N,6) xyz + normals; SA 512/128 points (radius
  .2/.4, nsample 64), a group-all SA [256,512,1024], FP [256,256]/[256,128]/
  [128,128,128] with xyz + normals as the last skip.
- ``PartSegMSGOneHot``: multi-scale SA1 (512 points, radii .1/.2/.4,
  nsample 32/64/128) and SA2 (128 points, .4/.8, 64/128), the same
  group-all SA, FP [256,256]/[256,128]/[128,128]; the one-hot of the
  object category (16) is broadcast to every point and concatenated in
  front of xyz + normals in the last skip.

FP1 interpolates from the group-all level's single centroid at the origin
(three-NN pads slots 2-3 with float32 max and index 0).  The head is FC 128
-> dropout 0.5 -> FC classes.  Module names follow the Flax names.  Both
models take ``compute_dtype``, the products' dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.models.cls import GLOBAL_MLP
from pointcloud_segmentation_attention_tpu_torch.nn import (
    Dropout,
    FeaturePropagation,
    PointConv,
    SetAbstraction,
    SetAbstractionMSG,
)

NUM_PART_CLASSES = 50
NUM_CATEGORIES = 16
POINT_CHANNELS = 6  # xyz + normals


class SegHead(nn.Module):
    """FC 128 -> dropout -> FC num_classes, per point."""

    def __init__(self, c_in: int, num_classes: int, dropout_rate: float,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = PointConv(c_in, 128, compute_dtype=compute_dtype)
        self.dp1 = Dropout(dropout_rate)
        self.fc2 = PointConv(128, num_classes, bn=False, activation=False,
                             compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc2(self.dp1(self.fc1(x, bn_momentum=bn_momentum), generator=generator))


class _PartSegmenter(nn.Module):
    """SA levels ``sa1`` and ``sa2`` from the subclass, the group-all
    ``sa3``, three FP levels (``fp3``'s skip is ``skip_channels`` wide) and
    the head."""

    def __init__(self, sa1: nn.Module, sa2: nn.Module, fp3_mlp, skip_channels: int,
                 num_classes: int, dropout_rate: float, compute_dtype: torch.dtype):
        super().__init__()
        dd = compute_dtype
        self.sa1, self.sa2 = sa1, sa2
        self.sa3 = SetAbstraction(None, None, None, sa2.out_channels, GLOBAL_MLP,
                                  group_all=True, compute_dtype=dd)
        self.fp1 = FeaturePropagation(self.sa3.out_channels + sa2.out_channels, (256, 256), dd)
        self.fp2 = FeaturePropagation(self.fp1.out_channels + sa1.out_channels, (256, 128), dd)
        self.fp3 = FeaturePropagation(self.fp2.out_channels + skip_channels, fp3_mlp, dd)
        self.head = SegHead(self.fp3.out_channels, num_classes, dropout_rate, dd)

    def _run(self, point_cloud: torch.Tensor, skip_front: Optional[torch.Tensor],
             bn_momentum: float, generator: Optional[torch.Generator]) -> torch.Tensor:
        if point_cloud.shape[-1] != POINT_CHANNELS:
            raise ValueError(f"expected (B, N, {POINT_CHANNELS}) xyz + normals, got "
                             f"{tuple(point_cloud.shape)}")
        # The kernels take contiguous tensors; slices of the last axis are not.
        l0_xyz = point_cloud[..., :3].contiguous()
        l0_points = point_cloud[..., 3:6].contiguous()
        l1_xyz, l1_points = self.sa1(l0_xyz, l0_points, bn_momentum=bn_momentum)[:2]
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, bn_momentum=bn_momentum)[:2]
        l3_xyz, l3_points, _ = self.sa3(l2_xyz, l2_points, bn_momentum=bn_momentum)
        l2_points = self.fp1(l2_xyz, l3_xyz, l2_points, l3_points, bn_momentum=bn_momentum)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points, bn_momentum=bn_momentum)
        skip = [l0_xyz, l0_points] if skip_front is None else [skip_front, l0_xyz, l0_points]
        l0_points = self.fp3(l0_xyz, l1_xyz, torch.cat(skip, dim=-1), l1_points,
                             bn_momentum=bn_momentum)
        return self.head(l0_points, bn_momentum=bn_momentum, generator=generator)


class PartSegSSG(_PartSegmenter):
    def __init__(self, num_classes: int = NUM_PART_CLASSES, dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        dd = compute_dtype
        sa1 = SetAbstraction(512, 0.2, 64, 3, (64, 64, 128), compute_dtype=dd)
        sa2 = SetAbstraction(128, 0.4, 64, sa1.out_channels, (128, 128, 256), compute_dtype=dd)
        super().__init__(sa1, sa2, (128, 128, 128), POINT_CHANNELS, num_classes,
                         dropout_rate, dd)

    def forward(self, point_cloud: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._run(point_cloud, None, bn_momentum, generator)


class PartSegMSGOneHot(_PartSegmenter):
    def __init__(self, num_classes: int = NUM_PART_CLASSES,
                 num_categories: int = NUM_CATEGORIES, dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        dd = compute_dtype
        sa1 = SetAbstractionMSG(512, (0.1, 0.2, 0.4), (32, 64, 128), 3,
                                ((32, 32, 64), (64, 64, 128), (64, 96, 128)), compute_dtype=dd)
        sa2 = SetAbstractionMSG(128, (0.4, 0.8), (64, 128), sa1.out_channels,
                                ((128, 128, 256), (128, 196, 256)), compute_dtype=dd)
        super().__init__(sa1, sa2, (128, 128), num_categories + POINT_CHANNELS, num_classes,
                         dropout_rate, dd)
        self.num_categories = num_categories

    def forward(self, point_cloud: torch.Tensor, cls_label: torch.Tensor,
                bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``cls_label`` (B,) int: each cloud's object category."""
        b, n, _ = point_cloud.shape
        one_hot = nn.functional.one_hot(cls_label.long(), self.num_categories)
        one_hot = one_hot.to(point_cloud.dtype)[:, None, :].expand(b, n, self.num_categories)
        return self._run(point_cloud, one_hot, bn_momentum, generator)
