"""Classification models (ModelNet40, 40 classes): the counterparts of the
JAX package's ``models/cls.py``.

- ``ClsSSG``: single-scale grouping, SA npoint 512/128 radius .2/.4
  nsample 32/64, mlps [64,64,128]/[128,128,256], then a group-all SA
  [256,512,1024].
- ``ClsMSG``: multi-scale grouping, SA1 512 points at radii .1/.2/.4 with
  nsample 16/32/128, SA2 128 points at .2/.4/.8 with 32/64/128, then the
  same group-all SA.

Both take ``(xyz (B,N,3), features (B,N,in_features) | None)``; the head is
FC 512 -> dropout -> FC 256 -> dropout -> FC classes on (B, 1024), its BNs
over the batch axis.  Module names follow the Flax names (sa1..sa3,
``branch{i}``, head/fc1..fc3), so checkpoints of the JAX package map onto
the state dict by name.  Every model takes ``compute_dtype``, the
products' dtype (``torch.bfloat16`` for mixed precision).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.nn import (
    Dropout,
    PointConv,
    SetAbstraction,
    SetAbstractionMSG,
)

GLOBAL_MLP = (256, 512, 1024)


class ClsHead(nn.Module):
    """FC 512 -> dropout -> FC 256 -> dropout -> FC num_classes."""

    def __init__(self, c_in: int, num_classes: int, dropout_rate: float,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        self.fc1 = PointConv(c_in, 512, compute_dtype=dd)
        self.dp1 = Dropout(dropout_rate)
        self.fc2 = PointConv(512, 256, compute_dtype=dd)
        self.dp2 = Dropout(dropout_rate)
        self.fc3 = PointConv(256, num_classes, bn=False, activation=False, compute_dtype=dd)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dp1(self.fc1(x, bn_momentum=bn_momentum), generator=generator)
        x = self.dp2(self.fc2(x, bn_momentum=bn_momentum), generator=generator)
        return self.fc3(x)


class _Classifier(nn.Module):
    """The subclass's two SA levels ``sa1`` and ``sa2``, the group-all
    ``sa3`` and the head."""

    def __init__(self, sa1: nn.Module, sa2: nn.Module, in_features: int, num_classes: int,
                 dropout_rate: float, compute_dtype: torch.dtype):
        super().__init__()
        self.in_features = in_features
        self.sa1, self.sa2 = sa1, sa2
        self.sa3 = SetAbstraction(None, None, None, sa2.out_channels, GLOBAL_MLP,
                                  group_all=True, compute_dtype=compute_dtype)
        self.head = ClsHead(self.sa3.out_channels, num_classes, dropout_rate, compute_dtype)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if (features is None) != (self.in_features == 0):
            raise ValueError(
                f"model built for {self.in_features} feature channels, got "
                f"{None if features is None else features.shape[-1]}")
        # The kernels take contiguous tensors (a batch split into xyz and
        # normals is two slices of its last axis).
        xyz = xyz.contiguous()
        features = None if features is None else features.contiguous()
        l1_xyz, l1_points = self.sa1(xyz, features, bn_momentum=bn_momentum)[:2]
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, bn_momentum=bn_momentum)[:2]
        _, l3_points, _ = self.sa3(l2_xyz, l2_points, bn_momentum=bn_momentum)
        net = l3_points.reshape(l3_points.shape[0], -1)
        return self.head(net, bn_momentum=bn_momentum, generator=generator)


class ClsSSG(_Classifier):
    def __init__(self, num_classes: int = 40, in_features: int = 0,
                 dropout_rate: float = 0.5, compute_dtype: torch.dtype = torch.float32):
        dd = compute_dtype
        sa1 = SetAbstraction(512, 0.2, 32, in_features, (64, 64, 128), compute_dtype=dd)
        sa2 = SetAbstraction(128, 0.4, 64, sa1.out_channels, (128, 128, 256),
                             compute_dtype=dd)
        super().__init__(sa1, sa2, in_features, num_classes, dropout_rate, dd)


class ClsMSG(_Classifier):
    def __init__(self, num_classes: int = 40, in_features: int = 0,
                 dropout_rate: float = 0.4, compute_dtype: torch.dtype = torch.float32):
        dd = compute_dtype
        sa1 = SetAbstractionMSG(512, (0.1, 0.2, 0.4), (16, 32, 128), in_features,
                                ((32, 32, 64), (64, 64, 128), (64, 96, 128)), compute_dtype=dd)
        sa2 = SetAbstractionMSG(128, (0.2, 0.4, 0.8), (32, 64, 128), sa1.out_channels,
                                ((64, 64, 128), (128, 128, 256), (128, 128, 256)),
                                compute_dtype=dd)
        super().__init__(sa1, sa2, in_features, num_classes, dropout_rate, dd)
