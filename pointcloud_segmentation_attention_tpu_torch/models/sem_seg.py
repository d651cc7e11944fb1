"""Semantic-segmentation model (ScanNet, 21 classes): PointNet++ with
single-scale grouping and a pooling per SA level, the counterpart of the JAX
package's ``models/sem_seg.py:SemSegNet`` (baseline, features, attention at
every level, attention at one level, attention plus max pooling).

Hierarchy: SA npoint 1024/256/64/16, radius .1/.2/.4/.8, nsample 32, mlps
[32,32,64]/[64,64,128]/[128,128,256]/[256,256,512]; FP [256,256]/[256,256]/
[256,128]/[128,128,128]; head conv1d(128) -> dropout(0.5) -> conv1d(classes).
Module names follow the Flax names (sa1..sa4, fp1..fp4, fc1, dp1, fc2), so
checkpoints of the JAX package map onto the state dict by name.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.nn import (
    Dropout,
    FeaturePropagation,
    PointConv,
    SetAbstraction,
)
from pointcloud_segmentation_attention_tpu_torch.nn.layers import reset_parameters

SA_NPOINTS = (1024, 256, 64, 16)
SA_RADII = (0.1, 0.2, 0.4, 0.8)
SA_NSAMPLE = 32
SA_MLPS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
FP_MLPS = ((256, 256), (256, 256), (256, 128), (128, 128, 128))


class SemSegNet(nn.Module):
    """PointNet++ semantic segmentation.  ``in_features`` is the per-point
    feature width (0: xyz only; 6: colors + normals); ``sa_pooling`` one
    ``SetAbstraction`` pooling per SA level; ``compute_dtype`` the products'
    dtype (``torch.bfloat16`` for mixed precision)."""

    def __init__(
        self,
        num_classes: int = 21,
        in_features: int = 0,
        sa_pooling: Tuple[str, ...] = ("max", "max", "max", "max"),
        dropout_rate: float = 0.5,
        sa_npoints: Sequence[int] = SA_NPOINTS,
        sa_radii: Sequence[float] = SA_RADII,
        sa_nsample: int = SA_NSAMPLE,
        sa_mlps: Sequence[Sequence[int]] = SA_MLPS,
        fp_mlps: Sequence[Sequence[int]] = FP_MLPS,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        dd = compute_dtype
        self.in_features = in_features
        widths = [in_features]
        for i in range(4):
            sa = SetAbstraction(sa_npoints[i], sa_radii[i], sa_nsample, widths[-1],
                                sa_mlps[i], pooling=sa_pooling[i], compute_dtype=dd)
            self.add_module(f"sa{i + 1}", sa)
            widths.append(sa.out_channels)
        up = widths[4]
        for i in range(4):
            fp = FeaturePropagation(up + widths[3 - i], fp_mlps[i], dd)
            self.add_module(f"fp{i + 1}", fp)
            up = fp.out_channels
        self.fc1 = PointConv(up, 128, bn=True, compute_dtype=dd)
        self.dp1 = Dropout(dropout_rate)
        self.fc2 = PointConv(128, num_classes, bn=False, activation=False, compute_dtype=dd)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every kernel from ``generator``; zero biases, unit BN."""
        reset_parameters(self, generator)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if (features is None) != (self.in_features == 0):
            raise ValueError(
                f"model built for {self.in_features} feature channels, got "
                f"{None if features is None else features.shape[-1]}")
        xyzs, feats = [xyz], [features]
        for i in range(4):
            new_xyz, new_points, _ = getattr(self, f"sa{i + 1}")(
                xyzs[-1], feats[-1], bn_momentum=bn_momentum)
            xyzs.append(new_xyz)
            feats.append(new_points)
        up = feats[4]
        for i in range(4):
            lvl = 3 - i
            up = getattr(self, f"fp{i + 1}")(
                xyzs[lvl], xyzs[lvl + 1], feats[lvl], up, bn_momentum=bn_momentum)
        net = self.fc1(up, bn_momentum=bn_momentum)
        net = self.dp1(net, generator=generator)
        return self.fc2(net)
