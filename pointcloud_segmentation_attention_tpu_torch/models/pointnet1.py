"""The PointNet v1 family: the counterparts of the JAX package's
``models/pointnet1.py`` (the reference's vendored ``pointnet1/models/``,
``part_seg/pointnet_part_seg.py``, ``sem_seg/model.py`` and
``models/pointnet_cls_basic.py``).

- ``PointNetClsBasic``: per-point MLP (64,64,64,128,1024), a global max
  pool and an FC 512/256/classes head.
- ``PointNetCls``: with the input (3x3) and feature (64x64) T-Nets; returns
  ``(logits, {'transform': the 64x64 matrix})`` for ``orthogonality_loss``.
- ``PointNetSeg``: T-Nets, per-point features concatenated with the tiled
  global feature, a conv head; 50 parts.
- ``PointNetSemSeg``: S3DIS blocks, 9-channel input, 13 classes.
- ``PointNetPartSegJoint``: the joint classification + part-segmentation
  model; takes the object class one-hot and returns ``(cls_logits,
  seg_logits, {'transform': the 128x128 matrix})``.

No kernel runs here: every layer is a ``PointConv`` (``mixed_matmul`` in
the model's ``compute_dtype``, BN, ReLU), on (B, N, C) per-point tensors and
on (B, C) in the FC stacks; the T-Nets' matrices and their products with
the points stay float32, as in the JAX package.
Module names are the Flax names (``transform_net1.tconv1``,
``transform_net2.transform_w``, ``conv3``, ``fc1``, ``cla_fc2``,
``seg_conv4``), so a JAX ``model.init`` loads through
``load_jax_variables``.  Every model takes ``forward(xyz[, cls_onehot],
bn_momentum=, generator=)``; dropout draws from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.nn import Dropout, PointConv
from pointcloud_segmentation_attention_tpu_torch.nn.layers import linear
from pointcloud_segmentation_attention_tpu_torch.parallel import act_sharding


def _stack(module: nn.Module, prefix: str, c_in: int, widths: Sequence[int],
           first: int = 1, compute_dtype: torch.dtype = torch.float32) -> int:
    """Add ``PointConv``s with BN named ``{prefix}{first}``, ... to
    ``module``; returns the last width."""
    for i, f in enumerate(widths):
        module.add_module(f"{prefix}{first + i}",
                          PointConv(c_in, f, compute_dtype=compute_dtype))
        c_in = f
    return c_in


def _run(module: nn.Module, prefix: str, x: torch.Tensor, first: int, count: int,
         bn_momentum: float) -> torch.Tensor:
    for i in range(first, first + count):
        x = getattr(module, f"{prefix}{i}")(x, bn_momentum=bn_momentum)
    return x


class TransformNet(nn.Module):
    """T-Net: per-point MLP ``tconv*``, max pool, FC stack ``tfc*``, then a
    K x K matrix ``x @ transform_w + transform_b + I``; ``transform_w`` and
    ``transform_b`` start at zero (``reset_parameters`` leaves them), so the
    matrix starts at the identity.  Under tensor parallelism a sharded
    ``transform_w`` (K*K dividing over the model axis) is column-parallel,
    as a ``PointConv`` kernel is."""

    tp_columns = ("transform_w", ("transform_b",))

    def __init__(self, c_in: int, k: int, mlp: Sequence[int] = (64, 128, 1024),
                 fc: Sequence[int] = (512, 256), compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.n_mlp, self.n_fc = k, len(mlp), len(fc)
        c = _stack(self, "tconv", c_in, mlp, compute_dtype=compute_dtype)
        c = _stack(self, "tfc", c, fc, compute_dtype=compute_dtype)
        self.transform_w = nn.Parameter(torch.zeros(c, k * k))
        self.transform_b = nn.Parameter(torch.zeros(k * k))

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        x = _run(self, "tconv", x, 1, self.n_mlp, bn_momentum).amax(dim=1)
        x = _run(self, "tfc", x, 1, self.n_fc, bn_momentum)
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(-1)
        t = act_sharding.constrain_channels(
            linear(x, self.transform_w, self.transform_b, torch.float32), self.k * self.k)
        return (t + eye).reshape(x.shape[0], self.k, self.k)


def orthogonality_loss(transform: torch.Tensor) -> torch.Tensor:
    """0.5 * ||T T^t - I||_F^2 summed over the batch (``tf.nn.l2_loss``; no
    mean over the batch, as the reference's ``get_loss``)."""
    k = transform.shape[-1]
    diff = transform @ transform.transpose(-1, -2) - torch.eye(
        k, dtype=transform.dtype, device=transform.device)
    return 0.5 * (diff * diff).sum()


class PointNetClsBasic(nn.Module):
    """Per-point MLP conv1-5, a global max pool, fc1-2, dropout and fc3."""

    def __init__(self, num_classes: int = 40, dropout_rate: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        c = _stack(self, "conv", 3, (64, 64, 64, 128, 1024), compute_dtype=dd)
        self.fc1 = PointConv(c, 512, compute_dtype=dd)
        self.fc2 = PointConv(512, 256, compute_dtype=dd)
        self.dp1 = Dropout(dropout_rate)
        self.fc3 = PointConv(256, num_classes, bn=False, activation=False, compute_dtype=dd)

    def forward(self, xyz: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self, "conv", xyz, 1, 5, bn_momentum).amax(dim=1)
        x = self.fc2(self.fc1(x, bn_momentum=bn_momentum), bn_momentum=bn_momentum)
        return self.fc3(self.dp1(x, generator=generator))


class _TNetFeatures(nn.Module):
    """The input T-Net, conv1-2 and the 64x64 feature T-Net that
    ``PointNetCls`` and ``PointNetSeg`` share."""

    def __init__(self, compute_dtype: torch.dtype):
        super().__init__()
        self.transform_net1 = TransformNet(3, 3, compute_dtype=compute_dtype)
        _stack(self, "conv", 3, (64, 64), compute_dtype=compute_dtype)
        self.transform_net2 = TransformNet(64, 64, compute_dtype=compute_dtype)

    def _point_features(self, xyz: torch.Tensor, bn_momentum: float):
        """(transformed (B,N,64) features, the feature transform)."""
        x = xyz @ self.transform_net1(xyz, bn_momentum=bn_momentum)
        x = _run(self, "conv", x, 1, 2, bn_momentum)
        t_feat = self.transform_net2(x, bn_momentum=bn_momentum)
        return x @ t_feat, t_feat


class PointNetCls(_TNetFeatures):
    """PointNet v1 with the T-Nets: ``(logits, {'transform': (B,64,64)})``."""

    def __init__(self, num_classes: int = 40, dropout_rate: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        dd = compute_dtype
        _stack(self, "conv", 64, (64, 128, 1024), first=3, compute_dtype=dd)
        self.fc1 = PointConv(1024, 512, compute_dtype=dd)
        self.dp1 = Dropout(dropout_rate)
        self.fc2 = PointConv(512, 256, compute_dtype=dd)
        self.dp2 = Dropout(dropout_rate)
        self.fc3 = PointConv(256, num_classes, bn=False, activation=False, compute_dtype=dd)

    def forward(self, xyz: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None):
        x, t_feat = self._point_features(xyz, bn_momentum)
        x = _run(self, "conv", x, 3, 3, bn_momentum).amax(dim=1)
        x = self.dp1(self.fc1(x, bn_momentum=bn_momentum), generator=generator)
        x = self.dp2(self.fc2(x, bn_momentum=bn_momentum), generator=generator)
        return self.fc3(x), {"transform": t_feat}


class PointNetSeg(_TNetFeatures):
    """PointNet v1 part segmentation: the T-Net point features concatenated
    with the tiled global feature, conv6-9 and ``conv10`` to the parts.
    Returns ``(logits (B,N,parts), {'transform': (B,64,64)})``."""

    def __init__(self, num_classes: int = 50, compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        dd = compute_dtype
        _stack(self, "conv", 64, (64, 128, 1024), first=3, compute_dtype=dd)
        _stack(self, "conv", 64 + 1024, (512, 256, 128, 128), first=6, compute_dtype=dd)
        self.conv10 = PointConv(128, num_classes, bn=False, activation=False, compute_dtype=dd)

    def forward(self, xyz: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None):
        point_feat, t_feat = self._point_features(xyz, bn_momentum)
        x = _run(self, "conv", point_feat, 3, 3, bn_momentum)
        global_feat = x.amax(dim=1, keepdim=True).expand(-1, xyz.shape[1], -1)
        x = _run(self, "conv", torch.cat([point_feat, global_feat], dim=-1), 6, 4, bn_momentum)
        return self.conv10(x), {"transform": t_feat}


class PointNetSemSeg(nn.Module):
    """S3DIS semantic segmentation: 9-channel blocks, 13 classes."""

    def __init__(self, num_classes: int = 13, dropout_rate: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        c = _stack(self, "conv", 9, (64, 64, 64, 128, 1024), compute_dtype=dd)
        self.fc1 = PointConv(c, 256, compute_dtype=dd)
        self.fc2 = PointConv(256, 128, compute_dtype=dd)
        _stack(self, "conv", c + 128, (512, 256), first=6, compute_dtype=dd)
        self.dp1 = Dropout(dropout_rate)
        self.conv8 = PointConv(256, num_classes, bn=False, activation=False, compute_dtype=dd)

    def forward(self, points: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        points_feat = _run(self, "conv", points, 1, 5, bn_momentum)
        g = self.fc1(points_feat.amax(dim=1), bn_momentum=bn_momentum)
        g = self.fc2(g, bn_momentum=bn_momentum)
        x = torch.cat([points_feat, g[:, None, :].expand(-1, points.shape[1], -1)], dim=-1)
        x = _run(self, "conv", x, 6, 2, bn_momentum)
        return self.conv8(self.dp1(x, generator=generator))


class PointNetPartSegJoint(nn.Module):
    """Joint classification and part segmentation: an input T-Net (FC
    128/128), conv1-3 (all kept for the seg head), a 128x128 feature T-Net
    (conv 256/1024, FC 512/256), conv4-5 and a global max; a classification
    head (``cla_fc1``-``cla_fc3``, dropout 0.3) and a segmentation head over
    [tiled global ++ one-hot class ++ out1..out5] (``seg_conv1``-
    ``seg_conv4``, dropout 0.2).  Returns ``(cls_logits (B,cat_num),
    seg_logits (B,N,part_num), {'transform': (B,128,128)})``."""

    def __init__(self, cat_num: int = 16, part_num: int = 50,
                 cls_dropout_rate: float = 0.3, seg_dropout_rate: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        self.transform_net1 = TransformNet(3, 3, mlp=(64, 128, 1024), fc=(128, 128),
                                           compute_dtype=dd)
        _stack(self, "conv", 3, (64, 128, 128), compute_dtype=dd)
        self.transform_net2 = TransformNet(128, 128, mlp=(256, 1024), fc=(512, 256),
                                           compute_dtype=dd)
        _stack(self, "conv", 128, (512, 2048), first=4, compute_dtype=dd)
        self.cla_fc1 = PointConv(2048, 256, compute_dtype=dd)
        self.cla_fc2 = PointConv(256, 256, compute_dtype=dd)
        self.cla_dp1 = Dropout(cls_dropout_rate)
        self.cla_fc3 = PointConv(256, cat_num, bn=False, activation=False, compute_dtype=dd)
        seg_in = 2048 + cat_num + 64 + 128 + 128 + 512 + 2048
        _stack(self, "seg_conv", seg_in, (256, 256, 128), compute_dtype=dd)
        self.seg_dp1 = Dropout(seg_dropout_rate)
        self.seg_dp2 = Dropout(seg_dropout_rate)
        self.seg_conv4 = PointConv(128, part_num, bn=False, activation=False, compute_dtype=dd)

    def forward(self, xyz: torch.Tensor, cls_onehot: torch.Tensor, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None):
        b, n, _ = xyz.shape
        out1 = self.conv1(xyz @ self.transform_net1(xyz, bn_momentum=bn_momentum),
                          bn_momentum=bn_momentum)
        out2 = self.conv2(out1, bn_momentum=bn_momentum)
        out3 = self.conv3(out2, bn_momentum=bn_momentum)
        t_feat = self.transform_net2(out3, bn_momentum=bn_momentum)
        out4 = self.conv4(out3 @ t_feat, bn_momentum=bn_momentum)
        out5 = self.conv5(out4, bn_momentum=bn_momentum)
        out_max = out5.amax(dim=1)

        c = self.cla_fc2(self.cla_fc1(out_max, bn_momentum=bn_momentum),
                         bn_momentum=bn_momentum)
        cls_logits = self.cla_fc3(self.cla_dp1(c, generator=generator))

        g = torch.cat([out_max, cls_onehot.to(out_max.dtype)], dim=-1)
        s = torch.cat([g[:, None, :].expand(b, n, -1), out1, out2, out3, out4, out5], dim=-1)
        s = self.seg_dp1(self.seg_conv1(s, bn_momentum=bn_momentum), generator=generator)
        s = self.seg_dp2(self.seg_conv2(s, bn_momentum=bn_momentum), generator=generator)
        s = self.seg_conv3(s, bn_momentum=bn_momentum)
        return cls_logits, self.seg_conv4(s), {"transform": t_feat}
