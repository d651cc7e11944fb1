"""The reference's full "AttentionNet" segmentation models: the counterparts
of the JAX package's ``models/attention_nets.py``.

Four attention SA levels (npoint 1024/256/64/16, radius 0.1 at every level,
nsample 32), then the FP pyramid and the seg head of ``SemSegNet``:

- ``AttentionNetModel``: inner attention blocks (or, with
  ``inner_kind='mlp'``, FeedForward blocks) over each group, then an
  ``AttentionPool`` queried by the group's first element; out_dims
  8/16/32/64 and 16 heads, so a level outputs 16 * out_dim channels.
- ``PoolingAttentionNetModel``: the conv-MLP SA ([32,32,64] ..
  [256,256,512]) pooled by an ``AttentionPool`` queried by the group's
  centre xyz; a level outputs 16 * out_dim (1024 .. 8192) channels.

The grouping goes through the kernels (FPS, ball query, the gather; three-NN
and the interpolation in the FP levels); the attention itself is plain
``torch.matmul`` and ``softmax``, as XLA runs it in the JAX package.  The
attention layers have no BatchNorm, so ``bn_momentum`` reaches the FP head
(and the pooling net's SA MLPs) only.  Module names are the Flax names
(``l1.inner0.attention.query_net``, ``l1.attention_pool.value_net``,
``head.fp1.mlp.conv0.bn``, ``head.fc1``), so a JAX ``model.init`` loads
through ``load_jax_variables`` with no missing or extra key.  Every model
and layer takes ``compute_dtype``, the dtype of its projections and
attention products (float32 results).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.nn import (
    AttentionPool,
    Dropout,
    FeaturePropagation,
    FeedForward,
    InnerAttentionBlock,
    PointConv,
    SharedMLP,
)
from pointcloud_segmentation_attention_tpu_torch.nn.modules import sample_and_group

FP_MLPS = ((256, 256), (256, 256), (256, 128), (128, 128, 128))
NPOINTS = (1024, 256, 64, 16)
NUM_HEADS = 16


class AttentionNetLayer(nn.Module):
    """sample_and_group -> inner blocks -> AttentionPool queried by the
    group's first element.  ``c_in`` is the feature width of ``points``
    (0 for none); the group has 3 + ``c_in`` channels (the centred xyz
    first).  ``inner_kind`` is 'attention' (``InnerAttentionBlock``) or
    'mlp' (``FeedForward``, a ReLU between blocks and none after the
    last).  Returns (new_xyz, (B, npoint, 16 * out_dim), idx)."""

    def __init__(self, npoint: int, out_dim: int, inner_dimensions: Sequence[int], c_in: int,
                 radius: float = 0.1, nsample: int = 32, inner_kind: str = "attention",
                 num_heads: int = NUM_HEADS, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        if inner_kind not in ("attention", "mlp"):
            raise ValueError(f"inner_kind must be 'attention' or 'mlp', got {inner_kind!r}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.inner_kind = inner_kind
        self.n_inner = len(inner_dimensions)
        c = 3 + c_in
        for i, dim in enumerate(inner_dimensions):
            block = (InnerAttentionBlock(c, dim, key_dim=out_dim, compute_dtype=dd)
                     if inner_kind == "attention" else FeedForward(c, dim, dim, compute_dtype=dd))
            self.add_module(f"inner{i}", block)
            c = dim
        self.attention_pool = AttentionPool(c, c, output_dim=out_dim, key_dim=out_dim,
                                            num_heads=num_heads, compute_dtype=dd)
        self.out_channels = num_heads * out_dim

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        new_xyz, new_points, idx, _ = sample_and_group(
            self.npoint, self.radius, self.nsample, xyz, points, False, True)
        for i in range(self.n_inner):
            new_points = getattr(self, f"inner{i}")(new_points, generator=generator)
            if self.inner_kind == "mlp" and i < self.n_inner - 1:
                new_points = torch.relu(new_points)
        pooled = self.attention_pool(new_points, new_points[:, :, :1, :])
        return new_xyz, pooled, idx


class PoolingAttentionNetLayer(nn.Module):
    """Conv-MLP SA pooled by an AttentionPool queried by the group's centre
    xyz.  Returns (new_xyz, (B, npoint, 16 * out_dim), idx)."""

    def __init__(self, npoint: int, out_dim: int, mlp: Sequence[int], c_in: int,
                 radius: float = 0.1, nsample: int = 32, num_heads: int = NUM_HEADS,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp = SharedMLP(3 + c_in, mlp, compute_dtype)
        self.attention_pool = AttentionPool(self.mlp.out_channels, 3, output_dim=out_dim,
                                            key_dim=out_dim, num_heads=num_heads,
                                            compute_dtype=compute_dtype)
        self.out_channels = num_heads * out_dim

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                bn_momentum: float = 0.9):
        new_xyz, new_points, idx, _ = sample_and_group(
            self.npoint, self.radius, self.nsample, xyz, points, False, True)
        new_points = self.mlp(new_points, bn_momentum=bn_momentum)
        return new_xyz, self.attention_pool(new_points, new_xyz[:, :, None, :]), idx


class _FPHead(nn.Module):
    """The FP pyramid and seg head every AttentionNet shares: ``widths``
    are the feature widths of the input and the four levels."""

    def __init__(self, widths: Sequence[int], num_classes: int, dropout_rate: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        dd = compute_dtype
        up = widths[4]
        for i in range(4):
            fp = FeaturePropagation(up + widths[3 - i], FP_MLPS[i], dd)
            self.add_module(f"fp{i + 1}", fp)
            up = fp.out_channels
        self.fc1 = PointConv(up, 128, bn=True, compute_dtype=dd)
        self.dp1 = Dropout(dropout_rate)
        self.fc2 = PointConv(128, num_classes, bn=False, activation=False, compute_dtype=dd)

    def forward(self, xyzs, feats, bn_momentum: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        up = feats[4]
        for i in range(4):
            lvl = 3 - i
            up = getattr(self, f"fp{i + 1}")(xyzs[lvl], xyzs[lvl + 1], feats[lvl], up,
                                             bn_momentum=bn_momentum)
        net = self.dp1(self.fc1(up, bn_momentum=bn_momentum), generator=generator)
        return self.fc2(net)


class _AttentionNetBase(nn.Module):
    """Levels ``l1``..``l4`` and the head; ``forward(xyz, features=None,
    bn_momentum=, generator=)`` is ``SemSegNet``'s contract."""

    def _check_features(self, features: Optional[torch.Tensor]) -> None:
        if (features is None) != (self.in_features == 0):
            raise ValueError(
                f"model built for {self.in_features} feature channels, got "
                f"{None if features is None else features.shape[-1]}")

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self._check_features(features)
        xyzs, feats = [xyz], [features]
        for i in range(4):
            new_xyz, pooled, _ = self._level(i, xyzs[-1], feats[-1], bn_momentum, generator)
            xyzs.append(new_xyz)
            feats.append(pooled)
        return self.head(xyzs, feats, bn_momentum, generator)


class AttentionNetModel(_AttentionNetBase):
    """Four ``AttentionNetLayer``s (out_dim 8/16/32/64, one inner block of
    out_dim each) and the FP head.  ``inner_kind='mlp'`` is the
    AttentionNetMLP variant; ``in_features`` > 0 feeds per-point features
    (the AttentionNetFeature variant)."""

    OUT_DIMS = (8, 16, 32, 64)

    def __init__(self, num_classes: int = 21, in_features: int = 0,
                 inner_kind: str = "attention", dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = in_features
        widths = [in_features]
        for i, out_dim in enumerate(self.OUT_DIMS):
            layer = AttentionNetLayer(NPOINTS[i], out_dim, [out_dim], widths[-1],
                                      inner_kind=inner_kind, compute_dtype=compute_dtype)
            self.add_module(f"l{i + 1}", layer)
            widths.append(layer.out_channels)
        self.head = _FPHead(widths, num_classes, dropout_rate, compute_dtype)

    def _level(self, i, xyz, points, bn_momentum, generator):
        return getattr(self, f"l{i + 1}")(xyz, points, generator=generator)


class PoolingAttentionNetModel(_AttentionNetBase):
    """Four ``PoolingAttentionNetLayer``s (mlps [32,32,64] .. [256,256,512],
    out_dims 64/128/256/512) and the FP head."""

    MLPS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
    OUT_DIMS = (64, 128, 256, 512)

    def __init__(self, num_classes: int = 21, in_features: int = 0,
                 dropout_rate: float = 0.5, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = in_features
        widths = [in_features]
        for i, out_dim in enumerate(self.OUT_DIMS):
            layer = PoolingAttentionNetLayer(NPOINTS[i], out_dim, self.MLPS[i], widths[-1],
                                             compute_dtype=compute_dtype)
            self.add_module(f"l{i + 1}", layer)
            widths.append(layer.out_channels)
        self.head = _FPHead(widths, num_classes, dropout_rate, compute_dtype)

    def _level(self, i, xyz, points, bn_momentum, generator):
        return getattr(self, f"l{i + 1}")(xyz, points, bn_momentum=bn_momentum)
