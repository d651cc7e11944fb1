"""The Point Transformer's layers (Zhao, Jiang, Jia, Torr, Koltun, ICCV 2021,
arXiv:2012.09164), after the published code's
``model/pointtransformer/pointtransformer_seg.py``, on the port's dense
(B, N, C) clouds.

- ``PointTransformerLayer``: vector attention of every point over its k
  nearest neighbours j: q, k, v linear in x; a positional encoding
  d_ij = Linear(3 -> C)(ReLU(BN(Linear(3 -> 3)(p_j - p_i)))); weights
  w_ij = Linear(C/s -> C/s)(ReLU(BN(Linear(C -> C/s)(ReLU(BN(k_j - q_i +
  d_ij)))))), a softmax over j per channel group, and y_i = sum_j (v_j +
  d_ij) * a_ij, channel c taking weight channel c mod (C/s) (s =
  ``share_planes``).  BN statistics are over every (point, neighbour) pair.
- ``PointTransformerBlock``: ReLU(BN(Linear)) -> ReLU(BN(layer)) ->
  BN(Linear) + identity -> ReLU, both linears without a bias.
- ``TransitionDown``: stride 1, Linear-BN-ReLU of the features; stride s,
  FPS to N/s centres, their k nearest among the N points grouped as
  cat(p_j - p_i, x_j) (``sample_and_group`` with kNN grouping), Linear
  without a bias, BN, ReLU and the max over the k.
- ``TransitionUp`` (Linear-BN-ReLU of the fine features plus the 3-NN
  interpolation of Linear-BN-ReLU of the coarse ones, weights 1/(|p - p_j|
  + 1e-8) normalised, Euclidean as ``pointops.interpolation``) and
  ``TransitionUpHead`` (the coarsest level: Linear-BN-ReLU of cat(x,
  ReLU(Linear(mean of x over the cloud)))).

A level's self kNN and relative positions (``neighbourhood``) are computed
once and handed to each of its blocks; the published code recomputes the
same kNN in every layer.  Under a profiler the layer's forward is the span
``nn.vector_attention`` and the transitions ``nn.transition_down`` and
``nn.transition_up`` (``utils/profiler.py``).  Every BN is the port's
``ScheduledBatchNorm`` at the step's momentum; every product takes the
module's ``compute_dtype``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch import ops
from pointcloud_segmentation_attention_tpu_torch.nn.layers import (
    Dense,
    PointConv,
    ScheduledBatchNorm,
)
from pointcloud_segmentation_attention_tpu_torch.nn.modules import sample_and_group
from pointcloud_segmentation_attention_tpu_torch.utils import profiler

INTERPOLATION_EPS = 1e-8


def neighbourhood(p: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A level's self kNN of its points p (B, N, 3): idx (B, N, k) int32
    (each point's own index first) and the relative positions p_j - p_i
    (B, N, k, 3)."""
    _, idx = ops.knn_point(k, p, p)
    return idx, ops.group_point_with_counts(p, idx) - p[:, :, None, :]


class BatchNormReLU(nn.Module):
    """ReLU(BN(x)), the BN under the name ``bn``."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = ScheduledBatchNorm(channels)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        return torch.relu(self.bn(x, momentum=bn_momentum))


class PointTransformerLayer(nn.Module):
    """Vector attention over each point's neighbours (the module's
    docstring); ``planes`` C in and out, C divisible by ``share_planes``."""

    def __init__(self, planes: int, share_planes: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if planes % share_planes:
            raise ValueError(f"planes {planes} must be divisible by share_planes {share_planes}")
        dd = compute_dtype
        self.planes, self.share_planes = planes, share_planes
        self.q = Dense(planes, planes, dd)
        self.kv = Dense(planes, 2 * planes, dd)  # keys and values: one product, one gather
        self.pos0 = PointConv(3, 3, compute_dtype=dd)
        self.pos1 = Dense(3, planes, dd)
        self.w_norm = BatchNormReLU(planes)
        self.w0 = PointConv(planes, planes // share_planes, compute_dtype=dd)
        self.w1 = Dense(planes // share_planes, planes // share_planes, dd)

    def forward(self, x: torch.Tensor, rel: torch.Tensor, idx: torch.Tensor,
                bn_momentum: float = 0.9) -> torch.Tensor:
        """x (B, N, C), rel (B, N, k, 3), idx (B, N, k) -> (B, N, C)."""
        with profiler.span("nn.vector_attention"):
            b, n, c = x.shape
            k, s = idx.shape[-1], self.share_planes
            q = self.q(x)
            kv = ops.group_point_with_counts(self.kv(x), idx)  # (B, N, k, 2C)
            delta = self.pos1(self.pos0(rel, bn_momentum))
            w = self.w_norm(kv[..., :c] - q[:, :, None, :] + delta, bn_momentum)
            a = torch.softmax(self.w1(self.w0(w, bn_momentum)), dim=2)  # (B, N, k, C/s)
            y = ((kv[..., c:] + delta).view(b, n, k, s, c // s) * a[:, :, :, None, :]).sum(dim=2)
            return y.reshape(b, n, c)


class PointTransformerBlock(nn.Module):
    """The residual block around a ``PointTransformerLayer``."""

    def __init__(self, planes: int, share_planes: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        self.linear1 = PointConv(planes, planes, bias=False, compute_dtype=dd)
        self.attention = PointTransformerLayer(planes, share_planes, dd)
        self.norm2 = BatchNormReLU(planes)
        self.linear3 = PointConv(planes, planes, activation=False, bias=False, compute_dtype=dd)

    def forward(self, x: torch.Tensor, rel: torch.Tensor, idx: torch.Tensor,
                bn_momentum: float = 0.9) -> torch.Tensor:
        y = self.linear1(x, bn_momentum)
        y = self.norm2(self.attention(y, rel, idx, bn_momentum), bn_momentum)
        return torch.relu(self.linear3(y, bn_momentum) + x)


class TransitionDown(nn.Module):
    """Stride 1: Linear-BN-ReLU of x (c_in channels, the xyz included by the
    caller); stride s: N/s centres by FPS (at least one), each grouping its
    ``nsample`` nearest points."""

    def __init__(self, c_in: int, c_out: int, stride: int, nsample: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        self.linear = PointConv(c_in + 3 * (stride != 1), c_out, bias=False,
                                compute_dtype=compute_dtype)

    def forward(self, p: torch.Tensor, x: torch.Tensor,
                bn_momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiler.span("nn.transition_down"):
            if self.stride == 1:
                return p, self.linear(x, bn_momentum)
            m = max(1, p.shape[1] // self.stride)
            new_p, grouped, _, _ = sample_and_group(m, None, self.nsample, p, x, knn=True)
            return new_p, self.linear(grouped, bn_momentum).amax(dim=2)


class TransitionUp(nn.Module):
    """The fine level's Linear-BN-ReLU plus the interpolation of the coarse
    level's (``c_in`` -> ``c_out``) at the fine points."""

    def __init__(self, c_in: int, c_out: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear1 = PointConv(c_out, c_out, compute_dtype=compute_dtype)
        self.linear2 = PointConv(c_in, c_out, compute_dtype=compute_dtype)

    def forward(self, p_fine: torch.Tensor, x_fine: torch.Tensor, p_coarse: torch.Tensor,
                x_coarse: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        with profiler.span("nn.transition_up"):
            fine = self.linear1(x_fine, bn_momentum)
            coarse = self.linear2(x_coarse, bn_momentum)
            dist, idx = ops.three_nn(p_fine, p_coarse)
            recip = 1.0 / (torch.sqrt(dist) + INTERPOLATION_EPS)
            weight = recip / recip.sum(dim=-1, keepdim=True)
            return fine + ops.three_interpolate(coarse, idx, weight)


class TransitionUpHead(nn.Module):
    """The coarsest level's transition: each point's features beside a
    projection of its cloud's mean."""

    def __init__(self, planes: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear1 = PointConv(2 * planes, planes, compute_dtype=compute_dtype)
        self.linear2 = PointConv(planes, planes, bn=False, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        with profiler.span("nn.transition_up"):
            g = self.linear2(x.mean(dim=1, keepdim=True))
            return self.linear1(torch.cat([x, g.expand_as(x)], dim=-1), bn_momentum)
