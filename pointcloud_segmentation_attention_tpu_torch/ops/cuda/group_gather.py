"""Wrappers of ``csrc/group_gather.cu`` and ``csrc/group_gather_bwd.cu``:
neighbourhood row gather on the card, its scatter-add backward, and the
autograd function joining them."""
from __future__ import annotations

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
    check_input,
    launch,
    refuse_grad,
)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,N,C) f32, (B,M,K) int32 CUDA -> (B,M,K,C): out[b,m,k] = points[b, idx[b,m,k]].
    Not differentiable itself: ``GroupPoint`` is."""
    check_input(points, "points", torch.float32, 3)
    check_input(idx, "idx", torch.int32, 3)
    refuse_grad("group_point", points)
    b, n, c = points.shape
    _, m, k = idx.shape
    if idx.shape[0] != b or idx.device != points.device:
        raise ValueError("points and idx must share batch size and device")
    out = torch.empty((b, m, k, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    launch("psa_group_gather", points.device, points.data_ptr(), idx.data_ptr(),
           out.data_ptr(), b, n, c, m * k)
    group_point.launches += 1
    return out


def group_point_backward(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B,M,K,C) f32, (B,M,K) int32 CUDA -> dP (B,n,C): the sum of the g rows
    gathered from each of the n rows.  Summed with atomics: not
    bit-reproducible."""
    check_input(g, "g", torch.float32, 4)
    check_input(idx, "idx", torch.int32, 3)
    b, m, k, c = g.shape
    if tuple(idx.shape) != (b, m, k) or idx.device != g.device:
        raise ValueError("g and idx shapes or devices disagree")
    if g.numel() == 0 or n == 0:
        return torch.zeros((b, n, c), dtype=torch.float32, device=g.device)
    dp = torch.empty((b, n, c), dtype=torch.float32, device=g.device)  # zeroed by the call
    launch("psa_group_gather_bwd", g.device, g.data_ptr(), idx.data_ptr(), dp.data_ptr(),
           b, n, c, m, k)
    group_point_backward.launches += 1
    return dp


class GroupPoint(torch.autograd.Function):
    """``group_point`` with the scatter-add kernel as its backward; ``idx``
    gets no gradient."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return group_point(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        dp = None
        if ctx.needs_input_grad[0]:
            dp = group_point_backward(grad.contiguous(), idx, ctx.n)
        return dp, None


group_point.launches = 0
group_point_backward.launches = 0
