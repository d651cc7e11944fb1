"""Wrappers of ``csrc/three_interpolate.cu`` and ``csrc/three_interpolate_bwd.cu``:
weighted 3-row gather on the card, its backward, and the autograd function
joining them."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
    check_input,
    launch,
    refuse_grad,
)


def _check(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> None:
    check_input(points, "points", torch.float32, 3)
    check_input(idx, "idx", torch.int32, 3, last=3)
    check_input(weight, "weight", torch.float32, 3, last=3)
    if idx.shape[0] != points.shape[0] or weight.shape != idx.shape:
        raise ValueError("points, idx and weight shapes disagree")
    if idx.device != points.device or weight.device != points.device:
        raise ValueError("points, idx and weight must share a device")


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B,M,C) f32, (B,N,3) int32, (B,N,3) f32 CUDA -> (B,N,C).  Not
    differentiable itself: ``ThreeInterpolate`` is."""
    _check(points, idx, weight)
    refuse_grad("three_interpolate", points, weight)
    b, m, c = points.shape
    n = idx.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    launch("psa_three_interpolate", points.device, points.data_ptr(), idx.data_ptr(),
           weight.data_ptr(), out.data_ptr(), b, m, n, c)
    three_interpolate.launches += 1
    return out


def three_interpolate_backward(
    g: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, points: torch.Tensor,
    need_dw: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """g (B,N,C) f32 CUDA -> (dP (B,M,C), dw (B,N,3) or None when not
    ``need_dw``).  dP is summed with atomics: not bit-reproducible."""
    _check(points, idx, weight)
    check_input(g, "g", torch.float32, 3)
    b, m, c = points.shape
    n = idx.shape[1]
    if tuple(g.shape) != (b, n, c) or g.device != points.device:
        raise ValueError("g must be (B, N, C) on the points' device")
    dw = torch.empty((b, n, 3), dtype=torch.float32, device=g.device) if need_dw else None
    if g.numel() == 0:
        if dw is not None:
            dw.zero_()
        return torch.zeros_like(points), dw
    dp = torch.empty_like(points)  # zeroed by the call
    launch("psa_three_interpolate_bwd", g.device, g.data_ptr(), idx.data_ptr(),
           weight.data_ptr(), points.data_ptr() if need_dw else None, dp.data_ptr(),
           dw.data_ptr() if need_dw else None, b, m, n, c)
    three_interpolate_backward.launches += 1
    return dp, dw


class ThreeInterpolate(torch.autograd.Function):
    """``three_interpolate`` with the backward kernel; gradients for points
    and weight (``dw`` only when it is needed), none for idx."""

    @staticmethod
    def forward(ctx, points, idx, weight):
        ctx.save_for_backward(points, idx, weight)
        return three_interpolate(points, idx, weight)

    @staticmethod
    def backward(ctx, grad):
        points, idx, weight = ctx.saved_tensors
        need_dp, _, need_dw = ctx.needs_input_grad
        if not (need_dp or need_dw):
            return None, None, None
        dp, dw = three_interpolate_backward(grad.contiguous(), idx, weight, points,
                                            need_dw=need_dw)
        return (dp if need_dp else None), None, dw


three_interpolate.launches = 0
three_interpolate_backward.launches = 0
