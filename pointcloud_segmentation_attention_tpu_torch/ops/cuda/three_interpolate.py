"""Wrapper of ``csrc/three_interpolate.cu``: weighted 3-row gather on the card."""
from __future__ import annotations

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import check_input, launch


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B,M,C) f32, (B,N,3) int32, (B,N,3) f32 CUDA -> (B,N,C)."""
    check_input(points, "points", torch.float32, 3)
    check_input(idx, "idx", torch.int32, 3, last=3)
    check_input(weight, "weight", torch.float32, 3, last=3)
    b, m, c = points.shape
    n = idx.shape[1]
    if idx.shape[0] != b or weight.shape != idx.shape:
        raise ValueError("points, idx and weight shapes disagree")
    if idx.device != points.device or weight.device != points.device:
        raise ValueError("points, idx and weight must share a device")
    out = torch.empty((b, n, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    launch("psa_three_interpolate", points.device, points.data_ptr(), idx.data_ptr(),
           weight.data_ptr(), out.data_ptr(), b, m, n, c)
    three_interpolate.launches += 1
    return out


three_interpolate.launches = 0
