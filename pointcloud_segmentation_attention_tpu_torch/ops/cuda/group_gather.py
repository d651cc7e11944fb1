"""Wrapper of ``csrc/group_gather.cu``: neighbourhood row gather on the card."""
from __future__ import annotations

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import check_input, launch


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,N,C) f32, (B,M,K) int32 CUDA -> (B,M,K,C): out[b,m,k] = points[b, idx[b,m,k]]."""
    check_input(points, "points", torch.float32, 3)
    check_input(idx, "idx", torch.int32, 3)
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


group_point.launches = 0
