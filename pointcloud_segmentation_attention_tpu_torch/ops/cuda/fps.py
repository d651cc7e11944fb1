"""Wrapper of ``csrc/fps.cu``: farthest point sampling on the card."""
from __future__ import annotations

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import check_input, launch


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) f32 CUDA -> (B, npoint) int32; seeds at index 0."""
    check_input(xyz, "xyz", torch.float32, 3, last=3)
    b, n, _ = xyz.shape
    if npoint < 1:
        raise ValueError("npoint must be >= 1")
    if n < 1:
        raise ValueError("farthest_point_sample needs at least one point")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0:
        return out
    # Min-distance scratch, used only by clouds too large for shared memory.
    mind = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    launch("psa_fps", xyz.device, xyz.data_ptr(), mind.data_ptr(), out.data_ptr(),
           b, n, npoint)
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0
