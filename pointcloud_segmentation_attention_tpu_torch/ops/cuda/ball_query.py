"""Wrapper of ``csrc/ball_query.cu``: first-k-in-order ball query on the card."""
from __future__ import annotations

from typing import Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import check_input, launch
from pointcloud_segmentation_attention_tpu_torch.ops.geometry import radius_threshold


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,N,3), (B,M,3) f32 CUDA -> idx (B,M,nsample) int32, cnt (B,M) int32."""
    check_input(xyz, "xyz", torch.float32, 3, last=3)
    check_input(new_xyz, "new_xyz", torch.float32, 3, last=3)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if new_xyz.shape[0] != b or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    if nsample < 1:
        raise ValueError("nsample must be >= 1")
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    if b * m == 0:
        return idx, cnt
    launch("psa_ball_query", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
           idx.data_ptr(), cnt.data_ptr(), b, n, m, radius_threshold(radius), nsample)
    ball_query.launches += 1
    return idx, cnt


ball_query.launches = 0
