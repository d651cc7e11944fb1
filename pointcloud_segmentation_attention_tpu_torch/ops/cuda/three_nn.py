"""Wrapper of ``csrc/three_nn.cu``: three nearest neighbours on the card."""
from __future__ import annotations

from typing import Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
    check_input,
    launch,
    refuse_grad,
)


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,N,3) unknown, (B,M,3) known f32 CUDA -> squared dist (B,N,3) ascending,
    idx (B,N,3) int32; slots beyond M hold FLT_MAX and index 0.  The
    distances carry no gradient, so inputs that require one are refused."""
    check_input(xyz1, "xyz1", torch.float32, 3, last=3)
    check_input(xyz2, "xyz2", torch.float32, 3, last=3)
    refuse_grad("three_nn", xyz1, xyz2)
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    if xyz2.shape[0] != b or xyz2.device != xyz1.device:
        raise ValueError("xyz1 and xyz2 must share batch size and device")
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=xyz1.device)
    if b * n == 0:
        return dist, idx
    launch("psa_three_nn", xyz1.device, xyz1.data_ptr(), xyz2.data_ptr(),
           dist.data_ptr(), idx.data_ptr(), b, n, m)
    three_nn.launches += 1
    return dist, idx


three_nn.launches = 0
