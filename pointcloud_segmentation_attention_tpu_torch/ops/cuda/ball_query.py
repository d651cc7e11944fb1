"""Wrapper of ``csrc/ball_query.cu``: first-k-in-order ball query on the card."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
    check_input,
    launch,
    ring_bytes,
)
from pointcloud_segmentation_attention_tpu_torch.ops.geometry import radius_threshold

TILE = 1024              # points per shared-memory tile (12 KB)
PER_WARP = (4, 2, 1)     # centres a warp owns, most first
MIN_WARPS = 2048         # R rises only while the warps still number this many
MAX_WARPS = 8            # warps a block


class BallQueryPlan(NamedTuple):
    """How ``csrc/ball_query.cu`` runs one call."""

    variant: str      # "whole": one tile holds the cloud; "ring": two tile buffers
    per_warp: int     # centres each warp owns (R)
    threads: int      # threads per block
    tile: int         # points per tile, a multiple of 32
    stages: int       # tile buffers
    smem_bytes: int   # dynamic shared memory per block
    blocks: int       # blocks per cloud; the grid is (blocks, B)


def plan(b: int, n: int, m: int) -> BallQueryPlan:
    """The launch for B clouds of N points and M centres each.  nsample and
    the radius do not enter it.

    R is the most centres a warp may own while the B * ceil(M / R) warps
    still number ``MIN_WARPS`` (at B16: SA1's 16,384 centres take R 4, SA2's
    4,096 R 2, SA3-4 R 1; R 8 measured no faster at SA1).  A block takes up
    to 8 warps: the small levels
    ran fastest with their centres in as few blocks as that allows
    (``utils/plan_sweep.py``).  The cloud passes through tiles of up to
    ``TILE`` points: one tile when it fits, else a ring of two."""
    if b < 1 or n < 1 or m < 1:
        raise ValueError(f"ball_query plan needs B, N, M >= 1, got {b}, {n}, {m}")
    per_warp = next(r for r in PER_WARP
                    if r == 1 or (r <= m and b * -(-m // r) >= MIN_WARPS))
    warps_needed = -(-m // per_warp)
    warps = min(MAX_WARPS, warps_needed)
    tile = min(TILE, -(-n // 32) * 32)
    stages = 1 if n <= tile else 2
    return BallQueryPlan("whole" if stages == 1 else "ring", per_warp, 32 * warps, tile, stages,
                         ring_bytes(tile, stages), -(-warps_needed // warps))


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
    if b * m == 0:
        return (torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device),
                torch.empty((b, m), dtype=torch.int32, device=xyz.device))
    if n == 0:  # every ball is empty: count 0, slots index 0
        return (torch.zeros((b, m, nsample), dtype=torch.int32, device=xyz.device),
                torch.zeros((b, m), dtype=torch.int32, device=xyz.device))
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    p = plan(b, n, m)
    launch("psa_ball_query", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
           idx.data_ptr(), cnt.data_ptr(), b, n, m, radius_threshold(radius), nsample,
           p.per_warp, p.threads, p.tile, p.stages, p.smem_bytes, p.blocks)
    ball_query.launches += 1
    return idx, cnt


ball_query.launches = 0
