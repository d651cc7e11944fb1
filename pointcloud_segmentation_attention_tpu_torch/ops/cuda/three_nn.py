"""Wrapper of ``csrc/three_nn.cu``: three nearest neighbours on the card."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
    allow_smem,
    check_input,
    launch,
    refuse_grad,
    ring_bytes,
)

WHOLE_MAX_POINTS = 8192       # the largest known cloud staged whole (96 KB)
TILE = 1024                   # points per ring tile beyond that (12 KB)
PER_THREAD = (2, 1)           # unknowns a thread owns, most first
MIN_THREADS = 65_536          # Q rises only while the threads still number this many
THREADS = (256, 128, 64, 32)  # threads a block, most first
MIN_BLOCKS = 128              # about one block per SM of an H100


class ThreeNnPlan(NamedTuple):
    """How ``csrc/three_nn.cu`` runs one call."""

    variant: str      # "whole": the known cloud in one tile; "ring": two tile buffers
    per_thread: int   # unknown points each thread owns (Q)
    threads: int      # threads per block
    tile: int         # known points per tile, a multiple of 32
    stages: int       # tile buffers
    smem_bytes: int   # dynamic shared memory per block
    blocks: int       # blocks per cloud; the grid is (blocks, B)


def plan(b: int, n: int, m: int) -> ThreeNnPlan:
    """The launch for B clouds of N unknown and M known points.

    Q is 2 while B * ceil(N / 2) threads still number ``MIN_THREADS`` (FP4
    at B16: 131,072 unknowns), else 1; 4 measured slower at FP4.  A block
    takes the most threads (up to 256) that still give ``MIN_BLOCKS``
    blocks (FP4 at B16: 256, FP3: 128, FP1-2: 32).  Both rules come from
    ``utils/plan_sweep.py`` on an H100.  The known cloud is staged whole up
    to ``WHOLE_MAX_POINTS`` points, else it passes through a ring of two
    ``TILE``-point tiles.  Above 48 KB the kernel must be allowed the shared
    memory first (``ops/cuda/__init__.py:allow_smem``)."""
    if b < 1 or n < 1 or m < 1:
        raise ValueError(f"three_nn plan needs B, N, M >= 1, got {b}, {n}, {m}")
    per_thread = next(q for q in PER_THREAD if q == 1 or b * -(-n // q) >= MIN_THREADS)
    run = -(-n // per_thread)  # threads a cloud needs
    threads = next(t for t in THREADS
                   if t == 32 or (t <= -(-run // 32) * 32 and b * -(-run // t) >= MIN_BLOCKS))
    whole = -(-m // 32) * 32
    if whole <= WHOLE_MAX_POINTS:
        tile, stages = whole, 1
    else:
        tile, stages = TILE, 2
    return ThreeNnPlan("whole" if stages == 1 else "ring", per_thread, threads, tile, stages,
                       ring_bytes(tile, stages), -(-run // threads))


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
    if b * n == 0:
        return (torch.empty((b, n, 3), dtype=torch.float32, device=xyz1.device),
                torch.empty((b, n, 3), dtype=torch.int32, device=xyz1.device))
    if m == 0:  # no known point: every slot is padding
        return (torch.full((b, n, 3), torch.finfo(torch.float32).max, device=xyz1.device),
                torch.zeros((b, n, 3), dtype=torch.int32, device=xyz1.device))
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=xyz1.device)
    p = plan(b, n, m)
    allow_smem("psa_three_nn_allow_smem", xyz1.device, p.smem_bytes)
    launch("psa_three_nn", xyz1.device, xyz1.data_ptr(), xyz2.data_ptr(),
           dist.data_ptr(), idx.data_ptr(), b, n, m, p.per_thread, p.threads, p.tile, p.stages,
           p.smem_bytes, p.blocks)
    three_nn.launches += 1
    return dist, idx


three_nn.launches = 0
