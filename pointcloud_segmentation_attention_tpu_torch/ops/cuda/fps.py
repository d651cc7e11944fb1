"""Wrapper of ``csrc/fps.cu``: farthest point sampling on the card."""
from __future__ import annotations

from typing import NamedTuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import check_input, launch

CLUSTER_MIN_N = 4096    # smaller clouds run one block each
CLUSTER = 8             # blocks per cloud in a cluster: the portable size
# Blocks per cloud -> (points each thread keeps in registers, most threads
# a block).  Few warps a block keep the per-pick exchange short: SA1
# (N 8192) runs 8 blocks of 64 threads x 16 points.
REGISTERS = {1: (4, 1024), CLUSTER: (16, 512)}
MEM_THREADS = 1024
SMEM_BYTES_PER_POINT = 16  # xyz and the running min-distance, f32
MAX_SMEM_BYTES = 200 * 1024


class FpsPlan(NamedTuple):
    """How ``csrc/fps.cu`` runs one call."""

    variant: str        # "block", "cluster", "cluster-smem" or "cluster-global"
    cluster: int        # blocks per cloud
    threads: int        # threads per block
    per_thread: int     # points each thread keeps in registers; 0: the slice is in memory
    smem_bytes: int     # dynamic shared memory per block ("cluster-smem")
    scratch_bytes: int  # min-distance scratch in device memory ("cluster-global")


def plan(b: int, n: int) -> FpsPlan:
    """The variant for B clouds of N points.  npoint does not enter: every
    variant runs the same pick loop.

    A cloud of N < ``CLUSTER_MIN_N`` is one block's slice; a larger one is
    cut into 8 slices of ceil(N / 8) points, one per block of a cluster.  A
    slice sits in registers, in the fewest threads (a multiple of 32) that
    hold it, within ``REGISTERS``' limit; else (clusters only) in shared
    memory at 16 bytes a point; else in device memory, with a (B, N) f32
    min-distance scratch."""
    if b < 1 or n < 1:
        raise ValueError(f"farthest_point_sample plan needs B, N >= 1, got {b}, {n}")
    cluster = 1 if n < CLUSTER_MIN_N else CLUSTER
    slice_ = -(-n // cluster)
    k, max_threads = REGISTERS[cluster]
    threads = max(32, -(-slice_ // (32 * k)) * 32)
    if threads <= max_threads:
        return FpsPlan("block" if cluster == 1 else "cluster", cluster, threads, k, 0, 0)
    smem = slice_ * SMEM_BYTES_PER_POINT
    if smem <= MAX_SMEM_BYTES:
        return FpsPlan("cluster-smem", cluster, MEM_THREADS, 0, smem, 0)
    return FpsPlan("cluster-global", cluster, MEM_THREADS, 0, 0, b * n * 4)


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
    p = plan(b, n)
    scratch = (torch.empty((b, n), dtype=torch.float32, device=xyz.device)
               if p.scratch_bytes else None)
    launch("psa_fps", xyz.device, xyz.data_ptr(),
           None if scratch is None else scratch.data_ptr(), out.data_ptr(),
           b, n, npoint, p.cluster, p.threads, p.per_thread, p.smem_bytes)
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0
