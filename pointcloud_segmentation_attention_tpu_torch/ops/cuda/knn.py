"""Wrapper of ``csrc/knn.cu``: the k (<= 16) nearest neighbours on the card."""
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

KMAX = (8, 16)                # the sorted lists the kernel keeps, smallest first
WHOLE_MAX_POINTS = 8192       # the largest cloud staged whole (96 KB)
TILE = 1024                   # points per ring tile beyond that (12 KB)
MIN_THREADS = 65_536          # two queries a thread only while the threads still number this many
THREADS = (256, 128, 64, 32)  # threads a block, most first
MIN_BLOCKS = 128              # about one block per SM of an H100


class KnnPlan(NamedTuple):
    """How ``csrc/knn.cu`` runs one call."""

    kmax: int         # the list kept in registers (8 or 16); the first k are written
    per_thread: int   # queries each thread owns (Q)
    threads: int      # threads per block
    tile: int         # cloud points per tile, a multiple of 32
    stages: int       # tile buffers
    smem_bytes: int   # dynamic shared memory per block
    blocks: int       # blocks per cloud; the grid is (blocks, B)
    variant: str      # "whole": the cloud in one tile; "ring": two tile buffers


def plan(b: int, m: int, n: int, k: int) -> KnnPlan:
    """The launch for B clouds of M queries among N points, k <= min(16, N).

    The list is the smallest of ``KMAX`` that holds k.  Q is 2 only with
    the list of 8 (16 entries and their indices a query would crowd the
    registers at Q 2) and while B * ceil(M / 2) threads still number
    ``MIN_THREADS`` (the level-1 self kNN at B16: 131,072 queries); else 1.
    Threads a block and the staging follow ``three_nn.plan``: the most
    threads (up to 256) that still give ``MIN_BLOCKS`` blocks, the cloud
    staged whole up to ``WHOLE_MAX_POINTS`` points, else a ring of two
    ``TILE``-point tiles.  Above 48 KB the kernel must be allowed the shared
    memory first (``ops/cuda/__init__.py:allow_smem``)."""
    if b < 1 or m < 1 or n < 1:
        raise ValueError(f"knn plan needs B, M, N >= 1, got {b}, {m}, {n}")
    if not 1 <= k <= min(KMAX[-1], n):
        raise ValueError(f"knn plan needs 1 <= k <= min({KMAX[-1]}, N), got k {k}, N {n}")
    kmax = next(x for x in KMAX if x >= k)
    per_thread = 2 if kmax == KMAX[0] and b * -(-m // 2) >= MIN_THREADS else 1
    run = -(-m // per_thread)  # threads a cloud needs
    threads = next(t for t in THREADS
                   if t == 32 or (t <= -(-run // 32) * 32 and b * -(-run // t) >= MIN_BLOCKS))
    whole = -(-n // 32) * 32
    if whole <= WHOLE_MAX_POINTS:
        tile, stages = whole, 1
    else:
        tile, stages = TILE, 2
    return KnnPlan(kmax, per_thread, threads, tile, stages, ring_bytes(tile, stages),
                   -(-run // threads), "whole" if stages == 1 else "ring")


def knn_point(k: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest points of xyz (B,N,3) to each query of new_xyz
    (B,M,3), f32 CUDA: squared dist (B,M,k) ascending and idx (B,M,k) int32,
    lower index on ties; with k > N the farthest neighbour repeats, as in
    ``ops/geometry.py:knn_point``.  k may be at most 16.  The distances
    carry no gradient, so inputs that require one are refused."""
    check_input(xyz, "xyz", torch.float32, 3, last=3)
    check_input(new_xyz, "new_xyz", torch.float32, 3, last=3)
    refuse_grad("knn_point", xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if new_xyz.shape[0] != b or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    if k > KMAX[-1]:
        raise ValueError(f"the kNN kernel serves k <= {KMAX[-1]}, got {k}")
    if b * m == 0 or k < 1:
        return (torch.empty((b, m, max(k, 0)), dtype=torch.float32, device=xyz.device),
                torch.empty((b, m, max(k, 0)), dtype=torch.int32, device=xyz.device))
    if n == 0:
        raise ValueError("knn_point needs at least one point a cloud")
    k_eff = min(k, n)
    dist = torch.empty((b, m, k_eff), dtype=torch.float32, device=xyz.device)
    idx = torch.empty((b, m, k_eff), dtype=torch.int32, device=xyz.device)
    p = plan(b, m, n, k_eff)
    allow_smem("psa_knn_allow_smem", xyz.device, p.smem_bytes)
    launch("psa_knn", xyz.device, new_xyz.data_ptr(), xyz.data_ptr(), dist.data_ptr(),
           idx.data_ptr(), b, m, n, k_eff, p.kmax, p.per_thread, p.threads, p.tile, p.stages,
           p.smem_bytes, p.blocks)
    knn_point.launches += 1
    if k_eff < k:
        pad = k - k_eff
        dist = torch.cat([dist, dist[..., -1:].expand(b, m, pad)], dim=-1)
        idx = torch.cat([idx, idx[..., -1:].expand(b, m, pad)], dim=-1)
    return dist, idx


knn_point.launches = 0
