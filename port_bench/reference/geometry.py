"""Plain PyTorch geometry ops of the reference: a frozen copy of the
port's ``ops/geometry.py`` (the oracle its CUDA kernels are held against
bit for bit), so that the yardstick does not move when the program's copy
changes.  Squared distances are summed ``(dx*dx + dy*dy) + dz*dz``; ties
go to the lower index everywhere.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Budget (elements) for one (B, M_chunk, N) distance tile: 2**23 f32 = 32 MiB.
_MAX_CHUNK_ELEMS = 2 ** 23


def _sq_dist(ax, ay, az, bx, by, bz) -> torch.Tensor:
    dx, dy, dz = ax - bx, ay - by, az - bz
    return dx * dx + dy * dy + dz * dz


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (B, M, 3), b: (B, N, 3) -> (B, M, N) squared distances (a - b)."""
    a3, b3 = a[:, :, None, :], b[:, None, :, :]
    return _sq_dist(a3[..., 0], a3[..., 1], a3[..., 2],
                    b3[..., 0], b3[..., 1], b3[..., 2])


def _query_chunk(m: int, b: int, n: int) -> int:
    return max(1, min(m, _MAX_CHUNK_ELEMS // max(b * n, 1)))


def radius_threshold(radius: float) -> float:
    """float32(max(radius, 1e-20)**2): squared in double, rounded once, as the
    JAX package compares ``d2 < r**2`` against a weakly typed f32 scalar."""
    return float(np.float32(max(radius, 1e-20) ** 2))


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32.  Seeds at index 0 with an initial
    min-distance of 1e38; each pick is the argmax of the running min squared
    distance to the picked set, lower index on ties."""
    b, n, _ = xyz.shape
    if npoint < 1:
        raise ValueError("npoint must be >= 1")
    xyz = xyz.float()
    out = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    if npoint == 1 or b == 0:
        return out
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lane = torch.arange(n, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    mind = torch.full((b, n), 1e38, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        lx, ly, lz = (c[rows, last][:, None] for c in (x, y, z))
        mind = torch.minimum(mind, _sq_dist(x, y, z, lx, ly, lz))
        best = mind.amax(dim=1, keepdim=True)
        last = torch.where(mind == best, lane, n).amin(dim=1)
        out[:, j] = last.to(torch.int32)
    return out


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, :] = points[b, idx[b, m], :]; (B,N,C), (B,M) -> (B,M,C)."""
    b, m = idx.shape
    index = idx.long().reshape(b, m, 1).expand(b, m, points.shape[-1])
    return torch.gather(points, 1, index)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, k, :] = points[b, idx[b, m, k], :]; (B,N,C), (B,M,K) -> (B,M,K,C)."""
    b, m, k = idx.shape
    return gather_point(points, idx.reshape(b, m * k)).reshape(b, m, k, points.shape[-1])


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``nsample`` points in index order with ``d2 < max(r,1e-20)^2``.

    Returns idx (B, M, nsample) int32 and cnt (B, M) int32, cnt clamped to
    nsample.  Slots at or beyond cnt repeat the first hit; an empty ball gives
    index 0.  ``nsample`` may exceed N.  A masked cumulative sum gives every
    hit its slot, so no sort is needed.
    """
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    r2 = radius_threshold(radius)
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    dev = xyz.device
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    slots = torch.arange(nsample, dtype=torch.int32, device=dev)
    chunk = _query_chunk(m, b, n)
    idx_parts, cnt_parts = [], []
    for s in range(0, m, chunk):
        mask = _pairwise_sqdist(new_xyz[:, s:s + chunk], xyz) < r2  # (B, Mc, N)
        pos = mask.cumsum(dim=-1, dtype=torch.int32)
        cnt = pos[..., -1].clamp(max=nsample) if n else pos.new_zeros(mask.shape[:2])
        # Hits beyond nsample, and non-hits, go to a discarded extra slot.
        slot = torch.where(mask & (pos <= nsample), pos - 1, nsample).long()
        hits = torch.zeros(mask.shape[:2] + (nsample + 1,), dtype=torch.int32, device=dev)
        hits.scatter_(-1, slot, lane.expand(mask.shape).contiguous())
        hits = hits[..., :nsample]
        idx_parts.append(torch.where(slots < cnt[..., None], hits, hits[..., :1]))
        cnt_parts.append(cnt)
    return torch.cat(idx_parts, dim=1), torch.cat(cnt_parts, dim=1)


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest known points (xyz2, (B,M,3)) of each unknown point (xyz1,
    (B,N,3)): squared dist (B,N,3) ascending, idx (B,N,3) int32, lower index
    on ties.  With M < 3 the missing slots hold float32 max and index 0."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    xyz1 = xyz1.float()
    xyz2 = xyz2.float()
    k = min(3, m)
    chunk = _query_chunk(n, b, m)
    dists, idxs = [], []
    for s in range(0, n, chunk):
        d2 = _pairwise_sqdist(xyz1[:, s:s + chunk], xyz2)  # (B, Nc, M)
        vals, order = torch.sort(d2, dim=-1, stable=True)
        dists.append(vals[..., :k])
        idxs.append(order[..., :k].to(torch.int32))
    dist, idx = torch.cat(dists, dim=1), torch.cat(idxs, dim=1)
    if k < 3:
        pad = (b, n, 3 - k)
        big = torch.finfo(torch.float32).max
        dist = torch.cat([dist, dist.new_full(pad, big)], dim=-1)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
    return dist, idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """out[b,n,:] = sum_k weight[b,n,k] * points[b, idx[b,n,k], :], k in order.

    points (B,M,C), idx (B,N,3), weight (B,N,3) -> (B,N,C)."""
    g = group_point(points, idx)  # (B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Inverse-distance weights over the 3 neighbours, normalised to sum to 1;
    dist are squared distances, clamped below at ``eps``."""
    inv = 1.0 / dist.clamp_min(eps)
    return inv / inv.sum(dim=-1, keepdim=True)
