"""Plain PyTorch point-cloud geometry ops.

The semantic source of truth of the port, as ``ops/geometry.py`` is for the
JAX package: the CPU path of every op and the oracle each CUDA kernel in
``ops/cuda/`` is held against on the card.  They run on any device.

Exactness notes (each kernel must give bit-identical indices):

- Squared distances are summed as ``(dx*dx + dy*dy) + dz*dz``, each step
  rounded on its own, which is what the kernels compute.
- Ties go to the lower index everywhere: the FPS argmax, the ball-query
  order and the three-NN order.  ``torch.topk`` does not promise that, so
  argmax is a masked index minimum and three-NN a stable sort.
- Pairwise-distance intermediates are taken over query chunks so no chunk
  holds more than ``_MAX_CHUNK_ELEMS`` elements.
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


def knn_point(k: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest points of xyz (B,N,3) to each query centre of
    new_xyz (B,M,3): squared dist (B,M,k) ascending and idx (B,M,k) int32,
    lower index on ties (a stable sort, as JAX's ``lax.top_k``).  With
    ``k > N`` the farthest neighbour repeats.  Plain PyTorch on every
    device: the JAX package computes it in XLA, not in a Pallas kernel."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    k_eff = min(k, n)
    chunk = _query_chunk(m, b, n)
    dists, idxs = [], []
    for s in range(0, m, chunk):
        d2 = _pairwise_sqdist(new_xyz[:, s:s + chunk], xyz)  # (B, Mc, N)
        vals, order = torch.sort(d2, dim=-1, stable=True)
        dists.append(vals[..., :k_eff])
        idxs.append(order[..., :k_eff].to(torch.int32))
    dist, idx = torch.cat(dists, dim=1), torch.cat(idxs, dim=1)
    if k_eff < k:
        pad = k - k_eff
        dist = torch.cat([dist, dist[..., -1:].expand(b, m, pad)], dim=-1)
        idx = torch.cat([idx, idx[..., -1:].expand(b, m, pad)], dim=-1)
    return dist, idx


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


def group_point_backward(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The gradient of ``group_point`` with respect to ``points``: g (B,M,K,C),
    idx (B,M,K) -> dP (B,n,C), each row the sum of the g rows gathered from
    it, by ``index_add_`` over the flattened rows.  The oracle of
    ``csrc/group_gather_bwd.cu``; autograd on the CPU differentiates
    ``group_point`` itself.  On the CPU, ``index_add_`` adds each row's g
    rows from 0 in ascending flat slot (b*M + m)*K + k, and the kernel
    matches that bit for bit; on the card it adds them with atomics in no
    fixed order."""
    b, m, k, c = g.shape
    offset = torch.arange(b, device=g.device)[:, None] * n
    rows = (idx.reshape(b, m * k).long() + offset).reshape(-1)
    dp = g.new_zeros((b * n, c))
    dp.index_add_(0, rows, g.reshape(b * m * k, c))
    return dp.reshape(b, n, c)


def three_interpolate_backward(g: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                               points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``three_interpolate``: g (B,N,C) -> dP (B,M,C), the
    scatter-add of ``weight[b,n,k] * g[b,n]`` into rows ``idx[b,n,k]``, and
    dw (B,N,3), ``dw[b,n,k] = <g[b,n], points[b, idx[b,n,k]]>``; idx gets
    none.  The oracle of ``csrc/three_interpolate_bwd.cu``.  On the CPU,
    ``index_add_`` adds each row's products from 0 in ascending (n, k)
    order, and the kernel's dP matches that bit for bit; on the card
    ``index_add_`` adds them with atomics in no fixed order."""
    b, n, c = g.shape
    m = points.shape[1]
    offset = torch.arange(b, device=g.device)[:, None, None] * m
    rows = (idx.long() + offset).reshape(-1)
    contrib = (weight[..., None] * g[:, :, None, :]).reshape(b * n * 3, c)
    dp = g.new_zeros((b * m, c))
    dp.index_add_(0, rows, contrib)
    dw = (group_point(points, idx) * g[:, :, None, :]).sum(dim=-1)
    return dp.reshape(b, m, c), dw


def transpose_csr(idx: torch.Tensor, n_keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transpose of idx (B, ...) with values in [0, n_keys) as a CSR over
    the B*n_keys keys: a stable sort of the flat keys ``b*n_keys + idx[b, e]``,
    e the flat index within a batch.  Returns offsets (B*n_keys + 1) and
    entries (idx.numel()), int32: the entries of key b*n_keys + t are the flat
    indices E of idx with ``idx[b, e] == t``, ascending.  The oracle of
    ``csrc/csr.cuh``."""
    b = idx.shape[0]
    keys = (idx.reshape(b, -1).long()
            + torch.arange(b, device=idx.device)[:, None] * n_keys).reshape(-1)
    entries = torch.sort(keys, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(b * n_keys + 1, dtype=torch.int64, device=idx.device)
    offsets[1:] = torch.bincount(keys, minlength=b * n_keys).cumsum(0)
    return offsets.to(torch.int32), entries


def interpolation_csr(idx: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``transpose_csr`` of the interpolation's idx (B,N,3) over the B*M known
    points: the entries of key b*M + t are the flat indices ``b*3N + 3n + k``
    with ``idx[b,n,k] == t``, ascending (the CSR of
    ``csrc/three_interpolate_bwd.cu``)."""
    return transpose_csr(idx, m)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Inverse-distance weights over the 3 neighbours, normalised to sum to 1;
    dist are squared distances, clamped below at ``eps``."""
    inv = 1.0 / dist.clamp_min(eps)
    return inv / inv.sum(dim=-1, keepdim=True)


def prob_sample(cdf_weights: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Weighted categorical sampling by inverse CDF: weights (B, N) >= 0 (not
    normalised), uniforms (B, M) in [0, 1) -> (B, M) int32 indices, the first
    index whose running sum reaches ``u * total``, clamped to [0, N-1].
    The running sum is a float32 ``cumsum`` (exact for integer-valued
    weights below 2**24)."""
    cdf = torch.cumsum(cdf_weights.to(torch.float32), dim=-1)
    targets = uniforms.to(torch.float32) * cdf[..., -1:]
    idx = torch.searchsorted(cdf.contiguous(), targets.contiguous(), right=False)
    return idx.clamp(0, cdf_weights.shape[-1] - 1).to(torch.int32)
