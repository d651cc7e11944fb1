"""FLOPs of the Point Transformer's forward from its configuration's widths,
and the least time its kNN could take.

Matmul FLOPs, as ``cost/model.py`` counts them: a linear of c_in -> c_out
over R rows is 2 R c_in c_out.  A level of n points, C channels and k
neighbours runs, per Point Transformer block: the block's two C x C
linears and the layer's q (C x C) and k, v (C x 2C) over the n points;
the positional encoding's 3 x 3 and 3 x C, the weights' C x C/8 and C/8 x
C/8 over the n k (point, neighbour) pairs; and the weighted sum over the
neighbours, 2 n k C.  A downward transition of stride s groups k
neighbours of each of its n/s centres: (3 + C_in) x C over n k / s
members; the stride-1 one (3 + F) x C over the points.  The upward ones:
the coarsest level's 2C x C over its points and C x C over one mean a
cloud; the others C x C over the fine and C_coarse x C over the coarse
points.  The head: C x C and C x classes over every point.  A training
step is three forwards.

The kNN bound follows ``cost/kernels.py:three_nn``: both clouds read and
(B, M, k) distances and indices written once, and 8 f32 operations for
each (query, point) pair, for every kNN the architecture needs: a self
kNN at each level and one for each downward transition's centres.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from port_bench.cost import kernels


def level_points(cfg: Dict, npoints: int) -> List[int]:
    out = [npoints]
    for s in cfg["stride"][1:]:
        out.append(max(1, out[-1] // s))
    return out


def _block(n: int, c: int, k: int, share: int) -> float:
    per_point = c * c + c * c + c * c + c * 2 * c           # linear1, linear3, q, kv
    per_pair = 3 * 3 + 3 * c + c * (c // share) + (c // share) ** 2
    return 2.0 * (n * per_point + n * k * per_pair) + 2.0 * n * k * c


def forward_flops(cfg: Dict, batch: int, npoints: int) -> float:
    """FLOPs of one forward of ``batch`` clouds of ``npoints``."""
    planes, blocks, ks = cfg["planes"], cfg["blocks"], cfg["nsample"]
    share, pts = cfg["share_planes"], level_points(cfg, npoints)
    flops = 0.0
    c_in = 3 + cfg["in_features"]
    for i, c in enumerate(planes):
        n, k = pts[i], ks[i]
        if cfg["stride"][i] == 1:
            flops += 2.0 * n * c_in * c
        else:
            flops += 2.0 * n * k * (3 + c_in) * c
        # blocks[i] - 1 encoder blocks and the level's one decoder block
        flops += blocks[i] * _block(n, c, k, share)
        c_in = c
    top = len(planes) - 1
    flops += 2.0 * (pts[top] * 2 * planes[top] * planes[top] + planes[top] * planes[top])
    for i in range(top):
        flops += 2.0 * (pts[i] * planes[i] * planes[i] + pts[i + 1] * planes[i + 1] * planes[i])
    flops += 2.0 * npoints * planes[0] * (planes[0] + cfg["num_classes"])
    return batch * flops


def train_step_flops(cfg: Dict, batch: int, npoints: int) -> float:
    return 3.0 * forward_flops(cfg, batch, npoints)


def knn_calls(cfg: Dict, batch: int, npoints: int) -> List[Tuple[int, int, int, int]]:
    """(B, M queries, N points, k) of every kNN of one forward."""
    pts, out = level_points(cfg, npoints), []
    for i, k in enumerate(cfg["nsample"]):
        if cfg["stride"][i] != 1:
            out.append((batch, pts[i], pts[i - 1], k))
        out.append((batch, pts[i], pts[i], k))
    return out


def knn(b: int, m: int, n: int, k: int) -> Tuple[float, float]:
    """Bytes and f32 operations of one kNN call."""
    return b * n * 12 + b * m * 12 + b * m * k * 8, 8.0 * b * m * n


def knn_bound_s(cfg: Dict, batch: int, npoints: int) -> float:
    """Seconds of bound of one forward's kNN calls."""
    return sum(kernels.bound_s(*knn(*call)) for call in knn_calls(cfg, batch, npoints))
