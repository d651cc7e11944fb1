"""Bytes and float32 operations of the program's seven CUDA kernels at
the model's shapes, and the least time the chip could take for them.

Copied from ``chip_smoke.py``'s bound arithmetic: inputs read once and
outputs written once; FPS 9 operations per (pick, point) pair; ball query
8 per (centre, point) pair up to each centre's nsample-th hit (what the
data needs, not the whole cloud); three-NN 8 per (unknown, known) pair;
the interpolation 5 per output element and its backward's dP 6 per
element of g (the weights come from three-NN's distances, which need no
gradient, so no dw is computed); the gather copies, and its backward adds
once per element of g.  The CSR that both backwards build is scratch and
counts nothing.  The bound is the larger of bytes over the HBM bandwidth
and operations over the float32 peak.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

_PEAKS = json.load(open(os.path.join(os.path.dirname(__file__), "peaks.json")))


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / _PEAKS["hbm_bytes_per_s"], flops / _PEAKS["f32_flops_per_s"])


def fps(b: int, n: int, m: int):
    return b * n * 12 + b * m * 4, 9.0 * b * (m - 1) * n


def ball_query(b: int, n: int, m: int, ns: int, visited: float):
    return b * n * 12 + b * m * 12 + b * m * ns * 4 + b * m * 4, 8.0 * visited


def gather(b: int, n: int, c: int, m: int, k: int):
    return b * n * c * 4 + b * m * k * 4 + b * m * k * c * 4, 0.0


def gather_bwd(b: int, n: int, c: int, m: int, k: int):
    return b * m * k * c * 4 + b * m * k * 4 + b * n * c * 4, float(b * m * k * c)


def three_nn(b: int, n: int, m: int):
    return b * n * 12 + b * m * 12 + b * n * 3 * 8, 8.0 * b * n * m


def interpolate(b: int, m: int, c: int, n: int):
    return b * m * c * 4 + b * n * 3 * 8 + b * n * c * 4, 5.0 * b * n * c


def interpolate_bwd_dp(b: int, m: int, c: int, n: int):
    return b * n * c * 4 + b * n * 3 * 8 + b * m * c * 4, 6.0 * b * n * c


def forward_bounds(cfg: Dict, batch: int, npoints: int, train: bool,
                   visits: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Seconds of bound, kernel by kernel, of one forward (with ``train``,
    and its backward) of ``batch`` clouds.  ``visits``: the points a level's
    ball queries visit in one such forward; without it every centre counts
    the whole cloud."""
    out = {k: 0.0 for k in ("fps", "ball_query", "group_gather", "three_nn",
                            "three_interpolate", "group_gather_bwd", "three_interpolate_bwd")}
    level_n = [npoints] + list(cfg["sa_npoints"])
    feat = [cfg["in_features"]] + [mlp[-1] for mlp in cfg["sa_mlps"]]
    ns = cfg["sa_nsample"]
    for i in range(4):
        n, m, c = level_n[i], level_n[i + 1], 3 + feat[i]
        seen = (visits or {}).get(f"SA{i + 1}", float(batch * m * n))
        out["fps"] += bound_s(*fps(batch, n, m))
        out["ball_query"] += bound_s(*ball_query(batch, n, m, ns, seen))
        out["group_gather"] += bound_s(*gather(batch, n, c, m, ns))
        if train and i > 0:
            out["group_gather_bwd"] += bound_s(*gather_bwd(batch, n, c, m, ns))
    up = feat[4]
    for j, mlp in enumerate(cfg["fp_mlps"]):
        lvl = 3 - j
        n, m = level_n[lvl], level_n[lvl + 1]
        out["three_nn"] += bound_s(*three_nn(batch, n, m))
        out["three_interpolate"] += bound_s(*interpolate(batch, m, up, n))
        if train:
            out["three_interpolate_bwd"] += bound_s(*interpolate_bwd_dp(batch, m, up, n))
        up = mlp[-1]
    return out


def peak_flops() -> float:
    return _PEAKS["f32_flops_per_s"]
