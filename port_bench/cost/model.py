"""Matmul FLOPs of the segmentation models, from a configuration's widths.

A pointwise layer of c_in -> c_out over R rows is 2 R c_in c_out FLOPs.
The set-abstraction MLPs run over every group member (B x npoint x
nsample rows), the feature-propagation MLPs over every point of their
level, the head over every input point.  The attention pooling adds its
key and value projections over every member (2 x 2 C^2 a member), its
query over every group, and its two products (2 x 2 C a member).  A
training step is three forwards (forward, and the backward's two
products a layer); recomputation is not counted.
"""
from __future__ import annotations

from typing import Dict


def _chain(c_in: int, widths) -> int:
    total = 0
    for c in widths:
        total += c_in * c
        c_in = c
    return total


def forward_flops(cfg: Dict, batch: int, npoints: int) -> float:
    """FLOPs of one eval forward of ``batch`` clouds of ``npoints``."""
    flops = 0.0
    feat = cfg["in_features"]
    level_n = [npoints] + list(cfg["sa_npoints"])
    widths = [feat]
    for i, mlp in enumerate(cfg["sa_mlps"]):
        groups = batch * cfg["sa_npoints"][i]
        members = groups * cfg["sa_nsample"]
        flops += 2.0 * members * _chain(3 + feat, mlp)
        c = mlp[-1]
        if cfg["sa_pooling"][i] == "attention":
            flops += 2.0 * members * 2 * c * c + 2.0 * groups * c * c + 2.0 * members * 2 * c
        feat = c
        widths.append(c)
    up = widths[4]
    for j, mlp in enumerate(cfg["fp_mlps"]):
        lvl = 3 - j
        rows = batch * level_n[lvl]
        flops += 2.0 * rows * _chain(up + widths[lvl], mlp)
        up = mlp[-1]
    flops += 2.0 * batch * npoints * _chain(up, cfg["head"])
    return flops


def train_step_flops(cfg: Dict, batch: int, npoints: int) -> float:
    return 3.0 * forward_flops(cfg, batch, npoints)
