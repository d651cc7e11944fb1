"""Host-side grid assignment of the full-scene chunker, in numpy.

The port's own copy of the numpy branch of the JAX package's
``native.grid_chunk_assign``; the pair order (point-major, then cell x, then
cell y) is kept, so chunking is identical to the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def grid_chunk_assign(
    points: np.ndarray, cell: float = 1.5, margin: float = 0.2
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(cell_ids, point_ids, ncell_x, ncell_y): every (cell, point) pair where
    the point's +-margin box overlaps the cell."""
    points = np.ascontiguousarray(points, np.float32)
    mn = points.min(0)
    mx = points.max(0)
    ncx = max(1, int(np.ceil((mx[0] - mn[0]) / cell)))
    ncy = max(1, int(np.ceil((mx[1] - mn[1]) / cell)))
    # Per axis a point overlaps cells [floor((p-margin)/cell),
    # floor((p+margin)/cell)]: a fixed (N, Kx, Ky) broadcast of candidates,
    # masked to each point's span and the grid.
    rel = points[:, :2].astype(np.float64) - mn[:2]
    lo = np.floor((rel - margin) / cell).astype(np.int64)  # (N, 2)
    hi = np.floor((rel + margin) / cell).astype(np.int64)
    span = hi - lo
    kx = int(span[:, 0].max(initial=0)) + 1
    ky = int(span[:, 1].max(initial=0)) + 1
    ox = np.arange(kx)[None, :]                      # (1, Kx)
    oy = np.arange(ky)[None, :]                      # (1, Ky)
    cx = (lo[:, :1] + ox)[:, :, None]                # (N, Kx, 1)
    cy = (lo[:, 1:2] + oy)[:, None, :]               # (N, 1, Ky)
    valid = (
        (ox[:, :, None] <= span[:, :1, None])
        & (oy[:, None, :] <= span[:, 1:2, None])
        & (cx >= 0) & (cx < ncx) & (cy >= 0) & (cy < ncy)
    )
    cell_ids = np.broadcast_to(cx * ncy + cy, valid.shape)
    pids = np.broadcast_to(
        np.arange(len(points), dtype=np.int64)[:, None, None], valid.shape)
    flat = valid.reshape(-1)
    return cell_ids.reshape(-1)[flat], pids.reshape(-1)[flat], ncx, ncy
