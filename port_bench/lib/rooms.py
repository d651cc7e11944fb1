"""Synthetic ScanNet-like rooms.

The benchmark's own copy of the port's ``data/scannet/scenes.make_synthetic_scene``
(a floor, one wall and gaussian furniture blobs; labels compact in [0, 20],
about 15 % unannotated; random colors and unit normals), vectorised and
extended with a room size: a room of ``n`` vertices has the synthetic
room's 6 x 5 m floor plan scaled by ``sqrt(n / 150,000)``, so the density
stays at 5,000 vertices a square metre and larger rooms have more chunks,
as real rooms do.  The height stays 2.6 m.  The yardstick must not move
when the program's copy changes, so nothing here imports the program.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List

import numpy as np

BASE_POINTS = 150_000
BASE_EXTENT = (6.0, 5.0, 2.6)
BASE_BLOBS = 12


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence((int(seed),) + tags)))


def room_sizes(count: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """``count`` vertex counts, ascending: the log-normal's quantiles at
    (i + 1/2) / count, with this median and sigma, clipped to [lo, hi]."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / count) for i in range(count)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def make_room(n: int, index: int) -> Dict[str, np.ndarray]:
    """Room ``index`` of ``n`` vertices: points (n, 3) f32 in metres, labels
    (n,) int32 in [0, 20], colors (n, 3) u8, normals (n, 3) f32 of unit
    length."""
    rng = _rng(202, index, n)
    s = float(np.sqrt(n / BASE_POINTS))
    ex, ey, ez = BASE_EXTENT[0] * s, BASE_EXTENT[1] * s, BASE_EXTENT[2]
    n_floor = n // 4
    n_wall = n // 4
    n_obj = n - n_floor - n_wall
    n_blobs = max(BASE_BLOBS, int(round(BASE_BLOBS * s * s)))

    floor = rng.uniform((0.0, 0.0, 0.0), (ex, ey, 0.05), (n_floor, 3))
    wall = rng.uniform((0.0, 0.0, 0.0), (ex, 0.05, ez), (n_wall, 3))
    centers = rng.uniform((0.5, 0.5, 0.0), (ex - 0.5, ey - 0.5, ez - 0.8), (n_blobs, 3))
    blob_labels = rng.integers(3, 21, n_blobs)
    blob_id = rng.integers(0, n_blobs, n_obj)
    obj = centers[blob_id] + rng.standard_normal((n_obj, 3)) * 0.3

    points = np.concatenate([floor, wall, obj]).astype(np.float32)
    labels = np.concatenate([np.full(n_floor, 2), np.full(n_wall, 1),
                             blob_labels[blob_id]]).astype(np.int32)
    labels[rng.random(n) < 0.15] = 0
    colors = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    normals = rng.standard_normal((n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    perm = rng.permutation(n)
    return {"points": points[perm], "labels": labels[perm], "colors": colors[perm],
            "normals": normals[perm]}


def make_rooms(seed: int, count: int, size: Dict) -> List[Dict[str, np.ndarray]]:
    """The set of ``count`` rooms whose sizes are the quantiles of ``size``
    (``median``, ``sigma``, ``min``, ``max``), in an order drawn from
    ``seed``.  Every seed has the same rooms, so that the seed changes the
    order, the weights and the random draws, and not how much work there
    is."""
    sizes = room_sizes(count, size["median"], size["sigma"], size["min"], size["max"])
    return [make_room(int(sizes[k]), int(k)) for k in _rng(seed, 101).permutation(count)]
