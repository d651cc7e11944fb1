"""Synthetic ScanNet-like rooms for tests and the smoke run (numpy only)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_synthetic_scene(n_points: int = 20000, seed: int = 0) -> Dict[str, np.ndarray]:
    """A room-like labelled scene in meters (extent ~6 x 5 x 2.6 m): floor,
    wall and 12 gaussian furniture blobs, labels compact in [0, 20] with ~15 %
    unannotated, random colors and unit normals.  The port's copy of the JAX
    package's ``make_synthetic_scene`` default branch: the same seed gives
    the same arrays.  Returns dict points/labels/colors/normals."""
    rng = np.random.RandomState(seed)
    extent = np.array([6.0, 5.0, 2.6], np.float32)
    n_floor = n_points // 4
    n_wall = n_points // 4
    n_obj = n_points - n_floor - n_wall

    floor = rng.uniform([0, 0, 0], [extent[0], extent[1], 0.05], (n_floor, 3))
    wall = rng.uniform([0, 0, 0], [extent[0], 0.05, extent[2]], (n_wall, 3))
    n_blobs = 12
    centers = rng.uniform([0.5, 0.5, 0.0], extent - [0.5, 0.5, 0.8], (n_blobs, 3))
    blob_labels = rng.randint(3, 21, n_blobs)
    blob_id = rng.randint(0, n_blobs, n_obj)
    obj = centers[blob_id] + rng.randn(n_obj, 3) * 0.3

    points = np.concatenate([floor, wall, obj]).astype(np.float32)
    labels = np.concatenate([
        np.full(n_floor, 2),            # floor
        np.full(n_wall, 1),             # wall
        blob_labels[blob_id],
    ]).astype(np.int32)
    labels[rng.rand(n_points) < 0.15] = 0

    colors = rng.randint(0, 256, (n_points, 3)).astype(np.int32)
    normals = rng.randn(n_points, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    perm = rng.permutation(n_points)
    return {
        "points": points[perm],
        "labels": labels[perm],
        "colors": colors[perm],
        "normals": normals[perm],
    }
