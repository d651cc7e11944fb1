"""S3DIS indoor semantic segmentation: room collection + 1 m block pipeline.
The port's own copy of the JAX package's ``data/s3dis.py`` (numpy only; the
same seed gives the same blocks bit for bit).

Equivalent of ``pointnet2_tensorflow/pointnet1/sem_seg/indoor3d_util.py``
(collect_point_label :collects per-object Annotations txt into one (N,7)
room array shifted to the origin; room2blocks_plus_normalized: 1 m xy blocks
with 9-channel normalized features) and ``collect_indoor3d_data.py`` /
``gen_indoor3d_h5.py``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

# The 13 S3DIS classes (ref indoor3d_util.py:10-12 g_classes).
CLASSES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
]
CLASS2LABEL = {c: i for i, c in enumerate(CLASSES)}
NUM_CLASSES = 13


def collect_room(annotations_dir: str) -> np.ndarray:
    """Concatenate one room's per-object ``Annotations/{class}_{k}.txt`` files
    (rows x y z r g b) into a single (N, 7) array [xyz rgb label], shifted so
    min xyz = 0; unknown class names count as clutter
    (ref indoor3d_util.py collect_point_label:30-60)."""
    rows: List[np.ndarray] = []
    for fn in sorted(os.listdir(annotations_dir)):
        if not fn.endswith(".txt"):
            continue
        cls_name = fn.split("_")[0]
        label = CLASS2LABEL.get(cls_name, CLASS2LABEL["clutter"])
        data = np.loadtxt(os.path.join(annotations_dir, fn)).reshape(-1, 6)
        rows.append(np.concatenate(
            [data, np.full((len(data), 1), label, data.dtype)], axis=1))
    room = np.concatenate(rows)
    room[:, :3] -= room[:, :3].min(axis=0)
    return room


def room_to_blocks_normalized(
    room: np.ndarray,
    num_point: int = 4096,
    block_size: float = 1.0,
    stride: float = 1.0,
    min_points: int = 100,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a (N, 7) room into xy blocks with 9-channel features
    (ref indoor3d_util.py room2blocks_plus_normalized):

    channels 0-2: xyz with xy centered on the block center,
    channels 3-5: rgb / 255,
    channels 6-8: xyz / room_max (global normalized coordinates).

    Each block is sampled to exactly ``num_point`` points with replacement;
    blocks with fewer than ``min_points`` points are skipped.
    Returns ``(data (K, num_point, 9), labels (K, num_point))``.
    """
    rng = rng if rng is not None else np.random.RandomState(0)
    xyz = room[:, :3]
    rgb = room[:, 3:6]
    labels = room[:, 6].astype(np.int32)
    room_max = np.maximum(xyz.max(axis=0), 1e-9)

    n_x = int(np.ceil(max(room_max[0] - block_size, 0) / stride)) + 1
    n_y = int(np.ceil(max(room_max[1] - block_size, 0) / stride)) + 1
    datas, labs = [], []
    for ix in range(n_x):
        for iy in range(n_y):
            lo = np.array([ix * stride, iy * stride])
            hi = lo + block_size
            sel = np.flatnonzero(
                (xyz[:, 0] >= lo[0]) & (xyz[:, 0] <= hi[0])
                & (xyz[:, 1] >= lo[1]) & (xyz[:, 1] <= hi[1])
            )
            if len(sel) < min_points:
                continue
            take = sel[rng.choice(len(sel), num_point, replace=True)]
            block = np.zeros((num_point, 9), np.float32)
            block[:, 0:3] = xyz[take]
            block[:, 0:2] -= (lo + hi) / 2.0  # center xy on the block
            block[:, 3:6] = rgb[take] / 255.0
            block[:, 6:9] = xyz[take] / room_max
            datas.append(block)
            labs.append(labels[take])
    if not datas:
        return (np.zeros((0, num_point, 9), np.float32),
                np.zeros((0, num_point), np.int32))
    return np.stack(datas), np.stack(labs)


def make_synthetic_room(n_points: int = 20000, seed: int = 0) -> np.ndarray:
    """A room-like (N, 7) array for tests/benchmarks: 5 x 4 x 3 m with floor,
    ceiling, two walls, and labeled furniture blobs."""
    rng = np.random.RandomState(seed)
    ext = np.array([5.0, 4.0, 3.0])
    quarter = n_points // 4
    floor = rng.uniform([0, 0, 0], [ext[0], ext[1], 0.05], (quarter, 3))
    ceiling = rng.uniform([0, 0, ext[2] - 0.05], ext, (quarter, 3))
    wall = rng.uniform([0, 0, 0], [ext[0], 0.05, ext[2]], (quarter, 3))
    n_obj = n_points - 3 * quarter
    centers = rng.uniform([0.5, 0.5, 0.0], ext - [0.5, 0.5, 1.5], (8, 3))
    blob_cls = rng.randint(3, NUM_CLASSES, 8)
    blob_id = rng.randint(0, 8, n_obj)
    obj = centers[blob_id] + rng.randn(n_obj, 3) * 0.25

    xyz = np.concatenate([floor, ceiling, wall, obj])
    labels = np.concatenate([
        np.full(quarter, CLASS2LABEL["floor"]),
        np.full(quarter, CLASS2LABEL["ceiling"]),
        np.full(quarter, CLASS2LABEL["wall"]),
        blob_cls[blob_id],
    ])
    rgb = rng.randint(0, 256, (n_points, 3))
    room = np.concatenate([xyz, rgb, labels[:, None]], axis=1).astype(np.float32)
    room[:, :3] -= room[:, :3].min(axis=0)
    perm = rng.permutation(n_points)
    return room[perm]
