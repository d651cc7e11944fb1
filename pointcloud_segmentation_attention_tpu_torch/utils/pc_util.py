"""Point-cloud utilities: voxelization, depth-image rendering, surface-voxel
labels, virtual scans.

The port's own copy of the JAX package's ``utils/pc_util.py`` (numpy only,
the same functions and results): equivalents of the reference's
``pointnet2_tensorflow/utils/pc_util.py`` (volume conversions, three-view
point renders), ``pointnet2_tensorflow/scannet/pc_util.py`` (surface-voxel
label downsampling for the calibrated accuracy metric) and
``scannet/scene_util.py`` (simulated depth-camera visibility subsampling).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def point_cloud_to_volume(points: np.ndarray, vsize: int, radius: float = 1.0) -> np.ndarray:
    """Occupancy volume (vsize^3) from a unit-sphere-ish cloud
    (ref pc_util.py:24-40)."""
    vol = np.zeros((vsize, vsize, vsize), np.float32)
    voxel = 2 * radius / float(vsize)
    locations = (points + radius) / voxel
    locations = locations.astype(int)
    keep = np.all((locations >= 0) & (locations < vsize), axis=1)
    locations = locations[keep]
    vol[locations[:, 0], locations[:, 1], locations[:, 2]] = 1.0
    return vol


def volume_to_point_cloud(vol: np.ndarray) -> np.ndarray:
    """Occupied voxel centers -> points (ref pc_util.py:50-63)."""
    vsize = vol.shape[0]
    pts = np.argwhere(vol > 0).astype(np.float32)
    return pts


def point_cloud_to_volume_batch(
    point_clouds: np.ndarray, vsize: int = 12, radius: float = 1.0, flatten: bool = True
) -> np.ndarray:
    """(B, N, 3) -> (B, vsize^3) or (B, v, v, v) (ref pc_util.py:42-48)."""
    vols = np.stack([
        point_cloud_to_volume(pc, vsize, radius) for pc in point_clouds
    ])
    return vols.reshape(len(point_clouds), -1) if flatten else vols


def point_cloud_to_image(
    points: np.ndarray, imgsize: int, radius: float = 1.0,
    num_sample: int = 128,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """(N, 3) -> (imgsize, imgsize, num_sample, 3): per-pixel point sets with
    pixel-centered, pixel-scaled xy (ref utils/pc_util.py:138-171).  Points
    are assumed in [-radius, radius]; pixels with more than ``num_sample``
    points are subsampled without replacement, fewer are edge-padded, empty
    pixels are zeros."""
    rng = rng or np.random
    img = np.zeros((imgsize, imgsize, num_sample, 3), points.dtype)
    pixel = 2 * radius / float(imgsize)
    locations = ((points[:, 0:2] + radius) / pixel).astype(int)
    # group point rows by pixel with one sort instead of a per-point dict
    keys = locations[:, 0] * imgsize + locations[:, 1]
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    bounds = np.append(starts, len(order))
    for u, s, e in zip(uniq, bounds[:-1], bounds[1:]):
        i, j = int(u) // imgsize, int(u) % imgsize
        if not (0 <= i < imgsize and 0 <= j < imgsize):
            continue
        pc = points[order[s:e]].copy()
        if len(pc) > num_sample:
            pc = pc[rng.choice(len(pc), num_sample, replace=False)]
        elif len(pc) < num_sample:
            pc = np.pad(pc, ((0, num_sample - len(pc)), (0, 0)), "edge")
        pc_center = (np.array([i, j]) + 0.5) * pixel - radius
        pc[:, 0:2] = (pc[:, 0:2] - pc_center) / pixel
        img[i, j] = pc
    return img


def point_cloud_to_image_batch(
    point_clouds: np.ndarray, imgsize: int, radius: float = 1.0,
    num_sample: int = 128,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """(B, N, 3) -> (B, I, I, num_sample, 3) (ref utils/pc_util.py:126-135)."""
    return np.stack([
        point_cloud_to_image(pc, imgsize, radius, num_sample, rng)
        for pc in point_clouds
    ])


def draw_point_cloud(
    points: np.ndarray,
    canvas_size: int = 500,
    space: float = 200.0,
    diameter: int = 25,
    xrot: float = 0.0, yrot: float = 0.0, zrot: float = 0.0,
    normalize: bool = True,
) -> np.ndarray:
    """Gaussian-splat orthographic render (ref pc_util.py:142-190): rotate by
    (xrot, yrot, zrot), z-sort back-to-front, splat a disk kernel."""
    image = np.zeros((canvas_size, canvas_size), np.float32)
    if points is None or len(points) == 0:
        return image
    pts = rotate_points(points, xrot, yrot, zrot)
    if normalize:
        centroid = pts.mean(0)
        pts = pts - centroid
        furthest = np.max(np.sqrt(np.sum(pts ** 2, axis=-1)))
        pts = pts / (furthest + 1e-12)
    # Pre-compute disk (gaussian falloff)
    radius = diameter // 2
    disk = np.zeros((diameter, diameter), np.float32)
    for i in range(diameter):
        for j in range(diameter):
            if (i - radius) ** 2 + (j - radius) ** 2 <= radius ** 2:
                disk[i, j] = np.exp(
                    -((i - radius) ** 2 + (j - radius) ** 2) / (radius ** 2)
                )
    order = np.argsort(pts[:, 2])
    pts = pts[order]
    max_depth = np.max(pts[:, 2]) + 1e-12
    for x, y, z in pts:
        xc = int(canvas_size / 2 + (x * space) / 2)
        yc = int(canvas_size / 2 + (y * space) / 2)
        xl, xh = xc - radius, xc + radius + 1
        yl, yh = yc - radius, yc + radius + 1
        if xl < 0 or yl < 0 or xh > canvas_size or yh > canvas_size:
            continue
        image[xl:xh, yl:yh] = np.maximum(
            image[xl:xh, yl:yh], (0.5 + z / max_depth * 0.5) * disk
        )
    m = image.max()
    return image / m if m > 0 else image


def rotate_points(points: np.ndarray, xrot: float, yrot: float, zrot: float) -> np.ndarray:
    cx, sx = np.cos(xrot), np.sin(xrot)
    cy, sy = np.cos(yrot), np.sin(yrot)
    cz, sz = np.cos(zrot), np.sin(zrot)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return points @ (rz @ ry @ rx).T.astype(points.dtype)


def point_cloud_three_views(points: np.ndarray) -> np.ndarray:
    """Three orthographic views concatenated horizontally
    (ref pc_util.py:192-206)."""
    img1 = draw_point_cloud(points, zrot=110 / 180 * np.pi,
                            xrot=45 / 180 * np.pi, yrot=0)
    img2 = draw_point_cloud(points, zrot=70 / 180 * np.pi,
                            xrot=135 / 180 * np.pi, yrot=0)
    img3 = draw_point_cloud(points, zrot=180 / 180 * np.pi,
                            xrot=90 / 180 * np.pi, yrot=0)
    return np.concatenate([img1, img2, img3], axis=1)


def point_cloud_label_to_surface_voxel_label(
    point_set: np.ndarray, label: np.ndarray, res: float = 0.0484
) -> Tuple[np.ndarray, np.ndarray]:
    """Majority-vote per-voxel label downsampling
    (ref scannet/pc_util.py:24-40).  The reference loops over voxels with a
    bincount each (O(V*N)); here one scatter-add builds the per-voxel label
    histogram and a single argmax takes the majority — same result, O(N).
    Returns (uvlabel, uvidx) like the ``_fast`` variant."""
    coordmax = np.max(point_set, axis=0)
    coordmin = np.min(point_set, axis=0)
    nvox = np.ceil((coordmax - coordmin) / res)
    vidx = np.ceil((point_set - coordmin) / res)
    vidx = vidx[:, 0] + vidx[:, 1] * nvox[0] + vidx[:, 2] * nvox[0] * nvox[1]
    uvidx, inv = np.unique(vidx, return_inverse=True)
    labels2d = label[:, None] if label.ndim == 1 else label
    out = np.zeros((len(uvidx), labels2d.shape[1]), labels2d.dtype)
    for col in range(labels2d.shape[1]):
        vals = labels2d[:, col].astype(np.int64)
        hist = np.zeros((len(uvidx), int(vals.max()) + 1), np.int64)
        np.add.at(hist, (inv, vals), 1)
        out[:, col] = np.argmax(hist, axis=1)
    uvlabel = out[:, 0] if label.ndim == 1 else out
    return uvlabel, uvidx


def point_cloud_label_to_surface_voxel_label_fast(
    point_set: np.ndarray, label: np.ndarray, res: float = 0.0484
) -> Tuple[np.ndarray, np.ndarray]:
    """First-point-per-voxel label downsampling used for the 'calibrated'
    voxel accuracy (ref scannet/pc_util.py:41-54)."""
    coordmax = np.max(point_set, axis=0)
    coordmin = np.min(point_set, axis=0)
    nvox = np.ceil((coordmax - coordmin) / res)
    vidx = np.ceil((point_set - coordmin) / res)
    vidx = vidx[:, 0] + vidx[:, 1] * nvox[0] + vidx[:, 2] * nvox[0] * nvox[1]
    uvidx, vpidx = np.unique(vidx, return_index=True)
    uvlabel = label[vpidx] if label.ndim == 1 else label[vpidx, :]
    return uvlabel, uvidx


# Per-class calibration weights for the voxel accuracy metric
# (ref scannet/train.py:469-474).
CALIBRATION_WEIGHTS = np.array([
    0.388, 0.357, 0.038, 0.033, 0.017, 0.02, 0.016, 0.025, 0.002, 0.002,
    0.002, 0.007, 0.006, 0.022, 0.004, 0.0004, 0.003, 0.002, 0.024, 0.029,
], np.float64)


def calibrated_voxel_accuracy(correct_per_class: np.ndarray,
                              seen_per_class: np.ndarray) -> float:
    """caliweight-averaged per-class voxel accuracy (ref scannet/train.py:469-475);
    inputs indexed by class 1..20 (length-20 arrays)."""
    seen = np.maximum(seen_per_class, 1e-6)
    acc = correct_per_class / seen
    valid = seen_per_class > 0
    w = CALIBRATION_WEIGHTS[valid]
    return float(np.sum(acc[valid] * w / w.sum()))


def virtual_scan(points: np.ndarray, mode: int = -1,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Simulated depth-camera visibility subsampling
    (ref scannet/scene_util.py:23-67): place a camera on one of 8 compass
    directions, convert to spherical coords, keep the nearest point per
    angular bin.  Returns indices of visible points."""
    rng = rng or np.random.RandomState()
    if mode == -1:
        mode = rng.randint(0, 8)
    camloc = points.mean(0)
    camloc[2] = 1.5  # eye height
    angle = mode * np.pi / 4
    camloc[0] -= 6 * np.cos(angle)
    camloc[1] -= 6 * np.sin(angle)
    rel = points - camloc
    r = np.linalg.norm(rel, axis=1)
    theta = np.arctan2(rel[:, 1], rel[:, 0])
    phi = np.arccos(np.clip(rel[:, 2] / np.maximum(r, 1e-9), -1, 1))
    # Angular bins ~0.5 deg
    nbins_t, nbins_p = 720, 360
    ti = ((theta + np.pi) / (2 * np.pi) * nbins_t).astype(int) % nbins_t
    pi_ = (phi / np.pi * nbins_p).astype(int).clip(0, nbins_p - 1)
    bins = ti * nbins_p + pi_
    order = np.argsort(r, kind="stable")
    _, first = np.unique(bins[order], return_index=True)
    return np.sort(order[first])


def sample_mesh_points(
    vertices: np.ndarray,
    faces: np.ndarray,
    n_samples: int,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Area-weighted uniform sampling of points on a triangle mesh.

    The capability behind the reference's ``prob_sample`` demo
    (``tf_sampling.py:61-90``: triangle areas -> cumulative distribution ->
    categorical sample -> barycentric point): picks faces proportionally to
    area via inverse-CDF sampling (the numpy analogue of ``ops.prob_sample``)
    and a uniform barycentric point within each.
    Returns (n_samples, 3) float32.
    """
    rng = rng or np.random.RandomState()
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    cdf = np.cumsum(areas)
    total = cdf[-1]
    if total <= 0:
        fi = rng.randint(0, len(faces), n_samples)
    else:
        fi = np.searchsorted(cdf, rng.rand(n_samples) * total)
        fi = np.minimum(fi, len(faces) - 1)
    # Uniform barycentric coordinates (square-root trick).
    r1 = np.sqrt(rng.rand(n_samples, 1))
    r2 = rng.rand(n_samples, 1)
    pts = (1 - r1) * v0[fi] + r1 * (1 - r2) * v1[fi] + r1 * r2 * v2[fi]
    return pts.astype(np.float32)
