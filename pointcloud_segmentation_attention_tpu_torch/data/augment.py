"""Numpy batch augmentations: the port's own copy of the JAX package's
``data/augment.py``, the same ``RandomState`` draws in the same order.

Reference: ``pointnet2_tensorflow/utils/provider.py`` — rotations around the
up axis (:36-76), SO3-ish perturbations incl. normals (:78-191), jitter
(:194), shift (:208), random scale (:222), random point dropout (:236).

All functions take a batch ``(B, N, C)`` (or a single cloud ``(N, C)`` where
noted) and an optional ``rng`` (``np.random.RandomState``); they never mutate
the input.  ModelNet's up axis is Y, so ``rotate_point_cloud`` rotates around
Y like the reference; ScanNet pipelines use ``rotate_point_cloud_z``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rng(rng: Optional[np.random.RandomState]) -> np.random.RandomState:
    return rng if rng is not None else np.random.RandomState()


def _roty(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rotz(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def rotate_point_cloud(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Random rotation around the up (Y) axis per cloud (ref provider.py:36)."""
    rng = _rng(rng)
    out = np.empty_like(batch_data)
    for k in range(batch_data.shape[0]):
        out[k] = batch_data[k] @ _roty(rng.uniform() * 2 * np.pi)
    return out


def rotate_point_cloud_z(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Random rotation around Z per cloud (ref provider.py:57)."""
    rng = _rng(rng)
    out = np.empty_like(batch_data)
    for k in range(batch_data.shape[0]):
        out[k] = batch_data[k] @ _rotz(rng.uniform() * 2 * np.pi)
    return out


def rotate_point_cloud_with_normal(batch_xyz_normal: np.ndarray, rng=None) -> np.ndarray:
    """Rotate xyz and normals around Y together (ref provider.py:78).
    Input (B, N, 6): xyz + normal."""
    rng = _rng(rng)
    out = batch_xyz_normal.copy()
    for k in range(out.shape[0]):
        rot = _roty(rng.uniform() * 2 * np.pi)
        out[k, :, :3] = out[k, :, :3] @ rot
        out[k, :, 3:6] = out[k, :, 3:6] @ rot
    return out


def rotate_point_cloud_by_angle(batch_data: np.ndarray, rotation_angle: float) -> np.ndarray:
    """Deterministic rotation around Y, used by the voting evaluator
    (ref provider.py:119, evaluate.py:125-141)."""
    rot = _roty(rotation_angle)
    return np.asarray(batch_data) @ rot


def rotate_point_cloud_by_angle_with_normal(
    batch_xyz_normal: np.ndarray, rotation_angle: float
) -> np.ndarray:
    """Deterministic Y rotation of xyz+normal (ref provider.py:137)."""
    rot = _roty(rotation_angle)
    out = np.array(batch_xyz_normal)
    out[..., :3] = out[..., :3] @ rot
    out[..., 3:6] = out[..., 3:6] @ rot
    return out


def rotate_perturbation_point_cloud(
    batch_data: np.ndarray, angle_sigma: float = 0.06, angle_clip: float = 0.18,
    rng=None,
) -> np.ndarray:
    """Small random rotations around all three axes (ref provider.py:157)."""
    rng = _rng(rng)
    out = np.empty_like(batch_data)
    for k in range(batch_data.shape[0]):
        a = np.clip(angle_sigma * rng.randn(3), -angle_clip, angle_clip)
        rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]], np.float32)
        ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]], np.float32)
        rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]], np.float32)
        out[k] = batch_data[k] @ (rz @ ry @ rx).T
    return out


def rotate_perturbation_point_cloud_with_normal(
    batch_xyz_normal: np.ndarray, angle_sigma: float = 0.06,
    angle_clip: float = 0.18, rng=None,
) -> np.ndarray:
    """Perturbation rotation applied to xyz and normals (ref provider.py:166)."""
    rng = _rng(rng)
    out = batch_xyz_normal.copy()
    for k in range(out.shape[0]):
        a = np.clip(angle_sigma * rng.randn(3), -angle_clip, angle_clip)
        rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]], np.float32)
        ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]], np.float32)
        rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]], np.float32)
        rot = (rz @ ry @ rx).T
        out[k, :, :3] = batch_xyz_normal[k, :, :3] @ rot
        out[k, :, 3:6] = batch_xyz_normal[k, :, 3:6] @ rot
    return out


def jitter_point_cloud(
    batch_data: np.ndarray, sigma: float = 0.01, clip: float = 0.05, rng=None
) -> np.ndarray:
    """Per-point gaussian jitter, clipped (ref provider.py:194)."""
    rng = _rng(rng)
    noise = np.clip(sigma * rng.randn(*batch_data.shape), -clip, clip)
    return (batch_data + noise).astype(batch_data.dtype)


def shift_point_cloud(
    batch_data: np.ndarray, shift_range: float = 0.1, rng=None
) -> np.ndarray:
    """Per-cloud random xyz shift (ref provider.py:208)."""
    rng = _rng(rng)
    shifts = rng.uniform(-shift_range, shift_range, (batch_data.shape[0], 3))
    return (batch_data + shifts[:, None, :]).astype(batch_data.dtype)


def random_scale_point_cloud(
    batch_data: np.ndarray, scale_low: float = 0.8, scale_high: float = 1.25,
    rng=None,
) -> np.ndarray:
    """Per-cloud random uniform scale (ref provider.py:222)."""
    rng = _rng(rng)
    scales = rng.uniform(scale_low, scale_high, batch_data.shape[0])
    return (batch_data * scales[:, None, None]).astype(batch_data.dtype)


def random_point_dropout(
    batch_data: np.ndarray, max_dropout_ratio: float = 0.875, rng=None
) -> np.ndarray:
    """Replace a random fraction of points by the first point
    (ref provider.py:236)."""
    rng = _rng(rng)
    out = batch_data.copy()
    for b in range(out.shape[0]):
        ratio = rng.random_sample() * max_dropout_ratio
        drop = np.where(rng.random_sample(out.shape[1]) <= ratio)[0]
        if len(drop) > 0:
            out[b, drop] = out[b, 0]
    return out


def shuffle_points(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Shuffle point order within each cloud (ref provider.py:24)."""
    rng = _rng(rng)
    idx = rng.permutation(batch_data.shape[1])
    return batch_data[:, idx, :]


def augment_batch_cls(
    batch_data: np.ndarray, with_normals: bool, rng=None
) -> np.ndarray:
    """The upstream classification augmentation chain
    (ref pointnet2_tensorflow/train.py:148-161): rotate, perturb, scale,
    shift, jitter xyz, shuffle."""
    rng = _rng(rng)
    if with_normals:
        data = rotate_point_cloud_with_normal(batch_data, rng=rng)
        data = rotate_perturbation_point_cloud_with_normal(data, rng=rng)
    else:
        data = rotate_point_cloud(batch_data, rng=rng)
        data = rotate_perturbation_point_cloud(data, rng=rng)
    xyz = data[..., :3]
    xyz = random_scale_point_cloud(xyz, rng=rng)
    xyz = shift_point_cloud(xyz, rng=rng)
    xyz = jitter_point_cloud(xyz, rng=rng)
    data = np.concatenate([xyz, data[..., 3:]], axis=-1) if data.shape[-1] > 3 else xyz
    return shuffle_points(data, rng=rng)
