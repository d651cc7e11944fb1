"""ScanNet scene store: per-scene npy arrays, split lists and synthetic
scenes (numpy only).

Layout: ``{root}/{points,labels,colors,normals}/{scene}.npy`` with split
lists at ``{root}/splits/scannetv2_{train,val,test}.txt``.  Labels are
stored raw (NYU40 ids); ``load_scene_mapped`` maps them to [0, 20].  The
official ScanNet v2 split lists ship with the port (``splits/``).  The
port's own copy of the JAX package's ``data/scannet/scenes.py``: the same
seed gives the same arrays and the same files.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import (
    map_labels,
    map_to_nyu40,
)
from pointcloud_segmentation_attention_tpu_torch.viz.palette import colorize_labels

ARRAY_KINDS = ("points", "labels", "colors", "normals")


def scene_path(data_root: str, kind: str, scene_name: str) -> str:
    return os.path.join(data_root, kind, f"{scene_name}.npy")


def save_scene(data_root: str, scene_name: str, scene: Dict[str, np.ndarray]) -> None:
    for kind in ARRAY_KINDS:
        os.makedirs(os.path.join(data_root, kind), exist_ok=True)
        np.save(scene_path(data_root, kind, scene_name), scene[kind])


def load_scene(data_root: str, scene_name: str) -> Dict[str, np.ndarray]:
    """One scene's raw arrays; labels are NYU40 ids."""
    return {kind: np.load(scene_path(data_root, kind, scene_name)) for kind in ARRAY_KINDS}


def load_scene_mapped(data_root: str, scene_name: str) -> Dict[str, np.ndarray]:
    """One scene with its labels mapped NYU40 -> [0, 20] (int32)."""
    scene = load_scene(data_root, scene_name)
    scene["labels"] = map_labels(scene["labels"]).astype(np.int32)
    return scene


def official_splits_dir() -> str:
    """Directory of the official ScanNet v2 split lists shipped with the
    port (1201 train / 312 val / 100 test scene names)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "splits")


def read_split(split_dir: Optional[str] = None, split: str = "train") -> List[str]:
    """Scene names of one split, from ``{split_dir}/scannetv2_{split}.txt``;
    ``split_dir=None`` reads the official lists."""
    if split_dir is None:
        split_dir = official_splits_dir()
    with open(os.path.join(split_dir, f"scannetv2_{split}.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def write_split(split_dir: str, split: str, names: Sequence[str]) -> None:
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, f"scannetv2_{split}.txt"), "w") as f:
        f.write("\n".join(names) + ("\n" if names else ""))


def make_synthetic_scene(n_points: int = 20000, seed: int = 0, color_coded: bool = False,
                         geometry_coded: bool = False) -> Dict[str, np.ndarray]:
    """A room-like labelled scene in meters (extent ~6 x 5 x 2.6 m): floor,
    wall and 12 gaussian furniture blobs, labels compact in [0, 20] with ~15 %
    unannotated.  Returns dict points/labels/colors/normals.

    By default colors and normals are random.  ``color_coded=True`` makes
    labels learnable from the features: colors are the label's palette
    entry plus noise and normals tilt with the label.  ``geometry_coded=True``
    makes blob labels learnable from xyz alone: a blob's height and spread
    are functions of its label."""
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
    if geometry_coded:
        centers = centers.copy()
        centers[:, 2] = 0.15 + 0.085 * (blob_labels - 3)
        sigma = (0.10 + 0.014 * (blob_labels - 3)).astype(np.float32)
        obj = centers[blob_id] + rng.randn(n_obj, 3) * sigma[blob_id, None]
    else:
        obj = centers[blob_id] + rng.randn(n_obj, 3) * 0.3

    points = np.concatenate([floor, wall, obj]).astype(np.float32)
    labels = np.concatenate([
        np.full(n_floor, 2),            # floor
        np.full(n_wall, 1),             # wall
        blob_labels[blob_id],
    ]).astype(np.int32)
    labels[rng.rand(n_points) < 0.15] = 0

    if color_coded:
        colors = colorize_labels(labels).astype(np.float32)
        colors += rng.randn(n_points, 3) * 8.0
        colors = np.clip(colors, 0, 255).astype(np.int32)
        normals = np.stack([np.cos(labels * 0.3), np.sin(labels * 0.3),
                            np.ones(n_points)], axis=1).astype(np.float32)
        normals += rng.randn(n_points, 3).astype(np.float32) * 0.1
    else:
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


def write_synthetic_dataset(
    data_root: str,
    n_train: int = 2,
    n_val: int = 1,
    n_test: int = 0,
    n_points: int = 20000,
    seed: int = 0,
    color_coded: bool = False,
    geometry_coded: bool = False,
) -> Dict[str, List[str]]:
    """Write a miniature ScanNet-layout dataset (scenes ``scene0000_00``,
    ``scene0001_00``, ... seeded ``seed + i``; labels stored as NYU40 ids)
    and its split lists; returns the split name lists."""
    splits: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    i = 0
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        for _ in range(count):
            name = f"scene{i:04d}_00"
            scene = make_synthetic_scene(n_points, seed=seed + i, color_coded=color_coded,
                                         geometry_coded=geometry_coded)
            raw = dict(scene)
            raw["labels"] = map_to_nyu40(scene["labels"]).astype(np.int32)
            save_scene(data_root, name, raw)
            splits[split].append(name)
            i += 1
    split_dir = os.path.join(data_root, "splits")
    for split, names in splits.items():
        write_split(split_dir, split, names)
    return splits
