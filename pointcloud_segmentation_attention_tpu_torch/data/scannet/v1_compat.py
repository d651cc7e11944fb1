"""Upstream ScanNet-v1-style dataset classes over the npy scene store.

Equivalents of ``pointnet2_tensorflow/scannet/scannet_dataset.py``:

- ``ScannetDataset``            (:29-63)  — random 1.5 m cuboid chunk per scene,
  label weights from the split's own histogram (1/log(1.2+freq) for train,
  uniform for val/test), inner-box mask folded into the weights.
- ``ScannetDatasetWholeScene``  (:90-125) — full-coverage grid chunks.
- ``ScannetDatasetVirtualScan`` (:152-176) — simulated depth-camera visibility
  subsampling (8 camera modes) before point sampling.

Unlike the reference (which unpickled a monolithic dump), scenes are loaded
lazily from the npy store and cached.  The port's copy of the JAX package's
``data/scannet/v1_compat.py``, on the port's own chunkers, scene store,
label map and ``utils/pc_util.py``: from one store and seed every item
equals the JAX package's bit for bit.  All draws come from the dataset's
``np.random.RandomState(seed)``, in the JAX package's order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet import chunks as chunks_lib
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as scenes_lib
from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import (
    compute_class_weights,
)
from pointcloud_segmentation_attention_tpu_torch.utils.pc_util import virtual_scan

NUM_CLASSES = 21


class _SceneStoreDataset:
    def __init__(self, data_root: str, scene_names: Sequence[str],
                 npoints: int, split: str, seed: int):
        self.data_root = data_root
        self.scene_names = list(scene_names)
        self.npoints = npoints
        self.split = split
        self.rng = np.random.RandomState(seed)
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}
        self.labelweights = self._compute_labelweights()

    def _scene(self, name: str) -> Dict[str, np.ndarray]:
        if name not in self._cache:
            self._cache[name] = scenes_lib.load_scene_mapped(self.data_root, name)
        return self._cache[name]

    def _compute_labelweights(self) -> np.ndarray:
        """Train: 1/log(1.2+freq) over this split's histogram
        (ref scannet_dataset.py:18-27); val/test: uniform with class 0 zeroed
        (ref :28, labelweights = ones)."""
        if self.split != "train":
            w = np.ones(NUM_CLASSES)
            w[0] = 0.0
            return w
        counts = np.zeros(NUM_CLASSES, np.int64)
        for name in self.scene_names:
            counts += np.bincount(self._scene(name)["labels"],
                                  minlength=NUM_CLASSES)[:NUM_CLASSES]
        counts = np.maximum(counts, 1)
        return compute_class_weights(counts)

    def __len__(self) -> int:
        return len(self.scene_names)


class ScannetDataset(_SceneStoreDataset):
    """Random-chunk training dataset (ref scannet_dataset.py:29-63)."""

    def __init__(self, data_root: str, scene_names: Sequence[str],
                 npoints: int = 8192, split: str = "train", seed: int = 0):
        super().__init__(data_root, scene_names, npoints, split, seed)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        scene = self._scene(self.scene_names[index])
        pts, lab, _, _, w = chunks_lib.sample_random_chunk(
            scene["points"], scene["labels"], None, None,
            self.npoints, self.rng, weight_table=self.labelweights,
        )
        return pts, lab, w


class ScannetDatasetWholeScene(_SceneStoreDataset):
    """Full-coverage grid chunks for whole-scene eval
    (ref scannet_dataset.py:90-125)."""

    def __init__(self, data_root: str, scene_names: Sequence[str],
                 npoints: int = 8192, seed: int = 0, split: str = "val"):
        super().__init__(data_root, scene_names, npoints, split, seed)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        scene = self._scene(self.scene_names[index])
        cs = chunks_lib.full_scene_chunks(
            scene["points"], [scene["labels"]], get_sample_weights=True,
            npoints=self.npoints, rng=self.rng,
            weight_table=self.labelweights,
        )
        return cs.points, cs.features[0].astype(np.int32), cs.weights


class ScannetDatasetVirtualScan(_SceneStoreDataset):
    """Virtual-scan visibility subsampling: for each of 8 camera positions,
    keep the depth-camera-visible points, then sample ``npoints``
    (ref scannet_dataset.py:152-176 + scene_util.virtual_scan)."""

    N_SCANS = 8

    def __init__(self, data_root: str, scene_names: Sequence[str],
                 npoints: int = 8192, split: str = "train", seed: int = 0):
        super().__init__(data_root, scene_names, npoints, split, seed)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        scene = self._scene(self.scene_names[index])
        points, labels = scene["points"], scene["labels"]
        pts_out: List[np.ndarray] = []
        lab_out: List[np.ndarray] = []
        w_out: List[np.ndarray] = []
        for mode in range(self.N_SCANS):
            visible = virtual_scan(points, mode=mode, rng=self.rng)
            if len(visible) < 8:
                continue
            take = self.rng.choice(len(visible), self.npoints, replace=True)
            idx = visible[take]
            pts_out.append(points[idx].astype(np.float32))
            lab_out.append(labels[idx].astype(np.int32))
            w_out.append(self.labelweights[labels[idx]].astype(np.float32))
        if not pts_out:  # degenerate scene: no camera saw >= 8 points
            idx = self.rng.choice(len(points), self.npoints, replace=True)
            pts_out.append(points[idx].astype(np.float32))
            lab_out.append(labels[idx].astype(np.int32))
            w_out.append(self.labelweights[labels[idx]].astype(np.float32))
        return np.stack(pts_out), np.stack(lab_out), np.stack(w_out)
