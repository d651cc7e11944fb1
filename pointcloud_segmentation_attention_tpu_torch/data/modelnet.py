"""ModelNet40 classification loaders: txt-per-shape and HDF5-shard layouts;
the port's own copy of the JAX package's ``data/modelnet.py`` (numpy).

Equivalents of ``pointnet2_tensorflow/modelnet_dataset.py`` (ModelNetDataset:
:23-144 — txt files with x,y,z,nx,ny,nz per line, unit-sphere normalization,
in-memory cache, batch iterator) and ``modelnet_h5_dataset.py``
(ModelNetH5Dataset :54-126 — h5 shards listed in a file list, shard-by-shard
iteration).  Augmentation uses ``data.augment.augment_batch_cls`` (the
reference's provider.py chain) on the host; batches are always padded to the
full fixed batch size so the device sees one shape (the true count is
returned as ``bsize``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.augment import augment_batch_cls


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center on the centroid and scale to the unit sphere
    (ref modelnet_dataset.py:13-19)."""
    pc = pc - pc.mean(axis=0)
    scale = np.max(np.linalg.norm(pc, axis=1))
    return (pc / max(scale, 1e-12)).astype(np.float32)


class ModelNetDataset:
    """txt-per-shape layout (ref modelnet_dataset.py:23-144)::

        root/modelnet40_shape_names.txt     one class name per line
        root/modelnet40_{train,test}.txt    shape ids like ``airplane_0001``
        root/{class}/{shape_id}.txt         x,y,z,nx,ny,nz per line (csv)
    """

    def __init__(self, root: str, batch_size: int = 32, npoints: int = 1024,
                 split: str = "train", normal_channel: bool = False,
                 shuffle: Optional[bool] = None, seed: int = 0):
        self.root = root
        self.batch_size = batch_size
        self.npoints = npoints
        self.normal_channel = normal_channel
        with open(os.path.join(root, "modelnet40_shape_names.txt")) as f:
            self.classes = [l.strip() for l in f if l.strip()]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        with open(os.path.join(root, f"modelnet40_{split}.txt")) as f:
            shape_ids = [l.strip() for l in f if l.strip()]
        # class name = shape id minus the trailing _NNNN (ref :38).
        self.datapath = [
            ("_".join(sid.split("_")[:-1]),
             os.path.join(root, "_".join(sid.split("_")[:-1]), f"{sid}.txt"))
            for sid in shape_ids
        ]
        self.shuffle = shuffle if shuffle is not None else (split == "train")
        self.rng = np.random.RandomState(seed)
        self._cache: dict = {}
        self.reset()

    def __len__(self) -> int:
        return len(self.datapath)

    def num_channel(self) -> int:
        return 6 if self.normal_channel else 3

    def _get_item(self, index: int) -> Tuple[np.ndarray, int]:
        if index not in self._cache:
            cls_name, path = self.datapath[index]
            raw = np.loadtxt(path, delimiter=",").astype(np.float32)
            pts = raw[: self.npoints]
            pts[:, :3] = pc_normalize(pts[:, :3])
            if not self.normal_channel:
                pts = pts[:, :3]
            self._cache[index] = (pts, self.class_to_idx[cls_name])
        return self._cache[index]

    def reset(self) -> None:
        self._order = (self.rng.permutation(len(self))
                       if self.shuffle else np.arange(len(self)))
        self._cursor = 0

    def has_next_batch(self) -> bool:
        return self._cursor < len(self)

    def next_batch(self, augment_data: bool = False) -> Tuple[np.ndarray, np.ndarray, int]:
        """Next ``(batch, labels, bsize)``; partial final batch is padded with
        repeats of its last shape to the fixed batch size (fixed shapes for
        the device; ref modelnet_h5_dataset.py:96-117 zero-padded instead)."""
        start = self._cursor
        stop = min(start + self.batch_size, len(self))
        bsize = stop - start
        batch = np.zeros((self.batch_size, self.npoints, self.num_channel()),
                         np.float32)
        labels = np.zeros(self.batch_size, np.int32)
        for i in range(self.batch_size):
            src = self._order[start + min(i, bsize - 1)]
            pts, cls = self._get_item(int(src))
            m = min(len(pts), self.npoints)
            batch[i, :m] = pts[:m]
            if m < self.npoints:  # resample short shapes with replacement
                extra = self.rng.choice(m, self.npoints - m)
                batch[i, m:] = pts[extra]
            labels[i] = cls
        self._cursor = stop
        if augment_data:
            batch = augment_batch_cls(batch, self.normal_channel, rng=self.rng)
        return batch, labels, bsize


class ModelNetH5Dataset:
    """HDF5-shard layout (ref modelnet_h5_dataset.py:54-126): a list file of
    h5 paths (resolved relative to the list file), each with ``data``
    (S, N, 3+) and ``label`` (S, 1)."""

    def __init__(self, list_filename: str, batch_size: int = 32,
                 npoints: int = 1024, shuffle: bool = True, seed: int = 0):
        import h5py  # optional dependency, only for this loader

        self.batch_size = batch_size
        self.npoints = npoints
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        base = os.path.dirname(os.path.abspath(list_filename))
        with open(list_filename) as f:
            paths = [os.path.join(base, l.strip()) for l in f if l.strip()]
        datas, labels = [], []
        for p in paths:
            with h5py.File(p, "r") as h5:
                datas.append(np.asarray(h5["data"], np.float32))
                labels.append(np.asarray(h5["label"]).reshape(-1).astype(np.int32))
        self.data = np.concatenate(datas)[:, :npoints]
        self.labels = np.concatenate(labels)
        self.reset()

    def __len__(self) -> int:
        return len(self.data)

    def num_channel(self) -> int:
        return self.data.shape[-1]

    def reset(self) -> None:
        self._order = (self.rng.permutation(len(self))
                       if self.shuffle else np.arange(len(self)))
        self._cursor = 0

    def has_next_batch(self) -> bool:
        return self._cursor < len(self)

    def next_batch(self, augment_data: bool = False) -> Tuple[np.ndarray, np.ndarray, int]:
        start = self._cursor
        stop = min(start + self.batch_size, len(self))
        bsize = stop - start
        sel = self._order[start:stop]
        if bsize < self.batch_size:  # pad with repeats to the fixed shape
            sel = np.concatenate(
                [sel, np.repeat(sel[-1:], self.batch_size - bsize)])
        batch = self.data[sel].copy()
        labels = self.labels[sel].copy()
        self._cursor = stop
        if augment_data:
            batch = augment_batch_cls(batch, self.num_channel() > 3,
                                      rng=self.rng)
        return batch, labels, bsize


def _synthetic_shape(cls: int, shape_seed: int, n_points: int) -> np.ndarray:
    """A class-distinctive point cloud: ellipsoid shell whose axis ratios and
    lobe count depend on the class, so classifiers can actually learn."""
    rng = np.random.RandomState(shape_seed)
    u = rng.randn(n_points, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    axes = np.array([1.0 + 0.5 * (cls % 3), 1.0 + 0.25 * (cls % 5),
                     1.0 + 0.125 * (cls % 7)])
    pts = u * axes
    pts[:, 2] += 0.3 * np.sin((cls + 1) * np.arctan2(u[:, 1], u[:, 0]))
    pts += rng.randn(n_points, 3) * 0.02
    normals = u.astype(np.float32)
    return np.concatenate([pts.astype(np.float32), normals], axis=1)


def write_synthetic_modelnet(root: str, num_classes: int = 4,
                             shapes_per_class: int = 3, n_points: int = 512,
                             seed: int = 0) -> None:
    """Miniature ModelNet in the txt layout (for tests/benchmarks): the last
    shape of each class goes to the test split, the rest to train."""
    names = [f"class{c:02d}" for c in range(num_classes)]
    with open(os.path.join(os.makedirs(root, exist_ok=True) or root,
                           "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    splits = {"train": [], "test": []}
    for c, name in enumerate(names):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for s in range(shapes_per_class):
            sid = f"{name}_{s:04d}"
            data = _synthetic_shape(c, seed + c * 1000 + s, n_points)
            np.savetxt(os.path.join(root, name, f"{sid}.txt"), data,
                       delimiter=",", fmt="%.6f")
            splits["test" if s == shapes_per_class - 1 else "train"].append(sid)
    for split, sids in splits.items():
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(sids) + "\n")
