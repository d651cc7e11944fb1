"""ShapeNet-Part dataset: xyz + normals + 50 part labels over 16 categories;
the port's own copy of the JAX package's ``data/shapenet_part.py`` (numpy).

Equivalent of ``pointnet2_tensorflow/part_seg/part_dataset_all_normal.py``
(PartNormalDataset :19-138): ``synsetoffset2category.txt`` maps category names
to synset directories, per-shape txt files hold ``x y z nx ny nz seg`` rows,
and the official ``train_test_split/shuffled_{split}_file_list.json`` lists
define the splits ("trainval" = train + val, ref :52-60).  Part-label ranges
per category match ``eval.part_iou.SEG_CLASSES``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.eval.part_iou import SEG_CLASSES


class PartNormalDataset:
    def __init__(self, root: str, npoints: int = 2048, split: str = "train",
                 return_cls_label: bool = False, normalize: bool = True,
                 seed: int = 0):
        self.root = root
        self.npoints = npoints
        self.return_cls_label = return_cls_label
        self.normalize = normalize
        self.rng = np.random.RandomState(seed)

        # category name -> synset dir (ref :31-38)
        self.cat: Dict[str, str] = {}
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            for line in f:
                if line.strip():
                    name, synset = line.strip().split()
                    self.cat[name] = synset
        self.classes = {name: i for i, name in enumerate(sorted(self.cat))}
        synset_to_cat = {v: k for k, v in self.cat.items()}

        split_names = ["train", "val"] if split == "trainval" else [split]
        files: List[str] = []
        for s in split_names:
            with open(os.path.join(root, "train_test_split",
                                   f"shuffled_{s}_file_list.json")) as f:
                files.extend(json.load(f))
        # entries look like "shape_data/{synset}/{uuid}" (ref :52-58)
        self.datapath: List[Tuple[str, str]] = []
        for entry in files:
            synset, uuid = entry.split("/")[-2:]
            self.datapath.append(
                (synset_to_cat[synset],
                 os.path.join(root, synset, f"{uuid}.txt"))
            )
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.datapath)

    def category_of(self, index: int) -> str:
        return self.datapath[index][0]

    def _load(self, index: int):
        if index not in self._cache:
            cat, path = self.datapath[index]
            raw = np.loadtxt(path).astype(np.float32)
            pts = raw[:, 0:3]
            if self.normalize:
                pts = pts - pts.mean(axis=0)
                pts = pts / max(np.max(np.linalg.norm(pts, axis=1)), 1e-12)
            self._cache[index] = (pts.astype(np.float32),
                                  raw[:, 3:6].astype(np.float32),
                                  raw[:, 6].astype(np.int32), cat)
        return self._cache[index]

    def __getitem__(self, index: int):
        """(points, normals, seg[, cls]) resampled to ``npoints`` with
        replacement (ref :100-112)."""
        pts, normals, seg, cat = self._load(index)
        choice = self.rng.choice(len(seg), self.npoints, replace=True)
        out = (pts[choice], normals[choice], seg[choice])
        if self.return_cls_label:
            return out + (self.classes[cat],)
        return out

    def batches(self, batch_size: int, shuffle: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
        """Fixed-shape batches ``(points+normals (B,N,6), seg (B,N),
        cls (B,), bsize)``; the ragged tail is padded with repeats."""
        order = (self.rng.permutation(len(self)) if shuffle
                 else np.arange(len(self)))
        for start in range(0, len(self), batch_size):
            sel = order[start:start + batch_size]
            bsize = len(sel)
            if bsize < batch_size:
                sel = np.concatenate(
                    [sel, np.repeat(sel[-1:], batch_size - bsize)])
            pts = np.zeros((batch_size, self.npoints, 6), np.float32)
            seg = np.zeros((batch_size, self.npoints), np.int32)
            cls = np.zeros(batch_size, np.int32)
            for i, idx in enumerate(sel):
                p, n, s, c = self._load(int(idx))[:3] + (self.category_of(int(idx)),)
                choice = self.rng.choice(len(s), self.npoints, replace=True)
                pts[i, :, :3] = p[choice]
                pts[i, :, 3:] = n[choice]
                seg[i] = s[choice]
                cls[i] = self.classes[c]
            yield pts, seg, cls, bsize


def write_synthetic_shapenet_part(
    root: str, categories: Optional[List[str]] = None,
    n_shapes_per_cat: int = 4, n_points: int = 256, seed: int = 0,
) -> None:
    """Miniature ShapeNet-Part in the official layout (for tests/benchmarks).
    Per category: last shape -> test, second-to-last -> val, rest -> train.
    Parts are spatial z-slices of a noisy ellipsoid, labeled with the
    category's official part ids so part-IoU machinery works unchanged."""
    if categories is None:
        categories = ["Airplane", "Chair"]
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for i, cat in enumerate(categories):
            f.write(f"{cat}\t{90000000 + i}\n")
    splits: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    for i, cat in enumerate(categories):
        synset = str(90000000 + i)
        os.makedirs(os.path.join(root, synset), exist_ok=True)
        parts = list(SEG_CLASSES[cat])
        for s in range(n_shapes_per_cat):
            pts = rng.randn(n_points, 3).astype(np.float32)
            pts /= np.linalg.norm(pts, axis=1, keepdims=True)
            pts *= np.array([1.0 + 0.3 * i, 1.0, 0.7])
            normals = pts / np.linalg.norm(pts, axis=1, keepdims=True)
            # part = z-slice index within the category's part range
            q = np.clip(((pts[:, 2] - pts[:, 2].min())
                         / max(np.ptp(pts[:, 2]), 1e-9) * len(parts)).astype(int),
                        0, len(parts) - 1)
            seg = np.asarray(parts)[q]
            uuid = f"{cat.lower()}{s:04d}"
            np.savetxt(os.path.join(root, synset, f"{uuid}.txt"),
                       np.concatenate([pts, normals, seg[:, None]], 1),
                       fmt="%.6f")
            split = ("test" if s == n_shapes_per_cat - 1 else
                     "val" if s == n_shapes_per_cat - 2 else "train")
            splits[split].append(f"shape_data/{synset}/{uuid}")
    for split, entries in splits.items():
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(entries, f)


# ---------------------------------------------------------------------------
# HDF5 flow used by the PointNet v1 part-seg subtree
# (ref ``pointnet1/part_seg/train.py``: ``provider.loadDataFile_with_seg``
# over ``train_hdf5_file_list.txt`` / ``val_hdf5_file_list.txt``; each h5
# shard holds ``data`` (S,N,3), ``label`` (S,1) object class, ``pid`` (S,N)
# per-point part id).
# ---------------------------------------------------------------------------

def load_h5_with_seg(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(data (S,N,3) f32, label (S,) i32, seg (S,N) i32) from one h5 shard."""
    import h5py  # optional dependency, only for this loader

    with h5py.File(path, "r") as h5:
        data = np.asarray(h5["data"], np.float32)
        label = np.asarray(h5["label"], np.int32).reshape(-1)
        seg = np.asarray(h5["pid"], np.int32)
    return data, label, seg


class ShapeNetPartH5Dataset:
    """File-list h5 dataset for the v1 joint part-seg trainer.

    ``list_path`` is a text file of h5 shard paths (relative to its own
    directory, like the reference's ``train_hdf5_file_list.txt``).  Batches
    are fixed-shape; within each shard the shape order is shuffled when
    ``shuffle`` (ref ``provider.shuffle_data``); the ragged per-shard tail is
    dropped like the reference (``num_batch = num_data // batch_size``).
    """

    def __init__(self, list_path: str, batch_size: int, npoints: int = 2048,
                 shuffle: bool = True, seed: int = 0):
        self.root = os.path.dirname(os.path.abspath(list_path))
        with open(list_path) as f:
            self.files = [os.path.join(self.root, line.strip())
                          for line in f if line.strip()]
        self.batch_size = batch_size
        self.npoints = npoints
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (points (B,n,3), cls (B,), seg (B,n))."""
        file_order = (self.rng.permutation(len(self.files)) if self.shuffle
                      else np.arange(len(self.files)))
        for fi in file_order:
            data, label, seg = load_h5_with_seg(self.files[fi])
            n = min(self.npoints, data.shape[1])
            data, seg = data[:, :n], seg[:, :n]
            order = (self.rng.permutation(len(label)) if self.shuffle
                     else np.arange(len(label)))
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                sel = order[start:start + self.batch_size]
                yield data[sel], label[sel], seg[sel]


def write_synthetic_shapenet_part_h5(
    root: str, n_shards: int = 2, shapes_per_shard: int = 8,
    n_points: int = 256, cat_num: int = 16, seed: int = 0,
) -> Tuple[str, str]:
    """Miniature h5 ShapeNet-Part in the v1 subtree's layout (for tests).
    Returns (train_list_path, val_list_path)."""
    import h5py

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    names = []
    for s in range(n_shards + 1):  # last shard is the val list
        pts = rng.randn(shapes_per_shard, n_points, 3).astype(np.float32)
        label = rng.randint(0, cat_num, shapes_per_shard).astype(np.int32)
        # part id = class-dependent z-halfspace so the task is learnable
        seg = (pts[..., 2] > 0).astype(np.int32) + 2 * label[:, None]
        name = os.path.join(root, f"ply_data_{s}.h5")
        with h5py.File(name, "w") as h5:
            h5.create_dataset("data", data=pts)
            h5.create_dataset("label", data=label[:, None])
            h5.create_dataset("pid", data=seg)
        names.append(os.path.basename(name))
    train_list = os.path.join(root, "train_hdf5_file_list.txt")
    val_list = os.path.join(root, "val_hdf5_file_list.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(names[:-1]) + "\n")
    with open(val_list, "w") as f:
        f.write(names[-1] + "\n")
    return train_list, val_list
