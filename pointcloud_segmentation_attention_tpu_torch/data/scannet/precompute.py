"""Chunk precomputation to disk, replay iterators and eval scene streams
(numpy only).

Training chunks are one random, z-rotated cuboid per (epoch, scene), one
``{epoch}-{scene}.npz`` each; validation chunks are a scene's full-coverage
grid chunks, one ``val-{scene}.npz`` per scene.  Replay walks them back as
an endless shuffled stream (train) or one ordered pass (val).  The eval
stream yields whole scenes as chunk stacks with masks and original indices
for stitched prediction.  The port's own copy of the JAX package's
``data/scannet/precompute.py``: the same inputs give the same arrays, files
and order.
"""
from __future__ import annotations

import itertools
import os
import zlib
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet import chunks as chunks_lib
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as scenes_lib

CHUNK_KEYS = ("points", "labels", "colors", "normals", "weights")


def train_chunk_path(out_dir: str, epoch: int, scene: str) -> str:
    return os.path.join(out_dir, f"{epoch}-{scene}.npz")


def val_chunk_path(out_dir: str, scene: str) -> str:
    return os.path.join(out_dir, f"val-{scene}.npz")


def precompute_train_chunks(
    data_root: str,
    scene_names: Sequence[str],
    out_dir: str,
    epochs: int,
    npoints: int = 8192,
    start_epoch: int = 0,
    seed: int = 0,
) -> int:
    """One random z-rotated chunk per (epoch, scene) for epochs
    ``start_epoch .. start_epoch + epochs - 1``, written as
    ``{epoch}-{scene}.npz``; returns the number written.  An existing file
    raises (resume with ``start_epoch``).  Each chunk's random stream is
    seeded from (seed, epoch, CRC32 of the scene name), not from the
    scene's place in the list, so a scene list sharded across hosts gives
    the same chunks as one host."""
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for epoch in range(start_epoch, start_epoch + epochs):
        for name in scene_names:
            path = train_chunk_path(out_dir, epoch, name)
            if os.path.exists(path):
                raise FileExistsError(f"{path} already exists; use start_epoch to resume")
            rng = np.random.RandomState(
                (seed * 1_000_003 + epoch * 8191 + zlib.crc32(name.encode())) % (2**31 - 1))
            scene = scenes_lib.load_scene_mapped(data_root, name)
            pts, nrm = chunks_lib.random_z_rotation(scene["points"], scene["normals"], rng)
            p, l, c, n, w = chunks_lib.sample_random_chunk(
                pts, scene["labels"], scene["colors"], nrm, npoints, rng)
            np.savez(path, points=p, labels=l, colors=c, normals=n, weights=w)
            written += 1
    return written


def precompute_val_chunks(
    data_root: str,
    scene_names: Sequence[str],
    out_dir: str,
    npoints: int = 8192,
    seed: int = 0,
) -> int:
    """Full-coverage grid chunks of each val scene, one ``val-{scene}.npz``
    per scene; returns the total chunk count."""
    os.makedirs(out_dir, exist_ok=True)
    total = 0
    for name in scene_names:
        scene = scenes_lib.load_scene_mapped(data_root, name)
        out = chunks_lib.grid_chunks_for_eval(
            scene["points"], scene["labels"], scene["colors"], scene["normals"], npoints,
            rng=np.random.RandomState(seed))
        np.savez(val_chunk_path(out_dir, name), **{k: out[k] for k in CHUNK_KEYS})
        total += len(out["points"])
    return total


def load_chunk(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in CHUNK_KEYS}


def replay_train_chunks(
    out_dir: str,
    epochs_available: int,
    scene_names: Sequence[str],
    shuffle_seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless replay: each pass walks every precomputed epoch, the scene
    order reshuffled per epoch by one ``RandomState(shuffle_seed)``."""
    rng = np.random.RandomState(shuffle_seed)
    names = list(scene_names)
    for _ in itertools.count():
        for epoch in range(epochs_available):
            for i in rng.permutation(len(names)):
                yield load_chunk(train_chunk_path(out_dir, epoch, names[i]))


def replay_val_chunks(out_dir: str, scene_names: Sequence[str]
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """One pass over every precomputed val chunk, in scene order."""
    for name in scene_names:
        stacked = load_chunk(val_chunk_path(out_dir, name))
        for i in range(len(stacked["points"])):
            yield {k: stacked[k][i] for k in CHUNK_KEYS}


def eval_scene_item(scene: Dict[str, np.ndarray], name: Optional[str] = None,
                    npoints: int = 8192, with_labels: bool = True, seed: int = 0) -> Dict:
    """One scene (labels in [0, 20], or absent) as the chunk stack a
    stitched prediction takes: chunked points/labels/colors/normals/weights,
    masks, orig_idx, num_vertices, the scene's own points and, with labels,
    its per-vertex labels.  Without labels the chunks carry label 0."""
    with_labels = with_labels and scene.get("labels") is not None
    labels = scene["labels"] if with_labels else np.zeros(len(scene["points"]), np.int32)
    out = chunks_lib.grid_chunks_for_eval(
        scene["points"], labels, scene["colors"], scene["normals"], npoints,
        rng=np.random.RandomState(seed))
    item = {
        "scene_name": name,
        **out,
        "num_vertices": len(scene["points"]),
        "vertex_points": scene["points"],
    }
    if with_labels:
        item["vertex_labels"] = scene["labels"]
    return item


def eval_scene_stream(
    data_root: str,
    scene_names: Sequence[str],
    npoints: int = 8192,
    with_labels: bool = True,
    seed: int = 0,
) -> Iterator[Dict]:
    """Whole scenes of the store as ``eval_scene_item`` dicts, in order."""
    for name in scene_names:
        scene = scenes_lib.load_scene_mapped(data_root, name)
        yield eval_scene_item(scene, name, npoints, with_labels, seed)
