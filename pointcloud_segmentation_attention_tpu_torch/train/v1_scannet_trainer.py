"""Upstream-style ScanNet v1 trainer: chopped-scene training and whole-scene
evaluation with the calibrated voxel-accuracy metric.

The counterpart of the JAX package's ``train/v1_scannet_trainer.py`` (the
reference's ``pointnet2_tensorflow/scannet/train.py``): per-batch random
point dropout (``get_batch_wdp``), z-rotation augmentation, and the
whole-scene pass reporting the surface-voxel 'calibrated' accuracy beside
the point accuracy and mIoU.  ``train_scannet_v1(..., device=)`` trains
the xyz-only ``sem_seg`` model (21 classes) with ``seg_train_step``.
``n_devices`` > 1 trains data-parallel as ``trainer.train`` does
(spawned ranks, or the ranks of a process group; global BN statistics,
loss, gradients and metrics; every rank evaluates, rank 0 writes).

Every host draw comes from one ``np.random.RandomState(seed)`` in the JAX
package's order (the datasets' own streams, then per batch each sample's
drop ratio and mask, the batch's z-rotation, and each epoch's permutation),
so the batch stream equals the JAX trainer's bit for bit; the weights'
initialisation and the dropout masks come from ``torch.Generator``s.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.augment import rotate_point_cloud_z
from pointcloud_segmentation_attention_tpu_torch.data.scannet.v1_compat import (
    NUM_CLASSES,
    ScannetDataset,
    ScannetDatasetVirtualScan,
    ScannetDatasetWholeScene,
)
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import (
    data_parallel,
    enter_world,
)
from pointcloud_segmentation_attention_tpu_torch.train import schedules
from pointcloud_segmentation_attention_tpu_torch.train.cls_trainer import (
    epoch_mean,
)
from pointcloud_segmentation_attention_tpu_torch.train.metrics import StreamingMeanIoU
from pointcloud_segmentation_attention_tpu_torch.train.steps import (
    seg_eval_step,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger, NoLogger
from pointcloud_segmentation_attention_tpu_torch.utils.pc_util import (
    calibrated_voxel_accuracy,
    point_cloud_label_to_surface_voxel_label_fast,
)

DECAY_STEP = 200000


class _FlattenedStacked:
    """Adapts a per-scene STACKED dataset (``__getitem__`` -> (K, N, 3) /
    (K, N) / (K, N), as ``ScannetDatasetWholeScene`` and
    ``ScannetDatasetVirtualScan`` give) to per-sample indexing for the batch
    loop.  Every stack is computed once, at construction, in scene order."""

    def __init__(self, ds):
        self._stacks = [ds[i] for i in range(len(ds))]
        self._index = [(si, k) for si, (p, _, _) in enumerate(self._stacks)
                       for k in range(len(p))]

    def __len__(self):
        return len(self._index)

    def __getitem__(self, i):
        si, k = self._index[i]
        p, l, w = self._stacks[si]
        return p[k], l[k], w[k]


def get_batch_wdp(dataset, idxs, start, bsize, npoints, rng):
    """A batch with random point dropout to point 0 (the reference's
    ``get_batch_wdp``): per sample a drop ratio in [0, 0.875), then the
    dropped points, which take point 0's coordinates and label and weight 0."""
    pts = np.zeros((bsize, npoints, 3), np.float32)
    lab = np.zeros((bsize, npoints), np.int32)
    w = np.zeros((bsize, npoints), np.float32)
    for i in range(bsize):
        p, l, sw = dataset[idxs[start + i]]
        drop_ratio = rng.random_sample() * 0.875
        drop = np.where(rng.random_sample(len(p)) <= drop_ratio)[0]
        p, l, sw = p.copy(), l.copy(), sw.copy()
        if len(drop):
            p[drop] = p[0]
            l[drop] = l[0]
            sw[drop] *= 0
        pts[i], lab[i], w[i] = p, l, sw
    return pts, lab, w


def train_scannet_v1(
    data_root: str,
    train_scenes: Sequence[str],
    val_scenes: Sequence[str],
    npoints: int = 8192,
    batch_size: int = 16,
    epochs: int = 201,
    log_dir: str = "logs/scannet_v1",
    n_devices: Optional[int] = None,
    seed: int = 0,
    max_steps: Optional[int] = None,
    dataset_kind: str = "chunk",
    *,
    device="cuda",
) -> dict:
    """Train ``sem_seg`` on ``dataset_kind``'s batches and evaluate the val
    scenes whole after every epoch; returns the last evaluation's
    ``eval_accuracy``, ``eval_miou`` and ``eval_calibrated_vox_accuracy``
    with that epoch's ``train_loss`` and the step count ``steps``.

    ``dataset_kind``: ``chunk`` (a random 1.5 m chunk a scene), ``virtual``
    (depth-camera visibility subsampling from 8 camera positions) or
    ``whole`` (full-coverage grid chunks, each scene's stack flattened into
    the batch loop), the reference's commented dataset swap."""
    world = enter_world(train_scannet_v1, n_devices, batch_size, device, dict(locals()))
    if world.summary is not None:
        return world.summary
    mesh, writer = world.mesh, world.writer  # only rank 0 writes logs and checkpoints
    if dataset_kind == "virtual":
        train_ds = _FlattenedStacked(
            ScannetDatasetVirtualScan(data_root, train_scenes, npoints, "train", seed))
    elif dataset_kind == "whole":
        train_ds = _FlattenedStacked(
            ScannetDatasetWholeScene(data_root, train_scenes, npoints, seed, split="train"))
    elif dataset_kind == "chunk":
        train_ds = ScannetDataset(data_root, train_scenes, npoints, "train", seed)
    else:
        raise ValueError(f"unknown dataset_kind '{dataset_kind}'")
    whole_ds = ScannetDatasetWholeScene(data_root, val_scenes, npoints, seed)
    model = models.get_model("sem_seg", device=world.device, num_classes=NUM_CLASSES,
                             generator=torch.Generator().manual_seed(seed))
    state = TrainState(model, lambda step: schedules.upstream_learning_rate(
        step, 1e-3, batch_size))
    bn = lambda step: schedules.upstream_bn_momentum(step, batch_size, DECAY_STEP)  # noqa: E731
    np_rng = np.random.RandomState(seed)
    logger = MetricLogger(log_dir, "scannet_v1") if writer else NoLogger()

    train_step = data_parallel(seg_train_step, mesh)
    steps = 0
    summary = {}
    n = len(train_ds)
    for _ in range(epochs):
        idxs = np_rng.permutation(n)
        losses = []
        for start in range(0, n - batch_size + 1, batch_size):
            pts, lab, w = get_batch_wdp(train_ds, idxs, start, batch_size, npoints, np_rng)
            pts = rotate_point_cloud_z(pts, rng=np_rng)
            state, m = train_step(state, {"points": pts, "labels": lab, "weights": w},
                                  seed, bn_schedule=bn)
            losses.append(m["loss"])  # device scalars, fetched at the epoch's end
            steps += 1
            if max_steps and steps >= max_steps:
                break
        metrics = eval_whole_scenes(state, whole_ds, batch_size)
        metrics["train_loss"] = epoch_mean(losses)
        logger.log(steps, metrics)
        summary.update(metrics)
        if max_steps and steps >= max_steps:
            break
    logger.close()
    summary["steps"] = steps
    return summary


def eval_whole_scenes(state: TrainState, whole_ds, batch_size: int) -> dict:
    """Whole-scene evaluation (the reference's ``scannet/train.py``): each
    scene's grid chunks in batches of ``batch_size`` through
    ``seg_eval_step``, the predictions fetched once a scene; the point
    accuracy and mIoU over label > 0, and the calibrated voxel accuracy over
    each chunk's surface voxels (numpy, on the host)."""
    miou = StreamingMeanIoU(NUM_CLASSES)
    correct = total = 0
    vox_correct = np.zeros(NUM_CLASSES - 1)
    vox_seen = np.zeros(NUM_CLASSES - 1)
    for si in range(len(whole_ds)):
        pts, lab, w = whole_ds[si]
        preds = torch.cat([
            seg_eval_step(state, {"points": pts[start:start + batch_size],
                                  "labels": lab[start:start + batch_size],
                                  "weights": w[start:start + batch_size]})["predictions"]
            for start in range(0, len(pts), batch_size)]).cpu().numpy()
        valid = lab > 0
        miou.update(lab, preds, valid)
        correct += ((preds == lab) & valid).sum()
        total += valid.sum()
        for b in range(len(pts)):
            mask = lab[b] > 0
            if mask.sum() == 0:
                continue
            uvlabel, _ = point_cloud_label_to_surface_voxel_label_fast(
                pts[b][mask], np.stack([lab[b][mask], preds[b][mask]], 1))
            for c in range(1, NUM_CLASSES):
                sel = uvlabel[:, 0] == c
                vox_seen[c - 1] += sel.sum()
                vox_correct[c - 1] += (uvlabel[sel, 1] == c).sum()
    mean_iou, _ = miou.result()
    return {
        "eval_accuracy": correct / max(total, 1),
        "eval_miou": mean_iou,
        "eval_calibrated_vox_accuracy": calibrated_voxel_accuracy(vox_correct, vox_seen),
    }
