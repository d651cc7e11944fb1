"""Multi-angle voting evaluation for classification: the port's own copy of
the JAX package's ``eval/voting.py``.  ``predict_fn`` maps a numpy batch to
numpy logits; it runs the model on whichever device the caller chose.

Reference: ``pointnet2_tensorflow/evaluate.py:106-155`` — rotate each cloud by
vote_idx/num_votes * 2pi around the up axis, sum the logits over votes, take
the argmax; also ``part_seg/evaluate.py`` (VOTE_NUM=12).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data import augment
from pointcloud_segmentation_attention_tpu_torch.eval.part_iou import (
    PartIoUAccumulator,
    restrict_logits_to_category,
)
from pointcloud_segmentation_attention_tpu_torch.viz.ply_export import export_labeled_scene


def vote_predict(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    points: np.ndarray,
    num_votes: int = 1,
    with_normals: bool = False,
) -> np.ndarray:
    """Summed logits over rotation votes.  points (B, N, 3[+3])."""
    total = None
    for vote in range(num_votes):
        angle = vote / float(num_votes) * 2 * np.pi
        if with_normals:
            rotated = augment.rotate_point_cloud_by_angle_with_normal(points, angle)
        else:
            rotated = points.copy()
            rotated[..., :3] = augment.rotate_point_cloud_by_angle(points[..., :3], angle)
        logits = np.asarray(predict_fn(rotated))
        total = logits if total is None else total + logits
    return total


def evaluate_classification(
    predict_fn: Callable,
    batches,  # iterable of (points (B,N,C), labels (B,))
    num_votes: int = 1,
    num_classes: int = 40,
    with_normals: bool = False,
) -> dict:
    """Overall + per-class ('avg class acc') accuracy with voting
    (ref evaluate.py:143-155)."""
    total_correct = 0
    total_seen = 0
    seen_per_class = np.zeros(num_classes)
    correct_per_class = np.zeros(num_classes)
    for points, labels in batches:
        logits = vote_predict(predict_fn, points, num_votes, with_normals)
        pred = np.argmax(logits, axis=-1)
        total_correct += (pred == labels).sum()
        total_seen += len(labels)
        for l, p in zip(labels, pred):
            seen_per_class[l] += 1
            correct_per_class[l] += int(l == p)
    per_class = correct_per_class / np.maximum(seen_per_class, 1)
    return {
        "accuracy": total_correct / max(total_seen, 1),
        "avg_class_accuracy": float(per_class[seen_per_class > 0].mean()),
        "per_class_accuracy": per_class,
    }


def vote_predict_partseg(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    points: np.ndarray,
    num_votes: int = 12,
    seed: int = 0,
) -> np.ndarray:
    """Per-point logits summed over shuffle votes (ref part_seg/evaluate.py,
    VOTE_NUM=12: each vote re-feeds the shape under a different point
    permutation and the logits are un-permuted before summing).
    points (B, N, C) -> logits (B, N, num_parts)."""
    rng = np.random.RandomState(seed)
    n = points.shape[1]
    total = None
    for _ in range(num_votes):
        perm = rng.permutation(n)
        inv = np.argsort(perm)
        logits = np.asarray(predict_fn(points[:, perm]))[:, inv]
        total = logits if total is None else total + logits
    return total


def evaluate_part_segmentation(
    predict_fn: Callable,
    dataset,  # PartNormalDataset
    batch_size: int = 8,
    num_votes: int = 12,
    ply_dir: Optional[str] = None,
) -> dict:
    """Voting part-seg evaluation with per-category IoU
    (ref part_seg/evaluate.py + test.py's per-shape ply dumps when
    ``ply_dir`` is given: ``shape{index:05d}_{category}.ply``, the points
    colored by the category-restricted argmax)."""
    acc = PartIoUAccumulator()
    cats = sorted(dataset.classes, key=lambda c: dataset.classes[c])
    if ply_dir is not None:
        os.makedirs(ply_dir, exist_ok=True)
    shape_idx = 0
    for pts, seg, cls, bsize in dataset.batches(batch_size, shuffle=False):
        logits = vote_predict_partseg(predict_fn, pts, num_votes)
        for i in range(bsize):
            cat = cats[cls[i]]
            acc.add_shape(logits[i], seg[i], cat)
            if ply_dir is not None:
                export_labeled_scene(os.path.join(ply_dir, f"shape{shape_idx:05d}_{cat}.ply"),
                                     pts[i, :, :3], restrict_logits_to_category(logits[i], cat))
            shape_idx += 1
    return acc.result()
