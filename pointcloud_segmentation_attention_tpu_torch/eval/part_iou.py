"""ShapeNet part-segmentation IoU: the port's own copy of the JAX package's
``eval/part_iou.py`` (numpy).

Reference: ``pointnet2_tensorflow/part_seg/train.py:223-306`` — per-shape part
IoU averaged within each object category, then averaged over categories
(plus the 'instance average' over all shapes).  Predictions are restricted to
the category's own part-label range (``train.py:277-281``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# ShapeNet-Part category -> part label range [start, end) over the 50 labels
# (ref part_seg/part_dataset_all_normal.py: seg_classes).
SEG_CLASSES: Dict[str, Sequence[int]] = {
    "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7],
    "Car": [8, 9, 10, 11], "Chair": [12, 13, 14, 15], "Earphone": [16, 17, 18],
    "Guitar": [19, 20, 21], "Knife": [22, 23], "Lamp": [24, 25, 26, 27],
    "Laptop": [28, 29], "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37],
    "Pistol": [38, 39, 40], "Rocket": [41, 42, 43], "Skateboard": [44, 45, 46],
    "Table": [47, 48, 49],
}
CATEGORIES = sorted(SEG_CLASSES)
LABEL_TO_CATEGORY = {}
for _cat, _parts in SEG_CLASSES.items():
    for _p in _parts:
        LABEL_TO_CATEGORY[_p] = _cat


def restrict_logits_to_category(logits: np.ndarray, category: str) -> np.ndarray:
    """argmax over only the category's part labels (ref train.py:277-281)."""
    parts = SEG_CLASSES[category]
    return np.asarray(parts)[np.argmax(logits[..., parts], axis=-1)]


def shape_iou(pred: np.ndarray, gt: np.ndarray, category: str) -> float:
    """Mean IoU over the category's parts for one shape; parts absent from
    both pred and gt count as IoU 1 (ref train.py:285-294)."""
    parts = SEG_CLASSES[category]
    ious = []
    for p in parts:
        tp = ((pred == p) & (gt == p)).sum()
        union = ((pred == p) | (gt == p)).sum()
        ious.append(1.0 if union == 0 else tp / union)
    return float(np.mean(ious))


class PartIoUAccumulator:
    def __init__(self):
        self._per_cat: Dict[str, list] = {c: [] for c in CATEGORIES}

    def add_shape(self, logits: np.ndarray, gt: np.ndarray, category: str):
        pred = restrict_logits_to_category(logits, category)
        self._per_cat[category].append(shape_iou(pred, gt, category))

    def result(self) -> dict:
        cat_means = {
            c: float(np.mean(v)) for c, v in self._per_cat.items() if v
        }
        all_shapes = [x for v in self._per_cat.values() for x in v]
        return {
            "class_avg_iou": float(np.mean(list(cat_means.values()))) if cat_means else 0.0,
            "instance_avg_iou": float(np.mean(all_shapes)) if all_shapes else 0.0,
            "per_category_iou": cat_means,
        }
