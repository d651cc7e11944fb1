"""Segmentation metrics, the counterparts of the JAX package's
``train/metrics.py``.

A (C, C) confusion matrix is accumulated over points whose label > 0; mIoU
is the mean of ``tp / (tp + fp + fn)`` over the classes whose denominator is
non-zero (``tf.metrics.mean_iou`` semantics).  ``update_confusion`` and
``accuracy`` run on the tensors' device without a host sync;
``miou_from_confusion`` and ``StreamingMeanIoU`` are host-side numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def update_confusion(confusion: torch.Tensor, labels: torch.Tensor,
                     predictions: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """confusion + counts of (label, prediction) pairs over valid points
    (any shape); returns a new tensor."""
    c = confusion.shape[0]
    flat = labels.reshape(-1).long() * c + predictions.reshape(-1).long()
    counts = torch.zeros(c * c, dtype=confusion.dtype, device=confusion.device)
    counts.index_add_(0, flat, valid_mask.reshape(-1).to(confusion.dtype))
    return confusion + counts.reshape(c, c)


def miou_from_confusion(confusion) -> Tuple[float, np.ndarray]:
    """(mean IoU, per-class IoU); classes with tp+fp+fn == 0 are left out of
    the mean and reported as 0."""
    cm = np.asarray(confusion, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    valid = denom > 0
    iou = np.where(valid, tp / np.maximum(denom, 1e-12), 0.0)
    mean = iou[valid].mean() if valid.any() else 0.0
    return float(mean), iou


def accuracy(labels: torch.Tensor, predictions: torch.Tensor,
             valid_mask: torch.Tensor) -> torch.Tensor:
    """Fraction of correct predictions over valid points."""
    correct = (labels == predictions) & valid_mask
    n = valid_mask.float().sum().clamp_min(1.0)
    return correct.float().sum() / n


class StreamingMeanIoU:
    """Host-side confusion accumulator with ``reset()``."""

    def __init__(self, num_classes: int = 21):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self._cm = np.zeros((self.num_classes, self.num_classes), np.float64)

    def update(self, labels, predictions, valid_mask=None):
        labels = np.asarray(labels).reshape(-1)
        predictions = np.asarray(predictions).reshape(-1)
        if valid_mask is None:
            valid_mask = np.ones_like(labels, bool)
        valid_mask = np.asarray(valid_mask).reshape(-1).astype(bool)
        lab, pred = labels[valid_mask], predictions[valid_mask]
        self._cm += np.bincount(lab * self.num_classes + pred,
                                minlength=self.num_classes ** 2
                                ).reshape(self.num_classes, self.num_classes)

    def update_confusion(self, partial_cm):
        self._cm += np.asarray(partial_cm, np.float64)

    def result(self):
        return miou_from_confusion(self._cm)

    @property
    def confusion(self):
        return self._cm
