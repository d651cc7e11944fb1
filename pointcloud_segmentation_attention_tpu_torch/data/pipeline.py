"""Chunk dicts -> model batches (host-side numpy).

``assemble_features`` builds the per-point features; ``make_batch`` stacks
training chunks into one batch, as the JAX package's ``data/pipeline.py``
does, in the f32 or the compact wire format.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import (
    TRAIN_LABEL_WEIGHTS,
)


def assemble_features(
    colors: Optional[np.ndarray],
    normals: Optional[np.ndarray],
    use_colors: bool,
    use_normals: bool,
) -> Optional[np.ndarray]:
    """Concat the selected per-point features: colors scaled from [0, 255]
    to [0, 1], then normals.  None when no features are selected."""
    parts = []
    if use_colors and colors is not None:
        parts.append(np.asarray(colors, np.float32) / 255.0)
    if use_normals and normals is not None:
        parts.append(np.asarray(normals, np.float32))
    if not parts:
        return None
    return np.concatenate(parts, axis=-1)


def make_batch(chunks: List[Dict[str, np.ndarray]], use_colors: bool, use_normals: bool,
               wire: str = "f32") -> Dict[str, np.ndarray]:
    """Stack chunk dicts (points, labels, colors, normals, weights) into one
    batch.  The stored weight only marks the inner box: the f32 batch's
    ``weights = TRAIN_LABEL_WEIGHTS[label] * (stored weight != 0)``.

    ``wire='compact'`` keeps labels and the inner-box mask as uint8, colors
    as raw uint8 and normals as f16 (about half the bytes to copy);
    ``train.steps.expand_wire_batch`` rebuilds the f32 features and weights
    on the device.  The packed single-buffer formats raise."""
    if wire.startswith("packed"):
        raise NotImplementedError(
            f"wire={wire!r}: the packed single-buffer wire (data/wire.py) is "
            "not ported yet (ROADMAP Queue 1 item 3)")
    if wire not in ("f32", "compact"):
        raise ValueError(f"unknown wire format {wire!r}")
    points = np.stack([c["points"] for c in chunks]).astype(np.float32)
    labels = np.stack([c["labels"] for c in chunks])
    mask = np.stack([c["weights"] for c in chunks]) != 0
    if wire == "compact":
        batch = {"points": points, "labels": labels.astype(np.uint8),
                 "mask": mask.astype(np.uint8)}
        if use_colors:
            batch["colors_u8"] = np.stack([c["colors"] for c in chunks]).astype(np.uint8)
        if use_normals:
            batch["normals_f16"] = np.stack([c["normals"] for c in chunks]).astype(np.float16)
        return batch
    labels = labels.astype(np.int32)
    weights = TRAIN_LABEL_WEIGHTS[labels] * mask.astype(np.float32)
    batch = {"points": points, "labels": labels, "weights": weights.astype(np.float32)}
    features = assemble_features(
        np.stack([c["colors"] for c in chunks]) if use_colors else None,
        np.stack([c["normals"] for c in chunks]) if use_normals else None,
        use_colors, use_normals,
    )
    if features is not None:
        batch["features"] = features
    return batch
