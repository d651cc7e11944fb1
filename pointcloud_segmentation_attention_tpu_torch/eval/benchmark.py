"""ScanNet benchmark export and the offline confusion / IoU evaluator
(numpy only).

File format: one NYU40 id per line per vertex.  The evaluator builds a
41x41 confusion matrix over scene pairs and reports per-class IoU =
tp / (tp + fp + fn) over the 20 valid ids, and optionally a results file
with the per-class IoUs and the confusion matrix.  The port's own copy of
the JAX package's ``eval/benchmark.py``: the same files and results.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import (
    INVERSE_LABEL_MAP,
)

CLASS_LABELS = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)
VALID_CLASS_IDS = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24,
                            28, 33, 34, 36, 39])
UNKNOWN_ID = int(VALID_CLASS_IDS.max()) + 1  # 40


def map_to_nyu40_for_benchmark(labels: np.ndarray) -> np.ndarray:
    """[0,20] -> NYU40, with unannotated (0) mapped to 1 (wall) because the
    benchmark format requires a valid id."""
    lut = np.array([INVERSE_LABEL_MAP.get(i, 1) or 1 for i in range(21)], np.int64)
    return lut[np.asarray(labels, np.int64)]


def export_ids(filename: str, ids: np.ndarray) -> None:
    """One id per line."""
    with open(filename, "w") as f:
        for i in np.asarray(ids).reshape(-1):
            f.write("%d\n" % int(i))


def export_benchmark_txt(filename: str, labels_020: np.ndarray) -> None:
    export_ids(filename, map_to_nyu40_for_benchmark(labels_020))


def load_ids(filename: str) -> np.ndarray:
    return np.array(open(filename).read().splitlines(), np.int64)


def export_groundtruth_from_json(
    agg_file: str, seg_file: str, raw_to_nyu40: Dict[str, int], output_file: str
) -> np.ndarray:
    """segs.json + aggregation.json + label map -> per-vertex NYU40 ids,
    also written to ``output_file``."""
    with open(agg_file) as f:
        agg = json.load(f)
    label_to_segs: Dict[str, List[int]] = {}
    for obj in agg["segGroups"]:
        label_to_segs.setdefault(obj["label"], []).extend(obj["segments"])
    with open(seg_file) as f:
        seg = json.load(f)
    seg_indices = np.asarray(seg["segIndices"], np.int64)
    num_verts = len(seg_indices)
    seg_to_verts: Dict[int, np.ndarray] = {}
    for s in np.unique(seg_indices):
        seg_to_verts[int(s)] = np.where(seg_indices == s)[0]
    label_ids = np.zeros(num_verts, np.uint32)
    for label, segs in label_to_segs.items():
        label_id = raw_to_nyu40.get(label, 0)
        for s in segs:
            label_ids[seg_to_verts.get(int(s), np.array([], np.int64))] = label_id
    export_ids(output_file, label_ids)
    return label_ids


def read_label_mapping_tsv(path: str, label_from="raw_category", label_to="nyu40id") -> Dict[str, int]:
    """scannetv2-labels.combined.tsv -> {raw label: nyu40 id}."""
    mapping = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        i_from, i_to = header.index(label_from), header.index(label_to)
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) > max(i_from, i_to) and cols[i_to]:
                mapping[cols[i_from]] = int(cols[i_to])
    return mapping


def update_confusion_nyu40(
    confusion: np.ndarray, gt_ids: np.ndarray, pred_ids: np.ndarray
) -> None:
    """Per-scene confusion update: gt ids outside the
    valid set are ignored; invalid predictions count as UNKNOWN_ID."""
    valid_gt = np.isin(gt_ids, VALID_CLASS_IDS)
    gt = gt_ids[valid_gt]
    pred = pred_ids[valid_gt].copy()
    pred[~np.isin(pred, VALID_CLASS_IDS)] = UNKNOWN_ID
    np.add.at(confusion, (gt, pred), 1)


def get_iou(label_id: int, confusion: np.ndarray):
    """(iou, tp, denom) for one NYU40 id."""
    tp = np.longlong(confusion[label_id, label_id])
    fn = np.longlong(confusion[label_id, :].sum()) - tp
    not_ignored = [l for l in VALID_CLASS_IDS if l != label_id]
    fp = np.longlong(confusion[not_ignored, label_id].sum())
    denom = tp + fp + fn
    if denom == 0:
        return float("nan"), tp, denom
    return float(tp) / denom, tp, denom


def evaluate(
    pred_files: Sequence[str], gt_files: Sequence[str],
    output_file: Optional[str] = None,
) -> Dict[str, float]:
    """Offline evaluator over exported txt files.

    Returns {'mean_iou': ..., per-class ious by name} and optionally writes the
    results file with per-class IoU + the confusion matrix.
    """
    confusion = np.zeros((UNKNOWN_ID + 1, UNKNOWN_ID + 1), np.uint64)
    for pred_file, gt_file in zip(pred_files, gt_files):
        pred_ids = load_ids(pred_file)
        gt_ids = load_ids(gt_file)
        if pred_ids.shape != gt_ids.shape:
            raise ValueError(
                f"{pred_file}: prediction count != vertex count"
            )
        update_confusion_nyu40(confusion, gt_ids, pred_ids)

    class_ious = {}
    for i, name in enumerate(CLASS_LABELS):
        class_ious[name] = get_iou(int(VALID_CLASS_IDS[i]), confusion)
    valid = [v[0] for v in class_ious.values() if not np.isnan(v[0])]
    mean_iou = float(np.mean(valid)) if valid else float("nan")

    if output_file:
        with open(output_file, "w") as f:
            f.write("iou scores\n")
            for i, name in enumerate(CLASS_LABELS):
                iou, tp, denom = class_ious[name]
                f.write(
                    "{0:<14s}({1:<2d}): {2:>5.3f}   ({3:>6d}/{4:<6d})\n".format(
                        name, int(VALID_CLASS_IDS[i]), iou, int(tp), int(denom)
                    )
                )
            f.write(f"\nmean iou: {mean_iou:.4f}\n\nconfusion matrix:\n")
            np.savetxt(f, confusion, fmt="%d")

    out = {name: v[0] for name, v in class_ious.items()}
    out["mean_iou"] = mean_iou
    return out
