"""Full-scene stitched prediction: the serving path of the port.

A scene is cut into full-coverage chunks (``precompute.eval_scene_item``),
the chunks run through the model in fixed-size batches
(``predict_scene_chunks``, the last batch padded), as f32 arrays or packed
wire rows, the labels are argmaxed on the device and only they are copied
back (``make_predict_fn``), and the inverse shuffle (``map_back``) restores
vertex order.  ``generate_predictions`` does this for the scenes of a store
and writes each scene's predictions and its ScanNet-benchmark txt.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.data.pipeline import assemble_features
from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute
from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import map_back
from pointcloud_segmentation_attention_tpu_torch.data.wire import pack_arrays
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.eval.benchmark import export_benchmark_txt
from pointcloud_segmentation_attention_tpu_torch.train.steps import (
    seg_predict_step,
    seg_predict_step_packed,
)


def scene_chunks(scene: Dict[str, np.ndarray], npoints: int = 8192, seed: int = 0) -> Dict:
    """The chunk dict of one in-memory scene (labels in [0, 20], or none),
    as ``precompute.eval_scene_stream`` yields it for a stored scene."""
    return precompute.eval_scene_item(scene, npoints=npoints, seed=seed)


def make_predict_fn(model: nn.Module, device="cuda", wire_spec=None) -> Callable:
    """``(points (B,N,3), features (B,N,K)|None) -> (B,N) uint8 labels``, or
    with ``wire_spec`` ``(packed rows (B, row_nbytes) u8) -> labels``.

    Inputs are copied to ``device``, the decode (packed rows), the eval-mode
    forward and the argmax run there, and only the u8 labels come back."""
    dev = resolve(device)
    model.to(dev)

    def labels_of(logits: torch.Tensor) -> np.ndarray:
        # u8 labels when the classes fit: 4x less device-to-host traffic.
        dtype = torch.uint8 if logits.shape[-1] <= 255 else torch.int32
        return logits.argmax(dim=-1).to(dtype).cpu().numpy()

    if wire_spec is not None:
        def predict_packed(rows: np.ndarray, _features=None) -> np.ndarray:
            return labels_of(seg_predict_step_packed(model, rows, wire_spec=wire_spec))

        return predict_packed

    def predict(points: np.ndarray, features: Optional[np.ndarray] = None) -> np.ndarray:
        pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(dev)
        fts = (torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
               if features is not None else None)
        return labels_of(seg_predict_step(model, pts, fts))

    return predict


def _padded(a: np.ndarray, batch_size: int) -> np.ndarray:
    pad = batch_size - len(a)
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad else a


def predict_scene_chunks(
    predict_fn: Callable,
    scene: Dict[str, np.ndarray],
    use_colors: bool,
    use_normals: bool,
    batch_size: int = 16,
    wire_spec=None,
) -> np.ndarray:
    """Run ``predict_fn`` over all chunks of one scene (the last batch
    padded with copies of its last chunk) and return per-vertex labels
    (num_vertices,) int32.  ``predict_fn(points (B,N,3), features
    (B,N,K)|None)`` returns labels (B,N) or logits (B,N,C); with
    ``wire_spec`` it takes packed rows instead (``make_predict_fn(...,
    wire_spec=spec)``), packed here with label 0 and mask 1."""
    points = scene["points"]
    if wire_spec is not None:
        rows = pack_arrays(points.astype(np.float32), np.zeros(points.shape[:2], np.uint8),
                           np.ones(points.shape[:2], np.uint8),
                           scene["colors"] if wire_spec.use_colors else None,
                           scene["normals"] if wire_spec.use_normals else None, wire_spec)

        def run(sl):
            return predict_fn(_padded(rows[sl], batch_size))
    else:
        feats = assemble_features(scene["colors"] if use_colors else None,
                                  scene["normals"] if use_normals else None,
                                  use_colors, use_normals)

        def run(sl):
            return predict_fn(_padded(points[sl], batch_size),
                              None if feats is None else _padded(feats[sl], batch_size))
    preds = []
    for off in range(0, len(points), batch_size):
        sl = slice(off, off + batch_size)
        out = np.asarray(run(sl))
        lab = out if out.ndim == 2 else np.argmax(out, axis=-1)
        preds.append(lab[: len(points[sl])])
    chunk_preds = np.concatenate(preds).astype(np.int32)
    return map_back(chunk_preds, scene["orig_idx"], scene["masks"], scene["num_vertices"],
                    fill_value=0)


def generate_predictions(
    predict_fn: Callable,
    data_root: str,
    scene_names: Sequence[str],
    output_dir: str,
    use_colors: bool = True,
    use_normals: bool = True,
    batch_size: int = 16,
    with_labels: bool = True,
    npoints: int = 8192,
    save_npy: bool = True,
    wire_spec=None,
) -> Iterator[Dict]:
    """Predict the stored scenes one by one; writes ``{name}.txt`` (the
    ScanNet benchmark's one NYU40 id per vertex) and, with ``save_npy``,
    ``{name}_points.npy``, ``{name}_labels.npy`` and ``{name}_gt.npy``
    (with labels).  Yields ``{'scene_name', 'predictions', 'labels'}``."""
    os.makedirs(output_dir, exist_ok=True)
    for scene in precompute.eval_scene_stream(data_root, scene_names, with_labels=with_labels,
                                              npoints=npoints):
        name = scene["scene_name"]
        vertex_pred = predict_scene_chunks(predict_fn, scene, use_colors, use_normals,
                                           batch_size, wire_spec=wire_spec)
        if save_npy:
            np.save(os.path.join(output_dir, f"{name}_points.npy"), scene["vertex_points"])
            np.save(os.path.join(output_dir, f"{name}_labels.npy"), vertex_pred)
            if with_labels:
                np.save(os.path.join(output_dir, f"{name}_gt.npy"), scene["vertex_labels"])
        export_benchmark_txt(os.path.join(output_dir, f"{name}.txt"), vertex_pred)
        yield {"scene_name": name, "predictions": vertex_pred,
               "labels": scene["vertex_labels"] if with_labels else None}
