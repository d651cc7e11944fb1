"""Full-scene stitched prediction: the serving path of the port.

A scene is cut into full-coverage chunks (``scene_chunks``), the chunks run
through the model in fixed-size batches (``predict_scene_chunks``, the last
batch padded), the labels are argmaxed on the device and only they are
copied back (``make_predict_fn``), and the inverse shuffle (``map_back``)
restores vertex order.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.data.pipeline import assemble_features
from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import (
    full_scene_chunks,
    map_back,
)
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.train.steps import seg_predict_step


def scene_chunks(scene: Dict[str, np.ndarray], npoints: int = 8192,
                 seed: int = 0) -> Dict:
    """The chunk dict a serving request carries, as the JAX package's
    ``precompute.eval_scene_stream`` builds it for one scene: chunked
    points/labels/colors/normals, masks, orig_idx, num_vertices and the
    scene's own points."""
    labels = scene.get("labels")
    if labels is None:
        labels = np.zeros(len(scene["points"]), np.int32)
    cs = full_scene_chunks(scene["points"], [labels, scene["colors"], scene["normals"]],
                           npoints=npoints, rng=np.random.RandomState(seed))
    return {
        "points": cs.points,
        "labels": cs.features[0].astype(np.int32),
        "colors": cs.features[1],
        "normals": cs.features[2].astype(np.float32),
        "masks": cs.masks,
        "orig_idx": cs.orig_idx,
        "num_vertices": len(scene["points"]),
        "vertex_points": scene["points"],
    }


def make_predict_fn(model: nn.Module, device="cuda") -> Callable:
    """``(points (B,N,3), features (B,N,K)|None) -> (B,N) uint8 labels``.

    Inputs are copied to ``device``, the eval-mode forward and the argmax run
    there, and only the u8 labels come back."""
    dev = resolve(device)
    model.to(dev)

    def predict(points: np.ndarray, features: Optional[np.ndarray] = None) -> np.ndarray:
        pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(dev)
        fts = (torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
               if features is not None else None)
        logits = seg_predict_step(model, pts, fts)
        # u8 labels when the classes fit: 4x less device-to-host traffic.
        dtype = torch.uint8 if logits.shape[-1] <= 255 else torch.int32
        return logits.argmax(dim=-1).to(dtype).cpu().numpy()

    return predict


def predict_scene_chunks(
    predict_fn: Callable,
    scene: Dict[str, np.ndarray],
    use_colors: bool,
    use_normals: bool,
    batch_size: int = 16,
) -> np.ndarray:
    """Run ``predict_fn`` over all chunks of one scene (padding the last
    batch) and return per-vertex labels (num_vertices,) int32.
    ``predict_fn(points (B,N,3), features (B,N,K)|None)`` returns labels
    (B,N) or logits (B,N,C)."""
    points = scene["points"]
    feats = assemble_features(
        scene["colors"] if use_colors else None,
        scene["normals"] if use_normals else None,
        use_colors, use_normals,
    )
    preds = []
    for off in range(0, len(points), batch_size):
        pb = points[off:off + batch_size]
        fb = feats[off:off + batch_size] if feats is not None else None
        real = len(pb)
        pad = batch_size - real
        if pad:
            pb = np.concatenate([pb, np.repeat(pb[-1:], pad, axis=0)])
            if fb is not None:
                fb = np.concatenate([fb, np.repeat(fb[-1:], pad, axis=0)])
        out = np.asarray(predict_fn(pb, fb))
        lab = out if out.ndim == 2 else np.argmax(out, axis=-1)
        preds.append(lab[:real])
    chunk_preds = np.concatenate(preds).astype(np.int32)
    return map_back(chunk_preds, scene["orig_idx"], scene["masks"],
                    scene["num_vertices"], fill_value=0)
