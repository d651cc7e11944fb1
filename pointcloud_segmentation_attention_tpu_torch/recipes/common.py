"""What the port's recipes share: restoring a trained state for the offline
eval, and the stitched offline mIoU of the val scenes served through
``ResidentSceneServer`` (one upload and one label fetch a scene)."""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import CONTEXT_MARGIN
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import load_scene
from pointcloud_segmentation_attention_tpu_torch.eval import benchmark
from pointcloud_segmentation_attention_tpu_torch.eval.resident_serving import (
    ResidentSceneServer,
)
from pointcloud_segmentation_attention_tpu_torch.train import trainer
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import (
    latest_checkpoint,
    restore_checkpoint,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig


def refuse_devices(n_devices: Optional[int]) -> None:
    """Recipes train on one device, as the trainer does."""
    if n_devices not in (None, 1):
        raise NotImplementedError(
            f"n_devices={n_devices}: training on more than one device is not ported yet "
            "(ROADMAP Queue 1 item 7)")


def restore_state(config: TrainConfig, device, first: str = "best",
                  then: str = "ckpt") -> Tuple[TrainState, Optional[str]]:
    """``(state, path)``: ``make_eval_state`` filled from the newest
    ``first`` checkpoint, else the newest ``then`` one; left as made, with
    path None, when the run saved none."""
    state = trainer.make_eval_state(config, device=device)
    ckpt = (latest_checkpoint(config.ckpt_dir, prefix=first)
            or latest_checkpoint(config.ckpt_dir, prefix=then))
    if ckpt is not None:
        restore_checkpoint(ckpt, state)
    return state, ckpt


def stitched_miou(state: TrainState, data_root: str, val_scenes: Sequence[str], pred_dir: str,
                  gt_dir: str, *, n_points: int, batch_size: int, device, layout: str = "q16",
                  use_colors: bool = True, use_normals: bool = True,
                  margin: float = CONTEXT_MARGIN) -> float:
    """Serve every val scene, export its benchmark txt (and the ground
    truth, where ``gt_dir`` lacks it) and return ``benchmark.evaluate``'s
    mean IoU."""
    server = ResidentSceneServer(state.model, n_points, batch_size=batch_size, layout=layout,
                                 use_colors=use_colors, use_normals=use_normals,
                                 margin=margin, device=device)
    os.makedirs(pred_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    pred_files, gt_files = [], []
    for name in val_scenes:
        scene = load_scene(data_root, name)
        scene["scene_name"] = name
        path = os.path.join(pred_dir, f"{name}.txt")
        benchmark.export_benchmark_txt(path, server.predict_scene(scene))
        pred_files.append(path)
        gt_path = os.path.join(gt_dir, f"{name}.txt")
        if not os.path.exists(gt_path):
            benchmark.export_ids(gt_path, scene["labels"].astype(np.int64))
        gt_files.append(gt_path)
    return benchmark.evaluate(pred_files, gt_files)["mean_iou"]
