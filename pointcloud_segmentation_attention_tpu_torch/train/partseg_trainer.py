"""ShapeNet part-segmentation trainer: the counterpart of the JAX package's
``train/partseg_trainer.py`` (the upstream ``part_seg/train.py`` and
``train_one_hot.py``).

``train_part_segmentation(data_root, ..., device=)`` trains ``part_seg``,
``part_seg_msg_one_hot`` or ``pointnet1_seg`` (fed xyz alone, with the T-Net
orthogonality loss at 0.001) over ``PartNormalDataset`` ('trainval'), with Adam
at the upstream learning-rate schedule and BN decay, evaluates the per-shape
part IoU averaged per category on 'test' every epoch, keeps the best
class-average-IoU checkpoint and logs to
``{log_dir}/part_seg_metrics.jsonl``.  Run it as ``python -m
pointcloud_segmentation_attention_tpu_torch.train.partseg_trainer --device
cuda|cpu --data_root ...``.  ``n_devices`` > 1 trains data-parallel as ``trainer.train`` does
(spawned ranks, or the ranks of a process group; global BN statistics,
loss, gradients and metrics; every rank evaluates, rank 0 writes).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.shapenet_part import PartNormalDataset
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import (
    data_parallel,
    enter_world,
)
from pointcloud_segmentation_attention_tpu_torch.eval.part_iou import PartIoUAccumulator
from pointcloud_segmentation_attention_tpu_torch.train import schedules
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import BestKeeper
from pointcloud_segmentation_attention_tpu_torch.train.cls_steps import (
    partseg_eval_step,
    partseg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.cls_trainer import (
    epoch_mean,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger, NoLogger


def train_part_segmentation(
    data_root: str,
    model_name: str = "part_seg",  # or 'part_seg_msg_one_hot', 'pointnet1_seg'
    npoints: int = 2048,
    batch_size: int = 16,
    epochs: int = 201,
    base_lr: float = 1e-3,
    log_dir: str = "logs/part_seg",
    n_devices: Optional[int] = None,
    seed: int = 0,
    max_steps: Optional[int] = None,
    reg_weight: Optional[float] = None,
    *,
    device="cuda",
):
    """Returns a summary dict with the best class-average part IoU
    (``best_class_avg_iou``) and the step count.  ``reg_weight=None`` is
    0.001 for ``pointnet1_seg`` (a T-Net model), else 0."""
    world = enter_world(train_part_segmentation, n_devices, batch_size, device, dict(locals()))
    if world.summary is not None:
        return world.summary
    mesh, writer = world.mesh, world.writer  # only rank 0 writes logs and checkpoints
    one_hot = model_name == "part_seg_msg_one_hot"
    is_v1 = model_name == "pointnet1_seg"  # xyz alone; returns (logits, end_points)
    if reg_weight is None:
        reg_weight = 0.001 if is_v1 else 0.0
    train_ds = PartNormalDataset(data_root, npoints, split="trainval", seed=seed)
    test_ds = PartNormalDataset(data_root, npoints, split="test", seed=seed)
    # The JAX trainer reads one batch to initialise its model; the same read
    # here keeps the dataset's random stream, and so the batches, equal.
    next(train_ds.batches(batch_size, shuffle=False))
    model = models.get_model(model_name, device=world.device,
                             generator=torch.Generator().manual_seed(seed))
    state = TrainState(model, lambda step: schedules.upstream_learning_rate(
        step, base_lr, batch_size))
    bn = lambda step: schedules.upstream_bn_momentum(step, batch_size)  # noqa: E731
    logger = MetricLogger(log_dir, "part_seg") if writer else NoLogger()
    best = BestKeeper(os.path.join(log_dir, "checkpoints"), write=writer)
    cats = sorted(test_ds.classes, key=lambda c: test_ds.classes[c])

    def make(pts, seg, cls):
        batch = {"points": pts[..., :3] if is_v1 else pts, "labels": seg}
        if one_hot:
            batch["cls"] = cls
        return batch

    train_step = data_parallel(partseg_train_step, mesh)
    steps = 0
    summary = {}
    for _ in range(epochs):
        losses, orthos = [], []
        for pts, seg, cls, _ in train_ds.batches(batch_size):
            state, m = train_step(state, make(pts, seg, cls), seed, bn_schedule=bn,
                                  reg_weight=reg_weight)
            losses.append(m["loss"])  # device scalars, fetched at the epoch's end
            orthos.append(m["ortho_loss"])
            steps += 1
            if max_steps and steps >= max_steps:
                break
        if orthos:
            summary["last_ortho_loss"] = float(orthos[-1])
        acc = PartIoUAccumulator()
        for pts, seg, cls, bsize in test_ds.batches(batch_size, shuffle=False):
            logits = partseg_eval_step(state, make(pts, seg, cls))["logits"].cpu().numpy()
            for i in range(bsize):
                acc.add_shape(logits[i], seg[i], cats[cls[i]])
        res = acc.result()
        logger.log(steps, {"train_loss": epoch_mean(losses),
                           "eval_class_avg_iou": res["class_avg_iou"],
                           "eval_instance_avg_iou": res["instance_avg_iou"]})
        if best.maybe_save(state, steps, res["class_avg_iou"]):
            summary["best_class_avg_iou"] = res["class_avg_iou"]
        if max_steps and steps >= max_steps:
            break
    logger.close()
    summary.setdefault("best_class_avg_iou", best.best)
    summary["steps"] = steps
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--data_root", required=True)
    p.add_argument("--model", default="part_seg")
    p.add_argument("--num_point", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_epoch", type=int, default=201)
    p.add_argument("--log_dir", default="logs/part_seg")
    p.add_argument("--max_steps", type=int, default=None)
    args = p.parse_args(argv)
    summary = train_part_segmentation(
        args.data_root, args.model, npoints=args.num_point, batch_size=args.batch_size,
        epochs=args.max_epoch, log_dir=args.log_dir, max_steps=args.max_steps,
        device=args.device)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
