"""PointNet v1 joint part-segmentation trainer (ShapeNet h5 shards): the
counterpart of the JAX package's ``train/v1_partseg_trainer.py`` (the
upstream ``pointnet1/part_seg/train.py``).

The joint classification + segmentation ``PointNetPartSegJoint`` trains on
h5 shard lists with the loss

    total = seg_weight * seg_loss + (1 - seg_weight) * label_loss + 1e-3 * ortho

and ``seg_weight`` 1.0 (the reference trains segmentation alone), Adam at an
exponential LR (base 1e-3, x0.5 every 16881 * 20 samples, floor 1e-5) and
the BN decay over twice that step.  Every epoch validates the label and
per-point part accuracy, keeps the best-part-accuracy checkpoint and logs to
``{log_dir}/v1_part_seg_metrics.jsonl``.  Run it as ``python -m
pointcloud_segmentation_attention_tpu_torch.train.v1_partseg_trainer
--device cuda|cpu --train_list ... --val_list ...``.
``n_devices`` > 1 trains data-parallel as ``trainer.train`` does
(spawned ranks, or the ranks of a process group; global BN statistics,
loss, gradients and metrics; every rank evaluates, rank 0 writes).
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.shapenet_part import (
    ShapeNetPartH5Dataset,
)
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import (
    data_parallel,
    enter_world,
    reduce_metrics,
)
from pointcloud_segmentation_attention_tpu_torch.models.pointnet1 import orthogonality_loss
from pointcloud_segmentation_attention_tpu_torch.train import losses, schedules
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import BestKeeper
from pointcloud_segmentation_attention_tpu_torch.train.steps import (
    _device_of,
    _dropout_generator,
    _to_device,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger, NoLogger

V1_PARTSEG_DECAY_STEP = 16881 * 20  # the upstream train.py's DECAY_STEP


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def joint_train_step(state: TrainState, batch: Dict, dropout_seed: int = 0, *,
                     bn_schedule: Callable[[int], float], seg_weight: float = 1.0,
                     reg_weight: float = 1e-3, cat_num: int = 16):
    """One step of the joint loss; ``batch``: 'points' (B,N,3), 'cls' (B,),
    'labels' (B,N).  Updates ``state`` in place; returns ``(state,
    metrics)`` with device scalars 'loss', 'ortho_loss', 'label_accuracy'
    and 'seg_accuracy'."""
    model = state.model
    dev = _device_of(model)
    batch = _to_device(batch, dev)
    bn_momentum = bn_schedule(state.step)
    generator = _dropout_generator(dev, dropout_seed, state.step)
    onehot = F.one_hot(batch["cls"].long(), cat_num).float()
    model.train()
    model.zero_grad(set_to_none=True)
    cls_logits, seg_logits, end_points = model(batch["points"], onehot,
                                               bn_momentum=bn_momentum, generator=generator)
    label_loss = losses.mean_softmax_cross_entropy(cls_logits, batch["cls"])
    seg_loss = losses.mean_softmax_cross_entropy(seg_logits, batch["labels"])
    ortho = orthogonality_loss(end_points["transform"].float())
    loss = seg_weight * seg_loss + (1.0 - seg_weight) * label_loss + reg_weight * ortho
    loss.backward()
    state.apply_gradients()
    out = reduce_metrics({"loss": loss, "ortho_loss": ortho,
                          "label_accuracy": _accuracy(cls_logits.detach(), batch["cls"]),
                          "seg_accuracy": _accuracy(seg_logits.detach(), batch["labels"])},
                         means=("label_accuracy", "seg_accuracy"))
    return state, {k: v.detach() for k, v in out.items()}


def joint_eval_step(state: TrainState, batch: Dict, *, cat_num: int = 16
                    ) -> Dict[str, torch.Tensor]:
    """Eval forward: device scalars 'label_accuracy' and 'seg_accuracy'; the
    model's train/eval mode is restored afterwards."""
    model = state.model
    batch = _to_device(batch, _device_of(model))
    onehot = F.one_hot(batch["cls"].long(), cat_num).float()
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            cls_logits, seg_logits, _ = model(batch["points"], onehot)
    finally:
        model.train(was_training)
    return {"label_accuracy": _accuracy(cls_logits, batch["cls"]),
            "seg_accuracy": _accuracy(seg_logits, batch["labels"])}


def train_v1_part_segmentation(
    train_list: str,
    val_list: str,
    cat_num: int = 16,
    part_num: int = 50,
    npoints: int = 2048,
    batch_size: int = 32,
    epochs: int = 200,
    base_lr: float = 1e-3,
    seg_weight: float = 1.0,
    reg_weight: float = 1e-3,
    log_dir: str = "logs/v1_part_seg",
    n_devices: Optional[int] = None,
    seed: int = 0,
    max_steps: Optional[int] = None,
    *,
    device="cuda",
) -> dict:
    """Returns a summary dict with the best validation part accuracy
    (``best_seg_accuracy``), the last step's ``last_ortho_loss`` and the
    step count."""
    world = enter_world(train_v1_part_segmentation, n_devices, batch_size, device, dict(locals()))
    if world.summary is not None:
        return world.summary
    mesh, writer = world.mesh, world.writer  # only rank 0 writes logs and checkpoints
    train_ds = ShapeNetPartH5Dataset(train_list, batch_size, npoints, shuffle=True, seed=seed)
    val_ds = ShapeNetPartH5Dataset(val_list, batch_size, npoints, shuffle=False, seed=seed)
    # The JAX trainer reads one batch to initialise its model; the same read
    # here keeps the dataset's random stream, and so the batches, equal.
    next(train_ds.batches())
    model = models.get_model("pointnet1_part_seg", device=world.device, cat_num=cat_num,
                             part_num=part_num, generator=torch.Generator().manual_seed(seed))
    state = TrainState(model, lambda step: schedules.upstream_learning_rate(
        step, base_lr, batch_size, V1_PARTSEG_DECAY_STEP, decay_rate=0.5))
    bn = lambda step: schedules.upstream_bn_momentum(  # noqa: E731
        step, batch_size, 2.0 * V1_PARTSEG_DECAY_STEP)
    logger = MetricLogger(log_dir, "v1_part_seg") if writer else NoLogger()
    best = BestKeeper(os.path.join(log_dir, "checkpoints"), write=writer)

    train_step = data_parallel(joint_train_step, mesh)
    steps = 0
    summary = {}
    for _ in range(epochs):
        epoch_metrics = []
        for pts, cls, seg in train_ds.batches():
            state, m = train_step(state, {"points": pts, "cls": cls, "labels": seg},
                                  seed, bn_schedule=bn, seg_weight=seg_weight,
                                  reg_weight=reg_weight, cat_num=cat_num)
            epoch_metrics.append(m)  # device scalars, fetched at the epoch's end
            steps += 1
            if max_steps and steps >= max_steps:
                break
        if epoch_metrics:
            fetched = [{k: float(v) for k, v in m.items()} for m in epoch_metrics]
            logger.log(steps, {"train_" + k: float(np.mean([m[k] for m in fetched]))
                               for k in fetched[0]})
            summary["last_ortho_loss"] = fetched[-1]["ortho_loss"]
        vals = [joint_eval_step(state, {"points": pts, "cls": cls, "labels": seg},
                                cat_num=cat_num) for pts, cls, seg in val_ds.batches()]
        if vals:
            seg_acc = float(np.mean([float(m["seg_accuracy"]) for m in vals]))
            logger.log(steps, {"val_seg_accuracy": seg_acc, "val_label_accuracy": float(
                np.mean([float(m["label_accuracy"]) for m in vals]))})
            if best.maybe_save(state, steps, seg_acc):
                summary["best_seg_accuracy"] = seg_acc
        if max_steps and steps >= max_steps:
            break
    logger.close()
    summary.setdefault("best_seg_accuracy", best.best)
    summary["steps"] = steps
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--train_list", required=True)
    p.add_argument("--val_list", required=True)
    p.add_argument("--point_num", type=int, default=2048)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--output_dir", default="logs/v1_part_seg")
    p.add_argument("--max_steps", type=int, default=None)
    args = p.parse_args(argv)
    summary = train_v1_part_segmentation(
        args.train_list, args.val_list, npoints=args.point_num, batch_size=args.batch,
        epochs=args.epoch, log_dir=args.output_dir, max_steps=args.max_steps,
        device=args.device)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
