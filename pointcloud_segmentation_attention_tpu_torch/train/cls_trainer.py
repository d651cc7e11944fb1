"""ModelNet classification trainer with voting evaluation: the counterpart of
the JAX package's ``train/cls_trainer.py`` (the upstream
``pointnet2_tensorflow/train.py`` and ``evaluate.py``).

``train_classification(data_root, ..., device=)`` trains a registry
classifier on augmented batches of ``ModelNetDataset`` (txt layout) or
``ModelNetH5Dataset`` (h5 shards), with Adam at the upstream learning-rate
schedule and BN decay, evaluates every epoch with multi-angle voting on the
test split, keeps the best-accuracy checkpoint and logs to
``{log_dir}/cls_metrics.jsonl``.  Run it as ``python -m
pointcloud_segmentation_attention_tpu_torch.train.cls_trainer --device
cuda|cpu --data_root ...``.  ``n_devices`` > 1 trains data-parallel as ``trainer.train`` does
(spawned ranks, or the ranks of a process group; global BN statistics,
loss, gradients and metrics; every rank evaluates, rank 0 writes).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.modelnet import (
    ModelNetDataset,
    ModelNetH5Dataset,
)
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import (
    data_parallel,
    enter_world,
)
from pointcloud_segmentation_attention_tpu_torch.eval.voting import evaluate_classification
from pointcloud_segmentation_attention_tpu_torch.train import schedules
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import BestKeeper
from pointcloud_segmentation_attention_tpu_torch.train.cls_steps import (
    cls_eval_step,
    cls_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger, NoLogger


def epoch_mean(values) -> float:
    """The mean of a list of device scalars, fetched once."""
    return float(torch.stack(values).mean()) if values else 0.0


def train_classification(
    data_root: str,
    model_name: str = "cls_ssg",
    h5_list: Optional[str] = None,
    h5_test_list: Optional[str] = None,
    num_classes: int = 40,
    npoints: int = 1024,
    batch_size: int = 16,
    epochs: int = 251,
    base_lr: float = 1e-3,
    decay_step: float = 200000,
    normal_channel: bool = False,
    log_dir: str = "logs/cls",
    num_votes: int = 1,
    n_devices: Optional[int] = None,
    seed: int = 0,
    max_steps: Optional[int] = None,
    reg_weight: Optional[float] = None,
    *,
    device="cuda",
):
    """Returns a summary dict with the best voting accuracy
    (``best_accuracy``) and the step count.  ``reg_weight`` scales a T-Net
    orthogonality loss (``None``: 0.001 for ``pointnet1_cls``, else 0); the
    classifier's input channels follow the data (3, or 6 with normals)."""
    world = enter_world(train_classification, n_devices, batch_size, device, dict(locals()))
    if world.summary is not None:
        return world.summary
    mesh, writer = world.mesh, world.writer  # only rank 0 writes logs and checkpoints
    if reg_weight is None:
        reg_weight = 0.001 if model_name == "pointnet1_cls" else 0.0
    if h5_list:
        if h5_test_list is None:
            raise ValueError(
                "h5_test_list is required with h5_list: evaluating on the train shards "
                "would inflate accuracy and the best-checkpoint choice")
        train_ds = ModelNetH5Dataset(h5_list, batch_size, npoints, shuffle=True)
        test_ds = ModelNetH5Dataset(h5_test_list, batch_size, npoints, shuffle=False)
    else:
        train_ds = ModelNetDataset(data_root, batch_size, npoints, "train",
                                   normal_channel=normal_channel, seed=seed)
        test_ds = ModelNetDataset(data_root, batch_size, npoints, "test",
                                  normal_channel=normal_channel, seed=seed)

    # The JAX trainer reads one batch to initialise its model; the same read
    # here keeps the datasets' random streams, and so the batches, equal.
    train_ds.next_batch()
    train_ds.reset()
    dev = world.device
    model = models.get_model(model_name, device=dev, num_classes=num_classes,
                             in_features=train_ds.num_channel() - 3,
                             generator=torch.Generator().manual_seed(seed))
    state = TrainState(model, lambda step: schedules.upstream_learning_rate(
        step, base_lr, batch_size, decay_step))
    bn = lambda step: schedules.upstream_bn_momentum(step, batch_size, decay_step)  # noqa: E731
    logger = MetricLogger(log_dir, "cls") if writer else NoLogger()
    best = BestKeeper(os.path.join(log_dir, "checkpoints"), write=writer)

    def predict_fn(points_np: np.ndarray) -> np.ndarray:
        batch = {"points": points_np, "labels": np.zeros(len(points_np), np.int32)}
        return cls_eval_step(state, batch)["logits"].cpu().numpy()

    train_step = data_parallel(cls_train_step, mesh)
    steps = 0
    summary = {}
    for _ in range(epochs):
        train_ds.reset()
        losses, accs, orthos = [], [], []
        while train_ds.has_next_batch():
            pts, labels, _ = train_ds.next_batch(augment_data=True)
            state, m = train_step(state, {"points": pts, "labels": labels}, seed,
                                  bn_schedule=bn, reg_weight=reg_weight)
            losses.append(m["loss"])  # device scalars, fetched at the epoch's end
            accs.append(m["accuracy"])
            orthos.append(m["ortho_loss"])
            steps += 1
            if max_steps and steps >= max_steps:
                break
        logger.log(steps, {"train_loss": epoch_mean(losses),
                           "train_accuracy": epoch_mean(accs),
                           "train_ortho_loss": epoch_mean(orthos)})
        if orthos:
            summary["last_ortho_loss"] = float(orthos[-1])
        test_ds.reset()
        batches = []
        while test_ds.has_next_batch():
            pts, labels, bsize = test_ds.next_batch()
            batches.append((pts[:bsize], labels[:bsize]))
        res = evaluate_classification(predict_fn, batches, num_votes=num_votes,
                                      num_classes=num_classes, with_normals=normal_channel)
        logger.log(steps, {"eval_accuracy": res["accuracy"],
                           "eval_avg_class_accuracy": res["avg_class_accuracy"]})
        if best.maybe_save(state, steps, res["accuracy"]):
            summary["best_accuracy"] = res["accuracy"]
        if max_steps and steps >= max_steps:
            break
    logger.close()
    summary.setdefault("best_accuracy", best.best)
    summary["steps"] = steps
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--data_root", required=True)
    p.add_argument("--model", default="cls_ssg")
    p.add_argument("--h5_list", default=None)
    p.add_argument("--h5_test_list", default=None)
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_epoch", type=int, default=251)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--decay_step", type=float, default=200000)
    p.add_argument("--normal", action="store_true")
    p.add_argument("--log_dir", default="logs/cls")
    p.add_argument("--num_votes", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    args = p.parse_args(argv)
    summary = train_classification(
        args.data_root, args.model, args.h5_list, args.h5_test_list,
        npoints=args.num_point, batch_size=args.batch_size, epochs=args.max_epoch,
        base_lr=args.learning_rate, decay_step=args.decay_step,
        normal_channel=args.normal, log_dir=args.log_dir, num_votes=args.num_votes,
        max_steps=args.max_steps, device=args.device)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
