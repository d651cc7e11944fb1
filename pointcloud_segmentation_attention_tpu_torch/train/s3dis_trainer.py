"""S3DIS semantic-segmentation trainer and whole-room inference (PointNet
v1): the counterpart of the JAX package's ``train/s3dis_trainer.py`` (the
upstream ``pointnet1/sem_seg/{train.py, batch_inference.py,
eval_iou_accuracy.py}``).

``train_s3dis(train_rooms, test_rooms, ..., device=)`` trains the 13-class
``PointNetSemSeg`` on the rooms' 1 x 1 m blocks (9 normalised channels) with
Adam at the upstream learning-rate schedule and BN decay (decay step
300,000), evaluates the confusion-matrix mIoU over the test rooms' blocks
every epoch, keeps the best-mIoU checkpoint and logs to
``{log_dir}/s3dis_metrics.jsonl``.  Run it as ``python -m
pointcloud_segmentation_attention_tpu_torch.train.s3dis_trainer --device
cuda|cpu --data_root DIR`` (one ``.npy`` (N, 7) room a file).
``n_devices`` > 1 trains data-parallel as ``trainer.train`` does
(spawned ranks, or the ranks of a process group; global BN statistics,
loss, gradients and metrics; every rank evaluates, rank 0 writes).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data import s3dis
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import (
    data_parallel,
    enter_world,
)
from pointcloud_segmentation_attention_tpu_torch.train import schedules
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import BestKeeper
from pointcloud_segmentation_attention_tpu_torch.train.cls_steps import (
    partseg_eval_step,
    partseg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.cls_trainer import (
    epoch_mean,
)
from pointcloud_segmentation_attention_tpu_torch.train.metrics import StreamingMeanIoU
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger, NoLogger

NUM_CLASSES = 13
DECAY_STEP = 300000


def rooms_to_block_dataset(rooms: Sequence[np.ndarray], num_point: int = 4096,
                           seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """All rooms' normalised blocks stacked, drawn from one
    ``RandomState(seed)`` in room order (the upstream ``gen_indoor3d_h5``)."""
    rng = np.random.RandomState(seed)
    datas, labels = [], []
    for room in rooms:
        d, lab = s3dis.room_to_blocks_normalized(room, num_point, rng=rng)
        if len(d):
            datas.append(d)
            labels.append(lab)
    return np.concatenate(datas), np.concatenate(labels)


def train_s3dis(
    train_rooms: Sequence[np.ndarray],
    test_rooms: Sequence[np.ndarray],
    num_point: int = 4096,
    batch_size: int = 24,
    epochs: int = 50,
    base_lr: float = 1e-3,
    log_dir: str = "logs/s3dis",
    n_devices: Optional[int] = None,
    seed: int = 0,
    max_steps: Optional[int] = None,
    *,
    device="cuda",
) -> dict:
    """Returns a summary dict with the best test mIoU (``best_miou``) and the
    step count.  Each epoch visits the blocks in a permutation of
    ``RandomState(seed)``'s stream, in whole batches."""
    world = enter_world(train_s3dis, n_devices, batch_size, device, dict(locals()))
    if world.summary is not None:
        return world.summary
    mesh, writer = world.mesh, world.writer  # only rank 0 writes logs and checkpoints
    data, labels = rooms_to_block_dataset(train_rooms, num_point, seed)
    model = models.get_model("pointnet1_sem_seg", device=world.device,
                             num_classes=NUM_CLASSES,
                             generator=torch.Generator().manual_seed(seed))
    state = TrainState(model, lambda step: schedules.upstream_learning_rate(
        step, base_lr, batch_size, decay_step=DECAY_STEP))
    bn = lambda step: schedules.upstream_bn_momentum(step, batch_size, DECAY_STEP)  # noqa: E731
    logger = MetricLogger(log_dir, "s3dis") if writer else NoLogger()
    best = BestKeeper(os.path.join(log_dir, "checkpoints"), write=writer)
    order_rng = np.random.RandomState(seed)

    train_step = data_parallel(partseg_train_step, mesh)
    steps = 0
    summary = {}
    n = len(data)
    for _ in range(epochs):
        order = order_rng.permutation(n)
        losses = []
        for start in range(0, n - batch_size + 1, batch_size):
            sel = order[start:start + batch_size]
            state, m = train_step(state, {"points": data[sel], "labels": labels[sel]},
                                  seed, bn_schedule=bn)
            losses.append(m["loss"])  # device scalars, fetched at the epoch's end
            steps += 1
            if max_steps and steps >= max_steps:
                break
        miou, acc = evaluate_rooms(state, test_rooms, num_point, batch_size)
        logger.log(steps, {"train_loss": epoch_mean(losses), "eval_miou": miou,
                           "eval_accuracy": acc})
        if best.maybe_save(state, steps, miou):
            summary["best_miou"] = miou
        if max_steps and steps >= max_steps:
            break
    logger.close()
    summary.setdefault("best_miou", best.best)
    summary["steps"] = steps
    return summary


def predict_room(state: TrainState, room: np.ndarray, num_point: int,
                 batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-room block inference (the upstream ``batch_inference.py``):
    the room's blocks (drawn from ``RandomState(0)``) in batches of
    ``batch_size``; returns (block logits (K,N,13), block labels (K,N))."""
    data, labels = s3dis.room_to_blocks_normalized(room, num_point,
                                                   rng=np.random.RandomState(0))
    logits = [partseg_eval_step(state, {"points": data[start:start + batch_size]})["logits"]
              .cpu().numpy() for start in range(0, len(data), batch_size)]
    return np.concatenate(logits), labels


def evaluate_rooms(state: TrainState, rooms, num_point: int, batch_size: int):
    """The 13-class mIoU and the point accuracy accumulated over the rooms'
    blocks (the upstream ``eval_iou_accuracy.py``)."""
    miou = StreamingMeanIoU(NUM_CLASSES)
    correct = total = 0
    for room in rooms:
        logits, labels = predict_room(state, room, num_point, batch_size)
        preds = np.argmax(logits, axis=-1)
        miou.update(labels, preds)
        correct += (preds == labels).sum()
        total += labels.size
    mean_iou, _ = miou.result()
    return mean_iou, correct / max(total, 1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--data_root", required=True,
                   help="a directory of one (N, 7) .npy array a room (s3dis.collect_room)")
    p.add_argument("--test_area", default="Area_6")
    p.add_argument("--num_point", type=int, default=4096)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--max_epoch", type=int, default=50)
    p.add_argument("--log_dir", default="logs/s3dis")
    p.add_argument("--max_steps", type=int, default=None)
    args = p.parse_args(argv)
    train_rooms, test_rooms = [], []
    for fn in sorted(os.listdir(args.data_root)):
        if fn.endswith(".npy"):
            room = np.load(os.path.join(args.data_root, fn))
            (test_rooms if args.test_area in fn else train_rooms).append(room)
    summary = train_s3dis(train_rooms, test_rooms, args.num_point, args.batch_size,
                          args.max_epoch, log_dir=args.log_dir, max_steps=args.max_steps,
                          device=args.device)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
