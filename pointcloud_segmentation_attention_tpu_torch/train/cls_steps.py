"""Train and eval steps for classification and part segmentation: the
counterparts of the JAX package's ``train/cls_steps.py``.

A training step is the flagship's (``train/steps.py``): the train-mode
forward with the BN EMA decay of ``bn_schedule`` at the pre-increment step
and a dropout generator seeded from (seed, step), the mean cross entropy,
backward (through the gather and interpolation kernels on the card), and
one Adam update at ``state``'s schedule (the trainers pass the upstream
``upstream_learning_rate`` / ``upstream_bn_momentum``).  With
``reg_weight``, a model whose output is ``(logits, end_points)`` with a
T-Net ``transform`` (``pointnet1_cls``, ``pointnet1_seg``) adds
``reg_weight`` times the orthogonality loss.  A classifier fed xyz alone is
called with ``(xyz,)``, as the JAX package calls it.  Batches are dicts of
numpy arrays or tensors, copied to the model's device.  Inside a
data-parallel step (``parallel.data_parallel``) the loss, accuracy and
orthogonality loss are the global batch's (``parallel.mesh.reduce_metrics``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from pointcloud_segmentation_attention_tpu_torch.models.pointnet1 import orthogonality_loss
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import reduce_metrics
from pointcloud_segmentation_attention_tpu_torch.train import losses, schedules
from pointcloud_segmentation_attention_tpu_torch.train.steps import (
    _device_of,
    _dropout_generator,
    _to_device,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState


def _cls_args(points: torch.Tensor):
    """(B,N,3[+k]) -> the classifier's arguments: (xyz, features), or
    (xyz,) for points without features."""
    if points.shape[-1] > 3:
        return points[..., :3], points[..., 3:]
    return (points,)


def _train_step(state: TrainState, args, labels: torch.Tensor, dropout_seed: int,
                bn_schedule: Callable[[int], float], reg_weight: float):
    model = state.model
    dev = _device_of(model)
    bn_momentum = bn_schedule(state.step)
    generator = _dropout_generator(dev, dropout_seed, state.step)
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(*args, bn_momentum=bn_momentum, generator=generator)
    logits, end_points = out if isinstance(out, tuple) else (out, {})
    loss = losses.mean_softmax_cross_entropy(logits, labels)
    ortho = torch.zeros((), dtype=torch.float32, device=dev)
    if reg_weight and "transform" in end_points:
        ortho = orthogonality_loss(end_points["transform"].float())
        loss = loss + reg_weight * ortho
    loss.backward()
    lr = state.apply_gradients()
    preds = logits.detach().argmax(dim=-1)
    acc = (preds == labels).float().mean()
    out = reduce_metrics({"loss": loss, "accuracy": acc, "ortho_loss": ortho},
                         means=("accuracy",))
    return state, {**{k: v.detach() for k, v in out.items()}, "learning_rate": lr}


def cls_train_step(state: TrainState, batch: Dict, dropout_seed: int = 0, *,
                   bn_schedule: Callable[[int], float] = schedules.upstream_bn_momentum,
                   reg_weight: float = 0.0):
    """One classification step (mean CE); ``batch``: 'points' (B,N,3[+k]),
    'labels' (B,).  Updates ``state`` in place; returns ``(state, metrics)``
    with device tensors 'loss', 'accuracy', 'ortho_loss' and the float
    'learning_rate'."""
    batch = _to_device(batch, _device_of(state.model))
    return _train_step(state, _cls_args(batch["points"]), batch["labels"],
                       dropout_seed, bn_schedule, reg_weight)


def cls_eval_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
    """Eval forward: 'logits', 'predictions' and 'accuracy' as device tensors."""
    model = state.model
    batch = _to_device(batch, _device_of(model))
    logits = _eval_logits(model, _cls_args(batch["points"]))
    preds = logits.argmax(dim=-1)
    return {"logits": logits, "predictions": preds,
            "accuracy": (preds == batch["labels"]).float().mean()}


def partseg_train_step(state: TrainState, batch: Dict, dropout_seed: int = 0, *,
                       bn_schedule: Callable[[int], float] = schedules.upstream_bn_momentum,
                       reg_weight: float = 0.0):
    """One part-segmentation step (mean CE over all points); ``batch``:
    'points' (B,N,6), 'labels' (B,N) and, for the one-hot model, 'cls' (B,).
    Returns ``(state, metrics)`` as ``cls_train_step``."""
    batch = _to_device(batch, _device_of(state.model))
    return _train_step(state, _partseg_args(batch), batch["labels"], dropout_seed,
                       bn_schedule, reg_weight)


def partseg_eval_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
    """Eval forward: 'logits' (B,N,parts) and 'predictions' (B,N)."""
    model = state.model
    batch = _to_device(batch, _device_of(model))
    logits = _eval_logits(model, _partseg_args(batch))
    return {"logits": logits, "predictions": logits.argmax(dim=-1)}


def _partseg_args(batch: Dict[str, torch.Tensor]):
    return (batch["points"], batch["cls"]) if "cls" in batch else (batch["points"],)


def _eval_logits(model, args) -> torch.Tensor:
    """Eval-mode logits (running BN statistics, no dropout); the model's
    train/eval mode is restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = model(*args)
    finally:
        model.train(was_training)
    return out[0] if isinstance(out, tuple) else out
