"""Step functions of the port: one training step, one eval step and the
eval-mode prediction for serving; the counterparts of the JAX package's
``train/steps.py``.

A training step is forward in train mode (batch statistics, the BN EMA
decay from ``bn_schedule`` at the pre-increment step), the weighted cross
entropy, backward (through the gather and interpolation kernels on the
card), one Adam update, and the confusion matrix, accuracy and LR of the
batch.  Batches are dicts of numpy arrays or tensors, in the f32 or compact
wire format of ``data.pipeline.make_batch``; they are copied to the model's
device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.train import losses, metrics, schedules
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState

# ScanNet class weights 1/log(1.2 + freq), class 0 = 0.
SCANNET_CLASS_WEIGHTS = (
    0.0, 2.743064592944318, 3.0830506790927132, 4.785754459526457,
    4.9963745147506184, 4.372710774561782, 5.039124880965811, 4.86451825464344,
    4.717751595568025, 4.809412839311939, 5.052097251455304, 5.389129668645318,
    5.390614085649042, 5.127458225110977, 5.086056870814752, 5.3831185190895265,
    5.422684124268539, 5.422955391988761, 5.433705358072363, 5.417426773812747,
    4.870172044153657,
)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        out[k] = t.to(device)
    return out


def make_sample_weights(labels: torch.Tensor, inner_mask: torch.Tensor) -> torch.Tensor:
    """weight = SCANNET_CLASS_WEIGHTS[label] * mask."""
    cw = torch.tensor(SCANNET_CLASS_WEIGHTS, dtype=torch.float32, device=labels.device)
    return cw[labels.long()] * inner_mask.float()


def expand_wire_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Compact-wire batch -> standard batch on its device: int32 labels, f32
    features (colors / 255, then normals) and ``class_weight[label] * mask``
    weights.  A standard batch passes through; a packed one raises."""
    if any(k.startswith("packed") for k in batch):
        raise NotImplementedError(
            "the packed single-buffer wire (data/wire.py) is not ported yet "
            "(ROADMAP Queue 1 item 3)")
    if "mask" not in batch:
        return batch
    labels = batch["labels"].to(torch.int32)
    out = {"points": batch["points"], "labels": labels,
           "weights": make_sample_weights(labels, batch["mask"] != 0)}
    parts = []
    if "colors_u8" in batch:
        parts.append(batch["colors_u8"].float() / 255.0)
    if "normals_f16" in batch:
        parts.append(batch["normals_f16"].float())
    if parts:
        out["features"] = torch.cat(parts, dim=-1)
    return out


def _dropout_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The dropout stream of one step, seeded from (seed, step) as the JAX
    step folds the step into its key.  Its numbers are not JAX's."""
    mixed = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _batch_metrics(logits: torch.Tensor, labels: torch.Tensor, num_classes: int):
    """(predictions (B,N) int32, {'accuracy', 'confusion'}) over label > 0."""
    preds = logits.argmax(dim=-1).to(torch.int32)
    valid = labels > 0
    confusion = metrics.update_confusion(
        torch.zeros((num_classes, num_classes), dtype=torch.float32, device=logits.device),
        labels, preds, valid)
    return preds, {"accuracy": metrics.accuracy(labels, preds, valid), "confusion": confusion}


def seg_train_step(
    state: TrainState,
    batch: Dict,
    dropout_seed: int = 0,
    *,
    bn_schedule: Callable[[int], float] = schedules.scannet_bn_momentum,
    num_classes: int = 21,
    remat: str = "none",
):
    """One training step on a segmentation batch; updates ``state`` in place
    and returns ``(state, metrics)``.

    ``batch``: 'points' (B,N,3) f32, 'labels' (B,N) int, 'weights' (B,N) f32
    (class weight x mask) and optional 'features' (B,N,K), or the compact
    wire format.  ``metrics`` holds device tensors 'loss', 'accuracy' and
    'confusion' (C, C) and the float 'learning_rate'; no host sync is made.
    After the step each parameter's ``.grad`` holds this step's gradient.
    """
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r}: activation rematerialisation is not ported yet")
    model = state.model
    dev = _device_of(model)
    batch = expand_wire_batch(_to_device(batch, dev))
    bn_momentum = bn_schedule(state.step)
    generator = _dropout_generator(dev, dropout_seed, state.step)
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(batch["points"], batch.get("features"), bn_momentum=bn_momentum,
                   generator=generator)
    loss = losses.weighted_softmax_cross_entropy(logits, batch["labels"], batch["weights"])
    loss.backward()
    lr = state.apply_gradients()
    _, out = _batch_metrics(logits.detach(), batch["labels"], num_classes)
    out.update(loss=loss.detach(), learning_rate=lr)
    return state, out


def seg_eval_step(state: TrainState, batch: Dict, *,
                  num_classes: int = 21) -> Dict[str, torch.Tensor]:
    """Eval forward (running BN statistics, no dropout): 'loss', 'accuracy',
    'confusion' and 'predictions' (B,N) int32, as device tensors.  The
    model's train/eval mode is restored afterwards."""
    model = state.model
    batch = expand_wire_batch(_to_device(batch, _device_of(model)))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            logits = model(batch["points"], batch.get("features"))
    finally:
        model.train(was_training)
    preds, out = _batch_metrics(logits, batch["labels"], num_classes)
    out.update(predictions=preds, loss=losses.weighted_softmax_cross_entropy(
        logits, batch["labels"], batch["weights"]))
    return out


def seg_predict_step(model: nn.Module, points: torch.Tensor,
                     features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode logits (B, N, num_classes), running BN statistics, no
    dropout; the model's train/eval mode is restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            return model(points, features)
    finally:
        model.train(was_training)
