"""Step functions of the port: one training step, one eval step and the
eval-mode predictions for serving; the counterparts of the JAX package's
``train/steps.py``.

A training step is forward in train mode (batch statistics, the BN EMA
decay from ``bn_schedule`` at the pre-increment step), the weighted cross
entropy, backward (through the gather and interpolation kernels on the
card), one Adam update, and the confusion matrix, accuracy and LR of the
batch.  Batches are dicts of numpy arrays or tensors, in the f32, compact
or packed wire format of ``data.pipeline.make_batch``; they are copied to
the model's device on the current stream and decoded there.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint

from pointcloud_segmentation_attention_tpu_torch.nn.layers import apply_bn_updates, bn_updates
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


@functools.lru_cache(maxsize=None)
def _class_weight_table(class_weights: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    # Made once per device: a table built from a Python list each call
    # would be a synchronous host-to-device copy in every step.
    return torch.tensor(class_weights, dtype=torch.float32, device=device)


def make_sample_weights(labels: torch.Tensor, inner_mask: torch.Tensor,
                        class_weights=None) -> torch.Tensor:
    """weight = class_weights[label] * mask, in float32; ``class_weights``
    defaults to ``SCANNET_CLASS_WEIGHTS``."""
    cw = _class_weight_table(tuple(float(w) for w in (
        SCANNET_CLASS_WEIGHTS if class_weights is None else class_weights)), labels.device)
    return cw[labels.long()] * inner_mask.float()


def expand_wire_batch(batch: Dict[str, torch.Tensor], wire_spec=None) -> Dict[str, torch.Tensor]:
    """Wire batch -> standard batch on its device: int32 labels, f32
    features (colors / 255, then normals) and ``class_weight[label] * mask``
    weights.  A packed batch ('packed', or the byte-column slices
    'packed0'.. joined in numeric order) is decoded by
    ``data.wire.unpack_batch`` with ``wire_spec``; a compact one is widened;
    a standard one passes through."""
    packed_keys = sorted((k for k in batch if k.startswith("packed")),
                         key=lambda k: int(k[6:] or 0))
    if packed_keys:
        from pointcloud_segmentation_attention_tpu_torch.data.wire import unpack_batch

        if wire_spec is None:
            raise ValueError("batch is in packed wire format but no wire_spec was passed "
                             "to the step")
        rows = (batch[packed_keys[0]] if len(packed_keys) == 1
                else torch.cat([batch[k] for k in packed_keys], dim=1))
        return unpack_batch(rows, wire_spec)
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


# The matmul outputs that ``remat='dots'`` keeps (``torch.matmul`` on (B, N,
# K, C) x (C, F) lowers to ``mm``; batched products to ``bmm``); JAX's
# ``jax.checkpoint_policies.dots_saveable``.  Every other op is recomputed.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _dots_saveable(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


@contextlib.contextmanager
def _restored(generator: torch.Generator, rng_state: torch.Tensor):
    """Rewind ``generator`` so that a recomputation draws the first
    forward's dropout masks."""
    generator.set_state(rng_state)
    yield


def _loss_and_logits(model: nn.Module, batch: Dict[str, torch.Tensor], bn_momentum: float,
                     generator: torch.Generator, remat: str):
    """Train-mode forward and weighted cross entropy, checkpointed per
    ``remat``.  Under ``'full'`` and ``'dots'`` the forward runs again in
    the backward; its BN updates are recorded in the first forward and
    applied by the caller once, and the recomputation skips them and
    rewinds the dropout generator, so the step equals ``'none'``'s."""

    def run(points, features):
        logits = model(points, features, bn_momentum=bn_momentum, generator=generator)
        loss = losses.weighted_softmax_cross_entropy(logits, batch["labels"], batch["weights"])
        return loss, logits

    if remat == "none":
        return run(batch["points"], batch.get("features")) + ([],)
    if remat not in ("full", "dots"):
        raise ValueError(f"remat must be 'none'|'dots'|'full', got {remat!r}")
    records: list = []
    rng_state = generator.get_state()

    def contexts():
        first, again = ((contextlib.nullcontext(), contextlib.nullcontext()) if remat == "full"
                        else checkpoint.create_selective_checkpoint_contexts(_dots_saveable))
        return (_entered(first, bn_updates(records)),
                _entered(again, bn_updates(None), _restored(generator, rng_state)))

    loss, logits = checkpoint.checkpoint(run, batch["points"], batch.get("features"),
                                         use_reentrant=False, context_fn=contexts,
                                         preserve_rng_state=False)
    return loss, logits, records


def seg_train_step(
    state: TrainState,
    batch: Dict,
    dropout_seed: int = 0,
    *,
    bn_schedule: Callable[[int], float] = schedules.scannet_bn_momentum,
    num_classes: int = 21,
    remat: str = "none",
    wire_spec=None,
):
    """One training step on a segmentation batch; updates ``state`` in place
    and returns ``(state, metrics)``.

    ``batch``: 'points' (B,N,3) f32, 'labels' (B,N) int, 'weights' (B,N) f32
    (class weight x mask) and optional 'features' (B,N,K), or the compact
    or packed wire format (``wire_spec`` describes a packed record).
    ``metrics`` holds device tensors 'loss', 'accuracy' and
    'confusion' (C, C) and the float 'learning_rate' (``state``'s schedule
    at the pre-increment step); no host sync is made.
    After the step each parameter's ``.grad`` holds this step's gradient.
    ``remat``: 'none', 'full' (the forward and loss recomputed in the
    backward) or 'dots' (only the matmul outputs kept); all three give the
    same step.
    """
    model = state.model
    dev = _device_of(model)
    batch = expand_wire_batch(_to_device(batch, dev), wire_spec)
    bn_momentum = bn_schedule(state.step)
    generator = _dropout_generator(dev, dropout_seed, state.step)
    model.train()
    model.zero_grad(set_to_none=True)
    loss, logits, bn_records = _loss_and_logits(model, batch, bn_momentum, generator, remat)
    loss.backward()
    apply_bn_updates(bn_records)
    lr = state.apply_gradients()
    _, out = _batch_metrics(logits.detach(), batch["labels"], num_classes)
    out.update(loss=loss.detach(), learning_rate=lr)
    return state, out


def seg_eval_step(state: TrainState, batch: Dict, *, num_classes: int = 21,
                  wire_spec=None) -> Dict[str, torch.Tensor]:
    """Eval forward (running BN statistics, no dropout): 'loss', 'accuracy',
    'confusion' and 'predictions' (B,N) int32, as device tensors.  The
    model's train/eval mode is restored afterwards."""
    model = state.model
    batch = expand_wire_batch(_to_device(batch, _device_of(model)), wire_spec)
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


def seg_predict_step_packed(model: nn.Module, packed, *, wire_spec) -> torch.Tensor:
    """``seg_predict_step`` on packed rows (B, row_nbytes) u8, numpy or a
    tensor: copied to the model's device and decoded there (the label and
    mask bytes are unused)."""
    batch = expand_wire_batch(_to_device({"packed": packed}, _device_of(model)), wire_spec)
    return seg_predict_step(model, batch["points"], batch.get("features"))
