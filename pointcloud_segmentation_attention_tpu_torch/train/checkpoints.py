"""Weight bridge between the JAX package's checkpoints and the port.

The JAX package's ``save_checkpoint`` writes one npz of flat keys,
``params/<module path>/<name>``, ``batch_stats/<module path>/<name>``,
``opt_state/...`` and ``step``, for example ``params/sa1/mlp/conv0/kernel``,
``params/sa1/mlp/conv0/bn/scale`` and ``batch_stats/fp4/mlp/conv2/bn/var``.
The port names its modules as Flax does and keeps kernels in (in, out)
layout, so a key maps onto the state dict by its path: parameters under
``params/``, buffers (the BN running statistics) under ``batch_stats/``.

For ``optax.adam(schedule)`` the optimizer state is the pair (Adam's count,
mu, nu; the schedule's count), written as ``opt_state/0/.count``,
``opt_state/0/.mu/<param path>``, ``opt_state/0/.nu/<param path>`` and
``opt_state/1/.count``.  They map onto ``torch.optim.Adam``'s state as mu ->
``exp_avg``, nu -> ``exp_avg_sq`` and count -> ``step``
(``export_jax_state`` / ``load_jax_state``).

The checkpoint manager (``save_checkpoint``, ``latest_checkpoint``,
``best_checkpoint``, ``restore_checkpoint``, ``BestKeeper``) writes those
keys as ``{prefix}_{step:08d}.npz`` beside a json manifest ``{"step",
"metric", "file"}``, as the JAX package's ``train/checkpoints.py`` does, so
each package restores the other's checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.train.bn_fold import FoldedBatchNorm
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState

_SECTIONS = ("params", "batch_stats")
_ADAM = "opt_state/0/"
_COUNTS = ("opt_state/0/.count", "opt_state/1/.count")
_MOMENTS = ((".mu/", "exp_avg"), (".nu/", "exp_avg_sq"))


def _jax_keys(model: nn.Module) -> Dict[str, str]:
    """Flat JAX key -> state-dict name, for every parameter and buffer."""
    keys = {}
    for name, _ in model.named_parameters():
        keys["params/" + name.replace(".", "/")] = name
    for name, _ in model.named_buffers():
        keys["batch_stats/" + name.replace(".", "/")] = name
    return keys


def export_jax_variables(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and BN statistics under the JAX flat keys; a
    BN folded away (``train/bn_fold.py``) as the JAX fold's neutral
    entries."""
    state = model.state_dict()
    flat = {k: state[name].detach().cpu().numpy().copy()
            for k, name in _jax_keys(model).items()}
    for name, mod in model.named_modules():
        if isinstance(mod, FoldedBatchNorm):
            flat.update(mod.jax_entries(name.replace(".", "/")))
    return flat


def load_jax_variables(flat: Dict[str, np.ndarray], model: nn.Module) -> nn.Module:
    """Fill ``model`` from JAX flat keys; returns it.

    Raises ``ValueError`` on any missing or extra ``params/``/``batch_stats/``
    key and on any shape mismatch.  ``opt_state/`` entries and ``step`` are
    ignored."""
    keys = _jax_keys(model)
    given = {k for k in flat if k.split("/", 1)[0] in _SECTIONS}
    missing, extra = sorted(set(keys) - given), sorted(given - set(keys))
    if missing or extra:
        raise ValueError(
            f"checkpoint does not match the model:\n"
            f"  missing from checkpoint: {missing[:8]}\n"
            f"  not in model: {extra[:8]}")
    state = model.state_dict()
    for k, name in keys.items():
        value = np.asarray(flat[k])
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"{k}: checkpoint shape {value.shape} != model shape "
                             f"{tuple(state[name].shape)}")
    with torch.no_grad():
        for k, name in keys.items():
            state[name].copy_(torch.tensor(np.asarray(flat[k], np.float32)))
    return model


def _param_paths(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def export_jax_state(state: TrainState) -> Dict[str, np.ndarray]:
    """The train state under the keys the JAX package's ``save_checkpoint``
    writes for ``optax.adam(schedule)``: parameters, BN statistics, Adam's
    mu/nu and counts, and ``step``."""
    flat = export_jax_variables(state.model)
    opt = state.optimizer.state
    for path, p in _param_paths(state.model).items():
        for jax_name, torch_name in _MOMENTS:
            flat[_ADAM + jax_name + path] = opt[p][torch_name].detach().cpu().numpy().copy()
    for key in _COUNTS:
        flat[key] = np.asarray(state.step, np.int32)
    flat["step"] = np.asarray(state.step)
    return flat


def load_jax_state(flat: Dict[str, np.ndarray], state: TrainState) -> TrainState:
    """Fill ``state`` (model, Adam moments, step) from the JAX flat keys;
    returns it.  Raises ``ValueError`` on a missing or extra key or a shape
    mismatch, and when the counts disagree with ``step``."""
    paths = _param_paths(state.model)
    want = {_ADAM + j + path for path in paths for j, _ in _MOMENTS} | set(_COUNTS)
    given = {k for k in flat if k.startswith("opt_state/")}
    missing, extra = sorted(want - given), sorted(given - want)
    if missing or extra:
        raise ValueError(
            f"optimizer state does not match Adam over the model:\n"
            f"  missing from checkpoint: {missing[:8]}\n"
            f"  not in model: {extra[:8]}")
    step = int(np.asarray(flat.get("step", flat[_COUNTS[0]])))
    counts = [int(np.asarray(flat[k])) for k in _COUNTS]
    if counts != [step, step]:
        raise ValueError(f"optimizer counts {counts} disagree with step {step}")
    for path, p in paths.items():
        for jax_name, _ in _MOMENTS:
            value = np.asarray(flat[_ADAM + jax_name + path])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{_ADAM + jax_name + path}: shape {value.shape} != "
                                 f"{tuple(p.shape)}")
    load_jax_variables(flat, state.model)
    opt = state.optimizer.state
    with torch.no_grad():
        for path, p in paths.items():
            for jax_name, torch_name in _MOMENTS:
                opt[p][torch_name].copy_(torch.tensor(
                    np.asarray(flat[_ADAM + jax_name + path], np.float32)))
            opt[p]["step"].fill_(float(step))
    state.step = step
    return state


def save_jax_checkpoint(path: str, state: TrainState) -> str:
    """Write ``export_jax_state(state)`` as one ``.npz`` that the JAX
    package's ``restore_checkpoint`` reads; returns the path."""
    np.savez(path, **export_jax_state(state))
    return path


def load_jax_checkpoint(path: str, target: Union[nn.Module, TrainState]):
    """Load a JAX package checkpoint ``.npz`` into a model (parameters and BN
    statistics) or a ``TrainState`` (also Adam's state and the step)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    if isinstance(target, TrainState):
        return load_jax_state(flat, target)
    return load_jax_variables(flat, target)


# ---- the checkpoint manager -----------------------------------------------------


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    metric: Optional[float] = None, keep_best_only: bool = False,
                    prefix: str = "ckpt") -> str:
    """Write ``state`` as ``{prefix}_{step:08d}.npz`` plus its json manifest;
    with ``keep_best_only`` every other checkpoint of ``prefix`` is removed.
    Returns the npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"{prefix}_{step:08d}"
    path = os.path.join(ckpt_dir, name + ".npz")
    save_jax_checkpoint(path, state)
    with open(os.path.join(ckpt_dir, name + ".json"), "w") as f:
        json.dump({"step": int(step), "metric": metric, "file": name + ".npz"}, f)
    if keep_best_only:
        _prune_others(ckpt_dir, prefix, keep=name)
    return path


def _manifests(ckpt_dir: str, prefix: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for fn in os.listdir(ckpt_dir):
        if fn.startswith(prefix) and fn.endswith(".json"):
            with open(os.path.join(ckpt_dir, fn)) as f:
                m = json.load(f)
            m["_name"] = fn[:-5]
            out.append(m)
    return out


def _prune_others(ckpt_dir: str, prefix: str, keep: str) -> None:
    for m in _manifests(ckpt_dir, prefix):
        if m["_name"] != keep:
            for ext in (".json", ".npz"):
                p = os.path.join(ckpt_dir, m["_name"] + ext)
                if os.path.exists(p):
                    os.remove(p)


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """The npz path of ``prefix``'s checkpoint with the highest step, or None."""
    ms = _manifests(ckpt_dir, prefix)
    if not ms:
        return None
    return os.path.join(ckpt_dir, max(ms, key=lambda m: m["step"])["file"])


def best_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """The npz path of ``prefix``'s checkpoint with the highest metric; the
    latest one when none has a metric."""
    ms = [m for m in _manifests(ckpt_dir, prefix) if m.get("metric") is not None]
    if not ms:
        return latest_checkpoint(ckpt_dir, prefix)
    return os.path.join(ckpt_dir, max(ms, key=lambda m: m["metric"])["file"])


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Fill ``state`` (a template of the same model and Adam) from a
    checkpoint of either package; raises ``ValueError`` on any key or shape
    mismatch."""
    return load_jax_checkpoint(path, state)


class BestKeeper:
    """Keeps the checkpoint of the best validation metric (prefix ``best``,
    the others pruned).  Seeded from the manifests already on disk, so a
    resumed run does not replace a better earlier best."""

    def __init__(self, ckpt_dir: str, prefix: str = "best"):
        self.ckpt_dir = ckpt_dir
        self.prefix = prefix
        self.best = -np.inf
        for manifest in _manifests(ckpt_dir, prefix):
            if manifest.get("metric") is not None:
                self.best = max(self.best, manifest["metric"])

    def maybe_save(self, state: TrainState, step: int, metric: float) -> bool:
        if metric > self.best:
            self.best = metric
            save_checkpoint(self.ckpt_dir, state, step, metric=metric, keep_best_only=True,
                            prefix=self.prefix)
            return True
        return False
