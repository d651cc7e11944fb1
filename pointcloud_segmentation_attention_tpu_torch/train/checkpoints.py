"""Weight bridge between the JAX package's checkpoints and the port.

The JAX package's ``save_checkpoint`` writes one npz of flat keys,
``params/<module path>/<name>``, ``batch_stats/<module path>/<name>``,
``opt_state/...`` and ``step``, for example ``params/sa1/mlp/conv0/kernel``,
``params/sa1/mlp/conv0/bn/scale`` and ``batch_stats/fp4/mlp/conv2/bn/var``.
The port names its modules as Flax does and keeps kernels in (in, out)
layout, so a key maps onto the state dict by its path: parameters under
``params/``, buffers (the BN running statistics) under ``batch_stats/``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

_SECTIONS = ("params", "batch_stats")


def _jax_keys(model: nn.Module) -> Dict[str, str]:
    """Flat JAX key -> state-dict name, for every parameter and buffer."""
    keys = {}
    for name, _ in model.named_parameters():
        keys["params/" + name.replace(".", "/")] = name
    for name, _ in model.named_buffers():
        keys["batch_stats/" + name.replace(".", "/")] = name
    return keys


def export_jax_variables(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and BN statistics under the JAX flat keys."""
    state = model.state_dict()
    return {k: state[name].detach().cpu().numpy().copy()
            for k, name in _jax_keys(model).items()}


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


def load_jax_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load a JAX package checkpoint ``.npz`` into ``model``."""
    with np.load(path, allow_pickle=False) as z:
        return load_jax_variables({k: z[k] for k in z.files}, model)
