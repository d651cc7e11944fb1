"""Training schedules, the counterparts of the JAX package's
``train/schedules.py``: staircase exponential decay of the learning rate and
of the BatchNorm EMA decay.  Each value is computed in float32, as the JAX
package computes it, and returned as a Python float.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ExpDecaySchedule:
    """``value(step) = base * rate ** floor(step * batch_size / decay_step)``
    (without the floor when not ``staircase``), in float32."""

    base: float
    decay_rate: float
    decay_step: float
    batch_size: int = 1
    staircase: bool = True

    def __call__(self, step) -> float:
        exponent = (np.float32(step) * np.float32(self.batch_size)
                    / np.float32(self.decay_step))
        if self.staircase:
            exponent = np.floor(exponent)
        return float(np.float32(self.base)
                     * np.power(np.float32(self.decay_rate), np.float32(exponent)))


def scannet_learning_rate(step, batch_size: int = 16, n_train_scenes: int = 1201) -> float:
    """LR 1e-3 x 0.7 every 80 epochs' worth of samples, floored at 1e-5."""
    lr = ExpDecaySchedule(1e-3, 0.7, n_train_scenes * 80, batch_size)(step)
    return float(np.maximum(np.float32(lr), np.float32(1e-5)))


def scannet_bn_momentum(step, batch_size: int = 16, n_train_scenes: int = 1201) -> float:
    """BN EMA decay 1 - 0.5 * 0.5^k, capped at 0.99."""
    m = ExpDecaySchedule(0.5, 0.5, n_train_scenes * 80, batch_size)(step)
    return float(np.minimum(np.float32(0.99), np.float32(1.0) - np.float32(m)))


def upstream_learning_rate(step, base_lr: float = 1e-3, batch_size: int = 16,
                           decay_step: float = 200000, decay_rate: float = 0.7) -> float:
    """The upstream classification trainer's LR, floored at 1e-5."""
    lr = ExpDecaySchedule(base_lr, decay_rate, decay_step, batch_size)(step)
    return float(np.maximum(np.float32(lr), np.float32(1e-5)))


def upstream_bn_momentum(step, batch_size: int = 16, decay_step: float = 200000,
                         bn_init_decay: float = 0.5, bn_decay_rate: float = 0.5,
                         bn_decay_clip: float = 0.99) -> float:
    """The upstream BN EMA decay, capped at ``bn_decay_clip``."""
    m = ExpDecaySchedule(bn_init_decay, bn_decay_rate, decay_step, batch_size)(step)
    return float(np.minimum(np.float32(bn_decay_clip), np.float32(1.0) - np.float32(m)))
