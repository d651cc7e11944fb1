"""Train state of the port: the model, the step count and an Adam that
matches the JAX package's ``optax.adam(schedule)``.

optax's Adam keeps ``mu`` and ``nu`` per parameter and a ``count``; its
update is ``-lr(count) * mu_hat / (sqrt(nu_hat) + eps)`` with b1 0.9, b2
0.999, eps 1e-8, and the schedule is called with the count *before* it is
incremented.  ``torch.optim.Adam`` computes the same update when its LR is
set from the schedule at the pre-increment step before each ``step()``,
which is what ``apply_gradients`` does.  Its state is created up front, so
a JAX checkpoint's ``mu``/``nu``/``count`` can be loaded into it before the
first step (``train/checkpoints.py``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.train import schedules

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class TrainState:
    """``model`` (parameters and BN running statistics), ``step`` (the
    number of updates applied) and ``optimizer`` (Adam over every
    parameter, with ``lr_schedule`` evaluated at the pre-increment step)."""

    def __init__(self, model: nn.Module,
                 lr_schedule: Callable[[int], float] = schedules.scannet_learning_rate,
                 step: int = 0):
        self.model = model
        self.lr_schedule = lr_schedule
        self.step = step
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr_schedule(step),
                                          betas=ADAM_BETAS, eps=ADAM_EPS)
        for p in model.parameters():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }

    def apply_gradients(self) -> float:
        """One Adam update from the parameters' ``.grad``; returns the LR used."""
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return lr
