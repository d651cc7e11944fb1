"""Core layers: pointwise convolution, scheduled-momentum BatchNorm, dense,
dropout.

Counterparts of the JAX package's ``nn/layers.py``.  Kernels keep Flax's
(in, out) layout, so checkpoints of the JAX package load without transposes.
Parameters are created by ``reset_parameters(generator)`` from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

# Where a train-mode BN sends its running-statistics update on this thread:
# None applies it in place; a list records (bn, batch mean, batch var,
# momentum) for ``apply_bn_updates``; ``_SKIP`` drops it (a recomputation
# under activation checkpointing, whose first forward recorded it).
_bn_sink = threading.local()
_SKIP = object()


@contextlib.contextmanager
def bn_updates(sink):
    """Route this thread's train-mode BN updates to ``sink`` (a list that
    records them, or ``None`` to skip them) while the block runs."""
    prev = getattr(_bn_sink, "value", None)
    _bn_sink.value = _SKIP if sink is None else sink
    try:
        yield
    finally:
        _bn_sink.value = prev


def apply_bn_updates(records: List[Tuple["ScheduledBatchNorm", torch.Tensor, torch.Tensor,
                                         float]]) -> None:
    """Apply recorded BN updates with the arithmetic of the in-place path."""
    for bn, mean, var, momentum in records:
        bn._update(mean, var, momentum)


class ScheduledBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with the EMA decay passed per
    call.  Stock ``nn.BatchNorm`` differs on three counts, all kept here:
    eps is 1e-3; ``momentum`` is the decay, ``ema = m*ema + (1-m)*batch``;
    the running variance takes the biased batch variance.  Eval mode computes
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  Inside
    ``bn_updates(sink)`` the running-statistics update is recorded or
    skipped instead of applied (activation checkpointing).
    """

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
            sink = getattr(_bn_sink, "value", None)
            if sink is None:
                self._update(mean, var, momentum)
            elif sink is not _SKIP:
                sink.append((self, mean.detach(), var.detach(), momentum))
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * inv + self.bias

    def _update(self, mean: torch.Tensor, var: torch.Tensor, momentum: float) -> None:
        with torch.no_grad():
            self.mean.copy_(momentum * self.mean + (1.0 - momentum) * mean)
            self.var.copy_(momentum * self.var + (1.0 - momentum) * var)


def _xavier_uniform_(kernel: torch.Tensor, bias: torch.Tensor,
                     generator: Optional[torch.Generator]) -> None:
    """Draw an (in, out) kernel xavier-uniform from ``generator``; zero the bias."""
    c_in, c_out = kernel.shape
    bound = math.sqrt(6.0 / (c_in + c_out))
    with torch.no_grad():
        u = torch.rand(kernel.shape, generator=generator)
        kernel.copy_((2.0 * u - 1.0) * bound)
        bias.zero_()


class PointConv(nn.Module):
    """Pointwise (1x1) conv over the channel axis: ``x @ kernel + bias``, then
    optional BN and ReLU.  Works on any (..., C_in) tensor.  The matmul is
    ``torch.matmul``, as the JAX package leaves it to XLA."""

    def __init__(self, c_in: int, features: int, bn: bool = True, activation: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(c_in, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.bn = ScheduledBatchNorm(features) if bn else None
        self.activation = activation
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform kernel (Flax's default here), zero bias."""
        _xavier_uniform_(self.kernel, self.bias, generator)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        y = torch.matmul(x, self.kernel) + self.bias
        if self.bn is not None:
            y = self.bn(y, momentum=bn_momentum)
        if self.activation:
            y = torch.relu(y)
        return y


class SharedMLP(nn.Module):
    """Stack of PointConv + BN + ReLU layers named ``conv0``, ``conv1``, ..."""

    def __init__(self, c_in: int, features: Sequence[int]):
        super().__init__()
        self.n_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"conv{i}", PointConv(c_in, f))
            c_in = f
        self.out_channels = c_in

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, bn_momentum=bn_momentum)
        return x


class Dense(nn.Module):
    """Plain dense layer, ``x @ kernel + bias`` over the last axis: an (in,
    out) kernel drawn xavier-uniform, a zero bias (tf.layers.Dense's
    initialisers, as the JAX package's ``Dense``)."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(c_in, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _xavier_uniform_(self.kernel, self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class Dropout(nn.Module):
    """Inverted dropout; identity in eval mode.  Draws its mask from the
    ``generator`` passed to ``forward``."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))
