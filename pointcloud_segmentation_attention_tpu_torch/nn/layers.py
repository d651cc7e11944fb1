"""Core layers: pointwise convolution, scheduled-momentum BatchNorm, dense,
dropout.

Counterparts of the JAX package's ``nn/layers.py``.  Kernels keep Flax's
(in, out) layout, so checkpoints of the JAX package load without transposes.
Parameters are created by ``reset_parameters(generator)`` from an explicit
``torch.Generator``.

Data parallelism: inside a ``parallel.data_parallel`` step a train-mode
``ScheduledBatchNorm`` takes its statistics over the global batch
(``_SyncBatchNorm``) and ``Dropout`` draws its mask for the global batch and
keeps this rank's rows, so every rank computes what one device computes.

Tensor parallelism: inside a ``parallel.model_parallel`` step a
``PointConv`` or ``Dense`` whose kernel ``parallel.shard_state`` sharded
(narrower than its bias) is column-parallel (``parallel/act_sharding.py``):
it computes its block of output channels from the full input, with its
block of the bias; the BN normalises that block (statistics over the data
group only: they are per channel) and keeps its running statistics full;
the ReLU runs on the block; then the full channels are gathered.  A
``SharedMLP`` gathers its layers' blocks at the next layer's input.

Mixed precision: ``PointConv`` and ``Dense`` take a ``compute_dtype``.
Parameters stay float32; under ``torch.bfloat16`` the product takes both
operands rounded to bf16 and returns float32 (``mixed_matmul``, JAX's
``preferred_element_type=float32``), and the bias, BN and ReLU run in
float32 on that output.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.parallel import act_sharding, collectives
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import active_mesh, local_rows

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


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BN over the global batch of a process group, with JAX's
    two passes: an all-reduce of the per-channel sum and the row count gives
    the mean, then one of the centred sum of squares the (biased) variance.
    The backward all-reduces ``sum(dy)`` and ``sum(dy * xhat)``; the scale
    and bias gradients it returns are this rank's sums, which the step's
    gradient all-reduce adds up.  Returns ``(y, mean, var)``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        c = x.shape[-1]
        rows = x.reshape(-1, c)
        stats = torch.cat([rows.sum(dim=0), rows.new_full((1,), float(rows.shape[0]))])
        collectives.all_reduce(stats, group)
        count = stats[c]
        mean = stats[:c] / count
        d = rows - mean
        var = collectives.all_reduce((d * d).sum(dim=0), group) / count
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(d, invstd, scale, count)
        ctx.group = group  # autograd may run the backward on another thread
        ctx.mark_non_differentiable(mean, var)
        return (d * (invstd * scale) + bias).view_as(x), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        d, invstd, scale, count = ctx.saved_tensors
        c = d.shape[-1]
        g = dy.reshape(-1, c)
        xhat = d * invstd
        local = torch.cat([g.sum(dim=0), (g * xhat).sum(dim=0)])
        sums = collectives.all_reduce(local.clone(), ctx.group) / count
        dx = (g - sums[:c] - xhat * sums[c:]) * (invstd * scale)
        return dx.view_as(dy), local[c:], local[:c], None, None


class ScheduledBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with the EMA decay passed per
    call.  Stock ``nn.BatchNorm`` differs on three counts, all kept here:
    eps is 1e-3; ``momentum`` is the decay, ``ema = m*ema + (1-m)*batch``;
    the running variance takes the biased batch variance.  Eval mode computes
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  Inside
    ``bn_updates(sink)`` the running-statistics update is recorded or
    skipped instead of applied (activation checkpointing).  Under an active
    data-parallel mesh the train-mode statistics, and so the running
    averages, are the global batch's (``_SyncBatchNorm``).  Given a block
    of its channels (a column-parallel layer's output), it normalises that
    block with its block of the scale and bias and of the running
    statistics, and updates the running statistics of every block (a sum of
    zero-padded blocks over the model group).
    """

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        c = self.scale.shape[0]
        block = None if x.shape[-1] == c else act_sharding.column_block(c)
        scale, bias = (self.scale, self.bias) if block is None else (self.scale[block],
                                                                     self.bias[block])
        if self.training:
            mesh = active_mesh()
            if mesh is not None:
                y, mean, var = _SyncBatchNorm.apply(x, scale, bias, self.eps, mesh.group)
                self._record(mean, var, momentum, block)
                return y
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
            self._record(mean, var, momentum, block)
        elif block is None:
            mean, var = self.mean, self.var
        else:
            mean, var = self.mean[block], self.var[block]
        inv = torch.rsqrt(var + self.eps) * scale
        return (x - mean) * inv + bias

    def _record(self, mean: torch.Tensor, var: torch.Tensor, momentum: float,
                block: Optional[slice] = None) -> None:
        """Apply, record or skip the running-statistics update (``bn_updates``);
        a block's statistics are joined with the other blocks' first."""
        sink = getattr(_bn_sink, "value", None)
        if block is not None and sink is not _SKIP:
            mean, var = act_sharding.full_channels(
                torch.stack([mean.detach(), var.detach()]), self.scale.shape[0])
        if sink is None:
            self._update(mean, var, momentum)
        elif sink is not _SKIP:
            sink.append((self, mean.detach(), var.detach(), momentum))

    def _update(self, mean: torch.Tensor, var: torch.Tensor, momentum: float) -> None:
        with torch.no_grad():
            self.mean.copy_(momentum * self.mean + (1.0 - momentum) * mean)
            self.var.copy_(momentum * self.var + (1.0 - momentum) * var)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float32 product of two 2-D or two batched 3-D tensors of one
    low-precision dtype.  On the card cuBLAS multiplies them as they are and
    accumulates in float32 (``out_dtype``); on the CPU they are widened
    first, which is the same sum of exact products in another order."""
    if a.is_cuda:
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MixedProduct(torch.autograd.Function):
    """``a @ b`` of float32 tensors, taken on their ``dtype`` roundings with a
    float32 result.  The backward is JAX's transpose of ``dot_general`` with
    ``preferred_element_type=float32`` followed by the ``astype`` VJP: each
    cotangent product is float32 (g with the other operand's rounding), then
    rounded to ``dtype`` and widened back to float32."""

    @staticmethod
    def forward(ctx, a, b, dtype):
        a_c, b_c = a.to(dtype), b.to(dtype)
        ctx.save_for_backward(a_c, b_c)
        ctx.dtype = dtype
        return _product(a_c, b_c)

    @staticmethod
    def backward(ctx, g):
        a_c, b_c = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b_c.float().transpose(-1, -2)).to(ctx.dtype).float()
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a_c.float().transpose(-1, -2), g).to(ctx.dtype).float()
        return da, db, None


def mixed_matmul(a: torch.Tensor, b: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a @ b`` in ``compute_dtype`` with a float32 result: ``torch.matmul``
    for float32; otherwise JAX's ``einsum(a.astype(dd), b.astype(dd),
    preferred_element_type=float32)`` (``_MixedProduct``).  ``b`` is a 2-D
    kernel (``a`` any (..., K)) or has ``a``'s batch axes."""
    if compute_dtype == torch.float32:
        return torch.matmul(a, b)
    if b.dim() == 2:
        out = _MixedProduct.apply(a.reshape(-1, a.shape[-1]), b, compute_dtype)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = a.shape[:-2]
    out = _MixedProduct.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                              compute_dtype)
    return out.reshape(*batch, *out.shape[-2:])


def linear(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ kernel + bias`` (``mixed_matmul``); with a kernel sharded over
    the model axis (narrower than its bias), this rank's column block of it
    from the full input (``act_sharding.product_input``)."""
    sharded = kernel.shape[-1] != bias.shape[-1]
    x = act_sharding.product_input(x, kernel.shape[0], sharded)
    y = mixed_matmul(x, kernel, compute_dtype)
    return y + (bias[act_sharding.column_block(bias.shape[-1])] if sharded else bias)


def _xavier_uniform_(kernel: torch.Tensor, bias: torch.Tensor,
                     generator: Optional[torch.Generator]) -> None:
    """Draw an (in, out) kernel xavier-uniform from ``generator``; zero the
    bias, if there is one."""
    c_in, c_out = kernel.shape
    bound = math.sqrt(6.0 / (c_in + c_out))
    with torch.no_grad():
        u = torch.rand(kernel.shape, generator=generator)
        kernel.copy_((2.0 * u - 1.0) * bound)
        if bias is not None:
            bias.zero_()


class PointConv(nn.Module):
    """Pointwise (1x1) conv over the channel axis: ``x @ kernel + bias``, then
    optional BN and ReLU.  Works on any (..., C_in) tensor.  The matmul is
    ``mixed_matmul`` in ``compute_dtype`` (``torch.matmul`` in float32), as
    the JAX package leaves it to XLA.  Column-parallel under tensor
    parallelism (the module's docstring); ``gather=False`` leaves the
    output as this rank's block (for a ``SharedMLP``'s next layer).
    ``bias=False`` leaves the bias out (a product straight into a BN, as
    the Point Transformer's bias-free linears; not column-parallel)."""

    tp_columns = ("kernel", ("bias", "bn.scale", "bn.bias"))

    def __init__(self, c_in: int, features: int, bn: bool = True, activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__()
        self.features = features
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(c_in, features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.bn = ScheduledBatchNorm(features) if bn else None
        self.activation = activation
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform kernel (Flax's default here), zero bias."""
        _xavier_uniform_(self.kernel, self.bias, generator)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9,
                gather: bool = True) -> torch.Tensor:
        y = (linear(x, self.kernel, self.bias, self.compute_dtype) if self.bias is not None
             else mixed_matmul(x, self.kernel, self.compute_dtype))
        if self.bn is not None:
            y = self.bn(y, momentum=bn_momentum)
        if self.activation:
            y = torch.relu(y)
        return act_sharding.constrain_channels(y, self.features) if gather else y


class SharedMLP(nn.Module):
    """Stack of PointConv + BN + ReLU layers named ``conv0``, ``conv1``, ..."""

    def __init__(self, c_in: int, features: Sequence[int],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"conv{i}", PointConv(c_in, f, compute_dtype=compute_dtype))
            c_in = f
        self.out_channels = c_in

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        last = self.n_layers - 1
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, bn_momentum=bn_momentum, gather=i == last)
        return x


class Dense(nn.Module):
    """Plain dense layer, ``x @ kernel + bias`` over the last axis: an (in,
    out) kernel drawn xavier-uniform, a zero bias (tf.layers.Dense's
    initialisers, as the JAX package's ``Dense``); the product in
    ``compute_dtype`` (``mixed_matmul``); column-parallel under tensor
    parallelism."""

    tp_columns = ("kernel", ("bias",))

    def __init__(self, c_in: int, features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(c_in, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _xavier_uniform_(self.kernel, self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act_sharding.constrain_channels(
            linear(x, self.kernel, self.bias, self.compute_dtype), self.features)


class Dropout(nn.Module):
    """Inverted dropout; identity in eval mode.  Draws its mask from the
    ``generator`` passed to ``forward``; under a data-parallel mesh, the
    global batch's mask, of which it keeps this rank's rows."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = local_rows(lambda shape: torch.rand(shape, generator=generator, device=x.device),
                       x.shape)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def reset_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every ``PointConv`` and ``Dense`` kernel of ``model`` from
    ``generator``, in module order; zero biases, unit BN (scale 1, bias 0,
    mean 0, var 1)."""
    for mod in model.modules():
        if isinstance(mod, (PointConv, Dense)):
            mod.reset_parameters(generator)
        elif isinstance(mod, ScheduledBatchNorm):
            with torch.no_grad():
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
