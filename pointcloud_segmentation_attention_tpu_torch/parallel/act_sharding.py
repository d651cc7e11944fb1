"""The activation layout of tensor parallelism: the port's counterpart of the
JAX package's ``parallel/act_sharding.py``.

In JAX, ``constrain_channels`` pins each ``PointConv`` output to
P(data, ..., model) and XLA's partitioner inserts the collectives that keep
every product split over ``model``.  Nothing partitions for PyTorch, so
here the layers do it themselves, Megatron's column-parallel way, while an
``activation_sharding(mesh)`` context is active (``parallel.tp.model_parallel``
enters it):

- a layer whose kernel is sharded over the model axis computes its own
  block of output channels from the full input (``product_input``, then
  ``column_block``'s slice of its replicated bias); its BN and ReLU run on
  that block;
- ``constrain_channels`` rebuilds the full channels for whatever consumes
  them: an all-gather over the model group;
- gradients: a full activation's cotangent is whole on every model rank.
  A sharded product's input cotangent is this rank's part of a sum over
  the model ranks, so ``product_input`` sums it over the model group in the
  backward (an all-reduce), and the gather's backward keeps this rank's
  block (no collective).  Where one sharded layer's block feeds the next
  sharded product directly (inside ``SharedMLP``), the two are one
  all-gather forward and one reduce-scatter backward.

Outside the context ``constrain_channels`` and ``product_input`` are the
identity, as JAX's ``constrain_channels`` is, so model code calls them
unconditionally.  Every collective goes through ``parallel/collectives.py``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from pointcloud_segmentation_attention_tpu_torch.parallel import collectives

_CTX: contextvars.ContextVar = contextvars.ContextVar("psa_activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Run the block with ``mesh``'s model axis active (a no-op for None or
    a mesh of one model rank)."""
    token = _CTX.set(mesh if mesh is not None and mesh.n_model > 1 else None)
    try:
        yield
    finally:
        _CTX.reset(token)


def model_mesh():
    """The mesh of the running tensor-parallel step, or None."""
    return _CTX.get()


def column_block(channels: int) -> slice:
    """This model rank's block of ``channels`` output channels; raises
    outside a tensor-parallel step (a sharded layer cannot run there)."""
    mesh = _CTX.get()
    if mesh is None:
        raise RuntimeError("a layer with a sharded kernel runs only inside "
                           "parallel.model_parallel (or unshard_state it first)")
    if channels % mesh.n_model:
        raise ValueError(f"{channels} channels do not divide over {mesh.n_model} model ranks")
    c = channels // mesh.n_model
    return slice(mesh.model_rank * c, (mesh.model_rank + 1) * c)


class _Gather(torch.autograd.Function):
    """Forward: the model ranks' blocks joined on the last axis.  Backward:
    this rank's block of the (whole) cotangent."""

    @staticmethod
    def forward(ctx, x, group, block):
        ctx.block = block
        return collectives.all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.block].contiguous(), None, None


class _GatherSummed(torch.autograd.Function):
    """Forward: the model ranks' blocks joined on the last axis.  Backward:
    the cotangent summed over the model ranks, this rank's block of it (a
    reduce-scatter): the consumer is a sharded product, whose input
    cotangent is a part of the sum on each rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group  # autograd may run the backward on another thread
        return collectives.all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return collectives.reduce_scatter(g, ctx.group), None


class _Summed(torch.autograd.Function):
    """Forward: the identity.  Backward: the cotangent summed over the model
    ranks (the input of a sharded product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                      ctx.group), None


def constrain_channels(x: torch.Tensor, channels: int) -> torch.Tensor:
    """A layer's (B, ..., C) output: inside a tensor-parallel step, where
    ``x`` holds this rank's block of ``channels`` (laid out P(data, ...,
    model)), the full channels gathered over the model group; ``x`` itself
    otherwise (a replicated layer's output, or no tensor-parallel step)."""
    mesh = _CTX.get()
    if mesh is None or x.shape[-1] == channels:
        return x
    return _Gather.apply(x, mesh.model_group, column_block(channels))


def product_input(x: torch.Tensor, c_in: int, sharded: bool) -> torch.Tensor:
    """The input of a product with ``c_in`` input channels, whose kernel is
    ``sharded`` over the model axis or not.  Inside a tensor-parallel step
    ``x`` may be the previous layer's block (``SharedMLP`` leaves its
    layers' outputs ungathered), which is gathered here; the input of a
    sharded product has its cotangent summed over the model group.  ``x``
    itself outside a tensor-parallel step."""
    mesh = _CTX.get()
    if mesh is None:
        return x
    block = x.shape[-1] != c_in
    if sharded:
        return (_GatherSummed.apply(x, mesh.model_group) if block
                else _Summed.apply(x, mesh.model_group))
    return _Gather.apply(x, mesh.model_group, column_block(c_in)) if block else x


def full_channels(parts: torch.Tensor, channels: int) -> torch.Tensor:
    """(k, block) per-channel values of this rank's block -> (k, channels)
    of every block, by a sum over the model group of zero-padded copies (an
    all-reduce: exact, and not an all-gather of a rank-2 tensor)."""
    mesh = _CTX.get()
    full = parts.new_zeros((parts.shape[0], channels))
    full[:, column_block(channels)] = parts
    return collectives.all_reduce(full, mesh.model_group)
