"""Group-attention layers: the counterparts of the JAX package's
``nn/attention.py``, the reference project's own layers.

The math is the reference's, quirks included, as in the JAX package:

- ``AttentionPool`` pools a (B, npoint, nsample, C) group to (B, npoint,
  heads * key_dim) with one query vector per group.  The head split is a
  raw row-major reshape of the projected activations, not a transpose; V is
  reshaped with ``key_dim`` although it is projected to ``output_dim *
  heads`` (the two agree in every caller, 4 and 4); there is no output
  projection.
- ``InnerAttention``: the softmax mixes the heads within each point, not
  the points within the group (the reference's reshape, reproduced).
- ``FeedForward`` and ``InnerAttentionBlock``: a 4-layer ReLU MLP, and
  pre-FF -> inner attention -> FF with a residual.

No Pallas kernel computes any of this in the JAX package (XLA's einsums and
softmax do), so here it is plain PyTorch: ``mixed_matmul`` and ``softmax``.
Every layer takes a ``compute_dtype``: its projections and both attention
products run in it with float32 results, and the softmax weights are
rounded to it before the second product, as the JAX package computes them.
Submodule names follow Flax's, so checkpoints of the JAX package map onto
the state dict by name.  Dropout draws from the ``generator`` passed to
``forward`` and is the identity in eval mode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.nn.layers import Dense, Dropout, mixed_matmul
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over the last two axes, both products in
    ``compute_dtype`` with float32 results."""
    logits = mixed_matmul(q, k.transpose(-1, -2), compute_dtype) / math.sqrt(q.shape[-1])
    return mixed_matmul(torch.softmax(logits, dim=-1), v, compute_dtype)


class AttentionPool(nn.Module):
    """Multi-head scaled dot-product attention pooling of a point group,
    queried by one vector per group (its first element, or its centroid).
    ``c_in`` and ``c_query`` are the group's and the query's channels.
    Returns (B, npoint, num_heads * key_dim).  Under a profiler the forward
    is the span ``nn.attention_pool``."""

    def __init__(self, c_in: int, c_query: int, output_dim: int, key_dim: int,
                 num_heads: int = 16, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.key_dim, self.num_heads = key_dim, num_heads
        self.compute_dtype = compute_dtype
        self.query_net = Dense(c_query, key_dim * num_heads, compute_dtype)
        self.key_net = Dense(c_in, key_dim * num_heads, compute_dtype)
        self.value_net = Dense(c_in, output_dim * num_heads, compute_dtype)

    def forward(self, group_feats: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        with profiler.span("nn.attention_pool"):
            b, npoint, nsample, _ = group_feats.shape
            h, kd = self.num_heads, self.key_dim
            # Raw row-major split (B, np, S, h*kd) -> (B, np, h, S, kd).
            q = self.query_net(query).reshape(b, npoint, h, 1, kd)
            k = self.key_net(group_feats).reshape(b, npoint, h, nsample, kd)
            v = self.value_net(group_feats).reshape(b, npoint, h, nsample, kd)
            return _attend(q, k, v, self.compute_dtype).reshape(b, npoint, h * kd)


class InnerAttention(nn.Module):
    """Self-attention "within" each group, as the reference computes it:
    (B, np, S, h*kd) is split to (B, np, S, h, kd) and the softmax runs over
    the heads of each point.  Then ``out_net`` to ``output_dim``."""

    def __init__(self, c_in: int, output_dim: int, key_dim: int, num_heads: int = 5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.key_dim, self.num_heads = key_dim, num_heads
        self.compute_dtype = compute_dtype
        self.query_net = Dense(c_in, key_dim * num_heads, compute_dtype)
        self.key_net = Dense(c_in, key_dim * num_heads, compute_dtype)
        self.value_net = Dense(c_in, key_dim * num_heads, compute_dtype)
        self.out_net = Dense(key_dim * num_heads, output_dim, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, npoint, nsample, _ = x.shape
        split = (b, npoint, nsample, self.num_heads, self.key_dim)
        out = _attend(self.query_net(x).reshape(split), self.key_net(x).reshape(split),
                      self.value_net(x).reshape(split), self.compute_dtype)
        return self.out_net(out.reshape(b, npoint, nsample, -1))


class FeedForward(nn.Module):
    """Dense + ReLU + dropout three times, then a Dense to
    ``input_and_output_dim`` (``layer_1`` .. ``layer_4``)."""

    def __init__(self, c_in: int, input_and_output_dim: int, inner_dim: int,
                 dropout: float = 0.0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, c in enumerate((c_in, inner_dim, inner_dim)):
            self.add_module(f"layer_{i + 1}", Dense(c, inner_dim, compute_dtype))
            self.add_module(f"drop_{i + 1}", Dropout(dropout))
        self.layer_4 = Dense(inner_dim, input_and_output_dim, compute_dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(1, 4):
            x = torch.relu(getattr(self, f"layer_{i}")(x))
            x = getattr(self, f"drop_{i}")(x, generator=generator)
        return self.layer_4(x)


class InnerAttentionBlock(nn.Module):
    """pre-FF -> inner attention -> FF with a residual around the last."""

    def __init__(self, c_in: int, out_dim: int, key_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        self.pre_feed_forward = FeedForward(c_in, out_dim, out_dim, compute_dtype=dd)
        self.attention = InnerAttention(out_dim, out_dim, key_dim, compute_dtype=dd)
        self.feed_forward = FeedForward(out_dim, out_dim, out_dim, compute_dtype=dd)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.attention(self.pre_feed_forward(x, generator=generator))
        return self.feed_forward(x, generator=generator) + x
