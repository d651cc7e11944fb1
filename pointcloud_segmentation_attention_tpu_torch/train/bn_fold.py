"""Fold frozen BatchNorm into the convolution weights for serving.

In eval mode the BN statistics are frozen, so every ``PointConv`` + BN pair

    y = relu(((x @ K + b) - mean) * rsqrt(var + eps) * scale + beta)

collapses into the conv's own affine map:

    K' = K * inv            (per output channel, inv = rsqrt(var + eps) * scale)
    b' = (b - mean) * inv + beta

The JAX package keeps the BN module and neutralises it (XLA fuses it into
the matmul's epilogue anyway).  Eager PyTorch does not fuse it, so here the
folded copy drops the BN: its ``bn`` becomes a ``FoldedBatchNorm``, which
computes nothing and exports the JAX package's neutral BN entries (scale 1,
bias 0, mean 0, var 1 - eps) through the checkpoint bridge, so the JAX
package can load a folded port model.  Standalone BN layers without a
paired kernel (the attention poolings' ``attention_bn``) are left as they
are.  The port's own copy of the JAX package's ``train/bn_fold.py``.
"""
from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.nn.layers import PointConv, ScheduledBatchNorm

_BN_EPS = 1e-3   # ScheduledBatchNorm's eps (tf.contrib parity)


class FoldedBatchNorm(nn.Module):
    """What a folded ``PointConv`` keeps of its BN: the identity, and the
    neutral entries the JAX package's fold leaves in its variables."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.channels = channels
        self.eps = eps

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        return x

    def jax_entries(self, path: str) -> Dict[str, np.ndarray]:
        """Flat JAX keys of a neutral BN at module path ``path`` ('/'-joined):
        ``rsqrt((1 - eps) + eps) == 1``, so JAX's eval BN is the identity."""
        c = self.channels
        return {f"params/{path}/scale": np.ones(c, np.float32),
                f"params/{path}/bias": np.zeros(c, np.float32),
                f"batch_stats/{path}/mean": np.zeros(c, np.float32),
                f"batch_stats/{path}/var": np.full(c, 1.0 - self.eps, np.float32)}


def fold_batchnorm_for_inference(model: nn.Module, eps: float = _BN_EPS
                                 ) -> Tuple[nn.Module, int]:
    """``(folded copy, n_folded)``: a deep copy of ``model`` with every
    ``PointConv``'s BN folded into its kernel and bias.  Eval outputs are the
    same math reassociated (float noise ~1e-6 relative); the copy is for
    serving only (train mode has no BN left).  Raises ``ValueError`` when
    nothing can be folded (a model already folded included)."""
    folded = copy.deepcopy(model)
    n = 0
    with torch.no_grad():
        for mod in folded.modules():
            if isinstance(mod, PointConv) and isinstance(mod.bn, ScheduledBatchNorm):
                bn = mod.bn
                inv = torch.rsqrt(bn.var + eps) * bn.scale
                mod.kernel.copy_(mod.kernel * inv[None, :])
                mod.bias.copy_((mod.bias - bn.mean) * inv + bn.bias)
                mod.bn = FoldedBatchNorm(inv.numel(), eps)
                n += 1
    if n == 0:
        raise ValueError("no foldable PointConv + BN pairs found in the model")
    return folded, n
