"""Point Transformer semantic segmentation (Zhao et al., ICCV 2021,
arXiv:2012.09164), the published ``pointtransformer_seg_repro`` at its
widths, on ``SemSegNet``'s contract: ``forward(xyz, features,
bn_momentum=, generator=)`` -> logits (B, N, num_classes), so that
``seg_train_step``, the sampler's step and ``train(config)`` take it
unchanged.

Five levels of ``PLANES`` 32/64/128/256/512 channels at strides 1/4/4/4/4
(8192 -> 2048 -> 512 -> 128 -> 32 points a cloud), each a
``TransitionDown`` then ``BLOCKS`` - 1 Point Transformer blocks over its
``NSAMPLE`` 8/16/16/16/16 nearest neighbours; the decoder goes back up
with a ``TransitionUp`` and one block a level (the coarsest level's
transition is ``TransitionUpHead``); the head is Linear(32, 32)-BN-ReLU-
Linear(32, classes).  The first transition sees xyz and the features
(9 channels with colors and normals).  Each level's kNN is computed once
and shared by its encoder and decoder blocks (``nn/point_transformer.py``).
There is no dropout: ``generator`` is accepted for the contract.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.nn.layers import PointConv, reset_parameters
from pointcloud_segmentation_attention_tpu_torch.nn.point_transformer import (
    PointTransformerBlock,
    TransitionDown,
    TransitionUp,
    TransitionUpHead,
    neighbourhood,
)

PLANES = (32, 64, 128, 256, 512)
BLOCKS = (2, 3, 4, 6, 3)
NSAMPLE = (8, 16, 16, 16, 16)
STRIDE = (1, 4, 4, 4, 4)
SHARE_PLANES = 8


class _Stage(nn.Module):
    """A transition (``down`` or ``up``) and the blocks after it."""

    def __init__(self, transition: nn.Module, planes: int, n_blocks: int, share_planes: int,
                 compute_dtype: torch.dtype, name: str):
        super().__init__()
        self.add_module(name, transition)
        self.blocks = nn.ModuleList(PointTransformerBlock(planes, share_planes, compute_dtype)
                                    for _ in range(n_blocks))

    def run_blocks(self, x, rel, idx, bn_momentum: float):
        for block in self.blocks:
            x = block(x, rel, idx, bn_momentum)
        return x


class PointTransformerSeg(nn.Module):
    """Point Transformer segmentation.  ``in_features`` is the per-point
    feature width beside xyz (6: colors + normals; 0: xyz only)."""

    def __init__(self, num_classes: int = 21, in_features: int = 6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dd = compute_dtype
        self.in_features = in_features
        self.nsample = NSAMPLE
        self.levels = len(PLANES)
        c = 3 + in_features
        for i, p in enumerate(PLANES):
            down = TransitionDown(c, p, STRIDE[i], NSAMPLE[i], dd)
            self.add_module(f"enc{i + 1}", _Stage(down, p, BLOCKS[i] - 1, SHARE_PLANES, dd,
                                                  "down"))
            c = p
        for i in reversed(range(self.levels)):
            up = (TransitionUpHead(PLANES[i], dd) if i == self.levels - 1
                  else TransitionUp(PLANES[i + 1], PLANES[i], dd))
            self.add_module(f"dec{i + 1}", _Stage(up, PLANES[i], 1, SHARE_PLANES, dd, "up"))
        self.fc1 = PointConv(PLANES[0], PLANES[0], compute_dtype=dd)
        self.fc2 = PointConv(PLANES[0], num_classes, bn=False, activation=False,
                             compute_dtype=dd)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every kernel from ``generator``; zero biases, unit BN."""
        reset_parameters(self, generator)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout
        if (features is None) != (self.in_features == 0):
            raise ValueError(
                f"model built for {self.in_features} feature channels, got "
                f"{None if features is None else features.shape[-1]}")
        p = xyz.float().contiguous()
        x = p if features is None else torch.cat([p, features.to(p.dtype)], dim=-1)
        levels = []
        for i in range(self.levels):
            enc = getattr(self, f"enc{i + 1}")
            p, x = enc.down(p, x, bn_momentum)
            p = p.contiguous()
            idx, rel = neighbourhood(p, self.nsample[i])
            x = enc.run_blocks(x, rel, idx, bn_momentum)
            levels.append((p, x, idx, rel))
        top = self.levels - 1
        _, x, idx, rel = levels[top]
        dec = getattr(self, f"dec{top + 1}")
        up = dec.run_blocks(dec.up(x, bn_momentum), rel, idx, bn_momentum)
        for i in reversed(range(top)):
            p, x, idx, rel = levels[i]
            dec = getattr(self, f"dec{i + 1}")
            up = dec.up(p, x, levels[i + 1][0], up, bn_momentum)
            up = dec.run_blocks(up, rel, idx, bn_momentum)
        return self.fc2(self.fc1(up, bn_momentum))
