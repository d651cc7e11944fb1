"""Loss functions of the port, the counterparts of the JAX package's
``train/losses.py``.

``weighted_softmax_cross_entropy`` is TF's ``SUM_BY_NONZERO_WEIGHTS``
reduction: the sum of weighted per-point CE divided by the number of
non-zero weights (not by the weight sum), at least 1.

Inside a data-parallel step (``parallel.data_parallel``) each rank's loss
is its share of the global batch's: the weighted CE divides this rank's sum
by the global count of non-zero weights (all-reduced, no gradient), and the
mean CE divides by the global number of elements, so the ranks' losses and
gradients sum to world size 1's.
"""
from __future__ import annotations

import torch

from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import active_mesh, global_sum


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element sparse softmax CE: logits (..., C), labels (...) int."""
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - label_logit


def weighted_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                   weights: torch.Tensor) -> torch.Tensor:
    """sum(w * ce) / max(count(w != 0), 1)."""
    ce = softmax_cross_entropy(logits.float(), labels)
    num_nonzero = global_sum((weights != 0).float().sum())
    return (ce * weights).sum() / num_nonzero.clamp_min(1.0)


def mean_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unweighted mean CE (over the global batch under a mesh, whose ranks
    hold equal shares)."""
    ce = softmax_cross_entropy(logits.float(), labels).mean()
    mesh = active_mesh()
    return ce if mesh is None else ce / mesh.world_size
