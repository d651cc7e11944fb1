"""Loss functions of the port, the counterparts of the JAX package's
``train/losses.py``.

``weighted_softmax_cross_entropy`` is TF's ``SUM_BY_NONZERO_WEIGHTS``
reduction: the sum of weighted per-point CE divided by the number of
non-zero weights (not by the weight sum), at least 1.
"""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element sparse softmax CE: logits (..., C), labels (...) int."""
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - label_logit


def weighted_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                   weights: torch.Tensor) -> torch.Tensor:
    """sum(w * ce) / max(count(w != 0), 1)."""
    ce = softmax_cross_entropy(logits.float(), labels)
    num_nonzero = (weights != 0).float().sum()
    return (ce * weights).sum() / num_nonzero.clamp_min(1.0)


def mean_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unweighted mean CE."""
    return softmax_cross_entropy(logits.float(), labels).mean()
