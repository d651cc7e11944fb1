"""Step functions of the port: eval-mode prediction for serving."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def seg_predict_step(model: nn.Module, points: torch.Tensor,
                     features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode logits (B, N, num_classes), running BN statistics, no
    dropout; the model's train/eval mode is restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            return model(points, features)
    finally:
        model.train(was_training)
