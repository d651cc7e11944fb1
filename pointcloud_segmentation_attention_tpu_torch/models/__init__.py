"""Model registry of the port: the names ported so far."""
from __future__ import annotations

from typing import Optional

import torch

from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.models.sem_seg import SemSegNet

# Registry name -> per-point input feature width (colors + normals = 6).
_REGISTRY = {
    "sem_seg": 0,
    "sem_seg_features": 6,
}


def get_model(name: str, *, device="cuda", generator: Optional[torch.Generator] = None,
              **kwargs) -> SemSegNet:
    """Build a registry model with weights drawn from ``generator`` and move
    it to ``device``.  Names of later slices raise ``KeyError``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown or not yet ported model '{name}'; "
                       f"available: {sorted(_REGISTRY)}")
    dev = resolve(device)
    model = SemSegNet(in_features=_REGISTRY[name], **kwargs)
    model.reset_parameters(generator)
    return model.to(dev)


def seeded_model(name: str = "sem_seg_features", seed: int = 0, device="cuda",
                 **kwargs) -> SemSegNet:
    """A registry model whose weights and BatchNorm statistics and affines
    are all drawn from ``seed`` (BN is then not the identity in eval mode):
    the stand-in for trained weights in smoke runs and benchmarks."""
    from pointcloud_segmentation_attention_tpu_torch.nn import ScheduledBatchNorm

    g = torch.Generator().manual_seed(seed)
    model = get_model(name, device="cpu", generator=g, **kwargs)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, ScheduledBatchNorm):
                c = bn.mean.shape[0]
                bn.mean.copy_(torch.randn(c, generator=g) * 0.1)
                bn.var.copy_(torch.rand(c, generator=g) + 0.5)
                bn.scale.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
                bn.bias.copy_(torch.randn(c, generator=g) * 0.05)
    return model.to(resolve(device))


def available_models():
    return sorted(_REGISTRY)


__all__ = ["SemSegNet", "available_models", "get_model", "seeded_model"]
