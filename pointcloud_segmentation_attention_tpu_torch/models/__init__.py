"""Model registry of the port: the names ported so far (the JAX package's
``models/__init__.py`` names of the ScanNet segmentation family)."""
from __future__ import annotations

from typing import Optional

import torch

from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.models.sem_seg import SemSegNet

# Registry name -> SemSegNet arguments: the per-point input feature width
# (colors + normals = 6; the attention variants are fed xyz only, as the
# reference's attention ablation ran them) and the SA poolings.
_REGISTRY = {
    "sem_seg": dict(in_features=0),
    "sem_seg_features": dict(in_features=6),
    "sem_seg_attention": dict(in_features=0, sa_pooling=("attention",) * 4),
    "sem_seg_attention_single_layer": dict(in_features=0),  # pooling from layer_idx
    "sem_seg_attention_and_pooling": dict(in_features=0, sa_pooling=("attention_and_pool",) * 4),
}


def _single_layer_pooling(layer_idx: int):
    """Attention pooling at SA level ``layer_idx`` (0-3), max elsewhere."""
    if not 0 <= layer_idx < 4:
        raise ValueError(f"layer_idx must be in 0..3, got {layer_idx}")
    return tuple("attention" if i == layer_idx else "max" for i in range(4))


def get_model(name: str, *, device="cuda", generator: Optional[torch.Generator] = None,
              **kwargs) -> SemSegNet:
    """Build a registry model with weights drawn from ``generator`` and move
    it to ``device``.  ``kwargs`` go to ``SemSegNet`` and override the
    name's defaults; ``sem_seg_attention_single_layer`` also takes
    ``layer_idx``.  Names of later slices raise ``KeyError``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown or not yet ported model '{name}'; "
                       f"available: {sorted(_REGISTRY)}")
    if name == "sem_seg_attention_single_layer":
        if "layer_idx" not in kwargs:
            raise TypeError(f"{name} needs layer_idx (the SA level with attention, 0-3)")
        kwargs["sa_pooling"] = _single_layer_pooling(kwargs.pop("layer_idx"))
    model = SemSegNet(**{**_REGISTRY[name], **kwargs})
    model.reset_parameters(generator)
    return model.to(resolve(device))


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
