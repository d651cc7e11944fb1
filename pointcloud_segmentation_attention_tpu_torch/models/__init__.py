"""Model registry of the port: every name of the JAX package's
``models/__init__.py``: the ScanNet segmentation family, the PointNet++
classifiers (``cls_ssg``, ``cls_msg``) and part segmenters (``part_seg``,
``part_seg_msg_one_hot``), the full attention nets (``attention_net``,
``attention_net_mlp``, ``pooling_attention_net``) and the PointNet v1
family (``pointnet1_*``); and, beyond the JAX package's names,
``point_transformer_seg`` (Point Transformer semantic segmentation,
``models/point_transformer.py``)."""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.models import pointnet1
from pointcloud_segmentation_attention_tpu_torch.models.attention_nets import (
    AttentionNetModel,
    PoolingAttentionNetModel,
)
from pointcloud_segmentation_attention_tpu_torch.models.cls import ClsMSG, ClsSSG
from pointcloud_segmentation_attention_tpu_torch.models.part_seg import (
    PartSegMSGOneHot,
    PartSegSSG,
)
from pointcloud_segmentation_attention_tpu_torch.models.point_transformer import (
    PointTransformerSeg,
)
from pointcloud_segmentation_attention_tpu_torch.models.sem_seg import SemSegNet
from pointcloud_segmentation_attention_tpu_torch.nn.layers import reset_parameters

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
# The other families: registry name -> class (ModelNet40: 40 classes;
# ShapeNet-part: 50 parts; the attention nets and the Point Transformer:
# ScanNet's 21; S3DIS: 13).
_FAMILIES = {
    "cls_ssg": ClsSSG,
    "cls_msg": ClsMSG,
    "part_seg": PartSegSSG,
    "part_seg_msg_one_hot": PartSegMSGOneHot,
    "attention_net": AttentionNetModel,
    "attention_net_mlp": functools.partial(AttentionNetModel, inner_kind="mlp"),
    "pooling_attention_net": PoolingAttentionNetModel,
    "point_transformer_seg": PointTransformerSeg,
}
# The PointNet v1 family takes the point block alone (xyz, or S3DIS's nine
# channels): ``in_features`` may be given only as 0.
_V1 = {
    "pointnet1_cls_basic": pointnet1.PointNetClsBasic,
    "pointnet1_cls": pointnet1.PointNetCls,
    "pointnet1_seg": pointnet1.PointNetSeg,
    "pointnet1_part_seg": pointnet1.PointNetPartSegJoint,
    "pointnet1_sem_seg": pointnet1.PointNetSemSeg,
}


def _single_layer_pooling(layer_idx: int):
    """Attention pooling at SA level ``layer_idx`` (0-3), max elsewhere."""
    if not 0 <= layer_idx < 4:
        raise ValueError(f"layer_idx must be in 0..3, got {layer_idx}")
    return tuple("attention" if i == layer_idx else "max" for i in range(4))


def get_model(name: str, *, device="cuda", generator: Optional[torch.Generator] = None,
              **kwargs) -> nn.Module:
    """Build a registry model with weights drawn from ``generator`` and move
    it to ``device``.  ``kwargs`` go to the model's class (``SemSegNet``
    for the sem_seg names, overriding the name's defaults; ``ClsSSG``,
    ``ClsMSG`` and the attention nets take ``num_classes``, ``in_features``
    and ``dropout_rate``; ``point_transformer_seg`` ``num_classes``
    and ``in_features`` (6 by default); the part segmenters
    ``num_classes`` and ``dropout_rate``; the PointNet v1 models their classes' arguments);
    ``sem_seg_attention_single_layer`` also takes ``layer_idx``.  Every
    name takes ``compute_dtype`` (``torch.bfloat16`` for bf16 products with
    float32 parameters and results).  An unknown name raises ``KeyError``."""
    if name not in available_models():
        raise KeyError(f"unknown model '{name}'; available: {available_models()}")
    if name in _V1:
        if kwargs.pop("in_features", 0):
            raise ValueError(f"{name} takes its point block alone: in_features must be 0")
        model = _V1[name](**kwargs)
    elif name in _FAMILIES:
        model = _FAMILIES[name](**kwargs)
    else:
        if name == "sem_seg_attention_single_layer":
            if "layer_idx" not in kwargs:
                raise TypeError(f"{name} needs layer_idx (the SA level with attention, 0-3)")
            kwargs["sa_pooling"] = _single_layer_pooling(kwargs.pop("layer_idx"))
        model = SemSegNet(**{**_REGISTRY[name], **kwargs})
    reset_parameters(model, generator)
    return model.to(resolve(device))


def seeded_model(name: str = "sem_seg_features", seed: int = 0, device="cuda",
                 **kwargs) -> nn.Module:
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
    return sorted({*_REGISTRY, *_FAMILIES, *_V1})


__all__ = ["AttentionNetModel", "ClsMSG", "ClsSSG", "PartSegMSGOneHot", "PartSegSSG",
           "PointTransformerSeg", "PoolingAttentionNetModel", "SemSegNet", "available_models",
           "get_model", "pointnet1", "seeded_model"]
