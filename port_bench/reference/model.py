"""The plain reference of the segmentation models: PointNet++ semantic
segmentation (Qi et al., arXiv:1706.02413) with a max or an attention
pooling at each set-abstraction level, as a function of a parameter dict.

Written from the reference project's description (the configuration
files name it), in plain float32 PyTorch over ``reference/geometry.py``;
it imports nothing of the program.  The parameter names are the state-dict
names of the program's ``SemSegNet`` (``sa1.mlp.conv0.kernel``, ...), so
that the benchmark can hand the same weights to both.  Kernels are (in,
out); BatchNorm has eps 1e-3, a biased variance and the running update
``ema = m * ema + (1 - m) * batch``; the attention pooling is the
reference project's (a raw row-major head split, the query the group's
first member, no output projection, then a BatchNorm).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from port_bench.reference import geometry as G

BN_EPS = 1e-3


def _bn(p: Dict[str, torch.Tensor], pre: str, y: torch.Tensor, train: bool, momentum: float,
        updates: Optional[List]) -> torch.Tensor:
    if train:
        axes = tuple(range(y.dim() - 1))
        mean = y.mean(dim=axes)
        var = y.var(dim=axes, unbiased=False)
        if updates is not None:
            updates.append((pre, mean.detach(), var.detach(), momentum))
    else:
        mean, var = p[pre + "mean"], p[pre + "var"]
    return (y - mean) * (torch.rsqrt(var + BN_EPS) * p[pre + "scale"]) + p[pre + "bias"]


def _conv(p, pre: str, x: torch.Tensor, train: bool, momentum: float, updates,
          bn: bool = True, relu: bool = True) -> torch.Tensor:
    y = torch.matmul(x, p[pre + "kernel"]) + p[pre + "bias"]
    if bn:
        y = _bn(p, pre + "bn.", y, train, momentum, updates)
    return torch.relu(y) if relu else y


def _mlp(p, pre: str, x, n_layers: int, train, momentum, updates):
    for j in range(n_layers):
        x = _conv(p, f"{pre}conv{j}.", x, train, momentum, updates)
    return x


def _dense(p, pre: str, x):
    return torch.matmul(x, p[pre + "kernel"]) + p[pre + "bias"]


def _attention_pool(p, pre: str, group: torch.Tensor, key_dim: int) -> torch.Tensor:
    b, npoint, nsample, c = group.shape
    heads = c // key_dim
    q = _dense(p, pre + "query_net.", group[:, :, :1, :]).reshape(b, npoint, heads, 1, key_dim)
    k = _dense(p, pre + "key_net.", group).reshape(b, npoint, heads, nsample, key_dim)
    v = _dense(p, pre + "value_net.", group).reshape(b, npoint, heads, nsample, key_dim)
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(key_dim)
    return torch.matmul(torch.softmax(logits, dim=-1), v).reshape(b, npoint, heads * key_dim)


def forward(p: Dict[str, torch.Tensor], cfg: Dict, xyz: torch.Tensor,
            features: Optional[torch.Tensor], *, train: bool = False, bn_momentum: float = 0.9,
            generator: Optional[torch.Generator] = None, updates: Optional[List] = None,
            visits: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Logits (B, N, num_classes) of a (B, N, 3) cloud with (B, N, K)
    features (None for xyz only).  In train mode BN takes batch statistics
    (their running updates are appended to ``updates``) and the head's
    dropout draws one ``torch.rand`` of its input's shape from
    ``generator``.  ``visits`` collects, a level, the points each ball
    query has to visit (up to its nsample-th hit): the data-dependent
    work of the cost model."""
    xyzs, feats = [xyz], [features]
    for i in range(4):
        x, f = xyzs[-1], feats[-1]
        npoint, radius, ns = cfg["sa_npoints"][i], cfg["sa_radii"][i], cfg["sa_nsample"]
        new_xyz = G.gather_point(x, G.farthest_point_sample(x, npoint))
        idx, cnt = G.ball_query(x, new_xyz, radius, ns)
        if visits is not None:
            n = x.shape[1]
            seen = torch.where(cnt == ns, idx[..., -1].long() + 1, torch.full_like(cnt, n).long())
            visits[f"SA{i + 1}"] = visits.get(f"SA{i + 1}", 0.0) + float(seen.sum())
        centre = new_xyz[:, :, None, :]
        if f is not None:
            grouped = G.group_point(torch.cat([x, f], dim=-1), idx)
            group = torch.cat([grouped[..., :3] - centre, grouped[..., 3:]], dim=-1)
        else:
            group = G.group_point(x, idx) - centre
        pre = f"sa{i + 1}."
        group = _mlp(p, pre + "mlp.", group, len(cfg["sa_mlps"][i]), train, bn_momentum, updates)
        if cfg["sa_pooling"][i] == "max":
            pooled = group.amax(dim=2)
        elif cfg["sa_pooling"][i] == "attention":
            att = _attention_pool(p, pre + "attention_pool.", group,
                                  cfg["attention"]["key_dim"])
            pooled = _bn(p, pre + "attention_bn.", att, train, bn_momentum, updates)
        else:
            raise ValueError(f"pooling {cfg['sa_pooling'][i]!r} has no reference")
        xyzs.append(new_xyz)
        feats.append(pooled)
    up = feats[4]
    for i in range(4):
        lvl = 3 - i
        dist, idx = G.three_nn(xyzs[lvl], xyzs[lvl + 1])
        interp = G.three_interpolate(up, idx, G.interpolation_weights(dist))
        if feats[lvl] is not None:
            interp = torch.cat([interp, feats[lvl]], dim=-1)
        up = _mlp(p, f"fp{i + 1}.mlp.", interp, len(cfg["fp_mlps"][i]), train, bn_momentum,
                  updates)
    net = _conv(p, "fc1.", up, train, bn_momentum, updates)
    if train and cfg["dropout"] > 0:
        keep = 1.0 - cfg["dropout"]
        u = torch.rand(net.shape, generator=generator, device=net.device)
        net = torch.where(u < keep, net / keep, torch.zeros_like(net))
    return _conv(p, "fc2.", net, train, bn_momentum, updates, bn=False, relu=False)


def is_buffer(name: str) -> bool:
    """BN running statistics: state, not parameters."""
    return name.endswith("bn.mean") or name.endswith("bn.var")
