"""A plain reference of Point Transformer semantic segmentation (Zhao et
al., ICCV 2021, arXiv:2012.09164; the published code's
``pointtransformer_seg.py``), in float32 torch ops, imported by the tests
of the port's ``point_transformer_seg``.

Written from the paper's equations and the published code, not from the
port: a full stable sort for every kNN and three-NN (ties to the lower
index), gathers by indexing, farthest-point sampling from index 0, and
BatchNorm over every axis but the channels (eps 1e-3, biased variance,
``ema = m * ema + (1 - m) * batch``: the port's BN).  The vector
attention's channel groups are spelled out as a repeat of the weights:
channel c takes weight channel c mod (C / share_planes).  Parameters are a
dict under the port's state-dict names, kernels (in, out).  It imports
torch and numpy only; ``logits`` and ``loss_and_grads`` run with TF32
off.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

BN_EPS = 1e-3
INTERPOLATION_EPS = 1e-8
_MAX_CHUNK_ELEMS = 2 ** 23  # one (B, M_chunk, N) distance tile at most


@contextlib.contextmanager
def tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, N): (dx*dx + dy*dy) + dz*dz of a - b."""
    d = a[:, :, None, :] - b[:, None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def nearest(k: int, points: torch.Tensor, queries: torch.Tensor,
            pad_far: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of each query by a full stable sort of its
    squared distances: (B, M, k) distances and int64 indices.  Past N the
    farthest repeats (``pad_far``) or the slots hold float32 max and 0."""
    b, n, _ = points.shape
    m = queries.shape[1]
    chunk = max(1, min(m, _MAX_CHUNK_ELEMS // max(b * n, 1)))
    keep = min(k, n)
    ds, ids = [], []
    for s in range(0, m, chunk):
        vals, order = torch.sort(sq_dist(queries[:, s:s + chunk], points), dim=-1, stable=True)
        ds.append(vals[..., :keep])
        ids.append(order[..., :keep])
    d, i = torch.cat(ds, dim=1), torch.cat(ids, dim=1)
    if keep < k:
        if pad_far:
            d = torch.cat([d, d[..., -1:].expand(b, m, k - keep)], dim=-1)
            i = torch.cat([i, i[..., -1:].expand(b, m, k - keep)], dim=-1)
        else:
            d = torch.cat([d, d.new_full((b, m, k - keep), torch.finfo(torch.float32).max)], -1)
            i = torch.cat([i, i.new_zeros((b, m, k - keep))], dim=-1)
    return d, i


def farthest_point_sample(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N, 3) -> (B, m) int64: start at index 0; each next point has the
    largest squared distance to the chosen set, the lowest index on ties."""
    b, n, _ = xyz.shape
    chosen = torch.zeros((b, m), dtype=torch.int64, device=xyz.device)
    mind = torch.full((b, n), 1e38, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    lane = torch.arange(n, device=xyz.device)
    last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    for j in range(1, m):
        mind = torch.minimum(mind, sq_dist(xyz[rows, last][:, None, :], xyz)[:, 0])
        best = mind.amax(dim=1, keepdim=True)
        last = torch.where(mind == best, lane, n).amin(dim=1)
        chosen[:, j] = last
    return chosen


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) -> (B, ..., C) by indexing."""
    rows = torch.arange(points.shape[0], device=points.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return points[rows, idx.long()]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _bn(p, pre: str, y: torch.Tensor, train: bool, momentum: float,
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


def _linear(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p[pre + "kernel"])
    return y + p[pre + "bias"] if pre + "bias" in p else y


def _conv(p, pre: str, x, st, bn: bool = True, relu: bool = True) -> torch.Tensor:
    """Linear (with a bias where the parameters hold one), BN, ReLU."""
    y = _linear(p, pre, x)
    if bn:
        y = _bn(p, pre + "bn.", y, *st)
    return torch.relu(y) if relu else y


def vector_attention(p, pre: str, x: torch.Tensor, rel: torch.Tensor, idx: torch.Tensor,
                     share: int, st) -> torch.Tensor:
    c = x.shape[-1]
    q = _linear(p, pre + "q.", x)
    kv = group(_linear(p, pre + "kv.", x), idx)                 # (B, N, k, 2C)
    delta = _linear(p, pre + "pos1.", _conv(p, pre + "pos0.", rel, st))
    w = torch.relu(_bn(p, pre + "w_norm.bn.", kv[..., :c] - q[:, :, None, :] + delta, *st))
    w = _linear(p, pre + "w1.", _conv(p, pre + "w0.", w, st))   # (B, N, k, C / share)
    a = torch.softmax(w, dim=2).repeat(1, 1, 1, share)          # channel c -> c mod C/share
    return ((kv[..., c:] + delta) * a).sum(dim=2)


def block(p, pre: str, x, rel, idx, share: int, st) -> torch.Tensor:
    y = _conv(p, pre + "linear1.", x, st)
    y = torch.relu(_bn(p, pre + "norm2.bn.", vector_attention(
        p, pre + "attention.", y, rel, idx, share, st), *st))
    return torch.relu(_conv(p, pre + "linear3.", y, st, relu=False) + x)


def forward(p: Dict[str, torch.Tensor], cfg: Dict, xyz: torch.Tensor,
            features: Optional[torch.Tensor], *, train: bool = False, bn_momentum: float = 0.9,
            updates: Optional[List] = None) -> torch.Tensor:
    """Logits (B, N, num_classes) of (B, N, 3) clouds with (B, N, F)
    features (None for xyz only).  ``cfg``: ``planes``, ``blocks``,
    ``nsample``, ``stride``, ``share_planes``.  In train mode BN takes batch
    statistics and appends its running updates (prefix, mean, var,
    momentum) to ``updates``."""
    st = (train, bn_momentum, updates)
    planes, nsample, stride = cfg["planes"], cfg["nsample"], cfg["stride"]
    share = cfg["share_planes"]
    pts = xyz.float()
    x = pts if features is None else torch.cat([pts, features.float()], dim=-1)
    levels = []
    for i in range(len(planes)):
        pre = f"enc{i + 1}."
        if stride[i] == 1:
            x = _conv(p, pre + "down.linear.", x, st)
        else:
            centres = group(pts, farthest_point_sample(pts, max(1, pts.shape[1] // stride[i])))
            _, idx = nearest(nsample[i], pts, centres, pad_far=True)
            g = group(torch.cat([pts, x], dim=-1), idx)
            g = torch.cat([g[..., :3] - centres[:, :, None, :], g[..., 3:]], dim=-1)
            x = _conv(p, pre + "down.linear.", g, st).amax(dim=2)
            pts = centres
        _, idx = nearest(nsample[i], pts, pts, pad_far=True)
        rel = group(pts, idx) - pts[:, :, None, :]
        for j in range(cfg["blocks"][i] - 1):
            x = block(p, f"{pre}blocks.{j}.", x, rel, idx, share, st)
        levels.append((pts, x, idx, rel))
    top = len(planes) - 1
    pts, x, idx, rel = levels[top]
    pre = f"dec{top + 1}."
    g = _conv(p, pre + "up.linear2.", x.mean(dim=1, keepdim=True), st, bn=False)
    up = _conv(p, pre + "up.linear1.", torch.cat([x, g.expand_as(x)], dim=-1), st)
    up = block(p, pre + "blocks.0.", up, rel, idx, share, st)
    for i in reversed(range(top)):
        pts, x, idx, rel = levels[i]
        pre = f"dec{i + 1}."
        fine = _conv(p, pre + "up.linear1.", x, st)
        coarse = _conv(p, pre + "up.linear2.", up, st)
        d2, near = nearest(3, levels[i + 1][0], pts, pad_far=False)
        recip = 1.0 / (torch.sqrt(d2) + INTERPOLATION_EPS)
        w = recip / recip.sum(dim=-1, keepdim=True)
        up = fine + (group(coarse, near) * w[..., None]).sum(dim=2)
        up = block(p, pre + "blocks.0.", up, rel, idx, share, st)
    return _conv(p, "fc2.", _conv(p, "fc1.", up, st), st, bn=False, relu=False)


def is_buffer(name: str) -> bool:
    """BN running statistics: state, not parameters."""
    return name.endswith("bn.mean") or name.endswith("bn.var")


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

def weighted_ce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    """sum(w * ce) / max(count(w != 0), 1)."""
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    return (ce * weights).sum() / (weights != 0).float().sum().clamp_min(1.0)


def logits(state: Dict[str, torch.Tensor], cfg: Dict, xyz, features,
           train: bool = False, bn_momentum: float = 0.9) -> torch.Tensor:
    with tf32_off(), torch.no_grad():
        return forward(state, cfg, xyz, features, train=train, bn_momentum=bn_momentum)


def loss_and_grads(state: Dict[str, torch.Tensor], cfg: Dict, batch: Dict[str, torch.Tensor],
                   bn_momentum: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """A train-mode forward of ``batch`` ('points', 'features', 'labels',
    'weights') from the state dict ``state``: the loss, each parameter's
    gradient (zeros where none flows) and the BN running statistics after
    the update."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()
              if not is_buffer(k)}
    buffers = {k: v.detach().clone() for k, v in state.items() if is_buffer(k)}
    updates: List = []
    with tf32_off():
        out = forward({**params, **buffers}, cfg, batch["points"], batch.get("features"),
                      train=True, bn_momentum=bn_momentum, updates=updates)
        loss = weighted_ce(out, batch["labels"], batch["weights"])
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: g if g is not None else torch.zeros_like(params[k]) for k, g in zip(names, grads)}
    with torch.no_grad():
        for pre, mean, var, mom in updates:
            buffers[pre + "mean"] = mom * buffers[pre + "mean"] + (1.0 - mom) * mean
            buffers[pre + "var"] = mom * buffers[pre + "var"] + (1.0 - mom) * var
    return loss.detach(), grads, buffers
