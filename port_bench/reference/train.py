"""The plain reference of a sampler training step: the chunk draw of the
reference project's random training cuboid, the weighted cross entropy,
one Adam update and the BatchNorm running statistics.

- The chunk draw follows ``sample_random_chunk``'s semantics (a random
  centre vertex, a 1.5 m box with a 0.2 m context margin, up to 10 tries
  for a box whose candidates are >= 70 % labelled and occupy >= 2 % of a
  31 x 31 x 62 voxel grid; the last tried box with candidates when no try
  passes; ``npoints`` drawn with replacement; weight = class weight x
  inside the inner box), with the random numbers of the program's own
  stream (``draws``), which the benchmark makes again from the seed.  The
  candidates are taken over the whole room; the voxel grid is anchored at
  the room (cells of (1.5 + 0.4) / 31 m in xy, the room's height / 62 in
  z) and the draw walks the candidates in the room's voxel order, so that
  equal random numbers pick equal vertices.
- The loss is TF's ``SUM_BY_NONZERO_WEIGHTS``: sum(w * ce) / max(count(w
  != 0), 1).
- Adam: b1 0.9, b2 0.999, eps 1e-8, bias-corrected, the learning rate of
  the step before it is counted.
- The schedules are the reference trainer's staircase decays in float32.

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference import model as M

CHUNK = 1.5
MARGIN = 0.2
MAX_TRIES = 10
MIN_LABELED = np.float32(0.7)
MIN_OCCUPANCY = np.float32(0.02)
GRID = (31, 31, 62)
N_VOXELS = GRID[0] * GRID[1] * GRID[2]
STRIPE_CELLS = GRID[0] + 2
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# ScanNet class weights 1/log(1.2 + freq), class 0 = 0 (the reference trainer's).
CLASS_WEIGHTS = np.array((
    0.0, 2.743064592944318, 3.0830506790927132, 4.785754459526457,
    4.9963745147506184, 4.372710774561782, 5.039124880965811, 4.86451825464344,
    4.717751595568025, 4.809412839311939, 5.052097251455304, 5.389129668645318,
    5.390614085649042, 5.127458225110977, 5.086056870814752, 5.3831185190895265,
    5.422684124268539, 5.422955391988761, 5.433705358072363, 5.417426773812747,
    4.870172044153657), np.float64).astype(np.float32)


def _decay(step: int, base: float, rate: float, decay_step: float, batch: int) -> np.float32:
    e = np.floor(np.float32(step) * np.float32(batch) / np.float32(decay_step))
    return np.float32(base) * np.power(np.float32(rate), np.float32(e))


def learning_rate(step: int, batch: int, n_scenes: int) -> float:
    return float(np.maximum(_decay(step, 1e-3, 0.7, n_scenes * 80, batch), np.float32(1e-5)))


def bn_momentum(step: int, batch: int, n_scenes: int) -> float:
    m = _decay(step, 0.5, 0.5, n_scenes * 80, batch)
    return float(np.minimum(np.float32(0.99), np.float32(1.0) - m))


# ---------------------------------------------------------------------------
# The chunk draw
# ---------------------------------------------------------------------------

class Room:
    """A room in its voxel order: x-cell first, then y-cell, then z-cell."""

    def __init__(self, room: Dict[str, np.ndarray]):
        pts = np.asarray(room["points"], np.float32)
        lo = pts.min(axis=0)
        cxy = (CHUNK + 2 * MARGIN) / GRID[0]
        cz = max(float(pts[:, 2].max() - lo[2]), 1e-6) / GRID[2]
        vx = np.floor((pts[:, 0] - lo[0]) / cxy).astype(np.int64)
        vy = np.floor((pts[:, 1] - lo[1]) / cxy).astype(np.int64)
        vz = np.minimum((pts[:, 2] - lo[2]) / cz, GRID[2] - 1).astype(np.int64)
        vid = (vx * (vy.max() + 1) + vy) * GRID[2] + vz
        order = np.argsort(vid, kind="stable")
        self.n = len(pts)
        self.points = pts[order]
        self.labels = np.asarray(room["labels"], np.int32)[order]
        self.colors = np.asarray(room["colors"], np.uint8)[order]
        self.normals = np.asarray(room["normals"], np.float32)[order]
        self.vid = vid[order]
        self.vx = vx[order]
        self.x_min = pts[:, 0].min()
        counts = np.bincount(self.vx)
        prefix = np.concatenate([[0], np.cumsum(counts)])
        w = min(STRIPE_CELLS, len(counts))
        self.stripe = int((prefix[w:] - prefix[:-w]).max()) if len(prefix) > w else self.n


def stripe_len(rooms: Sequence[Room]) -> int:
    """Rows the draw walks from its stripe start: the largest population of
    33 consecutive x-cells, rounded up to 1024, at most the largest room."""
    raw = max(r.stripe for r in rooms)
    return min(max(r.n for r in rooms), -(-raw // 1024) * 1024)


def draw_chunk(room: Room, centres: np.ndarray, u: np.ndarray, sub_len: int,
               use_colors: bool, use_normals: bool) -> Dict[str, np.ndarray]:
    """One training chunk of ``room`` from ten centre draws (indices into
    the voxel order) and ``npoints`` uniforms in [0, 1)."""
    xy = room.points[:, :2]
    half, margin = np.float32(CHUNK / 2), np.float32(MARGIN)
    recip_cxy = np.float32(1.0) / np.float32((CHUNK + 2 * MARGIN) / GRID[0])
    recip_vox = np.float32(1.0) / np.float32(N_VOXELS)
    kept = None
    for t in range(MAX_TRIES):
        centre = xy[int(centres[t])]
        lo, hi = centre - half, centre + half
        cand = np.all((xy >= lo - margin) & (xy <= hi + margin), axis=1)
        n_cand = int(cand.sum())
        if n_cand == 0:
            continue
        kept = (lo, hi, cand)
        labeled = np.float32(int((cand & (room.labels > 0)).sum())) / np.float32(n_cand)
        occupancy = np.float32(len(np.unique(room.vid[cand]))) * recip_vox
        if labeled >= MIN_LABELED and occupancy >= MIN_OCCUPANCY:
            break
    if kept is not None:
        lo, hi, cand = kept
        target = np.floor((lo[0] - margin - room.x_min) * recip_cxy)
        start = int(np.searchsorted(room.vx, np.int64(target), side="left"))
    else:
        start = 0
    rows = np.arange(start, start + sub_len)
    valid = rows < room.n
    rows_c = np.minimum(rows, room.n - 1)
    in_stripe = (cand[rows_c] & valid) if kept is not None else valid
    cdf = np.cumsum(in_stripe).astype(np.float32)
    take = np.searchsorted(cdf, u.astype(np.float32) * cdf[-1], side="left")
    take = np.clip(take, 0, sub_len - 1)
    picked = np.minimum(start + take, room.n - 1)
    points = room.points[picked]
    labels = room.labels[picked]
    if kept is not None:
        pxy = points[:, :2]
        inner = np.all((pxy >= lo) & (pxy <= hi), axis=1) & in_stripe[take]
    else:
        inner = valid[take]
    out = {"points": points, "labels": labels,
           "weights": CLASS_WEIGHTS[labels] * inner.astype(np.float32)}
    parts = []
    if use_colors:
        parts.append(room.colors[picked].astype(np.float32) / np.float32(255.0))
    if use_normals:
        parts.append(room.normals[picked])
    if parts:
        out["features"] = np.concatenate(parts, axis=1).astype(np.float32)
    return out


def draw_batch(rooms: Sequence[Room], ids: np.ndarray, centres: np.ndarray, u: np.ndarray,
               sub_len: int, use_colors: bool, use_normals: bool, device
               ) -> Dict[str, torch.Tensor]:
    chunks = [draw_chunk(rooms[int(s)], centres[b], u[b], sub_len, use_colors, use_normals)
              for b, s in enumerate(ids)]
    return {k: torch.from_numpy(np.stack([c[k] for c in chunks])).to(device)
            for k in chunks[0]}


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def weighted_ce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    ce = logz - logits.gather(-1, labels.long()[..., None])[..., 0]
    return (ce * weights).sum() / (weights != 0).float().sum().clamp_min(1.0)


class Trainer:
    """Parameters, BN statistics and Adam moments of the reference model;
    ``step`` makes one update and returns the loss and the gradients."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict, batch: int,
                 n_schedule_scenes: int):
        self.cfg = cfg
        self.batch = batch
        self.n_sched = n_schedule_scenes
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in weights.items() if not M.is_buffer(k)}
        self.buffers = {k: v.detach().clone() for k, v in weights.items() if M.is_buffer(k)}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0

    def state(self) -> Dict[str, torch.Tensor]:
        return {**{k: v.detach() for k, v in self.params.items()}, **self.buffers}

    def step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             visits=None, drop_rows: int = 0) -> Tuple[float, Dict[str, torch.Tensor]]:
        """``drop_rows`` > 0 leaves out the batch's last rows (a fault the
        checks are shown to catch)."""
        if drop_rows:
            batch = {k: v[:-drop_rows] for k, v in batch.items()}
        momentum = bn_momentum(self.count, self.batch, self.n_sched)
        updates: List = []
        logits = M.forward({**self.params, **self.buffers}, self.cfg, batch["points"],
                           batch.get("features"), train=True, bn_momentum=momentum,
                           generator=generator, updates=updates, visits=visits)
        loss = weighted_ce(logits, batch["labels"], batch["weights"])
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(self.params[k]))
                 for k, g in zip(names, grads)}
        lr = learning_rate(self.count, self.batch, self.n_sched)
        t = self.count + 1
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                self.v[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                m_hat = self.m[k] / (1 - ADAM_B1 ** t)
                v_hat = self.v[k] / (1 - ADAM_B2 ** t)
                self.params[k].sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
            for pre, mean, var, mom in updates:
                self.buffers[pre + "mean"].copy_(mom * self.buffers[pre + "mean"]
                                                 + (1.0 - mom) * mean)
                self.buffers[pre + "var"].copy_(mom * self.buffers[pre + "var"]
                                                + (1.0 - mom) * var)
        self.count += 1
        return float(loss.detach()), grads
