"""Scene chunkers: random training cuboids, full-coverage eval grids and
their inverse-shuffle stitch.

The port's own numpy copy of the JAX package's ``data/scannet/chunks.py``:

- ``sample_random_chunk``: a random ``chunk_size`` square (full height) with
  a ``margin`` of context, retried up to ``MAX_TRIES`` times until >= 70 %
  of its points are labelled and >= 2 % of a 31x31x62 voxel grid is
  occupied; ``npoints`` drawn with replacement; per-point weight = class
  weight x (inside the inner square).
- ``full_scene_chunks``: a grid of ``chunk_size`` cells with a ``margin``
  of context, each cell's members shuffled into ceil(len/npoints) chunks
  covering every point, the ragged tail filled with masked random repeats;
  optionally the per-point training weights; ``grid_chunks_for_eval``
  packages them as a validation chunk dict.
- ``random_z_rotation``: one random rotation of a cloud and its normals
  about z (the augmentation of precomputed training chunks).

Given the same ``RandomState`` both draw the same numbers in the same order
as the JAX package's, so their chunks are identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pointcloud_segmentation_attention_tpu_torch import native
from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import (
    TRAIN_LABEL_WEIGHTS,
)

CHUNK_SIZE = 1.5       # xy extent of a chunk/cell in meters
CONTEXT_MARGIN = 0.2   # context padding around the inner box
MIN_LABELED_FRACTION = 0.7     # validity: fraction of annotated points
MIN_VOXEL_OCCUPANCY = 0.02     # validity: occupied voxel fraction
OCCUPANCY_GRID = (31, 31, 62)  # validity voxel grid
MAX_TRIES = 10                 # retry budget of the random sampler


def check_grid_geometry(chunk_size: float, margin: float) -> None:
    """The chunker enumerates the 2x2 cell neighbourhood of a point's
    margin-shifted cell, which covers all memberships iff
    ``2*margin <= chunk_size``; anything else raises."""
    if not (chunk_size > 0):
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if margin < 0:
        raise ValueError(f"context margin must be >= 0, got {margin}")
    if 2.0 * margin > chunk_size:
        raise ValueError(
            f"context margin {margin} too large for chunk_size "
            f"{chunk_size}: the grid chunkers enumerate a 2x2 cell "
            "neighborhood, which requires 2*margin <= chunk_size"
        )


def _points_in_box(xy: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return ((xy >= lo) & (xy <= hi)).all(axis=1)


def _voxel_occupancy(pts: np.ndarray) -> float:
    """Fraction of occupied voxels of ``OCCUPANCY_GRID`` over the points' box."""
    if len(pts) == 0:
        return 0.0
    lo = pts.min(axis=0)
    extent = np.maximum(pts.max(axis=0) - lo, 1e-6)
    grid = np.array(OCCUPANCY_GRID, np.float64)
    cell = np.minimum((pts - lo) / extent * grid, grid - 1).astype(np.int64)
    flat = (cell[:, 0] * OCCUPANCY_GRID[1] + cell[:, 1]) * OCCUPANCY_GRID[2] + cell[:, 2]
    return len(np.unique(flat)) / float(np.prod(OCCUPANCY_GRID))


def sample_random_chunk(
    points: np.ndarray,
    labels: np.ndarray,
    colors: Optional[np.ndarray],
    normals: Optional[np.ndarray],
    npoints: int,
    rng: np.random.RandomState,
    weight_table: Optional[np.ndarray] = None,
    chunk_size: float = CHUNK_SIZE,
    margin: float = CONTEXT_MARGIN,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray], np.ndarray]:
    """A random training cuboid: ``(points, labels, colors, normals,
    weights)`` with exactly ``npoints`` rows; colors/normals stay None when
    absent.  ``weights[i] = weight_table[labels[i]] * (point i inside the
    inner square)``; ``weight_table`` defaults to ``TRAIN_LABEL_WEIGHTS``.
    A scene where no try finds a point falls back to all of it."""
    if weight_table is None:
        weight_table = TRAIN_LABEL_WEIGHTS
    xy = points[:, :2]
    half = chunk_size / 2.0
    sel = None
    inner = None
    for _ in range(MAX_TRIES):
        center = xy[rng.randint(len(points))]
        lo, hi = center - half, center + half
        cand = np.flatnonzero(_points_in_box(xy, lo - margin, hi + margin))
        if len(cand) == 0:
            continue
        sel = cand
        inner = _points_in_box(xy[cand], lo, hi)
        if float((labels[cand] > 0).mean()) < MIN_LABELED_FRACTION:
            continue
        if _voxel_occupancy(points[cand]) < MIN_VOXEL_OCCUPANCY:
            continue
        break
    if sel is None:
        sel = np.arange(len(points))
        inner = np.ones(len(points), bool)

    take = rng.choice(len(sel), npoints, replace=True)
    idx = sel[take]
    weights = (weight_table[labels[idx]] * inner[take]).astype(np.float32)
    return (
        points[idx].astype(np.float32),
        labels[idx].astype(np.int32),
        colors[idx] if colors is not None else None,
        normals[idx].astype(np.float32) if normals is not None else None,
        weights,
    )


@dataclasses.dataclass
class ChunkSet:
    """Fixed-shape chunks covering a whole scene.  ``masks[x, i]`` is True
    iff slot ``i`` of chunk ``x`` is a real point whose home cell is the
    chunk's cell; every vertex is mask-True in exactly one slot."""
    points: np.ndarray              # (X, npoints, 3) float32
    features: List[np.ndarray]      # each (X, npoints, ...) in input order
    masks: np.ndarray               # (X, npoints) bool
    orig_idx: np.ndarray            # (X, npoints) int64
    weights: Optional[np.ndarray] = None  # (X, npoints) float32, if asked for


def full_scene_chunks(
    points: np.ndarray,
    features: Sequence[np.ndarray],
    npoints: int,
    rng: np.random.RandomState,
    chunk_size: float = CHUNK_SIZE,
    margin: float = CONTEXT_MARGIN,
    *,
    get_sample_weights: bool = False,
    weight_table: Optional[np.ndarray] = None,
) -> ChunkSet:
    """Full-coverage grid chunks with context margins.  With
    ``get_sample_weights``, ``features[0]`` must be the per-point labels and
    ``weights = weight_table[label] * mask`` (``weight_table`` defaults to
    ``TRAIN_LABEL_WEIGHTS``); the random draws are the same either way."""
    check_grid_geometry(chunk_size, margin)
    xy = points[:, :2]
    cells, pids, ncx, ncy = native.grid_chunk_assign(
        points, cell=chunk_size, margin=margin)
    # Home cell of every point (boundary points clip into the last cell).
    xy_min = xy.min(axis=0)
    home = np.minimum((xy - xy_min) // chunk_size, [ncx - 1, ncy - 1]).astype(np.int64)
    home_id = home[:, 0] * ncy + home[:, 1]

    sort = np.argsort(cells, kind="stable")
    cells_s, pids_s = cells[sort], pids[sort]
    uniq, starts = np.unique(cells_s, return_index=True)
    bounds = np.append(starts, len(cells_s))

    out_points, out_feats, out_mask, out_idx = [], [], [], []
    for ui, cid in enumerate(uniq):
        member = pids_s[bounds[ui]:bounds[ui + 1]]
        inner = home_id[member] == cid
        if not inner.any():
            continue  # margin-only cell: its points are inner elsewhere
        order = rng.permutation(len(member))
        n_chunks = -(-len(member) // npoints)
        pad = n_chunks * npoints - len(member)
        fill = rng.randint(0, len(member), pad)
        seq = np.concatenate([order, fill])
        mask_seq = np.concatenate([inner[order], np.zeros(pad, bool)])
        orig = member[seq]
        out_points.append(points[orig].reshape(n_chunks, npoints, 3))
        out_feats.append([np.asarray(f)[orig].reshape((n_chunks, npoints)
                                                      + np.asarray(f).shape[1:])
                          for f in features])
        out_mask.append(mask_seq.reshape(n_chunks, npoints))
        out_idx.append(orig.reshape(n_chunks, npoints).astype(np.int64))

    feats = [np.concatenate([c[i] for c in out_feats]) for i in range(len(features))]
    masks = np.concatenate(out_mask)
    weights = None
    if get_sample_weights:
        table = TRAIN_LABEL_WEIGHTS if weight_table is None else weight_table
        weights = (table[feats[0].astype(np.int64)] * masks).astype(np.float32)
    return ChunkSet(np.concatenate(out_points).astype(np.float32), feats, masks,
                    np.concatenate(out_idx), weights)


def map_back(
    values: np.ndarray,
    orig_idx: np.ndarray,
    masks: np.ndarray,
    num_vertices: int,
    fill_value=0,
) -> np.ndarray:
    """Inverse-shuffle scatter of chunked per-point values back to original
    vertex order; uncovered vertices get ``fill_value``."""
    values = np.asarray(values)
    out = np.full((num_vertices,) + values.shape[2:], fill_value, values.dtype)
    flat_idx = np.asarray(orig_idx).reshape(-1)
    flat_mask = np.asarray(masks).reshape(-1).astype(bool)
    out[flat_idx[flat_mask]] = values.reshape((-1,) + values.shape[2:])[flat_mask]
    return out


def grid_chunks_for_eval(
    points: np.ndarray,
    labels: np.ndarray,
    colors: np.ndarray,
    normals: np.ndarray,
    npoints: int,
    rng: Optional[np.random.RandomState] = None,
    chunk_size: float = CHUNK_SIZE,
    margin: float = CONTEXT_MARGIN,
) -> Dict[str, np.ndarray]:
    """Validation chunks: ``full_scene_chunks`` with training weights, as a
    dict of points, labels (int32), colors, normals (f32), weights, masks
    and orig_idx.  ``rng`` defaults to ``RandomState(0)``."""
    rng = rng if rng is not None else np.random.RandomState(0)
    cs = full_scene_chunks(points, [labels, colors, normals], npoints=npoints, rng=rng,
                           chunk_size=chunk_size, margin=margin, get_sample_weights=True)
    return {
        "points": cs.points,
        "labels": cs.features[0].astype(np.int32),
        "colors": cs.features[1],
        "normals": cs.features[2].astype(np.float32),
        "weights": cs.weights,
        "masks": cs.masks,
        "orig_idx": cs.orig_idx,
    }


def random_z_rotation(points: np.ndarray, normals: Optional[np.ndarray],
                      rng: np.random.RandomState
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Rotate a cloud and its normals by one random angle about z."""
    a = rng.uniform() * 2 * np.pi
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return points @ rot, (normals @ rot if normals is not None else None)
