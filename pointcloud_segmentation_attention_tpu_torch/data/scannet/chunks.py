"""Full-coverage eval grid chunks and their inverse-shuffle stitch.

The port's own numpy copy of the JAX package's ``data/scannet/chunks.py``
eval chunker: a grid of ``chunk_size`` cells with a ``margin`` of context,
each cell's members shuffled into ceil(len/npoints) chunks covering every
point, the ragged tail filled with masked random repeats.  Given the same
``RandomState`` it draws the same numbers in the same order, so chunks are
identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from pointcloud_segmentation_attention_tpu_torch import native

CHUNK_SIZE = 1.5       # xy extent of a chunk/cell in meters
CONTEXT_MARGIN = 0.2   # context padding around the inner box


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


@dataclasses.dataclass
class ChunkSet:
    """Fixed-shape chunks covering a whole scene.  ``masks[x, i]`` is True
    iff slot ``i`` of chunk ``x`` is a real point whose home cell is the
    chunk's cell; every vertex is mask-True in exactly one slot."""
    points: np.ndarray              # (X, npoints, 3) float32
    features: List[np.ndarray]      # each (X, npoints, ...) in input order
    masks: np.ndarray               # (X, npoints) bool
    orig_idx: np.ndarray            # (X, npoints) int64


def full_scene_chunks(
    points: np.ndarray,
    features: Sequence[np.ndarray],
    npoints: int,
    rng: np.random.RandomState,
    chunk_size: float = CHUNK_SIZE,
    margin: float = CONTEXT_MARGIN,
) -> ChunkSet:
    """Full-coverage grid chunks with context margins.  (The JAX package's
    per-point training weights are not part of the serving path.)"""
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
    return ChunkSet(np.concatenate(out_points).astype(np.float32), feats,
                    np.concatenate(out_mask), np.concatenate(out_idx))


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
