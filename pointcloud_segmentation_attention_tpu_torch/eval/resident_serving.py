"""Resident-scene serving: one upload and one label fetch per scene.

The host serving path (``eval/full_scene.py``) chunks each scene with numpy
and copies every chunk batch to the card.  Here a scene crosses to the card
once, as a single packed u8 buffer (q16: 12 B/point), and everything else
happens there, as plain tensor ops:

- the full-coverage grid chunker (``make_scene_chunker``, the card's twin of
  ``chunks.full_scene_chunks``) in two phases: ``_chunk_runs`` groups the
  (cell, hash, point) membership entries by ONE sort and counts the chunks;
  ``_chunk_table`` extracts the kept-cell table by a top-k and turns chunk
  slots into point ids by small table arithmetic plus one gather;
- the chunk batches gather their points and features from the decoded
  scene and run the eval forward (``make_resident_predict_step``, the
  kernels through ``ops/dispatch.py``);
- the argmaxed labels go back to vertex order by one scatter
  (``make_stitch``): every vertex is mask-True exactly once;
- the server stages a scene on a thread of its own (pack, upload, decode,
  phase 1), reads the card's chunk count back (one 0-dim copy), and lays the
  chunks out for exactly the predict batches that count needs (phase 2);
  the forwards and the stitch are one call per scene
  (``make_scene_program``) that queues its work without a host sync; the
  labels come back as u8.

Chunk composition is deterministic (a keyed integer hash replaces the host
chunker's ``rng.permutation``, modulo fill replaces its random tail fill)
and is reproduced bit for bit by the numpy twin
``deterministic_scene_chunks``, so the stitched labels equal the host path
fed the same chunks.

The port's own copy of the JAX package's ``eval/resident_serving.py``: the
host twins and the packed layouts give the same bytes and chunks, the card
side gives the same chunks as its ``make_scene_chunker``.  (JAX's server
counts the chunks on the host and compiles the decode, the chunker and the
forwards into one program; here the card counts them.)  ``mesh=`` serves
a scene per device (``make_scene_program_mesh``): groups of one scene a
lane share a bucket, each lane runs the single-device program on its own
device with its own model replica, and there are no collectives, so the
labels equal the single-device server's bit for bit.
"""
from __future__ import annotations

import contextlib
import os
from collections import deque
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.data.pipeline import prefetch
from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import (
    CHUNK_SIZE,
    CONTEXT_MARGIN,
    ChunkSet,
    check_grid_geometry,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import load_scene_mapped
from pointcloud_segmentation_attention_tpu_torch.data.wire import exact_div
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.eval.benchmark import export_benchmark_txt
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import as_mesh, lane_replicas
from pointcloud_segmentation_attention_tpu_torch.train.steps import seg_predict_step
from pointcloud_segmentation_attention_tpu_torch.utils import profiler

_HASH_MULT = np.uint32(2654435761)      # Knuth multiplicative
_NO_CELL = 2**31 - 1                    # sort key of a non-member entry, past every cell


def _hash32(pid, seed: int):
    """Deterministic uint32 hash of a point id: the shared 'shuffle' key of
    the host twin and the card's chunker (``_hash32_torch``)."""
    h = (pid.astype(np.uint32) + np.uint32(seed * 7919 + 1)) * _HASH_MULT
    return h ^ (h >> np.uint32(16))


def _hash32_torch(pid: torch.Tensor, seed: int) -> torch.Tensor:
    """``_hash32`` in int64 tensor ops, bit for bit, on ``pid``'s device.
    Torch's uint32 has few ops and an int64 product of two 32-bit values
    can pass 2^63, so the multiply is split into 16-bit halves of the
    multiplier, each product below 2^48."""
    mask32 = 0xFFFFFFFF
    mult = int(_HASH_MULT)
    a = (pid.to(torch.int64) + (seed * 7919 + 1)) & mask32
    h = (a * (mult & 0xFFFF) + (((a * (mult >> 16)) & 0xFFFF) << 16)) & mask32
    return h ^ (h >> 16)


def _grid_dims(xy: np.ndarray, chunk_size: float = CHUNK_SIZE
               ) -> Tuple[np.ndarray, int, int]:
    # f32 division, as on the card (a f64 division could round ceil()
    # differently on extents that are near-multiples of the cell size).
    mn = xy.min(axis=0)
    ext = (xy.max(axis=0) - mn).astype(np.float32)
    ncx = max(1, int(np.ceil(ext[0] / np.float32(chunk_size))))
    ncy = max(1, int(np.ceil(ext[1] / np.float32(chunk_size))))
    return mn, ncx, ncy


def _memberships_np(xy: np.ndarray, mn, ncx: int, ncy: int,
                    chunk_size: float = CHUNK_SIZE, margin: float = CONTEXT_MARGIN):
    """(N, 4) membership enumeration: the 2x2 cells whose margin-enlarged box
    can contain the point (2*margin <= cell).  Returns (cell_id, member,
    home_id) with cell ids int64."""
    rel = xy - mn
    lo = np.floor((rel - margin) / chunk_size).astype(np.int64)
    home = np.minimum(np.floor(rel / chunk_size).astype(np.int64), [ncx - 1, ncy - 1])
    home = np.maximum(home, 0)
    home_id = home[:, 0] * ncy + home[:, 1]
    cxs, cys, members = [], [], []
    # Box arithmetic in f32 with the card's op order (cast-int * size -
    # margin, then + width), so the margin boundaries are bit-identical.
    chunk_f = np.float32(chunk_size)
    margin_f = np.float32(margin)
    width_f = np.float32(chunk_size + 2 * margin)
    for dx in (0, 1):
        for dy in (0, 1):
            cx = lo[:, 0] + dx
            cy = lo[:, 1] + dy
            box_lo_x = cx.astype(np.float32) * chunk_f - margin_f
            box_lo_y = cy.astype(np.float32) * chunk_f - margin_f
            member = ((cx >= 0) & (cx < ncx) & (cy >= 0) & (cy < ncy)
                      & (rel[:, 0] >= box_lo_x) & (rel[:, 0] < box_lo_x + width_f)
                      & (rel[:, 1] >= box_lo_y) & (rel[:, 1] < box_lo_y + width_f))
            cxs.append(cx)
            cys.append(cy)
            members.append(member)
    cell_id = np.stack(cxs, 1) * ncy + np.stack(cys, 1)       # (N, 4)
    return cell_id, np.stack(members, 1), home_id


def chunk_count(points: np.ndarray, npoints: int, chunk_size: float = CHUNK_SIZE,
                margin: float = CONTEXT_MARGIN) -> int:
    """Exact number of full-coverage chunks of a scene, from bincounts on the
    host, so the server knows how many predict batches to queue without
    waiting for the card's chunker."""
    check_grid_geometry(chunk_size, margin)
    xy = points[:, :2].astype(np.float32)
    mn, ncx, ncy = _grid_dims(xy, chunk_size)
    cell_id, member, home_id = _memberships_np(xy, mn, ncx, ncy, chunk_size, margin)
    n_cells = ncx * ncy
    member_counts = np.bincount(cell_id[member], minlength=n_cells)
    home_counts = np.bincount(home_id, minlength=n_cells)
    kept = home_counts > 0
    return int(np.sum(-(-member_counts[kept] // npoints)))


def deterministic_scene_chunks(
    points: np.ndarray,
    features: Sequence[np.ndarray],
    npoints: int,
    seed: int = 0,
    chunk_size: float = CHUNK_SIZE,
    margin: float = CONTEXT_MARGIN,
) -> ChunkSet:
    """Numpy twin of the card's chunker: the contract of
    ``chunks.full_scene_chunks`` (every vertex mask-True exactly once) with
    the hash order and modulo tail fill, so the chunks are bit-identical to
    ``make_scene_chunker``'s."""
    check_grid_geometry(chunk_size, margin)
    xy = points[:, :2].astype(np.float32)
    mn, ncx, ncy = _grid_dims(xy, chunk_size)
    cell_id, member, home_id = _memberships_np(xy, mn, ncx, ncy, chunk_size, margin)
    pid = np.broadcast_to(np.arange(len(points), dtype=np.int64)[:, None], cell_id.shape)
    cells_f = cell_id[member]
    pids_f = pid[member]
    h = _hash32(pids_f, seed).astype(np.int64)
    order = np.lexsort((pids_f, h, cells_f))
    cells_s, pids_s = cells_f[order], pids_f[order]
    is_home_s = home_id[pids_s] == cells_s

    uniq, starts = np.unique(cells_s, return_index=True)
    bounds = np.append(starts, len(cells_s))
    out_points, out_feats, out_mask, out_idx = [], [], [], []
    for ui in range(len(uniq)):
        s, e = bounds[ui], bounds[ui + 1]
        members_c = pids_s[s:e]
        inner_c = is_home_s[s:e]
        if not inner_c.any():
            continue  # margin-only cell: its points are inner elsewhere
        length = e - s
        n_chunks = -(-length // npoints)
        t = np.arange(n_chunks * npoints) % length     # modulo tail fill
        orig = members_c[t]
        mask_seq = (np.arange(n_chunks * npoints) < length) & inner_c[t]
        out_points.append(points[orig].reshape(n_chunks, npoints, 3))
        out_feats.append([np.asarray(f)[orig].reshape((n_chunks, npoints)
                                                      + np.asarray(f).shape[1:])
                          for f in features])
        out_mask.append(mask_seq.reshape(n_chunks, npoints))
        out_idx.append(orig.reshape(n_chunks, npoints))
    return ChunkSet(
        np.concatenate(out_points).astype(np.float32),
        [np.concatenate([c[i] for c in out_feats]) for i in range(len(features))],
        np.concatenate(out_mask),
        np.concatenate(out_idx).astype(np.int64),
        None,
    )


# ---------------------------------------------------------------------------
# Packed scene buffers (one host-to-device copy per scene)
# ---------------------------------------------------------------------------

class SceneLayout:
    """Static description of the packed resident scene buffer.

    q16: header (8 f32: mn[3], mx[3], pad) + xyz u16 + colors u8 + normals
    i8, 12 B/point.  f32: xyz f32 + colors u8 + normals f32 (27 B/point),
    the bit-exact layout of the parity checks.
    """

    def __init__(self, layout: str, n_pad: int, use_colors: bool = True,
                 use_normals: bool = True):
        if layout not in ("q16", "f32"):
            raise ValueError(f"unknown scene layout {layout!r}")
        self.layout = layout
        self.n_pad = n_pad
        self.use_colors = use_colors
        self.use_normals = use_normals

    @property
    def header_nbytes(self) -> int:
        return 32 if self.layout == "q16" else 0

    @property
    def nbytes(self) -> int:
        n = self.n_pad
        size = self.header_nbytes + (6 if self.layout == "q16" else 12) * n
        if self.use_colors:
            size += 3 * n
        if self.use_normals:
            size += (3 if self.layout == "q16" else 12) * n
        return size

    def pack(self, points: np.ndarray, colors: Optional[np.ndarray],
             normals: Optional[np.ndarray]) -> np.ndarray:
        """Scene arrays -> one u8 buffer (points padded to n_pad with the
        first point, so padding never lands outside the scene's bbox)."""
        n, n_pad = len(points), self.n_pad
        if n > n_pad:
            raise ValueError(f"scene has {n} points > n_pad {n_pad}")

        def padded(a, dt):
            a = np.asarray(a)
            out = np.empty((n_pad,) + a.shape[1:], dt)
            out[:n] = a
            out[n:] = a[:1] if n else 0
            return out

        buf = np.empty(self.nbytes, np.uint8)
        off = 0

        def put(a):
            nonlocal off
            raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
            buf[off:off + raw.size] = raw
            off += raw.size

        pts = padded(points, np.float32)
        if self.layout == "q16":
            mn, mx = pts.min(0), pts.max(0)
            header = np.zeros(8, np.float32)
            header[:3], header[3:6] = mn, mx
            put(header)
            scale = np.where(mx > mn, mx - mn, 1.0)
            put(np.clip(np.rint((pts - mn) / scale * 65535.0), 0, 65535).astype(np.uint16))
        else:
            put(pts)
        if self.use_colors:
            put(padded(colors, np.uint8))
        if self.use_normals:
            if self.layout == "q16":
                put(np.clip(np.rint(padded(normals, np.float32) * 127.0),
                            -127, 127).astype(np.int8))
            else:
                put(padded(normals, np.float32))
        assert off == self.nbytes
        return buf

    def decode_host(self, buf: np.ndarray) -> Dict[str, np.ndarray]:
        """Host-side decode: the exact coordinates the card will see
        (``chunk_count`` counts on these, not on the raw f32 scene)."""
        n = self.n_pad
        off = self.header_nbytes
        if self.layout == "q16":
            header = buf[:32].view(np.float32)
            mn, mx = header[:3], header[3:6]
            q = buf[off:off + 6 * n].view(np.uint16).reshape(n, 3)
            scale = np.where(mx > mn, mx - mn, 1.0)
            pts = (mn + q.astype(np.float32) * (scale / 65535.0)).astype(np.float32)
            off += 6 * n
        else:
            pts = buf[off:off + 12 * n].view(np.float32).reshape(n, 3).copy()
            off += 12 * n
        out = {"points": pts}
        if self.use_colors:
            out["colors"] = buf[off:off + 3 * n].reshape(n, 3).copy()
            off += 3 * n
        if self.use_normals:
            if self.layout == "q16":
                out["normals"] = (buf[off:off + 3 * n].view(np.int8)
                                  .reshape(n, 3).astype(np.float32) / 127.0)
            else:
                out["normals"] = buf[off:off + 12 * n].view(np.float32).reshape(n, 3).copy()
        return out


# ---------------------------------------------------------------------------
# The card's side: decode, chunker, predict step, stitch
# ---------------------------------------------------------------------------

def _bitcast(section: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A 1-D u8 slice viewed as ``dtype``; copied first when its offset is
    not a multiple of the element size (``view`` refuses it)."""
    if section.storage_offset() % dtype.itemsize:
        section = section.clone()
    return section.view(dtype)


def _decode_scene(buf: torch.Tensor, layout: SceneLayout) -> Dict[str, torch.Tensor]:
    """``SceneLayout.decode_host`` in tensor ops on ``buf``'s device, bit for
    bit: q16 points are ``mn + q * (scale / 65535)`` with each rounding its
    own op, and the divisions are correctly rounded (``exact_div``)."""
    n = layout.n_pad
    off = layout.header_nbytes

    def take(nbytes: int) -> torch.Tensor:
        nonlocal off
        off += nbytes
        return buf[off - nbytes:off]

    out = {}
    if layout.layout == "q16":
        header = _bitcast(buf[:32], torch.float32)
        mn, mx = header[:3], header[3:6]
        q = (_bitcast(take(6 * n), torch.int16).to(torch.int32) & 0xFFFF).float().reshape(n, 3)
        scale = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
        out["points"] = mn + q * exact_div(scale, 65535.0)
    else:
        out["points"] = _bitcast(take(12 * n), torch.float32).reshape(n, 3)
    if layout.use_colors:
        out["colors"] = take(3 * n).reshape(n, 3)
    if layout.use_normals:
        if layout.layout == "q16":
            out["normals"] = exact_div(
                _bitcast(take(3 * n), torch.int8).reshape(n, 3).float(), 127.0)
        else:
            out["normals"] = _bitcast(take(12 * n), torch.float32).reshape(n, 3)
    return out


class _Runs(NamedTuple):
    """Phase 1 of the card's chunker (``_chunk_runs``): the sorted membership
    entries and their runs of equal cells, all (4 n,) on the scene's device.
    Enough to count the chunks, and, given the slots to fill, to lay them
    out (``_chunk_table``)."""
    packed_s: torch.Tensor       # sorted entries: pid << 1 | home flag
    run_start: torch.Tensor      # first entry of the entry's run
    run_len: torch.Tensor        # length of the entry's run
    heads: torch.Tensor          # bool: the first entry of a kept cell
    chunks_of_run: torch.Tensor  # ceil(run_len / npoints)
    cum: torch.Tensor            # inclusive cumsum of the heads' chunks

    @property
    def n_chunks(self) -> torch.Tensor:
        """The scene's chunk count, exact: 0-dim int64."""
        return self.cum[-1]


def _chunk_runs(xyz: torch.Tensor, n: int, npoints: int, seed: int, chunk_size: float,
                margin: float) -> _Runs:
    """Phase 1 of the chunker on decoded points ``xyz`` (n_pad, 3), of which
    the first ``n`` are the scene's: the grid, ONE sort, the runs, the
    heads and their cumsum, queued without a host sync.  The f32 grid
    arithmetic is ``_memberships_np``'s, op for op; the constants are f32
    device tensors and the divisions tensor divisions (CUDA divides by a
    Python number as a product with its reciprocal)."""
    dev = xyz.device
    i64 = torch.int64

    def f32(v: float) -> torch.Tensor:
        return torch.full((), float(np.float32(v)), dtype=torch.float32, device=dev)

    cell_f, margin_f, width_f = f32(chunk_size), f32(margin), f32(chunk_size + 2 * margin)
    xy = xyz[:n, :2]
    mn = xy.amin(0)
    ncell = torch.clamp(torch.ceil((xy.amax(0) - mn) / cell_f), min=1).to(i64)   # ncx, ncy
    ncy = ncell[1]
    rel = xy - mn
    lo = torch.floor((rel - margin_f) / cell_f).to(i64)
    home = torch.clamp(torch.minimum(torch.floor(rel / cell_f).to(i64), ncell - 1), min=0)
    home_id = home[:, 0] * ncy + home[:, 1]

    # The 2x2 candidate cells in the twin's (dx, dy) order: entry e = 4 * pid + j.
    offsets = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=i64, device=dev)
    cxy = lo[:, None, :] + offsets                                  # (n, 4, 2)
    box_lo = cxy.to(torch.float32) * cell_f - margin_f
    r = rel[:, None, :]
    member = (((cxy >= 0) & (cxy < ncell)).all(-1)
              & ((r >= box_lo) & (r < box_lo + width_f)).all(-1))
    cell = cxy[..., 0] * ncy + cxy[..., 1]                          # (n, 4)

    # THE sort.  The twin orders members lexicographically by (cell, hash,
    # pid).  The hash is a bijection of the pid (add a constant, multiply by
    # an odd constant, xor-shift: each step invertible mod 2^32), so hashes
    # are distinct and (cell, hash) alone gives that order: one sort of the
    # int64 key cell << 32 | hash, non-members keyed past every cell.
    pid = torch.arange(n, dtype=i64, device=dev)
    key = (torch.where(member, cell, _NO_CELL) << 32) | _hash32_torch(pid, seed)[:, None]
    key_s, entry_s = torch.sort(key.reshape(-1), stable=True)
    cell_s = key_s >> 32
    pid_s = entry_s // 4
    is_home_s = cell_s == home_id[pid_s]
    packed_s = (pid_s << 1) | is_home_s.to(i64)                     # pid and home flag

    # Runs of equal cells (the non-member run included).
    run_start = torch.searchsorted(cell_s, cell_s)
    next_start = torch.searchsorted(cell_s, cell_s, right=True)
    run_len = next_start - run_start
    iota = torch.arange(4 * n, dtype=i64, device=dev)
    homes = torch.cat([torch.zeros(1, dtype=i64, device=dev), torch.cumsum(is_home_s, 0)])
    # Kept cells: >= 1 home entry in the run; their first entries are heads.
    heads = (run_start == iota) & (cell_s < _NO_CELL) & (homes[next_start] > homes[run_start])
    chunks_of_run = (run_len + npoints - 1) // npoints
    cum = torch.cumsum(torch.where(heads, chunks_of_run, 0), 0)
    return _Runs(packed_s, run_start, run_len, heads, chunks_of_run, cum)


def _chunk_table(runs: _Runs, x_cap: int, npoints: int):
    """Phase 2 of the chunker: ``(idx (x_cap, npoints) int32, mask bool,
    n_chunks int32 0-dim)`` from phase 1's ``runs``, queued without a host
    sync.  A chunk's composition does not depend on ``x_cap``; rows past
    ``n_chunks`` hold point 0, mask False."""
    dev = runs.cum.device
    i64 = torch.int64
    e_total = runs.packed_s.numel()
    n_chunks = runs.n_chunks

    # Kept-cell table (<= x_cap rows: every kept cell has >= 1 chunk): the
    # heads' positions, ascending, by one top-k.
    k = min(x_cap, e_total)
    iota = torch.arange(e_total, dtype=i64, device=dev)
    head_pos = torch.topk(torch.where(runs.heads, -iota, -(2**40)), k).indices
    cell_valid = torch.arange(k, device=dev) < runs.heads.sum()
    t_rs, t_len = runs.run_start[head_pos], runs.run_len[head_pos]
    t_base = runs.cum[head_pos] - runs.chunks_of_run[head_pos]      # chunks before the cell

    # Chunk x's cell: the last kept cell whose base <= x.
    x_ids = torch.arange(x_cap, dtype=i64, device=dev)
    rank = ((t_base[None, :] <= x_ids[:, None]) & cell_valid[None, :]).sum(1) - 1
    rank = rank.clamp(0, k - 1)
    c_rs, c_len, c_base = t_rs[rank], t_len[rank].clamp(min=1), t_base[rank]

    # Slot -> rank in the cell's slot space -> sorted entry -> ONE gather.
    slot = ((x_ids - c_base)[:, None] * npoints
            + torch.arange(npoints, dtype=i64, device=dev)[None, :])  # (X, npoints)
    real = slot < c_len[:, None]
    entry = (c_rs[:, None] + slot % c_len[:, None]).clamp(0, e_total - 1)  # modulo tail
    got = runs.packed_s[entry]
    in_chunks = (x_ids < n_chunks)[:, None]
    idx = torch.where(in_chunks, got >> 1, 0).to(torch.int32)
    mask = real & ((got & 1) == 1) & in_chunks
    return idx, mask, n_chunks.to(torch.int32)


def _chunk_points(xyz: torch.Tensor, n: int, x_cap: int, npoints: int, seed: int,
                  chunk_size: float, margin: float):
    """The whole chunker on decoded points: phase 1 (``_chunk_runs``), then
    phase 2 (``_chunk_table``) at ``x_cap`` rows, all on ``xyz``'s device."""
    return _chunk_table(_chunk_runs(xyz, n, npoints, seed, chunk_size, margin), x_cap, npoints)


def make_scene_chunker(layout: SceneLayout, x_cap: int, npoints: int, seed: int = 0,
                       chunk_size: float = CHUNK_SIZE, margin: float = CONTEXT_MARGIN):
    """``(scene_buf u8 tensor, n) -> (idx (x_cap, npoints) int32, mask
    (x_cap, npoints) bool, n_chunks int32)``: the full-coverage grid chunker
    on the buffer's device (one sort, cumsums, one top-k; no host sync).
    Chunk composition is bit-identical to ``deterministic_scene_chunks``'s;
    rows past ``n_chunks`` hold point 0, mask False."""
    check_grid_geometry(chunk_size, margin)

    def chunker(buf: torch.Tensor, n: int):
        return _chunk_points(_decode_scene(buf, layout)["points"], n, x_cap, npoints, seed,
                             chunk_size, margin)

    return chunker


def make_resident_predict_step(model: nn.Module, layout: SceneLayout, batch_size: int,
                               npoints: int):
    """``(scene, idx (B, npoints)) -> (B, npoints) u8 labels``, ``scene`` the
    ``_decode_scene`` of the resident buffer: gather the chunk batch (points;
    colors / 255 and normals as features), eval forward, argmax."""

    def step(scene: Dict[str, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
        flat = idx.reshape(-1)
        pts = scene["points"][flat].reshape(batch_size, npoints, 3)
        parts = []
        if layout.use_colors:
            parts.append(exact_div(scene["colors"][flat].float(), 255.0))
        if layout.use_normals:
            parts.append(scene["normals"][flat])
        feats = (torch.cat(parts, dim=-1).reshape(batch_size, npoints, -1)
                 if parts else None)
        return seg_predict_step(model, pts, feats).argmax(dim=-1).to(torch.uint8)

    return step


def make_stitch(n_pad: int):
    """``(labels (X, npoints) u8, idx, mask) -> (n_pad,) u8``: the card's
    ``map_back``.  Every vertex is mask-True exactly once, so one scatter
    into ``n_pad + 1`` slots puts vertex v's label at v; the masked slots all
    go to the last slot, which is dropped (only its value depends on the
    order of the writes)."""

    def stitch(labels: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        key = torch.where(mask, idx.to(torch.int64), n_pad).reshape(-1)
        out = torch.zeros(n_pad + 1, dtype=labels.dtype, device=labels.device)
        out[key] = labels.reshape(-1)
        return out[:n_pad]

    return stitch


def make_scene_program(model: nn.Module, layout: SceneLayout, nb: int, batch_size: int,
                       npoints: int):
    """``(scene, idx, mask, n_chunks) -> ((n_pad,) u8 labels, n_chunks)``:
    the per-scene work after the chunker as one call that queues it on the
    current stream without a host sync: ``nb`` predict batches (the JAX
    package compiles them with the decode and the chunker into one program;
    here they are ``nb`` forwards one after another) and the stitch.
    ``scene`` is ``_decode_scene``'s, ``(idx, mask, n_chunks)`` the
    chunker's (``_chunk_table``), with at least ``nb * batch_size`` rows.
    Rows past the last chunk hold point 0, and their labels go to the
    stitch's dropped slot."""
    predict = make_resident_predict_step(model, layout, batch_size, npoints)
    stitch = make_stitch(layout.n_pad)
    slots = nb * batch_size

    def program(scene: Dict[str, torch.Tensor], idx: torch.Tensor, mask: torch.Tensor,
                n_chunks: torch.Tensor):
        if slots > len(idx):
            raise ValueError(f"{nb} batches of {batch_size} exceed the chunk capacity {len(idx)}")
        labels = torch.cat([predict(scene, idx[b * batch_size:(b + 1) * batch_size])
                            for b in range(nb)])
        # n_chunks rides back with the labels, so the host can check that the
        # scheduled slots covered every chunk (``ResidentSceneServer._fetch``).
        return stitch(labels, idx[:slots], mask[:slots]), n_chunks

    return program


def make_scene_program_group(model: nn.Module, layout: SceneLayout, nb: int, batch_size: int,
                             npoints: int):
    """``(staged) -> ((K, n_pad) u8, (K,) n_chunks)``: K scenes a call on
    one device, ``staged`` a ``(scene, idx, mask, n_chunks)`` each from one
    upload, and one fetch for the group (the per-scene programs run one
    after another)."""
    body = make_scene_program(model, layout, nb, batch_size, npoints)

    def multi(staged: Sequence[tuple]):
        out = [body(*s) for s in staged]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    return multi


class _LanePrograms:
    """The scene-per-device program: ``(staged) -> ([labels (n_pad,) u8],
    [n_chunks])``, lane i running ``lanes[i]`` (a ``make_scene_program``
    on its device) on ``staged[i]``, one lane after another from the
    calling thread (each lane's work queues on its device's current
    stream)."""

    def __init__(self, lanes, devices):
        self.lanes = lanes
        self.devices = devices

    def __call__(self, staged):
        out = []
        for lane, dev, s in zip(self.lanes, self.devices, staged):
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                out.append(lane(*s))
        return [o[0] for o in out], [o[1] for o in out]


def make_scene_program_mesh(model: nn.Module, layout: SceneLayout, nb: int, batch_size: int,
                            npoints: int, mesh, replicas=None):
    """Scene-per-device serving over a 1-D serving mesh (a
    ``parallel.Mesh`` or a list of devices): ``(staged) -> ([(n_pad,) u8
    labels], [n_chunks])``, lane i running the per-scene program on its
    scene's chunks (on ``mesh.devices[i]``) with a replica of ``model``
    there (``replicas``, default ``parallel.lane_replicas``).  Zero
    collectives: each lane's labels equal ``make_scene_program``'s."""
    mesh = as_mesh(mesh)
    replicas = replicas or lane_replicas(model, mesh)
    lanes = [make_scene_program(r, layout, nb, batch_size, npoints) for r in replicas]
    return _LanePrograms(lanes, list(mesh.devices.flat))


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

def _bucket(x: int, mult: int) -> int:
    return max(mult, -(-x // mult) * mult)


class ResidentSceneServer:
    """Full-scene prediction with one upload and one fetch per scene.

    ``model``: an ``nn.Module`` (run in eval mode) moved to ``device``
    (``"cuda"`` unless the caller asks for the CPU; no fallback).  Programs
    are cached per (n_pad, nb); scene sizes are bucketed to multiples of
    ``pad_multiple``.  ``predict_scenes`` stages scenes on a prefetch thread
    up to ``pipeline_depth`` scenes ahead: pack, upload from pinned memory
    and the card's chunker on the device's high-priority staging stream,
    which reads its chunk count back so that the serving thread queues
    exactly the predict batches the scene needs (``_stage_chunks``).  It
    keeps that many scenes' labels in flight before it waits for the
    oldest: the u8 labels come back into pinned memory, and a CUDA event
    per scene lets the fetch wait for that scene only.  While a profiler
    session records, each stage, queueing and label wait is a span
    (``serve.*``, ``utils/profiler``) under the scene's sequence number, and
    rooms, vertices, scheduled slots and the card's chunks are counted.

    ``group_size``: batch this many scenes per upload, call and fetch
    (``make_scene_program_group``); bit-identical to the ungrouped path.

    ``mesh``: a 1-D serving mesh (a ``parallel.Mesh`` or a list of devices,
    which may repeat one) serves a scene per device: groups of
    ``len(mesh)`` scenes are packed to a common bucket, each uploaded to and
    chunked on its lane's device and run by ``make_scene_program_mesh``,
    bit-identical to the single-device path.  A one-device mesh is the
    single-device path on that device; ``mesh`` and ``group_size > 1`` are
    exclusive.
    """

    def __init__(self, model: nn.Module, npoints: int, batch_size: int = 16,
                 layout: str = "q16", seed: int = 0, use_colors: bool = True,
                 use_normals: bool = True, pad_multiple: int = 16384,
                 pipeline_depth: int = 2, chunk_size: float = CHUNK_SIZE,
                 margin: float = CONTEXT_MARGIN, mesh=None, group_size: int = 1,
                 device="cuda"):
        check_grid_geometry(chunk_size, margin)
        mesh = as_mesh(mesh)
        if mesh is not None and mesh.devices.ndim != 1:
            raise ValueError(
                f"serving mesh must be 1-D (scene-per-device); got axes {mesh.axis_names} — "
                "serving shards scenes, so build a 1-D mesh over the serving devices")
        if mesh is not None and mesh.size == 1:
            device, mesh = mesh.device, None  # a one-device mesh is the single-device path
        if mesh is not None and group_size > 1:
            raise ValueError("mesh and group_size are exclusive: the mesh path already "
                             "groups one scene per device")
        SceneLayout(layout, pad_multiple)  # refuses an unknown layout here
        self.mesh = mesh
        self.device = resolve(mesh.device if mesh is not None else device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            # Indexed, as uploaded tensors' devices are: it keys the staging streams.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model.to(self.device)
        self._replicas = lane_replicas(self.model, mesh) if mesh is not None else None
        self.n_lanes = mesh.size if mesh is not None else max(1, int(group_size))
        self.npoints = npoints
        self.batch_size = batch_size
        self.layout_kind = layout
        self.seed = seed
        self.use_colors = use_colors
        self.use_normals = use_normals
        self.pad_multiple = pad_multiple
        self.pipeline_depth = pipeline_depth
        self.chunk_size = chunk_size
        self.margin = margin
        self._programs = {}
        self._staging_streams = {}

    def _n_pad(self, n: int) -> int:
        # Linear buckets: the padding (and the upload) grows by at most
        # pad_multiple points.
        return -(-n // self.pad_multiple) * self.pad_multiple

    def _layout(self, n_pad: int) -> SceneLayout:
        return SceneLayout(self.layout_kind, n_pad, self.use_colors, self.use_normals)

    def _program(self, n_pad: int, nb: int, group: bool):
        key = (n_pad, nb, group)
        if key not in self._programs:
            args = (self.model, self._layout(n_pad), nb, self.batch_size, self.npoints)
            if self.mesh is not None:
                program = make_scene_program_mesh(*args, self.mesh, replicas=self._replicas)
            else:
                program = (make_scene_program_group if group else make_scene_program)(*args)
            self._programs[key] = program
        return self._programs[key]

    @contextlib.contextmanager
    def _staging(self, device: torch.device):
        """Queue on ``device``'s staging stream and yield it (None on the
        CPU).  One a device, of high priority, so that the chunker's few
        dozen small kernels do not wait behind the compute stream's
        forwards while the staging thread waits for the count."""
        if not self._cuda:
            yield None
            return
        stream = self._staging_streams.get(device)
        if stream is None:
            stream = self._staging_streams[device] = torch.cuda.Stream(device, priority=-1)
        with torch.cuda.stream(stream):
            yield stream

    @staticmethod
    def _recorded(stream):
        """An event recorded on ``stream`` now (None for no stream)."""
        if stream is None:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def _upload(self, buf: np.ndarray, device: torch.device) -> torch.Tensor:
        """``buf`` on ``device``.  On a card the copy runs from pinned memory
        on the device's staging stream, so it overlaps the compute stream's
        work, and the chunker queued after it on that stream reads it."""
        host = torch.from_numpy(buf)
        with self._staging(device) as stream:
            if stream is None:
                return host.to(device)
            return host.pin_memory().to(device, non_blocking=True)

    def _stage_chunks(self, layout: SceneLayout, dbufs: Sequence[torch.Tensor],
                      ns: Sequence[int]):
        """The card's chunker on uploaded scene buffers (the staging
        thread).  On each buffer's staging stream: decode it, run phase 1
        (``_chunk_runs``) and copy its chunk count into pinned memory; then
        wait for every count, and on each stream queue phase 2
        (``_chunk_table``) at the slots the largest count ``x`` needs.
        Returns (x, [(scene, idx, mask, n_chunks)] a buffer, [event its
        chunks are ready on, None on the CPU] a buffer)."""
        runs, counts, copied = [], [], []
        with profiler.span("serve.chunk_count"):
            for dbuf, n in zip(dbufs, ns):
                with self._staging(dbuf.device) as stream:
                    scene = _decode_scene(dbuf, layout)
                    r = _chunk_runs(scene["points"], n, self.npoints, self.seed,
                                    self.chunk_size, self.margin)
                    count = r.n_chunks
                    if stream is not None:
                        count = torch.empty((), dtype=count.dtype, pin_memory=True).copy_(
                            count, non_blocking=True)
                        copied.append(self._recorded(stream))
                runs.append((scene, r))
                counts.append(count)
            with profiler.span("serve.chunk_wait"):
                for event in copied:
                    event.synchronize()
                x = max(int(c) for c in counts)
        x_cap = _bucket(x, 4 * self.batch_size)
        staged, ready = [], []
        for dbuf, (scene, r) in zip(dbufs, runs):
            with self._staging(dbuf.device) as stream:
                staged.append((scene, *_chunk_table(r, x_cap, self.npoints)))
                ready.append(self._recorded(stream))
        return x, staged, ready

    def _on_compute_stream(self, staged, ready) -> None:
        """Make the compute stream wait for a staged scene's chunks, and keep
        the allocator from reusing its tensors (made on the staging stream)
        before the compute stream is done with them."""
        if ready is None:
            return
        scene, idx, mask, n_chunks = staged
        stream = torch.cuda.current_stream(idx.device)
        stream.wait_event(ready)
        for t in (*scene.values(), idx, mask, n_chunks):
            t.record_stream(stream)

    def _to_host(self, *tensors: torch.Tensor):
        """Queue copies of ``tensors`` into pinned host memory; returns the
        host tensors and the events they complete on (one per device; None
        on the CPU)."""
        if not self._cuda:
            return tensors, None
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        done = []
        for dev in dict.fromkeys(t.device for t in tensors):
            with torch.cuda.device(dev):
                done.append(torch.cuda.Event())
                done[-1].record()
        return tuple(out), done

    @staticmethod
    def _check_slots(name, nc: int, cap: int) -> None:
        """The guard that the scheduled predict batches covered every chunk
        of the card's chunker: a shortfall raises, it never stitches label
        0 into the chunks left out."""
        if nc > cap:
            raise RuntimeError(
                f"the card's chunker produced {nc} chunks for scene {name!r} but only "
                f"{cap} predict slots were scheduled: the slack was exceeded, so the slots "
                "were not scheduled from the card's own count")

    def _stage(self, scene: Dict[str, np.ndarray], request=None):
        """Host work, the ONE upload and the chunker of a scene (run on the
        prefetch thread): pack, upload, and the card's chunker with its
        count read back (``_stage_chunks``).  ``request`` (the scene's
        sequence number in ``predict_scenes``) rides along for the spans."""
        with profiler.span("serve.stage", request):
            points = np.asarray(scene["points"], np.float32)
            n = len(points)
            n_pad = self._n_pad(n)
            layout = self._layout(n_pad)
            with profiler.span("serve.pack"):
                buf = layout.pack(points, scene.get("colors") if self.use_colors else None,
                                  scene.get("normals") if self.use_normals else None)
            with profiler.span("serve.upload"):
                dbuf = self._upload(buf, self.device)
            x, (chunks,), (ready,) = self._stage_chunks(layout, [dbuf], [n])
            profiler.count("serve.rooms")
            profiler.count("serve.vertices", n)
        return scene.get("scene_name"), n, n_pad, x, chunks, ready, request

    def _compute(self, staged):
        """Queue one staged scene's program, ``ceil(x / batch_size)``
        batches, and the copy of its labels; no host sync.  Returns (name,
        n, host labels, host n_chunks, event, scheduled slots, request)."""
        name, n, n_pad, x, chunks, ready, request = staged
        nb = -(-x // self.batch_size)
        with profiler.span("serve.compute", request):
            self._on_compute_stream(chunks, ready)
            labels, n_chunks = self._program(n_pad, nb, False)(*chunks)
            (labels, n_chunks), done = self._to_host(labels[:n], n_chunks)
        profiler.count("serve.slots", nb * self.batch_size)
        return name, n, labels, n_chunks, done, nb * self.batch_size, request

    def _fetch(self, computed) -> Tuple[str, np.ndarray]:
        """Wait for one scene's labels, and check the slots (``_check_slots``)."""
        name, n, labels, n_chunks, done, cap, request = computed
        with profiler.span("serve.label_wait", request):
            for event in done or ():
                event.synchronize()
        nc = int(n_chunks)
        profiler.count("serve.chunks", nc)
        self._check_slots(name, nc, cap)
        return name, labels.numpy().astype(np.int32)

    # -- several scenes a call (group_size > 1) -----------------------------

    def _stage_group(self, group, request=None):
        """Pack ``<= n_lanes`` scenes at a common bucket (the chunks do not
        depend on n_pad or x_cap) and upload them as one (K, nbytes)
        buffer, or under a mesh each to its lane's device, then chunk them
        there (``_stage_chunks``: one count, the largest); a short group is
        filled with copies of its last buffer.  ``request``: the group's
        sequence number."""
        with profiler.span("serve.stage", request):
            names = [s.get("scene_name") for s in group]
            pts = [np.asarray(s["points"], np.float32) for s in group]
            ns = [len(p) for p in pts]
            n_pad = self._n_pad(max(ns))
            layout = self._layout(n_pad)
            with profiler.span("serve.pack"):
                packed = [layout.pack(p, s.get("colors") if self.use_colors else None,
                                      s.get("normals") if self.use_normals else None)
                          for p, s in zip(pts, group)]
            n_fill = self.n_lanes - len(group)
            packed += [packed[-1]] * n_fill
            ns_lanes = ns + [ns[-1]] * n_fill
            with profiler.span("serve.upload"):
                if self.mesh is not None:
                    dbufs = [self._upload(b, d) for b, d in zip(packed, self.mesh.devices)]
                else:
                    dbufs = list(self._upload(np.stack(packed), self.device))
            x, chunks, ready = self._stage_chunks(layout, dbufs, ns_lanes)
            profiler.count("serve.rooms", len(group))
            profiler.count("serve.vertices", sum(ns))
        return names, ns_lanes, len(group), n_pad, x, chunks, ready, request

    def _compute_group(self, staged):
        names, ns, n_real, n_pad, x, chunks, ready, request = staged
        nb = -(-x // self.batch_size)
        with profiler.span("serve.compute", request):
            for c, r in zip(chunks, ready):
                self._on_compute_stream(c, r)
            program = self._program(n_pad, nb, True)
            if self.mesh is not None:
                labels, n_chunks = program(chunks)
                host, done = self._to_host(*labels, *n_chunks)
                labels, n_chunks = host[:self.n_lanes], host[self.n_lanes:]
            else:
                (labels, n_chunks), done = self._to_host(*program(chunks))
        # Every lane runs nb batches, a short group's filler lanes too.
        profiler.count("serve.slots", len(ns) * nb * self.batch_size)
        return names, ns, n_real, labels, n_chunks, done, nb * self.batch_size, request

    def _fetch_group(self, computed):
        names, ns, n_real, labels, n_chunks, done, cap, request = computed
        with profiler.span("serve.label_wait", request):
            for event in done or ():
                event.synchronize()
        ncs = np.stack([np.asarray(t) for t in n_chunks]).reshape(-1)
        labs = [np.asarray(t) for t in labels]
        profiler.count("serve.chunks", int(ncs[:n_real].sum()))
        for i in range(n_real):
            self._check_slots(names[i], int(ncs[i]), cap)
            yield names[i], labs[i][:ns[i]].astype(np.int32)

    # -- public API ------------------------------------------------------

    def predict_scene(self, scene: Dict[str, np.ndarray]) -> np.ndarray:
        """points (N,3) [+ colors u8 / normals f32] -> per-vertex labels
        (N,) int32."""
        if self.n_lanes > 1:
            return next(self._fetch_group(self._compute_group(self._stage_group([scene]))))[1]
        return self._fetch(self._compute(self._stage(scene)))[1]

    def predict_scenes(self, scenes) -> Iterator[Tuple[str, np.ndarray]]:
        """Pipelined multi-scene serving; yields (scene_name, labels) in
        input order.  Staging runs on a prefetch thread while this thread
        queues the programs and fetches, ``pipeline_depth`` scenes (or
        groups) in flight."""
        if self.n_lanes > 1:
            def groups():
                g = []
                for s in scenes:
                    g.append(s)
                    if len(g) == self.n_lanes:
                        yield g
                        g = []
                if g:
                    yield g

            stage, compute, fetch = self._stage_group, self._compute_group, self._fetch_group
            items = groups()
        else:
            stage, compute = self._stage, self._compute

            def fetch(c):
                yield self._fetch(c)

            items = iter(scenes)
        staged = prefetch((stage(s, request) for request, s in enumerate(items)),
                          depth=self.pipeline_depth)
        pending = deque()
        try:
            for st in staged:
                pending.append(compute(st))
                if len(pending) > self.pipeline_depth:
                    yield from fetch(pending.popleft())
            while pending:
                yield from fetch(pending.popleft())
        finally:
            staged.close()


def generate_predictions_resident(
    model: nn.Module,
    data_root: str,
    scene_names,
    output_dir: str,
    npoints: int = 8192,
    batch_size: int = 16,
    layout: str = "q16",
    use_colors: bool = True,
    use_normals: bool = True,
    with_labels: bool = True,
    save_npy: bool = True,
    seed: int = 0,
    chunk_size: float = CHUNK_SIZE,
    margin: float = CONTEXT_MARGIN,
    mesh=None,
    device="cuda",
) -> Iterator[Dict]:
    """The resident twin of ``eval.full_scene.generate_predictions``: every
    stored scene through ``ResidentSceneServer``, writing the same artifacts
    (``{name}.txt`` for the benchmark and, with ``save_npy``,
    ``{name}_points.npy``, ``{name}_labels.npy`` and ``{name}_gt.npy``).
    Yields ``{'scene_name', 'predictions', 'labels'}``."""
    os.makedirs(output_dir, exist_ok=True)
    server = ResidentSceneServer(
        model, npoints, batch_size=batch_size, layout=layout, seed=seed,
        use_colors=use_colors, use_normals=use_normals, chunk_size=chunk_size,
        margin=margin, mesh=mesh, device=device)
    scenes = {}

    def stream():  # runs on the prefetch thread
        for name in scene_names:
            sc = load_scene_mapped(data_root, name)
            sc["scene_name"] = name
            scenes[name] = sc
            yield sc

    for name, pred in server.predict_scenes(stream()):
        scene = scenes.pop(name)
        if save_npy:
            np.save(os.path.join(output_dir, f"{name}_points.npy"), scene["points"])
            np.save(os.path.join(output_dir, f"{name}_labels.npy"), pred)
            if with_labels:
                np.save(os.path.join(output_dir, f"{name}_gt.npy"), scene["labels"])
        export_benchmark_txt(os.path.join(output_dir, f"{name}.txt"), pred)
        yield {"scene_name": name, "predictions": pred,
               "labels": scene["labels"] if with_labels else None}
