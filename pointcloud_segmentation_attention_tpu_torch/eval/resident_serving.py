"""Resident-scene serving: one upload and one label fetch per scene.

The host serving path (``eval/full_scene.py``) chunks each scene with numpy
and copies every chunk batch to the card.  Here a scene crosses to the card
once, as a single packed u8 buffer (q16: 12 B/point), and everything else
happens there, as plain tensor ops:

- the full-coverage grid chunker (``make_scene_chunker``, the card's twin of
  ``chunks.full_scene_chunks``): ONE sort groups the (cell, hash, point)
  membership entries, a top-k extracts the kept-cell table, and small table
  arithmetic plus one gather turn chunk slots into point ids;
- the chunk batches gather their points and features from the decoded
  scene and run the eval forward (``make_resident_predict_step``, the
  kernels through ``ops/dispatch.py``);
- the argmaxed labels go back to vertex order by one scatter
  (``make_stitch``): every vertex is mask-True exactly once;
- the whole pipeline is one call per scene (``make_scene_program``) that
  queues its work without a host sync; the labels come back as u8.

Chunk composition is deterministic (a keyed integer hash replaces the host
chunker's ``rng.permutation``, modulo fill replaces its random tail fill)
and is reproduced bit for bit by the numpy twin
``deterministic_scene_chunks``, so the stitched labels equal the host path
fed the same chunks.

The port's own copy of the JAX package's ``eval/resident_serving.py``: the
host twins and the packed layouts give the same bytes and chunks, the card
side gives the same chunks as its ``make_scene_chunker``.  ``mesh=`` (scene
per device) is not ported yet.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterator, Optional, Sequence, Tuple

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
from pointcloud_segmentation_attention_tpu_torch.train.steps import seg_predict_step

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


def _chunk_points(xyz: torch.Tensor, n: int, x_cap: int, npoints: int, seed: int,
                  chunk_size: float, margin: float):
    """The chunker on decoded points ``xyz`` (n_pad, 3), of which the first
    ``n`` are the scene's: ``(idx (x_cap, npoints) int32, mask bool,
    n_chunks int32 0-dim)``, all on ``xyz``'s device, queued without a host
    sync.  The f32 grid arithmetic is ``_memberships_np``'s, op for op; the
    constants are f32 device tensors and the divisions tensor divisions
    (CUDA divides by a Python number as a product with its reciprocal)."""
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
    e_total = 4 * n
    cell_s = key_s >> 32
    pid_s = entry_s // 4
    is_home_s = cell_s == home_id[pid_s]
    packed_s = (pid_s << 1) | is_home_s.to(i64)                     # pid and home flag

    # Runs of equal cells (the non-member run included).
    run_start = torch.searchsorted(cell_s, cell_s)
    next_start = torch.searchsorted(cell_s, cell_s, right=True)
    run_len = next_start - run_start
    iota = torch.arange(e_total, dtype=i64, device=dev)
    homes = torch.cat([torch.zeros(1, dtype=i64, device=dev), torch.cumsum(is_home_s, 0)])
    # Kept cells: >= 1 home entry in the run; their first entries are heads.
    heads = (run_start == iota) & (cell_s < _NO_CELL) & (homes[next_start] > homes[run_start])
    chunks_of_run = (run_len + npoints - 1) // npoints
    cum = torch.cumsum(torch.where(heads, chunks_of_run, 0), 0)
    n_chunks = cum[-1]

    # Kept-cell table (<= x_cap rows: every kept cell has >= 1 chunk): the
    # heads' positions, ascending, by one top-k.
    k = min(x_cap, e_total)
    head_pos = torch.topk(torch.where(heads, -iota, -(2**40)), k).indices
    cell_valid = torch.arange(k, device=dev) < heads.sum()
    t_rs, t_len = run_start[head_pos], run_len[head_pos]
    t_base = cum[head_pos] - chunks_of_run[head_pos]                # chunks before the cell

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
    got = packed_s[entry]
    in_chunks = (x_ids < n_chunks)[:, None]
    idx = torch.where(in_chunks, got >> 1, 0).to(torch.int32)
    mask = real & ((got & 1) == 1) & in_chunks
    return idx, mask, n_chunks.to(torch.int32)


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


def make_scene_program(model: nn.Module, layout: SceneLayout, x_cap: int, nb: int,
                       batch_size: int, npoints: int, seed: int = 0,
                       chunk_size: float = CHUNK_SIZE, margin: float = CONTEXT_MARGIN):
    """``(scene_buf u8 tensor, n) -> ((n_pad,) u8 labels, n_chunks)``: the
    whole per-scene pipeline as one call that queues its work on the current
    stream without a host sync: decode once, chunk, ``nb`` predict batches
    (the JAX package compiles them into one program; here they are ``nb``
    forwards one after another), stitch.  Batches past the last chunk hold
    point 0, and their labels go to the stitch's dropped slot."""
    check_grid_geometry(chunk_size, margin)
    predict = make_resident_predict_step(model, layout, batch_size, npoints)
    stitch = make_stitch(layout.n_pad)
    slots = nb * batch_size
    if slots > x_cap:
        raise ValueError(f"{nb} batches of {batch_size} exceed the chunk capacity {x_cap}")

    def program(buf: torch.Tensor, n: int):
        scene = _decode_scene(buf, layout)
        idx, mask, n_chunks = _chunk_points(scene["points"], n, x_cap, npoints, seed,
                                            chunk_size, margin)
        labels = torch.cat([predict(scene, idx[b * batch_size:(b + 1) * batch_size])
                            for b in range(nb)])
        # n_chunks rides back with the labels, so the host can check that the
        # scheduled slots covered every chunk (``ResidentSceneServer._fetch``).
        return stitch(labels, idx[:slots], mask[:slots]), n_chunks

    return program


def make_scene_program_group(model: nn.Module, layout: SceneLayout, x_cap: int, nb: int,
                             batch_size: int, npoints: int, seed: int = 0,
                             chunk_size: float = CHUNK_SIZE,
                             margin: float = CONTEXT_MARGIN):
    """``(bufs (K, nbytes) u8, ns (K,)) -> ((K, n_pad) u8, (K,) n_chunks)``:
    K scenes a call on one device, one upload and one fetch for the group
    (the per-scene programs run one after another)."""
    body = make_scene_program(model, layout, x_cap, nb, batch_size, npoints, seed,
                              chunk_size, margin)

    def multi(bufs: torch.Tensor, ns: Sequence[int]):
        out = [body(bufs[k], int(n)) for k, n in enumerate(ns)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    return multi


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

def _bucket(x: int, mult: int) -> int:
    return max(mult, -(-x // mult) * mult)


class ResidentSceneServer:
    """Full-scene prediction with one upload and one fetch per scene.

    ``model``: an ``nn.Module`` (run in eval mode) moved to ``device``
    (``"cuda"`` unless the caller asks for the CPU; no fallback).  Programs
    are cached per (n_pad, x_cap, nb); scene sizes are bucketed to
    multiples of ``pad_multiple``.  ``predict_scenes`` stages scenes (pack,
    chunk count, upload from pinned memory on a copy stream) on a prefetch
    thread up to ``pipeline_depth`` scenes ahead, and keeps that many
    scenes' labels in flight before it waits for the oldest: the u8 labels
    come back into pinned memory, and a CUDA event per scene lets the fetch
    wait for that scene only.

    ``group_size``: batch this many scenes per upload, call and fetch
    (``make_scene_program_group``); bit-identical to the ungrouped path.
    ``mesh=`` (a scene per device) is not ported and raises.
    """

    def __init__(self, model: nn.Module, npoints: int, batch_size: int = 16,
                 layout: str = "q16", seed: int = 0, use_colors: bool = True,
                 use_normals: bool = True, pad_multiple: int = 16384,
                 pipeline_depth: int = 2, chunk_size: float = CHUNK_SIZE,
                 margin: float = CONTEXT_MARGIN, mesh=None, group_size: int = 1,
                 device="cuda"):
        check_grid_geometry(chunk_size, margin)
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: serving a scene per device is not ported yet (ROADMAP Queue 1 "
                "item 7)")
        SceneLayout(layout, pad_multiple)  # refuses an unknown layout here
        self.device = resolve(device)
        self.model = model.to(self.device)
        self.n_lanes = max(1, int(group_size))
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
        self._cuda = self.device.type == "cuda"
        self._upload_stream = torch.cuda.Stream(self.device) if self._cuda else None

    def _n_pad(self, n: int) -> int:
        # Linear buckets: the padding (and the upload) grows by at most
        # pad_multiple points.
        return -(-n // self.pad_multiple) * self.pad_multiple

    def _layout(self, n_pad: int) -> SceneLayout:
        return SceneLayout(self.layout_kind, n_pad, self.use_colors, self.use_normals)

    def _slots(self, x: int) -> int:
        """Chunks to schedule for ``x`` counted on the host.  q16: one batch
        of slack, as the JAX package schedules, in case the card's count
        drifts from the host's by a cell's ceil; ``_fetch`` raises if it is
        ever exceeded.  (The f32 membership arithmetic is exact.)"""
        return x + (self.batch_size if self.layout_kind == "q16" else 0)

    def _program(self, n_pad: int, x_cap: int, nb: int, group: bool):
        key = (n_pad, x_cap, nb, group)
        if key not in self._programs:
            make = make_scene_program_group if group else make_scene_program
            self._programs[key] = make(self.model, self._layout(n_pad), x_cap, nb,
                                       self.batch_size, self.npoints, self.seed,
                                       chunk_size=self.chunk_size, margin=self.margin)
        return self._programs[key]

    def _upload(self, buf: np.ndarray):
        """(device buffer, event its copy completes on, or None on the CPU).
        On a card the copy runs from pinned memory on the upload stream, so
        it overlaps the compute stream's work."""
        host = torch.from_numpy(buf)
        if not self._cuda:
            return host.to(self.device), None
        host = host.pin_memory()
        with torch.cuda.stream(self._upload_stream):
            dbuf = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        return dbuf, ready

    def _on_compute_stream(self, dbuf: torch.Tensor, ready) -> None:
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            dbuf.record_stream(stream)  # the allocator must not reuse it early

    def _to_host(self, *tensors: torch.Tensor):
        """Queue copies of ``tensors`` into pinned host memory; returns the
        host tensors and the event they complete on (None on the CPU)."""
        if not self._cuda:
            return tensors, None
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        done = torch.cuda.Event()
        done.record()
        return tuple(out), done

    def _stage(self, scene: Dict[str, np.ndarray]):
        """Host work and the ONE upload of a scene (run on the prefetch
        thread): pack, count the chunks on the decoded coordinates (q16
        moves points by up to half a quantum, enough to flip a margin
        membership), upload."""
        points = np.asarray(scene["points"], np.float32)
        n = len(points)
        n_pad = self._n_pad(n)
        layout = self._layout(n_pad)
        buf = layout.pack(points, scene.get("colors") if self.use_colors else None,
                          scene.get("normals") if self.use_normals else None)
        x = self._slots(chunk_count(layout.decode_host(buf)["points"][:n], self.npoints,
                                    self.chunk_size, self.margin))
        dbuf, ready = self._upload(buf)
        return (scene.get("scene_name"), n, n_pad, _bucket(x, 4 * self.batch_size), x,
                dbuf, ready)

    def _compute(self, staged):
        """Queue one staged scene's program and the copy of its labels; no
        host sync.  Returns (name, n, host labels, host n_chunks, event,
        scheduled slots)."""
        name, n, n_pad, x_cap, x, dbuf, ready = staged
        self._on_compute_stream(dbuf, ready)
        nb = -(-x // self.batch_size)
        labels, n_chunks = self._program(n_pad, x_cap, nb, False)(dbuf, n)
        (labels, n_chunks), done = self._to_host(labels[:n], n_chunks)
        return name, n, labels, n_chunks, done, nb * self.batch_size

    def _fetch(self, computed) -> Tuple[str, np.ndarray]:
        """Wait for one scene's labels.  The guard that the scheduled predict
        batches covered every chunk of the card's chunker lives here: a
        shortfall raises, it never stitches label 0 into the chunks left
        out."""
        name, n, labels, n_chunks, done, cap = computed
        if done is not None:
            done.synchronize()
        nc = int(n_chunks)
        if nc > cap:
            raise RuntimeError(
                f"the card's chunker produced {nc} chunks for scene {name!r} but only "
                f"{cap} predict slots were scheduled: the q16 host/card chunk-count "
                "slack was exceeded; raise it in ResidentSceneServer._slots")
        return name, labels.numpy().astype(np.int32)

    # -- several scenes a call (group_size > 1) -----------------------------

    def _stage_group(self, group):
        """Pack ``<= n_lanes`` scenes at a common bucket (the chunks do not
        depend on n_pad or x_cap) and upload them as one (K, nbytes)
        buffer; a short group is filled with copies of its last buffer."""
        names = [s.get("scene_name") for s in group]
        pts = [np.asarray(s["points"], np.float32) for s in group]
        ns = [len(p) for p in pts]
        n_pad = self._n_pad(max(ns))
        layout = self._layout(n_pad)
        packed = [layout.pack(p, s.get("colors") if self.use_colors else None,
                              s.get("normals") if self.use_normals else None)
                  for p, s in zip(pts, group)]
        x = self._slots(max(chunk_count(layout.decode_host(b)["points"][:n], self.npoints,
                                        self.chunk_size, self.margin)
                            for b, n in zip(packed, ns)))
        n_fill = self.n_lanes - len(group)
        dbufs, ready = self._upload(np.stack(packed + [packed[-1]] * n_fill))
        return (names, ns + [ns[-1]] * n_fill, len(group), n_pad,
                _bucket(x, 4 * self.batch_size), x, dbufs, ready)

    def _compute_group(self, staged):
        names, ns, n_real, n_pad, x_cap, x, dbufs, ready = staged
        self._on_compute_stream(dbufs, ready)
        nb = -(-x // self.batch_size)
        labels, n_chunks = self._program(n_pad, x_cap, nb, True)(dbufs, ns)
        (labels, n_chunks), done = self._to_host(labels, n_chunks)
        return names, ns, n_real, labels, n_chunks, done, nb * self.batch_size

    def _fetch_group(self, computed):
        names, ns, n_real, labels, n_chunks, done, cap = computed
        if done is not None:
            done.synchronize()
        ncs = n_chunks.numpy()
        labs = labels.numpy()
        for i in range(n_real):
            if int(ncs[i]) > cap:
                raise RuntimeError(
                    f"the card's chunker produced {int(ncs[i])} chunks for scene "
                    f"{names[i]!r} but only {cap} predict slots were scheduled: the q16 "
                    "host/card chunk-count slack was exceeded; raise it in "
                    "ResidentSceneServer._slots")
            yield names[i], labs[i, :ns[i]].astype(np.int32)

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
        staged = prefetch((stage(s) for s in items), depth=self.pipeline_depth)
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
