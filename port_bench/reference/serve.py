"""The plain reference of whole-room serving: what the served labels of a
room have to be.

A room is served in full-coverage chunks.  The floor plan is cut into
1.5 m cells; a vertex is a member of every cell whose box, grown by the
0.2 m context margin, holds it, and is labelled in its home cell.  A cell
with at least one home vertex is served in ceil(members / 8192) chunks of
8192 slots: its members in a keyed hash order, the last chunk filled from
the start.  The coordinates are those the served wire format carries
(q16: each axis quantised to 16 bits over the room's bounding box; colors
as bytes, normals as signed bytes over 127), so the reference works the
quantisation out again from the room.  Each chunk runs through the eval
forward of ``reference/model.py``; a vertex's reference logits are those
of its home slot.

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from port_bench.reference import model as M

CHUNK = 1.5
MARGIN = 0.2
HASH_MULT = np.uint32(2654435761)


def wire_q16(room: Dict[str, np.ndarray], use_colors: bool, use_normals: bool
             ) -> Dict[str, np.ndarray]:
    """The room as the q16 wire format decodes: points, colors / 255, normals."""
    pts = np.asarray(room["points"], np.float32)
    mn, mx = pts.min(0), pts.max(0)
    scale = np.where(mx > mn, mx - mn, 1.0).astype(np.float32)
    q = np.clip(np.rint((pts - mn) / scale * 65535.0), 0, 65535).astype(np.uint16)
    out = {"points": (mn + q.astype(np.float32) * (scale / 65535.0)).astype(np.float32)}
    parts = []
    if use_colors:
        parts.append(np.asarray(room["colors"], np.uint8).astype(np.float32) / np.float32(255.0))
    if use_normals:
        nq = np.clip(np.rint(np.asarray(room["normals"], np.float32) * 127.0), -127, 127)
        parts.append(nq.astype(np.int8).astype(np.float32) / np.float32(127.0))
    out["features"] = np.concatenate(parts, axis=1) if parts else None
    return out


def _hash32(pid: np.ndarray, seed: int) -> np.ndarray:
    h = (pid.astype(np.uint32) + np.uint32(seed * 7919 + 1)) * HASH_MULT
    return h ^ (h >> np.uint32(16))


def _cells(points: np.ndarray):
    """(cell_id (N, 4), member (N, 4), home_id (N,), n_cells): the 2 x 2
    cells whose margin-grown box can hold each vertex, whether it does, and
    the vertex's home cell; box arithmetic in float32."""
    xy = points[:, :2].astype(np.float32)
    mn = xy.min(axis=0)
    ext = (xy.max(axis=0) - mn).astype(np.float32)
    ncx = max(1, int(np.ceil(ext[0] / np.float32(CHUNK))))
    ncy = max(1, int(np.ceil(ext[1] / np.float32(CHUNK))))
    rel = xy - mn
    lo = np.floor((rel - MARGIN) / CHUNK).astype(np.int64)
    home = np.maximum(np.minimum(np.floor(rel / CHUNK).astype(np.int64), [ncx - 1, ncy - 1]), 0)
    chunk_f, margin_f = np.float32(CHUNK), np.float32(MARGIN)
    width_f = np.float32(CHUNK + 2 * MARGIN)
    cells, members = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            cx, cy = lo[:, 0] + dx, lo[:, 1] + dy
            bx = cx.astype(np.float32) * chunk_f - margin_f
            by = cy.astype(np.float32) * chunk_f - margin_f
            members.append((cx >= 0) & (cx < ncx) & (cy >= 0) & (cy < ncy)
                           & (rel[:, 0] >= bx) & (rel[:, 0] < bx + width_f)
                           & (rel[:, 1] >= by) & (rel[:, 1] < by + width_f))
            cells.append(cx * ncy + cy)
    return np.stack(cells, 1), np.stack(members, 1), home[:, 0] * ncy + home[:, 1], ncx * ncy


def chunks(points: np.ndarray, npoints: int, seed: int = 0):
    """(idx (X, npoints) int64 vertex ids, home (X, npoints) bool): every
    vertex is home in exactly one slot."""
    cell_id, member, home_id, _ = _cells(points)
    pid = np.broadcast_to(np.arange(len(points), dtype=np.int64)[:, None], cell_id.shape)
    cells_f, pids_f = cell_id[member], pid[member]
    order = np.lexsort((pids_f, _hash32(pids_f, seed).astype(np.int64), cells_f))
    cells_s, pids_s = cells_f[order], pids_f[order]
    is_home = home_id[pids_s] == cells_s
    uniq, starts = np.unique(cells_s, return_index=True)
    bounds = np.append(starts, len(cells_s))
    idx, homes = [], []
    for ui in range(len(uniq)):
        s, e = bounds[ui], bounds[ui + 1]
        if not is_home[s:e].any():
            continue
        length = e - s
        n_chunks = -(-length // npoints)
        t = np.arange(n_chunks * npoints) % length
        idx.append(pids_s[s:e][t].reshape(n_chunks, npoints))
        homes.append(((np.arange(n_chunks * npoints) < length)
                      & is_home[s:e][t]).reshape(n_chunks, npoints))
    return np.concatenate(idx), np.concatenate(homes)


def room_logits(weights: Dict[str, torch.Tensor], cfg: Dict, room: Dict[str, np.ndarray],
                npoints: int, batch: int, device, visits: Optional[Dict] = None
                ) -> torch.Tensor:
    """(n_vertices, num_classes) float32 reference logits of one room, on
    ``device``; ``visits`` as in ``model.forward`` (summed over chunks)."""
    wire = wire_q16(room, cfg["use_colors"], cfg["use_normals"])
    idx, home = chunks(wire["points"], npoints)
    pts = torch.from_numpy(wire["points"]).to(device)
    feats = (torch.from_numpy(wire["features"]).to(device)
             if wire["features"] is not None else None)
    out = torch.zeros((len(wire["points"]), cfg["num_classes"]), dtype=torch.float32,
                      device=device)
    with torch.no_grad():
        for s in range(0, len(idx), batch):
            bi = torch.from_numpy(idx[s:s + batch]).to(device)
            bh = torch.from_numpy(home[s:s + batch]).to(device)
            logits = M.forward(weights, cfg, pts[bi], feats[bi] if feats is not None else None,
                               visits=visits)
            out[bi[bh]] = logits[bh]
    return out


def chunk_count(points: np.ndarray, npoints: int) -> int:
    """The chunks a room needs: ceil(members / npoints) over the cells with
    a home vertex (``chunks`` without the order)."""
    cell_id, member, home_id, n_cells = _cells(points)
    counts = np.bincount(cell_id[member], minlength=n_cells)
    kept = np.bincount(home_id, minlength=n_cells) > 0
    return int(np.sum(-(-counts[kept] // npoints)))


def calibrate_bn(weights: Dict[str, torch.Tensor], cfg: Dict, room: Dict[str, np.ndarray],
                 npoints: int, n_chunks: int, device) -> Dict[str, torch.Tensor]:
    """``weights`` with each BatchNorm's running statistics set to its batch
    statistics over the first ``n_chunks`` chunks of ``room``, layer by
    layer, as a trained model's are: random running statistics leave an
    eval forward nearly constant over a room (xyz-only inputs centred in
    their groups are near zero), so its labels would tell little."""
    wire = wire_q16(room, cfg["use_colors"], cfg["use_normals"])
    idx = torch.from_numpy(chunks(wire["points"], npoints)[0][:n_chunks]).to(device)
    pts = torch.from_numpy(wire["points"]).to(device)[idx]
    feats = (torch.from_numpy(wire["features"]).to(device)[idx]
             if wire["features"] is not None else None)
    updates: list = []
    with torch.no_grad():
        M.forward(weights, {**cfg, "dropout": 0.0}, pts, feats, train=True, updates=updates)
    out = dict(weights)
    for pre, mean, var, _ in updates:
        out[pre + "mean"], out[pre + "var"] = mean.clone(), var.clone()
    return out
