"""Packed single-buffer wire format: one host-to-device copy per batch.

Every sample is one fixed-size uint8 record and a batch is one
``(B, row_nbytes)`` uint8 array; ``unpack_batch`` decodes it with torch ops
on the tensor's own device (bit casts, one dequantisation, the feature
concat and the class-weight lookup).

Two layouts:

- ``f32``: points f32, normals f16, colors u8, labels u8, mask u8
  (23 B/point with colors and normals; the bytes of the compact wire).
- ``q16``: a per-sample bbox header of 8 f32 (mn[3], mx[3], 2 pad), points
  u16 over the bbox, normals i8 (x127), colors, labels and mask u8
  (14 B/point).

Sections are laid out f32 first, then 16-bit, then bytes.  The port's own
copy of the JAX package's ``data/wire.py``: the same inputs give the same
bytes, and the decode gives the same values (see ``unpack_batch``).
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

_FORMAT_RE = re.compile(r"packed(_q16)?(?:x(\d+))?")


class WireSpec(NamedTuple):
    """Static description of a packed record."""

    n: int                    # points per sample
    layout: str = "f32"       # 'f32' | 'q16'
    use_colors: bool = True
    use_normals: bool = True

    @classmethod
    def from_format(cls, fmt: str, n: int, use_colors: bool,
                    use_normals: bool) -> Tuple[Optional["WireSpec"], int]:
        """Parse a wire-format string ('packed', 'packed_q16', 'packed_q16x4',
        ...) -> (spec, number of byte-column splits); (None, 1) for the
        formats that are not packed."""
        m = _FORMAT_RE.fullmatch(fmt)
        if not m:
            return None, 1
        spec = cls(n=n, layout="q16" if m.group(1) else "f32",
                   use_colors=use_colors, use_normals=use_normals)
        return spec, int(m.group(2) or 1)

    @property
    def header_nbytes(self) -> int:
        return 32 if self.layout == "q16" else 0

    @property
    def row_nbytes(self) -> int:
        n = self.n
        if self.layout == "f32":
            size = 12 * n                      # points f32
            if self.use_normals:
                size += 6 * n                  # normals f16
        elif self.layout == "q16":
            size = self.header_nbytes + 6 * n  # bbox + points u16
            if self.use_normals:
                size += 3 * n                  # normals i8
        else:
            raise ValueError(f"unknown wire layout {self.layout!r}")
        if self.use_colors:
            size += 3 * n                      # colors u8
        return size + 2 * n                    # labels u8 + mask u8

    def sections(self) -> List[Tuple[str, int]]:
        """(field, bytes per sample) in record order."""
        n = self.n
        if self.layout == "f32":
            out = [("points", 12 * n)] + ([("normals", 6 * n)] if self.use_normals else [])
        else:
            out = [("bbox", 32), ("points", 6 * n)]
            out += [("normals", 3 * n)] if self.use_normals else []
        out += [("colors", 3 * n)] if self.use_colors else []
        return out + [("labels", n), ("mask", n)]


def _row_views(row, spec: WireSpec) -> Dict:
    """Column slices of a (B, row_nbytes) array, one per field (no copies)."""
    out, off = {}, 0
    for name, nbytes in spec.sections():
        out[name] = row[:, off:off + nbytes]
        off += nbytes
    assert off == spec.row_nbytes
    return out


def pack_arrays(
    points: np.ndarray,            # (B, N, 3) f32
    labels: np.ndarray,            # (B, N) int
    mask: np.ndarray,              # (B, N) bool/int
    colors: Optional[np.ndarray],  # (B, N, 3) uint8-ranged
    normals: Optional[np.ndarray],  # (B, N, 3) f32
    spec: WireSpec,
) -> np.ndarray:
    """Stacked arrays -> (B, row_nbytes) u8 packed batch."""
    b = points.shape[0]
    row = np.empty((b, spec.row_nbytes), np.uint8)
    v = _row_views(row, spec)
    if spec.layout == "f32":
        v["points"][:] = np.ascontiguousarray(points, np.float32).view(np.uint8).reshape(b, -1)
        if spec.use_normals:
            v["normals"][:] = np.ascontiguousarray(
                normals, np.float16).view(np.uint8).reshape(b, -1)
    else:
        mn = points.min(axis=1)                          # (B, 3)
        mx = points.max(axis=1)
        header = np.zeros((b, 8), np.float32)
        header[:, :3] = mn
        header[:, 3:6] = mx
        v["bbox"][:] = header.view(np.uint8)
        scale = np.where(mx > mn, mx - mn, 1.0)
        q = np.clip(np.rint((points - mn[:, None]) / scale[:, None] * 65535.0),
                    0, 65535).astype(np.uint16)
        v["points"][:] = q.view(np.uint8).reshape(b, -1)
        if spec.use_normals:
            nq = np.clip(np.rint(np.asarray(normals, np.float32) * 127.0),
                         -127, 127).astype(np.int8)
            v["normals"][:] = nq.view(np.uint8).reshape(b, -1)
    if spec.use_colors:
        v["colors"][:] = np.asarray(colors).astype(np.uint8).reshape(b, -1)
    v["labels"][:] = np.asarray(labels).astype(np.uint8)
    v["mask"][:] = (np.asarray(mask) != 0).astype(np.uint8)
    return row


def pack_chunks(chunks: List[Dict[str, np.ndarray]], spec: WireSpec) -> np.ndarray:
    """Chunk dicts (points/labels/colors/normals/weights) -> packed
    (B, row_nbytes) u8 batch; the stored weight only gives the inner-box
    mask (weight != 0)."""
    return pack_arrays(
        np.stack([c["points"] for c in chunks]).astype(np.float32),
        np.stack([c["labels"] for c in chunks]),
        np.stack([c["weights"] for c in chunks]) != 0,
        np.stack([c["colors"] for c in chunks]) if spec.use_colors else None,
        np.stack([c["normals"] for c in chunks]) if spec.use_normals else None,
        spec,
    )


def exact_div(x, d: float):
    """``x / d`` correctly rounded on the tensor's device: the divisor is a
    0-dim tensor there, because CUDA divides by a Python number as a product
    with its reciprocal, which is not correctly rounded."""
    import torch

    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def unpack_batch(packed, spec: WireSpec, class_weights=None) -> Dict:
    """(B, row_nbytes) uint8 tensor -> {'points' f32 (B,N,3), 'labels' int32,
    'weights' f32 (class_weight[label] x mask), 'features' f32 (B,N,K) when
    colors or normals are packed}, computed on ``packed``'s device.

    Each section is made contiguous before it is bit-cast (a column slice
    is neither contiguous nor, when ``row_nbytes % 4 != 0``, aligned).  q16
    points are ``mn + q * (scale / 65535.0)`` in f32, in that order, and
    the u16 values are read as int16 widened and masked with 0xFFFF.  The
    divisions are ``exact_div``'s, so the f32 layout's colors / 255 equal
    the host's."""
    import torch

    from pointcloud_segmentation_attention_tpu_torch.train.steps import make_sample_weights

    b, n = packed.shape[0], spec.n
    v = {k: t.contiguous() for k, t in _row_views(packed, spec).items()}
    out = {}
    normals = None
    if spec.layout == "f32":
        out["points"] = v["points"].view(torch.float32).reshape(b, n, 3)
        if spec.use_normals:
            normals = v["normals"].view(torch.float16).reshape(b, n, 3).float()
    else:
        header = v["bbox"].view(torch.float32)                       # (B, 8)
        mn, mx = header[:, None, :3], header[:, None, 3:6]
        q = (v["points"].view(torch.int16).to(torch.int32) & 0xFFFF).float().reshape(b, n, 3)
        scale = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
        out["points"] = mn + q * exact_div(scale, 65535.0)
        if spec.use_normals:
            normals = exact_div(v["normals"].view(torch.int8).reshape(b, n, 3).float(), 127.0)
    parts = []
    if spec.use_colors:
        parts.append(exact_div(v["colors"].reshape(b, n, 3).float(), 255.0))
    if normals is not None:
        parts.append(normals)
    labels = v["labels"].to(torch.int32)
    out["labels"] = labels
    out["weights"] = make_sample_weights(labels, v["mask"] != 0, class_weights)
    if parts:
        out["features"] = torch.cat(parts, dim=-1)
    return out


def split_wire_batch(batch: Dict[str, np.ndarray], k: int) -> Dict[str, np.ndarray]:
    """{'packed': rows} -> K contiguous byte-column slices 'packed0'..
    'packed{K-1}' (K <= 1: unchanged); ``train.steps.expand_wire_batch``
    joins them again."""
    if k <= 1:
        return batch
    rows = batch["packed"]
    bounds = np.linspace(0, rows.shape[1], k + 1).astype(int)
    return {f"packed{i}": np.ascontiguousarray(rows[:, bounds[i]:bounds[i + 1]])
            for i in range(k)}
