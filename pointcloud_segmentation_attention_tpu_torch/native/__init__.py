"""Host-side grid assignment of the full-scene chunker.

``grid_chunk_assign`` runs the port's own copy of the JAX package's C++
``native_ops.cpp:grid_chunk_assign`` (``grid_chunk.cpp``), which is what
the JAX package runs wherever ``g++`` exists.  The library is built with
``g++ -O3 -shared -fPIC`` at first use into the package's ``_build/``
directory, named by a hash of the source and flags, and loaded with
``ctypes``.  A failed build raises with the compiler's output: there is no
quiet fallback.

``grid_chunk_assign_numpy`` is the plain version and the tests' oracle: the
same float32 arithmetic step for step (``x = p - min``, then
``floor((x -+ margin) / cell)``), so it equals the C++ bit for bit.  The
pair order (point-major, then cell x, then cell y) is the C++ writer's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "grid_chunk.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpsa_native_{digest.hexdigest()[:16]}.so")


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the host library; returns it.  Raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_so = os.path.join(tmp, "lib.so")
                try:
                    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp_so, SOURCE],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
                except FileNotFoundError as e:
                    raise RuntimeError(f"g++ not found; it builds {SOURCE}") from e
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}")
                os.replace(tmp_so, so_path)
        lib = ctypes.CDLL(so_path)
        fn = lib.psa_grid_chunk_assign
        fn.restype = ctypes.c_int64
        fn.argtypes = (ctypes.c_int64, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int64, ctypes.c_void_p)
        _lib = lib
        return lib


def _grid(points: np.ndarray, cell: float):
    """(float32 points, min, ncell_x, ncell_y), as the JAX package sizes the
    grid.  The library reads rows of 3 floats, so the points must be (N, 3)."""
    points = np.ascontiguousarray(points, np.float32)
    if points.ndim != 2 or points.shape[1] != 3 or len(points) == 0:
        raise ValueError(f"points must be (N >= 1, 3), got {points.shape}")
    mn = points.min(0)
    mx = points.max(0)
    ncx = max(1, int(np.ceil((mx[0] - mn[0]) / cell)))
    ncy = max(1, int(np.ceil((mx[1] - mn[1]) / cell)))
    return points, mn, ncx, ncy


def grid_chunk_assign(
    points: np.ndarray, cell: float = 1.5, margin: float = 0.2
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(cell_ids, point_ids, ncell_x, ncell_y): every (cell, point) pair where
    the point's +-margin box overlaps the cell, from the compiled library."""
    points, mn, ncx, ncy = _grid(points, cell)
    fn = build().psa_grid_chunk_assign

    def run(capacity: int, pairs: np.ndarray) -> int:
        return fn(len(points), points.ctypes.data, float(mn[0]), float(mn[1]), ncx, ncy,
                  cell, margin, capacity, pairs.ctypes.data)

    capacity = len(points) * 4
    pairs = np.empty((capacity, 2), np.int64)
    n_written = run(capacity, pairs)
    if n_written > capacity:  # margins wider than a cell: rerun at the exact size
        pairs = np.empty((n_written, 2), np.int64)
        n_written = run(n_written, pairs)
    pairs = pairs[:n_written]
    return pairs[:, 0].copy(), pairs[:, 1].copy(), ncx, ncy


def grid_chunk_assign_numpy(
    points: np.ndarray, cell: float = 1.5, margin: float = 0.2
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """``grid_chunk_assign`` in numpy, the same float32 arithmetic as the C++."""
    points, mn, ncx, ncy = _grid(points, cell)
    rel = points[:, :2] - mn[:2]                       # float32, x = p - min
    m, c = np.float32(margin), np.float32(cell)
    lo = np.floor((rel - m) / c).astype(np.int64)      # (N, 2)
    hi = np.floor((rel + m) / c).astype(np.int64)
    # Per axis a point overlaps cells [lo, hi]: a fixed (N, Kx, Ky)
    # broadcast of candidates, masked to each point's span and the grid.
    span = hi - lo
    kx = int(span[:, 0].max(initial=0)) + 1
    ky = int(span[:, 1].max(initial=0)) + 1
    ox = np.arange(kx)[None, :]                      # (1, Kx)
    oy = np.arange(ky)[None, :]                      # (1, Ky)
    cx = (lo[:, :1] + ox)[:, :, None]                # (N, Kx, 1)
    cy = (lo[:, 1:2] + oy)[:, None, :]               # (N, 1, Ky)
    valid = (
        (ox[:, :, None] <= span[:, :1, None])
        & (oy[:, None, :] <= span[:, 1:2, None])
        & (cx >= 0) & (cx < ncx) & (cy >= 0) & (cy < ncy)
    )
    cell_ids = np.broadcast_to(cx * ncy + cy, valid.shape)
    pids = np.broadcast_to(
        np.arange(len(points), dtype=np.int64)[:, None, None], valid.shape)
    flat = valid.reshape(-1)
    return cell_ids.reshape(-1)[flat], pids.reshape(-1)[flat], ncx, ncy
