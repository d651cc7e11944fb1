"""Host-side C++ of the port: the full-scene chunker's grid assignment,
the ball-splat renderer, and the host three-NN and ball query.

``grid_chunk_assign``, ``render_ball``, ``three_nn`` and ``ball_query`` run
the port's own copies of the JAX package's C++
``native_ops.cpp:grid_chunk_assign``, ``:render_ball``, ``:three_nn_cpu``
and ``:ball_query_cpu`` (``grid_chunk.cpp``, ``render_ball.cpp``,
``geometry_cpu.cpp``), which is what the JAX package runs wherever ``g++``
exists.  The sources are built with ``g++ -O3 -ffp-contract=off -shared
-fPIC`` at first use into one library in
the package's ``_build/`` directory, named by a hash of the sources and
flags, and loaded with ``ctypes``; processes that build at once take
``build_lock`` on that directory, so one compiles and the others load its
library.  A failed build raises with the compiler's output: there
is no quiet fallback.

``grid_chunk_assign_numpy`` is the grid assignment's plain version and the
tests' oracle: the same float32 arithmetic step for step (``x = p - min``,
then ``floor((x -+ margin) / cell)``), so it equals the C++ bit for bit.
The pair order (point-major, then cell x, then cell y) is the C++ writer's.

``three_nn`` and ``ball_query`` are host oracles, independent of the
plain versions (``ops/geometry.py``) and the kernels: three-NN in double
with the lower index on a tie, ball query in float32 with
``max(sqrt(d2), 1e-20) < radius`` (the plain version and the kernel compare
``d2 < radius**2``, which can decide a point on the radius the other way).
``geometry_cpu.cpp`` says why its squared distances are two written-out
fused multiply-adds.

``render_ball_numpy`` is the renderer's plain version, equal to the C++
byte for byte: ``std::lround`` (half away from zero), the float32 depth
bump ``z - sqrt(r^2 - dx^2 - dy^2)``, and the strict depth test in point
order (the earlier point keeps a tied pixel).  The JAX package's own numpy
fallback draws far to near without the bump and rounds half to even, so it
disagrees with its C++; the port follows the C++.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, name)
                for name in ("grid_chunk.cpp", "render_ball.cpp", "geometry_cpu.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


@contextlib.contextmanager
def build_lock(build_dir: str):
    """An exclusive lock on ``build_dir/.lock`` across processes (``flock``),
    held while a library is looked for and, if missing, compiled: processes
    that build at once (the ranks of a data-parallel run) compile once.
    Both this library and ``ops.cuda``'s kernels take it."""
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for source in SOURCES:  # every source linked into the library
        digest.update(os.path.basename(source).encode())
        with open(source, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpsa_native_{digest.hexdigest()[:16]}.so")


def _compile(so_path: str) -> None:
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, "lib.so")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp_so, *SOURCES],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found; it builds {SOURCES}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCES}:\n{proc.stdout}")
        os.replace(tmp_so, so_path)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the host library; returns it.  Raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        with build_lock(BUILD_DIR):
            if not os.path.exists(so_path):
                _compile(so_path)
        lib = ctypes.CDLL(so_path)
        fn = lib.psa_grid_chunk_assign
        fn.restype = ctypes.c_int64
        fn.argtypes = (ctypes.c_int64, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int64, ctypes.c_void_p)
        fn = lib.psa_render_ball
        fn.restype = None
        fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int)
        fn = lib.psa_three_nn_cpu
        fn.restype = None
        fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
        fn = lib.psa_ball_query_cpu
        fn.restype = None
        fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
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


def _clouds(a: np.ndarray, b: np.ndarray, names: Tuple[str, str]):
    """(float32 a, float32 b), checked: the library reads (B, *, 3) rows with
    int extents."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if a.ndim != 3 or b.ndim != 3 or a.shape[2] != 3 or b.shape[2] != 3 \
            or a.shape[0] != b.shape[0]:
        raise ValueError(f"{names[0]} and {names[1]} must be (B, *, 3) with one B, got "
                         f"{a.shape} and {b.shape}")
    if max(a.size, b.size) >= 2 ** 31:
        raise ValueError(f"{a.shape} and {b.shape} exceed int32 indexing")
    return a, b


def three_nn(xyz1: np.ndarray, xyz2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 3 nearest known points (xyz2, (B,M,3)) of each unknown point
    (xyz1, (B,N,3)), from the compiled library: squared distance (B,N,3)
    float32 ascending (computed in double), idx (B,N,3) int32, the lower
    index on a tie.  With M < 3 the missing slots hold inf and index 0."""
    xyz1, xyz2 = _clouds(xyz1, xyz2, ("xyz1", "xyz2"))
    b, n, _ = xyz1.shape
    dist = np.empty((b, n, 3), np.float32)
    idx = np.empty((b, n, 3), np.int32)
    build().psa_three_nn_cpu(b, n, xyz2.shape[1], xyz1.ctypes.data, xyz2.ctypes.data,
                             dist.ctypes.data, idx.ctypes.data)
    return dist, idx


def ball_query(xyz: np.ndarray, centers: np.ndarray, radius: float,
               nsample: int) -> Tuple[np.ndarray, np.ndarray]:
    """The first ``nsample`` points of xyz (B,N,3) in point order within
    ``radius`` of each centre (B,M,3), from the compiled library: idx
    (B,M,nsample) int32 (the slots past the count repeat the first hit; an
    empty ball gives 0) and cnt (B,M) int32."""
    xyz, centers = _clouds(xyz, centers, ("xyz", "centers"))
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")
    b, n, _ = xyz.shape
    m = centers.shape[1]
    idx = np.empty((b, m, nsample), np.int32)
    cnt = np.empty((b, m), np.int32)
    build().psa_ball_query_cpu(b, n, m, radius, nsample, xyz.ctypes.data, centers.ctypes.data,
                               idx.ctypes.data, cnt.ctypes.data)
    return idx, cnt


def _splat_inputs(points: np.ndarray, colors: np.ndarray, h: int, w: int):
    """(float32 points, uint8 colors), checked: the library reads rows of 3,
    rounds x and y to ints and indexes the image with ints."""
    points = np.ascontiguousarray(points, np.float32)
    colors = np.ascontiguousarray(colors, np.uint8)
    if points.ndim != 2 or points.shape[1] != 3 or colors.shape != points.shape:
        raise ValueError(f"points and colors must both be (N, 3), got {points.shape} and "
                         f"{colors.shape}")
    if not np.all(np.abs(points[:, :2]) <= 2.0 ** 30):  # NaN fails too
        raise ValueError("screen x and y must be finite and within +-2^30 pixels")
    if h * w >= 2 ** 31 or len(points) >= 2 ** 31:
        raise ValueError(f"image {h} x {w} or {len(points)} points exceed int32 indexing")
    return points, colors


def render_ball(points: np.ndarray, colors: np.ndarray, h: int = 600, w: int = 600,
                radius: int = 3, background: int = 255) -> np.ndarray:
    """Z-buffered ball-splat render of screen-space points (n,3 float; x,y in
    pixels, z = depth) with per-point (n,3) uint8 colors -> (h,w,3) uint8,
    from the compiled library."""
    points, colors = _splat_inputs(points, colors, h, w)
    image = np.full((h, w, 3), background, np.uint8)
    zbuf = np.full((h, w), np.inf, np.float32)
    build().psa_render_ball(h, w, image.ctypes.data, zbuf.ctypes.data, len(points),
                            points.ctypes.data, colors.ctypes.data, radius)
    return image


def render_ball_numpy(points: np.ndarray, colors: np.ndarray, h: int = 600, w: int = 600,
                      radius: int = 3, background: int = 255) -> np.ndarray:
    """``render_ball`` in numpy, equal to the C++ byte for byte.  A pixel
    keeps the color of the first point (in point order) whose bumped depth
    is the least there, which is what the C++'s strict test in point order
    leaves; NaN depths never draw."""
    points, colors = _splat_inputs(points, colors, h, w)
    image = np.full((h, w, 3), background, np.uint8)
    offsets = [(dy, dx) for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1) if dx * dx + dy * dy <= radius * radius]
    if not offsets or not len(points):
        return image
    dy, dx = (np.array(v, np.int64) for v in zip(*offsets))
    dz = np.sqrt((radius * radius - dx * dx - dy * dy).astype(np.float32))
    # std::lround: half away from zero, exact in float64 for |x| <= 2^30.
    xy = points[:, :2].astype(np.float64)
    xi, yi = (np.sign(xy) * np.floor(np.abs(xy) + 0.5)).astype(np.int64).T
    px = xi[:, None] + dx[None, :]
    py = yi[:, None] + dy[None, :]
    zz = points[:, 2:3] - dz[None, :]                   # float32, as the C++
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (zz < np.inf)
    pid = np.broadcast_to(np.arange(len(points))[:, None], ok.shape)[ok]
    pix, zz = (py * w + px)[ok], zz[ok]
    order = np.lexsort((pid, zz, pix))                  # by pixel, depth, point
    pix, pid = pix[order], pid[order]
    first = np.ones(len(pix), bool)
    first[1:] = pix[1:] != pix[:-1]
    image.reshape(-1, 3)[pix[first]] = colors[pid[first]]
    return image
