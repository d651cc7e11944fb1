"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

The sources live in the package's ``csrc/``.  ``build()`` compiles each
source with ``nvcc`` (all started together), links them into one shared
library with a plain C interface under the package's ``_build/`` directory,
and loads it; the library is named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.  Nothing is built
or imported when this module is imported: the CPU-only test machine never
reaches ``build()``.

Every wrapper launches on PyTorch's current stream, allocates its outputs
and scratch with ``torch.empty``, raises if the launch reports an error, and
adds one to its ``launches`` counter when it launches its kernel: one count
per call of the wrapper, however many kernels its C entry point queues (the
interpolation backward queues four: three CSR passes and the consuming
pass; ``three_interpolate.interpolation_csr`` runs the CSR passes alone and
has a counter of its own).  The gather and the interpolation are
differentiable through ``torch.autograd.Function``s whose backward is a
kernel too (``group_gather.GroupPoint``,
``three_interpolate.ThreeInterpolate``); a wrapper that has no backward
refuses to run where autograd would need one (``refuse_grad``).  Where a
kernel has a launch plan (FPS, ball query, three-NN, the interpolation and
its backward), a pure ``plan()`` in the wrapper's module chooses it and the
C entry point refuses a plan that would miss work.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fps.cu", "ball_query.cu", "group_gather.cu", "group_gather_bwd.cu",
           "three_nn.cu", "three_interpolate.cu", "three_interpolate_bwd.cu")
HEADERS = ("point_tiles.cuh",)  # included by sources; part of the library's hash
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers, ints, the stream last)
    "psa_fps": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # ball query and three-NN take their plan's fields after the shapes
    "psa_ball_query": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _I, _I,
                       _P),
    "psa_group_gather": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "psa_group_gather_bwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "psa_three_nn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "psa_three_nn_allow_smem": (_I, _P),  # the stream is not used
    # the interpolation takes its plan's fields after the shapes
    "psa_three_interpolate": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "psa_interpolation_csr": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "psa_three_interpolate_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _P),
}

DEFAULT_SMEM_BYTES = 48 * 1024   # dynamic shared memory a kernel may take unasked
MAX_SMEM_BYTES = 232_448         # the most a block may take on an H100 (227 KB)
RING_HEADER_BYTES = 16           # csrc/point_tiles.cuh: two mbarriers before the tiles
BYTES_PER_POINT = 12             # xyz, f32


def ring_bytes(tile: int, stages: int) -> int:
    """Dynamic shared memory of a ``csrc/point_tiles.cuh`` ring of ``stages``
    buffers of ``tile`` points (``point_tiles::ring_bytes``)."""
    return RING_HEADER_BYTES + stages * tile * BYTES_PER_POINT


_lock = threading.Lock()
_lib = None
# The C entry points by name, resolved once by ``build()``; ``launch()``
# reads them without the lock.
_fns: Dict[str, Callable[..., int]] = {}
# (entry point, device index) -> the largest dynamic shared memory allowed so far.
_smem_allowed: Dict[Tuple[str, int], int] = {}
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libpsa_kernels_{digest.hexdigest()[:16]}.so")


def _compile(so_path: str, verbose: bool) -> str:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        extra = ("-Xptxas", "-v") if verbose else ()
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", os.path.join(CSRC, name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so, *(o for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so_path)
    return "\n".join(log)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns it."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not os.path.exists(so_path):
            build_log = _compile(so_path, verbose)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        _lib = lib
        return lib


def check_input(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                last: Optional[int] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given type/rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward: its result would silently be detached from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: this kernel has no backward; call it under torch.no_grad() "
            "or on tensors that do not require grad")


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; raise on error.

    The hot path after the first ``build()``: one dict lookup, the raw
    stream handle (no ``torch.cuda.Stream`` object is built), and a device
    switch only when ``device`` is not the current one."""
    fn = _fns.get(fn_name)
    if fn is None:
        build()
        fn = _fns[fn_name]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err} on {device}")


def allow_smem(fn_name: str, device: torch.device, nbytes: int) -> None:
    """Let a kernel family take ``nbytes`` of dynamic shared memory on
    ``device``: above the default 48 KB a kernel needs
    ``cudaFuncSetAttribute`` first, which ``fn_name`` makes.  Called once per
    device and larger size; sizes within 48 KB need no call."""
    if nbytes <= DEFAULT_SMEM_BYTES:
        return
    index = torch.cuda.current_device() if device.index is None else device.index
    if _smem_allowed.get((fn_name, index), 0) >= nbytes:
        return
    launch(fn_name, device, nbytes)
    _smem_allowed[(fn_name, index)] = nbytes


def kernels() -> Dict[str, object]:
    """The seven kernel wrappers by name (five forward, two backward); each
    has a ``launches`` counter."""
    from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
        ball_query, fps, group_gather, three_interpolate, three_nn,
    )

    return {
        "fps": fps.farthest_point_sample,
        "ball_query": ball_query.ball_query,
        "group_gather": group_gather.group_point,
        "group_gather_bwd": group_gather.group_point_backward,
        "three_nn": three_nn.three_nn,
        "three_interpolate": three_interpolate.three_interpolate,
        "three_interpolate_bwd": three_interpolate.three_interpolate_backward,
    }


def reset_launches() -> None:
    for fn in kernels().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernels().items()}
