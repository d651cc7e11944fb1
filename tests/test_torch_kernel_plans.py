"""The host side of the port's kernels, without a card or nvcc: the FPS
variant plan (``ops/cuda/fps.py:plan``) and the lean launch path
(``ops/cuda/__init__.py:launch``) against a stub ctypes library."""
from __future__ import annotations

import contextlib
import ctypes
import types

import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch.ops import cuda
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import fps


# ---- FPS plan ------------------------------------------------------------

@pytest.mark.parametrize("b, n, want", [
    # The main path at B16: SA1 in a cluster of 8, SA2-4 one block per cloud.
    (16, 8192, fps.FpsPlan("cluster", 8, 64, 16, 0, 0)),
    (16, 1024, fps.FpsPlan("block", 1, 256, 4, 0, 0)),
    (16, 256, fps.FpsPlan("block", 1, 64, 4, 0, 0)),
    (16, 64, fps.FpsPlan("block", 1, 32, 4, 0, 0)),
    # Larger clouds: more threads, then shared memory, then device memory.
    (2, 4096, fps.FpsPlan("cluster", 8, 32, 16, 0, 0)),
    (3, 8193, fps.FpsPlan("cluster", 8, 96, 16, 0, 0)),
    (2, 33_024, fps.FpsPlan("cluster", 8, 288, 16, 0, 0)),
    (1, 70_000, fps.FpsPlan("cluster-smem", 8, 1024, 0, 8750 * 16, 0)),
    (1, 120_000, fps.FpsPlan("cluster-global", 8, 1024, 0, 0, 120_000 * 4)),
    (3, 120_000, fps.FpsPlan("cluster-global", 8, 1024, 0, 0, 3 * 120_000 * 4)),
])
def test_fps_plan_at_main_path_and_large_shapes(b, n, want):
    assert fps.plan(b, n) == want


@pytest.mark.parametrize("n", [1, 2, 31, 33, 100, 1000, 4095, 4096, 4097, 8192, 8193, 16_384,
                               16_385, 32_768, 65_536, 65_537, 102_400, 102_401, 250_000])
def test_fps_plan_covers_every_point(n):
    p = fps.plan(4, n)
    slice_ = -(-n // p.cluster)
    assert (p.cluster == 1) == (n < fps.CLUSTER_MIN_N)
    assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
    if p.per_thread:
        assert p.variant == ("block" if p.cluster == 1 else "cluster")
        k, max_threads = fps.REGISTERS[p.cluster]
        assert p.per_thread == k and p.threads <= max_threads
        assert p.threads * p.per_thread >= slice_
        # One warp fewer would not hold the slice: no idle warps.
        assert (p.threads - 32) * p.per_thread < slice_ or p.threads == 32
        assert p.smem_bytes == 0 and p.scratch_bytes == 0
    elif p.smem_bytes:
        assert p.variant == "cluster-smem" and p.cluster == fps.CLUSTER
        assert p.smem_bytes == slice_ * 16 <= fps.MAX_SMEM_BYTES and p.scratch_bytes == 0
    else:
        assert p.variant == "cluster-global" and p.cluster == fps.CLUSTER
        assert slice_ * 16 > fps.MAX_SMEM_BYTES and p.scratch_bytes == 4 * n * 4


def test_fps_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        fps.plan(0, 8192)
    with pytest.raises(ValueError):
        fps.plan(2, 0)


# ---- the launch path -----------------------------------------------------

class _StubFn:
    def __init__(self, rc: int):
        self.rc = rc
        self.calls = []
        self.argtypes = None
        self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _StubLib:
    """Stands in for the ``ctypes.CDLL`` of the kernel library; counts how
    often each entry point is looked up."""

    def __init__(self, rcs):
        self._fns = {name: _StubFn(rcs.get(name, 0)) for name in cuda._SIGNATURES}
        self.lookups = {name: 0 for name in cuda._SIGNATURES}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self.lookups[name] += 1
        return self._fns[name]


class _NoLock:
    def __enter__(self):
        raise AssertionError("launch() took the build lock after the library was loaded")

    def __exit__(self, *exc):
        return False


@pytest.fixture
def stub_library(monkeypatch, tmp_path):
    """Load a stub library through ``build()`` and a stub CUDA stream; the
    real library, nvcc and the card are never touched."""
    so = tmp_path / "libstub.so"
    so.write_bytes(b"")
    libs = []

    def make(rcs=None):
        lib = _StubLib(rcs or {})
        libs.append(lib)
        return lib

    state = {"rcs": {}}
    monkeypatch.setattr(cuda, "_lib", None)
    monkeypatch.setattr(cuda, "_fns", {})
    monkeypatch.setattr(cuda, "library_path", lambda: str(so))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: make(state["rcs"]))
    streams = []

    def raw_stream(index):
        streams.append(index)
        return 0xBEEF

    # CPU-only torch has no CUDA stream: a stub hands out a fixed handle.
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    switches = []

    @contextlib.contextmanager
    def device_ctx(device):
        switches.append(device)
        yield

    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    return types.SimpleNamespace(libs=libs, state=state, switches=switches, streams=streams)


def test_launch_resolves_each_entry_point_once(stub_library, monkeypatch):
    dev = torch.device("cuda", 0)
    for _ in range(3):
        for name in cuda._SIGNATURES:
            cuda.launch(name, dev, 1, 2)
        monkeypatch.setattr(cuda, "_lock", _NoLock())  # loaded: no lock from here on
    (lib,) = stub_library.libs
    assert set(cuda._SIGNATURES) == set(lib.lookups) and len(lib.lookups) == 7
    assert lib.lookups == {name: 1 for name in cuda._SIGNATURES}
    for name, argtypes in cuda._SIGNATURES.items():
        fn = lib._fns[name]
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_int
        assert fn.calls == [(1, 2, 0xBEEF)] * 3
    assert stub_library.switches == []  # the current device needs no switch


def test_launch_switches_device_only_when_not_current(stub_library):
    cuda.launch("psa_fps", torch.device("cuda", 1), 7)
    cuda.launch("psa_fps", torch.device("cuda", 0), 7)
    cuda.launch("psa_fps", torch.device("cuda"), 7)
    assert stub_library.switches == [1]
    assert stub_library.streams == [1, 0, 0]  # each launch on its device's stream


def test_launch_raises_on_nonzero_return_code(stub_library):
    stub_library.state["rcs"] = {"psa_group_gather": 700}
    with pytest.raises(RuntimeError, match="psa_group_gather.*error 700"):
        cuda.launch("psa_group_gather", torch.device("cuda", 0), 1)
    cuda.launch("psa_fps", torch.device("cuda", 0), 1)  # the others still launch
