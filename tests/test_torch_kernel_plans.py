"""The host side of the port's kernels, without a card or nvcc: the launch
plans of FPS, ball query and three-NN (``ops/cuda/{fps,ball_query,
three_nn}.py:plan``; the interpolation's are in
``test_torch_interpolation.py``), the lean launch path
(``ops/cuda/__init__.py:launch``) and the wrappers' argument lists against a
stub ctypes library."""
from __future__ import annotations

import contextlib
import ctypes
import types

import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch.ops import cuda
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import ball_query as bq
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import fps
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_interpolate as ti
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_nn as tn
from pointcloud_segmentation_attention_tpu_torch.ops.geometry import radius_threshold


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


# ---- ball-query and three-NN plans --------------------------------------

@pytest.mark.parametrize("b, n, m, want", [
    # The main path at B16, SA1-4: 4 centres a warp at SA1, 2 at SA2.
    (16, 8192, 1024, bq.BallQueryPlan("ring", 4, 256, 1024, 2, 16 + 2 * 1024 * 12, 32)),
    (16, 1024, 256, bq.BallQueryPlan("whole", 2, 256, 1024, 1, 16 + 1024 * 12, 16)),
    (16, 256, 64, bq.BallQueryPlan("whole", 1, 256, 256, 1, 16 + 256 * 12, 8)),
    (16, 64, 16, bq.BallQueryPlan("whole", 1, 256, 64, 1, 16 + 64 * 12, 2)),
])
def test_ball_query_plan_at_main_path_shapes(b, n, m, want):
    assert bq.plan(b, n, m) == want


@pytest.mark.parametrize("b, n, m, want", [
    # The main path at B16, FP1-4 (N unknown, M known): the known cloud whole,
    # two unknowns a thread at FP4.
    (16, 64, 16, tn.ThreeNnPlan("whole", 1, 32, 32, 1, 16 + 32 * 12, 2)),
    (16, 256, 64, tn.ThreeNnPlan("whole", 1, 32, 64, 1, 16 + 64 * 12, 8)),
    (16, 1024, 256, tn.ThreeNnPlan("whole", 1, 128, 256, 1, 16 + 256 * 12, 8)),
    (16, 8192, 1024, tn.ThreeNnPlan("whole", 2, 256, 1024, 1, 16 + 1024 * 12, 16)),
])
def test_three_nn_plan_at_main_path_shapes(b, n, m, want):
    assert tn.plan(b, n, m) == want


def _check_ring(p, n):
    """A plan's tile ring holds the cloud of n points within the card's limit."""
    assert p.tile % 32 == 0 and p.tile >= 32 and p.stages in (1, 2)
    assert (p.variant == "whole") == (p.stages == 1)
    if p.stages == 1:
        assert p.tile >= n and p.tile - 32 < n  # the whole cloud, no idle warp of points
    assert p.smem_bytes == cuda.ring_bytes(p.tile, p.stages) <= cuda.MAX_SMEM_BYTES


@pytest.mark.parametrize("n", [1, 31, 33, 64, 1000, 1024, 1025, 8192, 8193, 33_024])
@pytest.mark.parametrize("m", [1, 7, 16, 256, 1000, 1024, 4097])
def test_ball_query_plan_covers_every_centre(n, m):
    for b in (1, 3, 16, 17):
        p = bq.plan(b, n, m)
        warps = p.threads // 32
        assert p.threads % 32 == 0 and 32 <= p.threads <= 256
        assert p.per_warp in bq.PER_WARP and p.per_warp <= m
        assert p.blocks * warps * p.per_warp >= m          # every centre has a warp
        assert (p.blocks - 1) * warps * p.per_warp < m     # and no block is idle
        assert (warps - 1) * p.per_warp < m                # nor a warp of a one-block cloud
        _check_ring(p, n)
        assert p.tile == min(bq.TILE, -(-n // 32) * 32)
        assert p.smem_bytes <= cuda.DEFAULT_SMEM_BYTES     # never needs the opt-in


@pytest.mark.parametrize("n", [1, 31, 33, 100, 1000, 1024, 8191, 8192, 8193, 40_000])
@pytest.mark.parametrize("m", [1, 2, 3, 16, 1000, 4095, 4096, 4097, 8192, 8193, 20_000])
def test_three_nn_plan_covers_every_unknown(n, m):
    for b in (1, 3, 16, 17):
        p = tn.plan(b, n, m)
        run = p.threads * p.per_thread  # unknowns a block
        assert p.threads in tn.THREADS and p.threads % 32 == 0 and p.threads <= 1024
        assert p.per_thread in tn.PER_THREAD
        assert p.blocks * run >= n > (p.blocks - 1) * run  # every unknown, no idle block
        _check_ring(p, m)
        whole = -(-m // 32) * 32 <= tn.WHOLE_MAX_POINTS
        assert p.variant == ("whole" if whole else "ring")
        if not whole:
            assert p.tile == tn.TILE


@pytest.mark.parametrize("plan, args", [
    (bq.plan, (0, 8192, 1024)), (bq.plan, (2, 0, 1024)), (bq.plan, (2, 8192, 0)),
    (tn.plan, (0, 8192, 1024)), (tn.plan, (2, 0, 1024)), (tn.plan, (2, 8192, 0)),
])
def test_ball_query_and_three_nn_plans_refuse_empty_shapes(plan, args):
    with pytest.raises(ValueError):
        plan(*args)


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
    monkeypatch.setattr(cuda, "_smem_allowed", {})
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
    assert set(cuda._SIGNATURES) == set(lib.lookups) and len(lib.lookups) == 10
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


@pytest.fixture
def cpu_wrappers(stub_library, monkeypatch):
    """Let the ball-query and three-NN wrappers take CPU tensors, so that their
    argument lists reach the stub library."""
    def accept(t, name, dtype, ndim, last=None):
        assert t.dtype == dtype and t.dim() == ndim and t.is_contiguous()

    monkeypatch.setattr(bq, "check_input", accept)
    monkeypatch.setattr(tn, "check_input", accept)
    monkeypatch.setattr(ti, "check_input", accept)
    bq.ball_query.launches = tn.three_nn.launches = 0
    ti.three_interpolate.launches = ti.three_interpolate_backward.launches = 0
    ti.interpolation_csr.launches = 0
    return stub_library


@pytest.mark.parametrize("b, n, m", [(16, 8192, 1024), (16, 1024, 256), (3, 33, 7), (2, 8193, 1)])
@pytest.mark.parametrize("nsample", [1, 13, 32, 64])
def test_ball_query_wrapper_passes_its_plan(cpu_wrappers, b, n, m, nsample):
    xyz, new_xyz = torch.zeros(b, n, 3), torch.zeros(b, m, 3)
    idx, cnt = bq.ball_query(xyz, new_xyz, 0.2, nsample)
    assert idx.shape == (b, m, nsample) and cnt.shape == (b, m)
    (lib,) = cpu_wrappers.libs
    (call,) = lib._fns["psa_ball_query"].calls
    p = bq.plan(b, n, m)
    assert call == (xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(), cnt.data_ptr(), b, n, m,
                    radius_threshold(0.2), nsample, p.per_warp, p.threads, p.tile, p.stages,
                    p.smem_bytes, p.blocks, 0xBEEF)
    assert len(call) == len(cuda._SIGNATURES["psa_ball_query"])
    assert bq.ball_query.launches == 1


@pytest.mark.parametrize("m", [1000, 4095, 4096, 4097, 6000, 8192, 8193, 20_000])
def test_three_nn_wrapper_allows_smem_exactly_above_48k(cpu_wrappers, m):
    b, n = 2, 300
    xyz1, xyz2 = torch.zeros(b, n, 3), torch.zeros(b, m, 3)
    p = tn.plan(b, n, m)
    outs = [tn.three_nn(xyz1, xyz2) for _ in range(2)]  # the second finds the size allowed
    (lib,) = cpu_wrappers.libs
    allowed = lib._fns["psa_three_nn_allow_smem"].calls
    assert allowed == ([(p.smem_bytes, 0xBEEF)] if p.smem_bytes > cuda.DEFAULT_SMEM_BYTES else [])
    calls = lib._fns["psa_three_nn"].calls
    assert calls == [(xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, m,
                      p.per_thread, p.threads, p.tile, p.stages, p.smem_bytes, p.blocks, 0xBEEF)
                     for dist, idx in outs]
    assert len(calls[0]) == len(cuda._SIGNATURES["psa_three_nn"])
    assert tn.three_nn.launches == 2


def test_three_nn_smem_opt_in_is_per_device_and_grows(cpu_wrappers):
    small, big = tn.plan(1, 10, 6000).smem_bytes, tn.plan(1, 10, 8000).smem_bytes
    assert cuda.DEFAULT_SMEM_BYTES < small < big
    cuda.allow_smem("psa_three_nn_allow_smem", torch.device("cuda", 0), big)
    cuda.allow_smem("psa_three_nn_allow_smem", torch.device("cuda", 0), small)  # covered
    cuda.allow_smem("psa_three_nn_allow_smem", torch.device("cuda", 1), small)  # other card
    cuda.allow_smem("psa_three_nn_allow_smem", torch.device("cuda", 0), 1024)   # needs none
    (lib,) = cpu_wrappers.libs
    assert lib._fns["psa_three_nn_allow_smem"].calls == [(big, 0xBEEF), (small, 0xBEEF)]
    assert cpu_wrappers.switches == [1]


def _interp_inputs(b, n, m, c, misaligned=False):
    flat = torch.zeros(b * m * c + 1)
    points = flat[1:].view(b, m, c) if misaligned else torch.zeros(b, m, c)
    return points, torch.zeros(b, n, 3, dtype=torch.int32), torch.zeros(b, n, 3)


@pytest.mark.parametrize("b, n, m, c, misaligned", [
    (16, 8192, 1024, 128, False), (16, 64, 16, 512, False), (3, 301, 17, 5, False),
    (2, 500, 40, 128, True), (2, 10, 3, 4, False)])
def test_three_interpolate_wrapper_passes_its_plan(cpu_wrappers, b, n, m, c, misaligned):
    points, idx, weight = _interp_inputs(b, n, m, c, misaligned)
    out = ti.three_interpolate(points, idx, weight)
    assert out.shape == (b, n, c)
    (lib,) = cpu_wrappers.libs
    (call,) = lib._fns["psa_three_interpolate"].calls
    p = ti.plan(b, n, m, c, not misaligned)
    assert call == (points.data_ptr(), idx.data_ptr(), weight.data_ptr(), out.data_ptr(), b, m,
                    n, c, int(p.vector), p.lanes, p.threads, p.blocks, 0xBEEF)
    assert len(call) == len(cuda._SIGNATURES["psa_three_interpolate"])
    assert ti.three_interpolate.launches == 1


@pytest.mark.parametrize("b, n, m", [(16, 8192, 1024), (16, 64, 16), (2, 2000, 33_024)])
def test_interpolation_csr_wrapper_passes_its_plan(cpu_wrappers, b, n, m):
    idx = torch.zeros(b, n, 3, dtype=torch.int32)
    offsets, entries = ti.interpolation_csr(idx, m)
    assert offsets.shape == (b * m + 1,) and entries.shape == (3 * b * n,)
    (lib,) = cpu_wrappers.libs
    (call,) = lib._fns["psa_interpolation_csr"].calls
    p = ti.csr_plan(b, n, m)
    assert call[:3] == (idx.data_ptr(), offsets.data_ptr(), entries.data_ptr())
    assert isinstance(call[3], int)  # the histograms' scratch
    assert call[4:] == (b, n, m, int(p.variant != "chunked"), p.steps, p.warps, p.smem_bytes,
                        0xBEEF)
    assert len(call) == len(cuda._SIGNATURES["psa_interpolation_csr"])
    assert ti.interpolation_csr.launches == 1


@pytest.mark.parametrize("b, n, m, c", [(16, 8192, 1024, 128), (16, 64, 16, 512),
                                        (2, 777, 3, 130)])
@pytest.mark.parametrize("need_dw", [True, False])
def test_three_interpolate_backward_wrapper_passes_its_plan(cpu_wrappers, b, n, m, c, need_dw):
    points, idx, weight = _interp_inputs(b, n, m, c)
    g = torch.zeros(b, n, c)
    dp, dw = ti.three_interpolate_backward(g, idx, weight, points, need_dw=need_dw)
    assert dp.shape == (b, m, c) and (dw is None) == (not need_dw)
    (lib,) = cpu_wrappers.libs
    (call,) = lib._fns["psa_three_interpolate_bwd"].calls
    p = ti.backward_plan(b, n, m, c, True)
    assert call[:6] == (g.data_ptr(), idx.data_ptr(), weight.data_ptr(),
                        points.data_ptr() if need_dw else None, dp.data_ptr(),
                        dw.data_ptr() if need_dw else None)
    # The column blocks' partial dot products need scratch only with dw and several blocks.
    assert (call[6] is None) == (not need_dw or p.col_blocks == 1)
    assert all(isinstance(ptr, int) for ptr in call[7:10])  # offsets, pairs, histograms
    csr = p.csr
    assert call[10:] == (b, m, n, c, int(csr.variant != "chunked"), csr.steps, csr.warps,
                         csr.smem_bytes, int(p.vector), p.lanes, p.ahead, p.col_blocks,
                         p.threads, 0xBEEF)
    assert len(call) == len(cuda._SIGNATURES["psa_three_interpolate_bwd"])
    assert ti.three_interpolate_backward.launches == 1
