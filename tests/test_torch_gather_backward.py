"""The gather backward's host side without a card: the plain CSR of idx's
transpose (``ops/geometry.py:transpose_csr``) against numpy's stable
argsort, the summation order of the plain backward on the CPU (which the
CUDA backward reproduces bit for bit), the launch plans of
``ops/cuda/group_gather.py`` and the wrappers' argument lists against the
stub library of ``test_torch_kernel_plans.py``.  Imports nothing of JAX, so
that the ``cuda`` test also runs on a machine with a card and no JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch.ops import cuda
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as tgeo
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import csr
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import group_gather as gg
from test_torch_kernel_plans import stub_library  # noqa: F401  (a fixture)

# The main path at B16: SA2-4 as (N rows, M centres, K slots, C channels).
SA_LEVELS = [(1024, 256, 32, 67), (256, 64, 32, 131), (64, 16, 32, 259)]
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)


def _numpy_csr(idx: np.ndarray, n_keys: int):
    b = idx.shape[0]
    keys = (idx.reshape(b, -1).astype(np.int64) + np.arange(b)[:, None] * n_keys).reshape(-1)
    entries = np.argsort(keys, kind="stable").astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=b * n_keys))])
    return offsets.astype(np.int32), entries


def _ball_idx(rng, b, n, m, k, radius):
    """Ball-query idx of m FPS centres of b clouds of n points: the padding
    repeats slot 0 in every slot at or beyond the hit count."""
    xyz = torch.from_numpy((rng.rand(b, n, 3) * EXTENT).astype(np.float32))
    centres = tgeo.gather_point(xyz, tgeo.farthest_point_sample(xyz, m))
    idx, _ = tgeo.ball_query(xyz, centres, radius, k)
    return idx


# ---- the plain CSR --------------------------------------------------------

@pytest.mark.parametrize("k", [3, 32])
@pytest.mark.parametrize("b, m, n", [(2, 100, 37), (3, 16, 64), (1, 50, 1), (2, 7, 1000),
                                     (1, 1, 5), (4, 256, 1024)])
def test_transpose_csr_matches_numpy_stable_argsort(b, m, k, n):
    rng = np.random.RandomState(b * 1000 + m + k)
    idx = torch.from_numpy(rng.randint(0, n, (b, m, k)).astype(np.int32))
    offsets, entries = tgeo.transpose_csr(idx, n)
    want_offsets, want_entries = _numpy_csr(idx.numpy(), n)
    assert offsets.dtype == entries.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    np.testing.assert_array_equal(entries.numpy(), want_entries)
    # Every entry once; each key's entries name it, ascending.
    assert sorted(entries.tolist()) == list(range(b * m * k))
    flat = idx.reshape(-1).numpy()
    for key in range(b * n):
        seg = entries[offsets[key]:offsets[key + 1]].numpy()
        assert (np.diff(seg) > 0).all()
        assert (seg // (m * k) == key // n).all() and (flat[seg] == key % n).all()


def test_transpose_csr_empty_keys_one_key_and_the_interpolation_name():
    # Keys no slot names get empty segments; with N = 1 one key takes all MK.
    idx = torch.tensor([[[4, 4], [0, 4]]], dtype=torch.int32)
    offsets, entries = tgeo.transpose_csr(idx, 6)
    assert offsets.tolist() == [0, 1, 1, 1, 1, 4, 4]
    assert entries.tolist() == [2, 0, 1, 3]
    offsets, entries = tgeo.transpose_csr(torch.zeros(2, 5, 4, dtype=torch.int32), 1)
    assert offsets.tolist() == [0, 20, 40] and entries.tolist() == list(range(40))
    # interpolation_csr is the same function under the interpolation's name.
    idx = torch.from_numpy(np.random.RandomState(1).randint(0, 9, (2, 30, 3)).astype(np.int32))
    for got, want in zip(tgeo.interpolation_csr(idx, 9), tgeo.transpose_csr(idx, 9)):
        assert torch.equal(got, want)


# ---- the order of the plain backward's sums on the CPU ---------------------

@pytest.mark.parametrize("b, n, m, k, c, radius", [
    (2, 300, 40, 16, 9, 0.3), (1, 1, 30, 8, 5, 1.0), (2, 1024, 256, 32, 67, 0.2),
    (2, 256, 64, 32, 131, 0.4), (3, 200, 50, 1, 3, 0.2), (1, 64, 16, 64, 4, 2.0)])
def test_plain_backward_sums_in_ascending_slot_order_on_the_cpu(b, n, m, k, c, radius):
    """dP on the CPU equals, bit for bit, each row's g rows added from 0 in
    ascending flat slot (b*M + m)*K + k, the order the CUDA backward adds
    them in.  Guards the oracle against an index_add_ that sums in another
    order.  Ball-query idx: slot 0's row collects the padding."""
    rng = np.random.RandomState(n + m + k)
    idx = _ball_idx(rng, b, n, m, k, radius)
    g = torch.from_numpy((rng.randn(b, m, k, c) * 10.0 ** rng.randint(-3, 3, (b, m, k, 1)))
                         .astype(np.float32))
    dp = tgeo.group_point_backward(g, idx, n)
    offsets, entries = _numpy_csr(idx.numpy(), n)
    gf = g.numpy().reshape(b * m * k, c)
    want = np.zeros((b * n, c), np.float32)
    for key in range(b * n):
        acc = np.zeros(c, np.float32)
        for e in entries[offsets[key]:offsets[key + 1]]:
            acc = acc + gf[e]  # float32 sums, one at a time
        want[key] = acc
    np.testing.assert_array_equal(dp.reshape(b * n, c).numpy(), want)


# ---- the backward's plans ---------------------------------------------------

@pytest.mark.parametrize("level, sort, consume", [
    # The fused CSR, 4 steps a warp where 32 warps allow (SA3-4), else 8
    # (SA2, 128 KB).  The consuming pass in floats (C 67/131/259), 3, 5 and
    # 5 elements a lane in 1/1/2 column blocks, 8 rows a round, a group per 16
    # places (B16 x MK / 16 windows) and per 32 rows (B16 x N / 32 zero
    # groups), 8 groups a block.
    (0, csr.CsrPlan("fused", 8, 32, 32, 32 * 1024 * 4, 0),
     (False, 32, 3, 8, 1, 256, (8192 + 512) // 8, 16)),
    (1, csr.CsrPlan("fused", 4, 16, 16, 16 * 256 * 4, 0),
     (False, 32, 5, 8, 1, 256, (2048 + 128) // 8, 16)),
    (2, csr.CsrPlan("fused", 4, 4, 4, 4 * 64 * 4, 0),
     (False, 32, 5, 8, 2, 256, (512 + 32) // 8, 16)),
])
def test_backward_plan_at_main_path_shapes(level, sort, consume):
    n, m, k, c = SA_LEVELS[level]
    p = gg.backward_plan(16, n, m, k, c, True)
    assert p.csr == sort and tuple(p)[1:] == consume
    assert gg.csr_plan(16, n, m, k) == csr.plan(16, m * k, n, csr.SMEM_MAX, gg.FUSED_STEPS)


@pytest.mark.parametrize("n", [1, 2, 64, 1000, 1024, 12_032, 12_033, 33_024])
@pytest.mark.parametrize("m, k", [(1, 1), (16, 32), (101, 13), (256, 32), (4096, 32), (64, 64)])
def test_csr_plan_covers_every_slot(n, m, k):
    for b in (1, 3, 16, 17):
        p = gg.csr_plan(b, n, m, k)
        per_chunk = 32 * p.steps
        assert p.chunks * per_chunk >= m * k > (p.chunks - 1) * per_chunk
        if p.variant == "fused":
            assert p.warps == p.chunks <= csr.FUSED_WARPS and p.steps <= csr.FUSED_MAX_STEPS
            assert p.smem_bytes == 4 * n * p.warps <= csr.SMEM_MAX and p.hist_ints == 0
            assert p.key_tile == n
            # 4 steps a warp, or more only where 32 warps would not cover it.
            assert p.steps <= gg.FUSED_STEPS or p.warps == min(
                csr.FUSED_WARPS, csr.SMEM_MAX // (4 * n))
        elif p.variant == "tiled":
            # Beyond a warp's counters in SMEM_LIMIT: up to 32 warps share a
            # batch, in the fewest steps; a block counts one tile of keys.
            assert 4 * n > csr.SMEM_LIMIT and p.hist_ints == 0
            assert p.warps == p.chunks <= csr.FUSED_WARPS
            assert p.steps == -(-m * k // (32 * csr.FUSED_WARPS))
            assert p.key_tile == min(n, csr.SMEM_MAX // (4 * p.warps))
            assert p.smem_bytes == 4 * p.key_tile * p.warps <= csr.SMEM_MAX
        else:
            assert p.variant == "chunked" and 1 <= p.warps <= max(csr.WARPS)
            assert p.hist_ints == b * p.chunks * (n + -(-n // csr.SCAN_TILE))
            assert p.smem_bytes == 4 * n * p.warps <= csr.SMEM_LIMIT


@pytest.mark.parametrize("c", [1, 3, 4, 5, 9, 64, 67, 128, 131, 259, 512, 1000])
@pytest.mark.parametrize("is_aligned", [True, False])
def test_backward_plan_covers_every_row_and_column(c, is_aligned):
    for b, n in ((1, 1), (3, 33), (16, 1024), (17, 8193)):
        p = gg.backward_plan(b, n, 40, 32, c, is_aligned)
        assert p.vector == (is_aligned and c % 4 == 0)
        width = c // 4 if p.vector else c
        assert p.lanes == min(32, 1 << max(0, width - 1).bit_length())
        most = gg.MAX_PER_LANE_VEC if p.vector else gg.MAX_PER_LANE
        assert 1 <= p.per_lane <= most and p.ahead == gg.AHEAD[p.vector][p.per_lane]
        # A round's loads in at most 40 registers a lane.
        assert p.ahead * p.per_lane * (4 if p.vector else 1) <= 40
        # Every element in a block, the fewest blocks, no block without work.
        assert p.col_blocks * p.lanes * p.per_lane >= width
        assert (p.col_blocks - 1) * p.lanes * most < width
        assert (p.col_blocks - 1) * p.lanes * p.per_lane < width
        # A group per window of the CSR's places and per ZERO_KEYS rows,
        # every group in a block.
        per_block = p.threads // p.lanes
        windows = gg.windows(b, 40, 32, p.window)
        assert windows * p.window >= b * 40 * 32 > (windows - 1) * p.window
        groups = windows + -(-(b * n) // gg.ZERO_KEYS)
        assert p.blocks * per_block >= groups > (p.blocks - 1) * per_block


@pytest.mark.parametrize("plan, args", [
    (gg.csr_plan, (0, 10, 10, 4)), (gg.csr_plan, (2, 0, 10, 4)), (gg.csr_plan, (2, 10, 0, 4)),
    (gg.csr_plan, (2, 10, 10, 0)), (gg.csr_plan, (2, 10, 40_000_000, 32)),
    (gg.backward_plan, (2, 10, 10, 4, 0, True)), (csr.plan, (1, 0, 4)), (csr.plan, (1, 4, 0)),
])
def test_gather_plans_refuse_bad_shapes(plan, args):
    with pytest.raises(ValueError):
        plan(*args)


# ---- the wrappers' argument lists -------------------------------------------

@pytest.fixture
def cpu_gather(stub_library, monkeypatch):  # noqa: F811
    """Let the gather wrappers take CPU tensors, so that their argument lists
    reach the stub library."""
    def accept(t, name, dtype, ndim, last=None):
        assert t.dtype == dtype and t.dim() == ndim and t.is_contiguous()

    monkeypatch.setattr(gg, "check_input", accept)
    gg.group_point_backward.launches = gg.group_gather_csr.launches = 0
    return stub_library


@pytest.mark.parametrize("b, n, m, k, c, misaligned", [
    (16, 1024, 256, 32, 67, False), (16, 256, 64, 32, 131, False), (16, 64, 16, 32, 259, False),
    (2, 33_024, 4096, 32, 64, False), (2, 500, 40, 16, 128, True), (1, 1, 5, 3, 4, False)])
def test_group_point_backward_wrapper_passes_its_plan(cpu_gather, b, n, m, k, c, misaligned):
    flat = torch.zeros(b * m * k * c + 1)
    g = flat[1:].view(b, m, k, c) if misaligned else torch.zeros(b, m, k, c)
    idx = torch.zeros(b, m, k, dtype=torch.int32)
    dp = gg.group_point_backward(g, idx, n)
    assert dp.shape == (b, n, c)
    (lib,) = cpu_gather.libs
    (call,) = lib._fns["psa_group_gather_bwd"].calls
    p = gg.backward_plan(b, n, m, k, c, not misaligned)
    assert p.vector == (c % 4 == 0 and not misaligned)
    assert call[:3] == (g.data_ptr(), idx.data_ptr(), dp.data_ptr())
    # One scratch tensor: the windows' (first key, offset) pairs, 8-byte
    # aligned, then the CSR's entries, its offsets and the histograms.
    sort = p.csr
    first_at = call[6]
    assert first_at % 8 == 0 and call[4] == first_at + 8 * (gg.windows(b, m, k, p.window) + 1)
    assert call[3] == call[4] + 4 * b * m * k and call[5] == call[3] + 4 * (b * n + 1)
    assert call[7:] == (b, n, c, m, k, int(sort.variant != "chunked"), sort.steps, sort.warps,
                        sort.smem_bytes, int(p.vector), p.lanes, p.per_lane, p.ahead,
                        p.col_blocks, p.threads, p.window, 0xBEEF)
    assert len(call) == len(cuda._SIGNATURES["psa_group_gather_bwd"])
    assert gg.group_point_backward.launches == 1


@pytest.mark.parametrize("b, n, m, k", [(16, 1024, 256, 32), (16, 64, 16, 32), (2, 33_024, 4096, 32)])
def test_group_gather_csr_wrapper_passes_its_plan(cpu_gather, b, n, m, k):
    idx = torch.zeros(b, m, k, dtype=torch.int32)
    offsets, entries = gg.group_gather_csr(idx, n)
    assert offsets.shape == (b * n + 1,) and entries.shape == (b * m * k,)
    (lib,) = cpu_gather.libs
    (call,) = lib._fns["psa_group_gather_csr"].calls
    p = gg.csr_plan(b, n, m, k)
    assert call[:3] == (idx.data_ptr(), offsets.data_ptr(), entries.data_ptr())
    assert isinstance(call[3], int)  # the histograms' scratch
    assert call[4:] == (b, n, m, k, int(p.variant != "chunked"), p.steps, p.warps,
                        p.smem_bytes, 0xBEEF)
    assert len(call) == len(cuda._SIGNATURES["psa_group_gather_csr"])
    assert gg.group_gather_csr.launches == 1


def test_empty_backward_launches_nothing(cpu_gather):
    g, idx = torch.zeros(2, 0, 32, 5), torch.zeros(2, 0, 32, dtype=torch.int32)
    dp = gg.group_point_backward(g, idx, 7)
    assert dp.shape == (2, 7, 5) and not dp.any()
    assert cpu_gather.libs == [] or not cpu_gather.libs[0]._fns["psa_group_gather_bwd"].calls
    assert gg.group_point_backward.launches == 0


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_cuda_gather_backward_is_bit_equal_to_the_cpu_and_reproducible(cuda_device, level):
    """At SA2-4 on ball-query idx: two calls give the same bits, and both
    equal the plain version run on CPU copies; the CSR equals
    ``transpose_csr``."""
    n, m, k, c = SA_LEVELS[level]
    rng = np.random.RandomState(level)
    idx = _ball_idx(rng, 4, n, m, k, (0.2, 0.4, 0.8)[level]).to(cuda_device)
    g = torch.from_numpy(rng.randn(4, m, k, c).astype(np.float32)).to(cuda_device)
    first = gg.group_point_backward(g, idx, n)
    second = gg.group_point_backward(g, idx, n)
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), tgeo.group_point_backward(g.cpu(), idx.cpu(), n))
    for got, want in zip(gg.group_gather_csr(idx, n), tgeo.transpose_csr(idx.cpu(), n)):
        assert torch.equal(got.cpu(), want)
