"""The interpolation's host side without a card: the plain CSR of idx's
transpose (``ops/geometry.py:interpolation_csr``) against numpy's stable
argsort, the summation order of the plain backward on the CPU (which the
CUDA backward reproduces bit for bit), and the launch plans of
``ops/cuda/three_interpolate.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch.ops import geometry as tgeo
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import csr
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_interpolate as ti

# The main path at B16: FP1-4 as (N unknown, M known, C channels).
FP_LEVELS = [(64, 16, 512), (256, 64, 256), (1024, 256, 256), (8192, 1024, 128)]


def _idx(rng, b, n, m):
    return torch.from_numpy(rng.randint(0, m, (b, n, 3)).astype(np.int32))


def _numpy_csr(idx: np.ndarray, m: int):
    b = idx.shape[0]
    keys = (idx.astype(np.int64) + np.arange(b)[:, None, None] * m).reshape(-1)
    entries = np.argsort(keys, kind="stable").astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=b * m))])
    return offsets.astype(np.int32), entries


# ---- the plain CSR --------------------------------------------------------

@pytest.mark.parametrize("b, n, m", [(2, 300, 37), (3, 64, 16), (1, 50, 1), (2, 7, 1000),
                                     (1, 1, 5), (4, 1024, 256)])
def test_interpolation_csr_matches_numpy_stable_argsort(b, n, m):
    rng = np.random.RandomState(b * 1000 + m)
    idx = _idx(rng, b, n, m)
    offsets, entries = tgeo.interpolation_csr(idx, m)
    want_offsets, want_entries = _numpy_csr(idx.numpy(), m)
    assert offsets.dtype == entries.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    np.testing.assert_array_equal(entries.numpy(), want_entries)
    # Every entry once; each key's entries name it, ascending.
    assert sorted(entries.tolist()) == list(range(3 * b * n))
    flat = idx.reshape(-1).numpy()
    for key in range(b * m):
        seg = entries[offsets[key]:offsets[key + 1]].numpy()
        assert (np.diff(seg) > 0).all()
        assert (seg // (3 * n) == key // m).all() and (flat[seg] == key % m).all()


def test_interpolation_csr_empty_segments_and_one_key():
    # Keys no entry names get empty segments; with M = 1 one key takes all 3N.
    idx = torch.tensor([[[4, 4, 0], [4, 0, 4]]], dtype=torch.int32)
    offsets, entries = tgeo.interpolation_csr(idx, 6)
    assert offsets.tolist() == [0, 2, 2, 2, 2, 6, 6]
    assert entries.tolist() == [2, 4, 0, 1, 3, 5]
    offsets, entries = tgeo.interpolation_csr(torch.zeros(2, 5, 3, dtype=torch.int32), 1)
    assert offsets.tolist() == [0, 15, 30] and entries.tolist() == list(range(30))


# ---- the order of the plain backward's sums on the CPU ---------------------

@pytest.mark.parametrize("b, n, m, c", [(2, 300, 1, 5), (2, 1024, 256, 64), (1, 500, 3, 7),
                                        (2, 2048, 512, 32)])
def test_plain_backward_sums_in_ascending_n_k_on_the_cpu(b, n, m, c):
    """dP on the CPU equals, bit for bit, each key's products w * g added
    from 0 in ascending (n, k), the order the CUDA backward adds them in.
    Guards the oracle against an index_add_ that sums in another order."""
    rng = np.random.RandomState(n + m)
    idx = _idx(rng, b, n, m)
    w = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    pts = torch.from_numpy(rng.randn(b, m, c).astype(np.float32))
    dp, _ = tgeo.three_interpolate_backward(g, idx, w, pts)
    offsets, entries = _numpy_csr(idx.numpy(), m)
    wf, gf = w.numpy().reshape(-1), g.numpy().reshape(b * n, c)
    want = np.zeros((b * m, c), np.float32)
    for key in range(b * m):
        acc = np.zeros(c, np.float32)
        for e in entries[offsets[key]:offsets[key + 1]]:
            acc = acc + wf[e] * gf[e // 3]  # float32 products and sums, one at a time
        want[key] = acc
    np.testing.assert_array_equal(dp.reshape(b * m, c).numpy(), want)


# ---- the forward's plan -----------------------------------------------------

@pytest.mark.parametrize("level, want", [
    # 32 lanes of up to 4 float4s at FP1-3 (C 512, 256), 16 of 2 at FP4 (C 128).
    (0, ti.InterpolatePlan(True, 32, 1, 128, 16)),
    (1, ti.InterpolatePlan(True, 32, 1, 128, 64)),
    (2, ti.InterpolatePlan(True, 32, 1, 128, 256)),
    (3, ti.InterpolatePlan(True, 16, 2, 128, 1024)),
])
def test_plan_at_main_path_shapes(level, want):
    n, m, c = FP_LEVELS[level]
    assert ti.plan(16, n, m, c, True) == want


@pytest.mark.parametrize("c, is_aligned, vector, lanes", [
    (128, True, True, 16), (128, False, False, 32), (4, True, True, 1), (8, True, True, 1),
    (12, True, True, 2), (130, True, False, 32), (5, True, False, 4), (3, True, False, 2),
    (1, True, False, 1), (1, False, False, 1), (64, True, True, 8), (1024, True, True, 32),
])
def test_plan_vector_or_scalar_over_c_and_alignment(c, is_aligned, vector, lanes):
    p = ti.plan(2, 100, 10, c, is_aligned)
    assert (p.vector, p.lanes) == (vector, lanes)
    width = c // 4 if vector else c
    assert p.lanes * ti.PER_ROW_LANE >= width or p.lanes == 32  # at most two elements a lane
    assert p.rows_per_warp == 32 // p.lanes


@pytest.mark.parametrize("n", [1, 31, 33, 64, 1000, 8191, 8192, 33_024])
@pytest.mark.parametrize("c", [1, 3, 5, 128, 130, 512])
def test_plan_covers_every_row(n, c):
    for b in (1, 3, 16, 17):
        p = ti.plan(b, n, 7, c, True)
        per_block = p.threads // p.lanes
        assert p.blocks * per_block >= n > (p.blocks - 1) * per_block
        assert p.threads % 32 == 0 and p.threads % p.lanes == 0


def test_aligned_sees_a_sliced_tensor():
    x = torch.zeros(65)
    assert ti.aligned(x[:64]) and not ti.aligned(x[1:])


# ---- the backward's plans ---------------------------------------------------

@pytest.mark.parametrize("level, csr, consume", [
    # FP1-3: the fused CSR, one block a batch; FP4: chunked, 16 steps a chunk.
    (0, ti.CsrPlan("fused", 1, 6, 6, 6 * 16 * 4, 0), (True, 32, 8, 4, 256, 32)),
    (1, ti.CsrPlan("fused", 1, 24, 24, 24 * 64 * 4, 0), (True, 32, 8, 2, 256, 128)),
    (2, ti.CsrPlan("fused", 3, 32, 32, 32 * 256 * 4, 0), (True, 32, 4, 2, 128, 1024)),
    (3, ti.CsrPlan("chunked", 16, 48, 2, 2 * 1024 * 4, 16 * 48 * (1024 + 4)),
     (True, 32, 4, 1, 128, 4096)),
])
def test_backward_plan_at_main_path_shapes(level, csr, consume):
    n, m, c = FP_LEVELS[level]
    p = ti.backward_plan(16, n, m, c, True)
    assert p.csr == csr and tuple(p)[1:] == consume


@pytest.mark.parametrize("n", [1, 10, 11, 300, 1024, 8192, 8193])
@pytest.mark.parametrize("m", [1, 2, 3, 16, 256, 1024, 12_032, 12_033, 33_024])
def test_csr_plan_covers_every_entry(n, m):
    for b in (1, 3, 16, 17):
        p = ti.csr_plan(b, n, m)
        per_chunk = 32 * p.steps
        assert p.chunks * per_chunk >= 3 * n > (p.chunks - 1) * per_chunk
        if p.variant == "fused":
            assert p.warps == p.chunks <= csr.FUSED_WARPS and p.steps <= csr.FUSED_MAX_STEPS
            assert p.smem_bytes == 4 * m * p.warps <= csr.SMEM_LIMIT and p.hist_ints == 0
        elif p.variant == "chunked":
            assert 1 <= p.warps <= max(csr.WARPS)
            assert p.hist_ints == b * p.chunks * (m + -(-m // csr.SCAN_TILE))
            # Counters in shared memory while a warp's M ints fit.
            assert p.smem_bytes == 4 * m * p.warps <= csr.SMEM_LIMIT
        else:
            # Beyond that, tiled: a block per tile of keys, its counters within SMEM_MAX.
            assert p.variant == "tiled" and 4 * m > csr.SMEM_LIMIT and p.hist_ints == 0
            assert p.warps == p.chunks <= csr.FUSED_WARPS
            assert p.smem_bytes == 4 * p.key_tile * p.warps <= csr.SMEM_MAX


@pytest.mark.parametrize("c, is_aligned, vector, lanes, col_blocks", [
    (128, True, True, 32, 1), (512, True, True, 32, 4), (128, False, False, 32, 4),
    (130, True, False, 32, 5), (5, True, False, 8, 1), (1, True, False, 1, 1),
    (4, True, True, 1, 1), (64, True, True, 16, 1),
])
def test_backward_plan_column_blocks(c, is_aligned, vector, lanes, col_blocks):
    p = ti.backward_plan(2, 100, 10, c, is_aligned)
    assert (p.vector, p.lanes, p.col_blocks) == (vector, lanes, col_blocks)
    width = c // 4 if vector else c
    assert p.col_blocks * p.lanes >= width > (p.col_blocks - 1) * p.lanes
    assert p.blocks * (p.threads // p.lanes) >= 2 * 10


@pytest.mark.parametrize("plan, args", [
    (ti.plan, (0, 10, 10, 8, True)), (ti.plan, (2, 0, 10, 8, True)),
    (ti.plan, (2, 10, 0, 8, True)), (ti.plan, (2, 10, 10, 0, True)),
    (ti.csr_plan, (0, 10, 10)), (ti.csr_plan, (2, 0, 10)), (ti.csr_plan, (2, 10, 0)),
    (ti.csr_plan, (2, 400_000_000, 10)), (ti.backward_plan, (2, 10, 10, 0, True)),
])
def test_interpolation_plans_refuse_bad_shapes(plan, args):
    with pytest.raises(ValueError):
        plan(*args)
