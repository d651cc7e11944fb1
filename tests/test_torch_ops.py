"""Parity of the PyTorch port's geometry ops with the JAX package.

The same seeded numpy inputs go through the JAX functions (the XLA versions
in ``ops.geometry`` and the Pallas kernels in interpret mode, as
``tests/test_pallas_kernels.py`` runs them) and through the port's plain
versions on the CPU.  Index outputs must be equal; float outputs agree within
rtol=1e-6, atol=1e-6.  The CUDA kernels are held against the plain versions
on the card by the tests marked ``cuda`` below and by ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_attention_tpu.ops import geometry as jgeo
from pointcloud_segmentation_attention_tpu.ops.pallas import (
    ball_query_pallas,
    farthest_point_sample_pallas,
    three_nn_pallas,
)
from pointcloud_segmentation_attention_tpu.ops.pallas.group_gather_kernel import (
    group_gather,
)
from pointcloud_segmentation_attention_tpu_torch import ops as tops
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as tgeo

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)  # one serving chunk's extent


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.fixture
def rng():
    return np.random.RandomState(11)


@pytest.mark.parametrize("b,n,npoint", [(2, 300, 37), (3, 256, 128), (2, 2048, 256),
                                        (1, 5, 1), (1, 8, 8)])
def test_fps_matches_jax(rng, b, n, npoint):
    xyz = (rng.rand(b, n, 3) * EXTENT).astype(np.float32)
    got = tgeo.farthest_point_sample(_t(xyz), npoint).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _np(jgeo.farthest_point_sample(jnp.asarray(xyz), npoint)))
    if n >= 256:
        np.testing.assert_array_equal(
            got, _np(farthest_point_sample_pallas(jnp.asarray(xyz), npoint, True)))


def test_fps_ties_go_to_lower_index():
    # A 2x2 grid with duplicated corners: every pick is a tie.
    xyz = np.array([[[0, 0, 0], [1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0], [1, 1, 0]]],
                   np.float32)
    got = tgeo.farthest_point_sample(_t(xyz), 4).numpy()
    np.testing.assert_array_equal(got, _np(jgeo.farthest_point_sample(jnp.asarray(xyz), 4)))
    np.testing.assert_array_equal(got, [[0, 5, 1, 3]])


def _centers(xyz, m):
    idx = _np(jgeo.farthest_point_sample(jnp.asarray(xyz), m))
    return np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)


@pytest.mark.parametrize("radius,nsample", [(0.1, 32), (0.2, 16), (0.5, 8), (3.0, 16)])
def test_ball_query_matches_jax_mixed_density(rng, radius, nsample):
    n = 2048
    xyz = (rng.rand(2, n, 3) * EXTENT).astype(np.float32)
    centers = np.concatenate([_centers(xyz, 6), np.full((2, 2, 3), 50.0, np.float32)], 1)
    gi, gc = tgeo.ball_query(_t(xyz), _t(centers), radius, nsample)
    assert gi.dtype == torch.int32 and gc.dtype == torch.int32
    wi, wc = jgeo.ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, nsample)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gc.numpy(), _np(wc))
    pi, pc = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), radius, nsample, True)
    np.testing.assert_array_equal(gi.numpy(), _np(pi))
    np.testing.assert_array_equal(gc.numpy(), _np(pc))


def test_ball_query_empty_and_full():
    xyz = np.zeros((1, 8, 3), np.float32)
    xyz[0, :, 0] = np.arange(8)
    centers = np.array([[[100.0, 0, 0], [0.0, 0, 0]]], np.float32)
    gi, gc = tgeo.ball_query(_t(xyz), _t(centers), 2.5, 4)
    assert gc[0, 0] == 0 and (gi[0, 0] == 0).all()
    assert gc[0, 1] == 3
    np.testing.assert_array_equal(gi[0, 1].numpy(), [0, 1, 2, 0])
    pi, pc = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), 2.5, 4, True)
    np.testing.assert_array_equal(gi.numpy(), _np(pi))
    np.testing.assert_array_equal(gc.numpy(), _np(pc))


def test_ball_query_nsample_exceeds_n(rng):
    xyz = rng.rand(2, 5, 3).astype(np.float32)
    centers = xyz[:, :3].copy()
    gi, gc = tgeo.ball_query(_t(xyz), _t(centers), 0.7, 8)
    wi, wc = jgeo.ball_query(jnp.asarray(xyz), jnp.asarray(centers), 0.7, 8)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gc.numpy(), _np(wc))


def test_ball_query_large_n(rng):
    n = (1 << 15) + 256
    xyz = (rng.rand(1, n, 3) * 0.2).astype(np.float32)
    centers = xyz[:, :8].copy()
    gi, gc = tgeo.ball_query(_t(xyz), _t(centers), 0.5, 8)
    wi, wc = jgeo.ball_query(jnp.asarray(xyz), jnp.asarray(centers), 0.5, 8)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gc.numpy(), _np(wc))


def test_fps_large_n(rng):
    n = (1 << 15) + 256
    xyz = rng.rand(1, n, 3).astype(np.float32)
    got = tgeo.farthest_point_sample(_t(xyz), 16).numpy()
    np.testing.assert_array_equal(got, _np(jgeo.farthest_point_sample(jnp.asarray(xyz), 16)))


def test_ball_query_threshold_is_float32_of_double_square():
    r = 0.1
    assert tgeo.radius_threshold(r) == float(np.float32(r * r))
    assert tgeo.radius_threshold(0.0) == float(np.float32(1e-40))


@pytest.mark.parametrize("radius", [0.05, 0.9])
def test_group_point_matches_jax_and_pallas(rng, radius):
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    pts = rng.rand(2, 300, 9).astype(np.float32)
    centers = _centers(xyz, 40)
    idx, cnt = jgeo.ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, 16)
    got = tops.group_point_with_counts(_t(pts), _t(_np(idx)), _t(_np(cnt))).numpy()
    np.testing.assert_array_equal(got, _np(jgeo.group_point(jnp.asarray(pts), idx)))
    np.testing.assert_array_equal(got, _np(group_gather(jnp.asarray(pts), idx, cnt, True)))


def test_gather_point_matches_jax(rng):
    pts = rng.rand(2, 50, 5).astype(np.float32)
    idx = rng.randint(0, 50, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tgeo.gather_point(_t(pts), _t(idx)).numpy(),
        _np(jgeo.gather_point(jnp.asarray(pts), jnp.asarray(idx))))


@pytest.mark.parametrize("n,m", [(100, 16), (256, 64), (1024, 256)])
def test_three_nn_matches_jax(rng, n, m):
    xyz1 = (rng.rand(2, n, 3) * EXTENT).astype(np.float32)
    xyz2 = (rng.rand(2, m, 3) * EXTENT).astype(np.float32)
    gd, gi = tgeo.three_nn(_t(xyz1), _t(xyz2))
    assert gi.dtype == torch.int32
    wd, wi = jgeo.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_allclose(gd.numpy(), _np(wd), **FLOAT_TOL)
    pd, pi = three_nn_pallas(jnp.asarray(xyz1), jnp.asarray(xyz2), True)
    np.testing.assert_array_equal(gi.numpy(), _np(pi))
    np.testing.assert_allclose(gd.numpy(), _np(pd), **FLOAT_TOL)


def test_three_nn_ties_go_to_lower_index():
    xyz2 = np.array([[[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0]]], np.float32)
    xyz1 = np.zeros((1, 1, 3), np.float32)
    _, gi = tgeo.three_nn(_t(xyz1), _t(xyz2))
    _, wi = jgeo.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gi.numpy(), [[[0, 1, 2]]])


@pytest.mark.parametrize("m", [1, 2])
def test_three_nn_fewer_than_three_known(rng, m):
    xyz1 = rng.randn(2, 20, 3).astype(np.float32)
    xyz2 = rng.randn(2, m, 3).astype(np.float32)
    gd, gi = tgeo.three_nn(_t(xyz1), _t(xyz2))
    wd, wi = jgeo.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_allclose(gd.numpy(), _np(wd), **FLOAT_TOL)
    assert (gd.numpy()[..., m:] == np.finfo(np.float32).max).all()


def test_interpolation_matches_jax(rng):
    xyz1 = (rng.rand(2, 512, 3) * EXTENT).astype(np.float32)
    xyz2 = (rng.rand(2, 64, 3) * EXTENT).astype(np.float32)
    xyz1[:, :4] = xyz2[:, :4]  # zero distances exercise the eps clamp
    pts = rng.randn(2, 64, 33).astype(np.float32)
    dist, idx = jgeo.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    w_j = jgeo.interpolation_weights(dist)
    w_t = tgeo.interpolation_weights(_t(_np(dist)))
    np.testing.assert_allclose(w_t.numpy(), _np(w_j), **FLOAT_TOL)
    got = tgeo.three_interpolate(_t(pts), _t(_np(idx)), _t(_np(w_j))).numpy()
    want = _np(jgeo.three_interpolate(jnp.asarray(pts), idx, w_j))
    np.testing.assert_allclose(got, want, **FLOAT_TOL)


def test_dispatch_routes_cpu_tensors_to_plain(rng):
    from pointcloud_segmentation_attention_tpu_torch.ops import cuda

    cuda.reset_launches()
    xyz = _t(rng.rand(1, 64, 3).astype(np.float32))
    np.testing.assert_array_equal(tops.farthest_point_sample(xyz, 8).numpy(),
                                  tgeo.farthest_point_sample(xyz, 8).numpy())
    assert set(cuda.launch_counts().values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    from pointcloud_segmentation_attention_tpu_torch.ops.cuda import fps

    with pytest.raises(ValueError, match="CUDA"):
        fps.farthest_point_sample(_t(rng.rand(1, 8, 3).astype(np.float32)), 2)


# ---- on the card: each kernel against its plain version ------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device, rng):
    xyz = _t((rng.rand(2, 4096, 3) * EXTENT).astype(np.float32)).to(cuda_device)
    fps = tops.farthest_point_sample(xyz, 512)
    torch.testing.assert_close(fps, tgeo.farthest_point_sample(xyz, 512), rtol=0, atol=0)
    new_xyz = tgeo.gather_point(xyz, fps)
    idx, cnt = tops.ball_query(xyz, new_xyz, 0.2, 32)
    pidx, pcnt = tgeo.ball_query(xyz, new_xyz, 0.2, 32)
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    torch.testing.assert_close(cnt, pcnt, rtol=0, atol=0)
    pts = torch.rand(2, 4096, 67, device=cuda_device)
    torch.testing.assert_close(tops.group_point_with_counts(pts, idx, cnt),
                               tgeo.group_point(pts, idx), rtol=0, atol=0)
    dist, nn_idx = tops.three_nn(xyz, new_xyz)
    pdist, pnn_idx = tgeo.three_nn(xyz, new_xyz)
    torch.testing.assert_close(nn_idx, pnn_idx, rtol=0, atol=0)
    torch.testing.assert_close(dist, pdist, rtol=0, atol=0)
    w = tgeo.interpolation_weights(dist)
    feats = torch.rand(2, 512, 128, device=cuda_device)
    torch.testing.assert_close(tops.three_interpolate(feats, nn_idx, w),
                               tgeo.three_interpolate(feats, nn_idx, w), **FLOAT_TOL)


# Edge shapes of the ball-query and three-NN launch plans
# (``ops/cuda/{ball_query,three_nn}.py:plan``): every variant, ragged tiles
# and blocks, empty and full balls, M < 3, ties.  Bit-identical on the card.
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,radius,nsample,scale", [
    (1, 8192, 1024, 0.1, 32, 1.0),     # ring, one centre a warp
    (17, 8192, 1024, 0.1, 32, 1.0),    # ring, four centres a warp
    (2, 1, 1, 0.5, 4, 1.0),            # N 1, nsample > N
    (3, 31, 31, 0.5, 13, 1.0),
    (2, 33, 33, 1.0, 64, 1.0),         # nsample > N and > a warp
    (3, 8193, 1000, 0.2, 32, 1.0),     # a last tile of one point
    (6, 1024, 1000, 0.2, 32, 1.0),     # whole, two centres a warp, ragged block
    (5, 4096, 1000, 0.2, 32, 1.0),     # ring, two centres a warp
    (16, 1024, 1024, 0.2, 32, 1.0),    # whole, four centres a warp
    (2, 4096, 256, 1e-4, 16, 1.0),     # empty balls
    (16, 8192, 1024, 2.0, 64, 0.2),    # every ball full in the first tile
])
def test_cuda_ball_query_edge_shapes_match_plain(cuda_device, rng, b, n, m, radius, nsample,
                                                 scale):
    xyz = _t((rng.rand(b, n, 3) * EXTENT * scale).astype(np.float32)).to(cuda_device)
    new_xyz = xyz[:, _t(rng.randint(0, n, m)).to(cuda_device)].contiguous()
    idx, cnt = tops.ball_query(xyz, new_xyz, radius, nsample)
    pidx, pcnt = tgeo.ball_query(xyz, new_xyz, radius, nsample)
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    torch.testing.assert_close(cnt, pcnt, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_ball_query_point_on_the_sphere_is_no_hit(cuda_device):
    xyz = torch.tensor([[[0.5, 0, 0], [0, 0, 0], [0.25, 0, 0], [0.4999, 0, 0]]],
                       device=cuda_device)
    idx, cnt = tops.ball_query(xyz, xyz[:, 1:2].contiguous(), 0.5, 4)
    assert cnt.tolist() == [[3]] and idx.tolist() == [[[1, 2, 3, 1]]]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,equal", [
    (2, 1000, 1, False), (3, 500, 2, False), (2, 777, 3, False),
    (4, 5000, 1000, False),
    (2, 2000, 6000, False),     # whole cloud above 48 KB of shared memory
    (2, 3000, 10_000, False),   # the ring
    (16, 8191, 1024, False),    # a ragged last block
    (2, 4096, 1024, True),      # all known points equal: ties by index
    (1, 8192, 1024, False), (17, 8192, 1024, False),
])
def test_cuda_three_nn_edge_shapes_match_plain(cuda_device, rng, b, n, m, equal):
    xyz1 = _t((rng.rand(b, n, 3) * EXTENT).astype(np.float32)).to(cuda_device)
    known = np.full((b, m, 3), 0.7) if equal else rng.rand(b, m, 3) * EXTENT
    xyz2 = _t(known.astype(np.float32)).to(cuda_device)
    dist, idx = tops.three_nn(xyz1, xyz2)
    pdist, pidx = tgeo.three_nn(xyz1, xyz2)
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    torch.testing.assert_close(dist, pdist, rtol=0, atol=0)
