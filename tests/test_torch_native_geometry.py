"""The port's host three-NN and ball query (``native.three_nn``,
``native.ball_query``, ``native/geometry_cpu.cpp``) against the JAX
package's compiled ``native_ops.cpp``, on the CPU.

The port's C++ must equal the JAX package's bit for bit: indices, counts
and distances, on seeded clouds at B2 x N 128-2048 x M 16-512, with points
placed exactly on the radius and with duplicated points (ties).  Then the
C++ against the plain versions (``ops/geometry.py``), which compare squared
distances in float32 where the C++ takes a square root (ball query) or
works in double (three-NN): the rows where they differ are counted at the
flagship's SA shapes and on spheres, and must be the rows where the JAX
package's C++ differs from its own plain ops on the same input.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloud_segmentation_attention_tpu import native as jnative
from pointcloud_segmentation_attention_tpu import ops as jops
from pointcloud_segmentation_attention_tpu_torch import native as tnative
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as plain

EXTENT = np.array([1.9, 1.9, 2.6], np.float32)  # one training chunk with its margin
SHAPES = ((128, 16, 0.8), (256, 64, 0.4), (512, 128, 0.2), (1024, 256, 0.2),
          (2048, 512, 0.1), (2048, 16, 0.8))
SA_LEVELS = ((8192, 1024, 0.1), (1024, 256, 0.2), (256, 64, 0.4), (64, 16, 0.8))


def _cloud(kind: str, n: int, m: int, radius: float, seed: int):
    """(xyz (2, n, 3), centres (2, m, 3)) float32.  'uniform': points in the
    chunk extent, centres a subset of them; 'on_radius': n // m points at
    distance ``radius`` (rounded to float32) around each centre;
    'duplicates': a cloud of n // 4 distinct points, each repeated."""
    rng = np.random.RandomState(seed)
    if kind == "on_radius":
        centres = (rng.rand(2, m, 3) * EXTENT).astype(np.float32)
        d = rng.randn(2, m, n // m, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        xyz = (centres[:, :, None] + radius * d).astype(np.float32).reshape(2, -1, 3)
        return xyz, centres
    if kind == "duplicates":
        distinct = (rng.rand(2, n // 4, 3) * EXTENT).astype(np.float32)
        xyz = distinct[:, rng.randint(0, n // 4, n)]
    else:
        xyz = (rng.rand(2, n, 3) * EXTENT).astype(np.float32)
    return xyz, xyz[:, rng.choice(n, m, replace=False)]


@pytest.mark.parametrize("kind", ["uniform", "on_radius", "duplicates"])
@pytest.mark.parametrize("n,m,radius", SHAPES)
def test_native_equals_jax_compiled(kind, n, m, radius):
    assert jnative.available()  # g++ is here: the JAX package runs its C++
    xyz, centres = _cloud(kind, n, m, radius, seed=n + m)
    for nsample in (32, 1, n + 7):
        want = jnative.ball_query(xyz, centres, radius, nsample)
        got = tnative.ball_query(xyz, centres, radius, nsample)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for a, b in ((centres, xyz), (xyz, centres), (xyz, xyz[:, :2])):  # FP shapes, M < 3
        want = jnative.three_nn(a, b)
        got = tnative.three_nn(a, b)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_three_nn_is_double_with_lower_index_on_ties():
    """Distances are the float64 sums rounded once to float32, and an exact
    tie (duplicated known points) goes to the lower index: a stable sort of
    the float64 distances."""
    xyz, _ = _cloud("duplicates", 512, 16, 0.2, seed=3)
    query = (np.random.RandomState(4).rand(2, 300, 3) * EXTENT).astype(np.float32)
    dist, idx = tnative.three_nn(query, xyz)
    d2 = np.sum((query[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2, -1)
    order = np.argsort(d2, -1, kind="stable")[..., :3]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(dist, np.take_along_axis(d2, order, -1).astype(np.float32))
    assert (np.diff(np.sort(d2, -1)[..., :4], axis=-1) == 0).any()  # ties were there


def test_native_refuses_malformed_clouds():
    with pytest.raises(ValueError, match="must be"):
        tnative.three_nn(np.zeros((2, 4, 3)), np.zeros((1, 4, 3)))
    with pytest.raises(ValueError, match="must be"):
        tnative.ball_query(np.zeros((2, 4, 2)), np.zeros((2, 4, 3)), 0.1, 4)
    with pytest.raises(ValueError, match="nsample"):
        tnative.ball_query(np.zeros((2, 4, 3)), np.zeros((2, 4, 3)), 0.1, 0)


def _differing_rows(a, b):
    """(B, M) rows where any of the outputs ``a`` and ``b`` differ."""
    rows = np.zeros(a[0].shape[:2], bool)
    for x, y in zip(a, b):
        rows |= (x != y).reshape(rows.shape + (-1,)).any(-1)
    return rows


def _ulps(d2: np.ndarray, value) -> np.ndarray:
    return np.abs(d2 - value) / np.spacing(np.float32(value)).astype(np.float64)


def _disagreements(xyz, centres, radius, boundary: bool = False):
    """{pair: (B, M) differing rows} of ball query (the centres in xyz) and
    three-NN (xyz among the centres, the FP direction) between the port's
    C++ and its plain version ('port'), the JAX package's C++ and its plain
    ops ('jax') and the two plain versions ('plain'); with ``boundary``
    also the boundary rows: ball-query rows with a point whose squared distance, from the
    float32 differences summed in float64, lies within 4 float32 ulps of
    radius**2, and three-NN rows whose 4 nearest squared distances hold two
    within 4 ulps of each other.  Each implementation rounds a squared
    distance within ~2.5 ulps and takes the threshold within 1.5, so only
    boundary rows can differ."""
    t = torch.from_numpy
    bq = {"cpp": tnative.ball_query(xyz, centres, radius, 32),
          "jax_cpp": jnative.ball_query(xyz, centres, radius, 32),
          "plain": [a.numpy() for a in plain.ball_query(t(xyz), t(centres), radius, 32)],
          "jax": [np.asarray(a) for a in jops.ball_query(jnp.asarray(xyz),
                                                         jnp.asarray(centres), radius, 32)]}
    nn = {"cpp": tnative.three_nn(xyz, centres)[1:],
          "jax_cpp": jnative.three_nn(xyz, centres)[1:],
          "plain": [plain.three_nn(t(xyz), t(centres))[1].numpy()],
          "jax": [np.asarray(jops.three_nn(jnp.asarray(xyz), jnp.asarray(centres))[1])]}
    out = {}
    for op, res in (("ball_query", bq), ("three_nn", nn)):
        for g, w in zip(res["cpp"], res["jax_cpp"]):
            np.testing.assert_array_equal(g, w)
        out[op] = {"port": _differing_rows(res["cpp"], res["plain"]),
                   "jax": _differing_rows(res["jax_cpp"], res["jax"]),
                   "plain": _differing_rows(res["plain"], res["jax"])}
    if not boundary:
        return out
    diff = (centres[:, :, None, :] - xyz[:, None, :, :]).astype(np.float64)  # f32 differences
    d2 = (diff ** 2).sum(-1)
    out["ball_query"]["boundary"] = (_ulps(d2, np.float32(radius) ** 2) <= 4).any(-1)
    diff = (centres[:, None, :, :] - xyz[:, :, None, :]).astype(np.float64)
    near = np.sort((diff ** 2).sum(-1), -1)[..., :4]
    gaps = np.diff(near, axis=-1) / np.spacing(near[..., 1:].astype(np.float32))
    out["three_nn"]["boundary"] = (gaps <= 4).any(-1)
    return out


@pytest.mark.parametrize("n,m,radius", SA_LEVELS)
def test_cpp_and_plain_agree_at_flagship_shapes(n, m, radius):
    """At the flagship's SA1-4 shapes (B2, centres by the plain FPS) the C++
    and the plain versions, the port's and the JAX package's, agree on
    every row of ball query and three-NN: these clouds put no point within
    rounding of the radius and no two known points within rounding of each
    other.  ``chip_smoke.py``'s native-oracles phase holds the card's
    kernels to the C++ at these shapes with 0 differing rows."""
    rng = np.random.RandomState(n)
    xyz = (rng.rand(2, n, 3) * EXTENT).astype(np.float32)
    t = torch.from_numpy(xyz)
    centres = plain.gather_point(t, plain.farthest_point_sample(t, m)).numpy()
    for op, rows in _disagreements(xyz, centres, radius).items():
        for pair in ("port", "jax", "plain"):
            assert not rows[pair].any(), (op, pair, int(rows[pair].sum()))


def test_cpp_and_plain_differ_only_at_the_boundary():
    """Points on the radius (ball query) and known points 0-2 float32 ulps
    apart (three-NN: near-ties that float64 orders and float32 may not)
    make the C++ and the plain versions differ, in the JAX package as in
    the port, and the two packages' plain versions differ there too: the
    JAX package's XLA on the CPU fuses the squared distance into
    fma(dz, dz, fma(dy, dy, dx*dx)), its C++ into fma(dz, dz, fma(dx, dx,
    dy*dy)), and the port's plain version and kernels round each step.
    Every differing row is a boundary row; half the centres (ball query)
    sit in a uniform cloud, and their rows must all agree."""
    rng = np.random.RandomState(7)
    on_xyz, on_centres = _cloud("on_radius", 2048, 64, 0.2, seed=7)
    uniform = (rng.rand(2, 2048, 3) * EXTENT).astype(np.float32)
    xyz = np.concatenate([on_xyz, uniform], axis=1)
    centres = np.concatenate([on_centres, uniform[:, rng.choice(2048, 64, replace=False)]], 1)
    bq = _disagreements(xyz, centres, 0.2, boundary=True)["ball_query"]
    base = (rng.rand(2, 128, 3) * EXTENT).astype(np.float32).repeat(4, axis=1)
    known = base + rng.randint(-2, 3, base.shape).astype(np.float32) * np.spacing(base)
    unknown = (rng.rand(2, 256, 3) * EXTENT).astype(np.float32)
    nn = _disagreements(unknown, known, 0.2, boundary=True)["three_nn"]
    for op, rows in (("ball_query", bq), ("three_nn", nn)):
        assert rows["port"].any() and rows["jax"].any(), op
        assert not rows["boundary"].all(), op
        for pair in ("port", "jax", "plain"):
            outside = rows[pair] & ~rows["boundary"]
            assert not outside.any(), (op, pair, int(outside.sum()))
