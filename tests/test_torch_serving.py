"""Parity of the PyTorch port's serving path with the JAX package's.

A synthetic room is chunked by both packages (the port keeps its own numpy
copy of the chunker) and must give identical chunks; then both packages
stitch labels through ``predict_scene_chunks`` with the same tiny model
weights.  Index outputs of every SA level must be equal; at least 99.9 % of
vertex labels must agree (logits differ by matmul summation order, so a
near-tie can flip an argmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu import native as jnative
from pointcloud_segmentation_attention_tpu.data.scannet import chunks as jchunks
from pointcloud_segmentation_attention_tpu.data.scannet import scenes as jscenes
from pointcloud_segmentation_attention_tpu.eval import full_scene as jfull
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import native as tnative
from pointcloud_segmentation_attention_tpu_torch.data.scannet import chunks as tchunks
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.eval import full_scene as tfull
from pointcloud_segmentation_attention_tpu_torch.train import load_jax_variables
from test_torch_model import TINY, _flat_variables, _unflatten


@pytest.fixture(scope="module")
def scene():
    return jscenes.make_synthetic_scene(n_points=6000, seed=0)


def test_synthetic_scene_copy_matches_jax(scene):
    mine = tscenes.make_synthetic_scene(n_points=6000, seed=0)
    assert set(mine) == set(scene)
    for k in scene:
        np.testing.assert_array_equal(mine[k], scene[k])


def test_grid_assign_matches_jax(scene):
    for margin in (0.2, 0.0, 0.75):
        want = jnative.grid_chunk_assign(scene["points"], cell=1.5, margin=margin)
        got = tnative.grid_chunk_assign(scene["points"], cell=1.5, margin=margin)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def _boundary_cloud(seed=0):
    """Points whose x or y sits within a few float32 ulps of a margin
    boundary, ``float32(+-0.2 + 1.5k)`` for k = 1..5, where float32 and
    float64 arithmetic put the point on different sides; with the origin
    as the grid's minimum."""
    rng = np.random.RandomState(seed)
    edges = []
    for k in range(1, 6):
        for centre in (np.float32(0.2 + 1.5 * k), np.float32(-0.2 + 1.5 * k)):
            v = centre
            for _ in range(3):
                v = np.nextafter(v, np.float32(-np.inf))
            for _ in range(7):  # 3 ulps below the edge to 3 above
                edges.append(v)
                v = np.nextafter(v, np.float32(np.inf))
    edges = np.unique(np.array(edges, np.float32))
    n = 4 * len(edges)
    pts = np.empty((n + 2, 3), np.float32)
    pts[0] = 0.0
    pts[1] = (8.0, 8.0, 2.0)
    pts[2:, 0] = np.concatenate([edges, edges, rng.rand(2 * len(edges)) * 8])
    pts[2:, 1] = np.concatenate([rng.rand(len(edges)) * 8, edges, edges,
                                 rng.choice(edges, len(edges))])
    pts[2:, 2] = rng.rand(n) * 2
    return pts


def test_grid_assign_at_margin_boundaries_matches_jax_compiled():
    """The port's compiled and numpy assignments equal the JAX package's
    compiled one (its main path wherever g++ exists) at float32 margin
    boundaries; a float64 assignment puts point 1 of the four-point cloud
    outside cell 2's context."""
    assert jnative.available()
    four = np.array([[0, 0, 0], [1.3, 0.5, 0.1], [3.0, 2.0, 0.5], [2.8, 1.0, 0.2]],
                    np.float32)
    cells, pids, ncx, ncy = tnative.grid_chunk_assign(four)
    np.testing.assert_array_equal(cells, [0, 0, 2, 3, 2])
    np.testing.assert_array_equal(pids, [0, 1, 1, 2, 3])
    for bad in (np.zeros((4, 6), np.float32), np.zeros((0, 3), np.float32)):
        with pytest.raises(ValueError, match="points must be"):
            tnative.grid_chunk_assign(bad)
    for pts in (four, _boundary_cloud()):
        for cell, margin in ((1.5, 0.2), (1.5, 0.0), (1.0, 0.3)):
            want = jnative.grid_chunk_assign(pts, cell=cell, margin=margin)
            for fn in (tnative.grid_chunk_assign, tnative.grid_chunk_assign_numpy):
                got = fn(pts, cell=cell, margin=margin)
                for w, g in zip(want, got):
                    np.testing.assert_array_equal(g, w, err_msg=f"{fn.__name__} {cell} {margin}")


def test_scene_chunks_at_margin_boundaries_identical_to_jax(scene):
    edge = _boundary_cloud(seed=1)
    rng = np.random.RandomState(2)
    pick = rng.randint(0, len(scene["points"]), len(edge))
    room = {k: np.concatenate([scene[k], scene[k][pick]]) for k in
            ("labels", "colors", "normals")}
    # The room's minimum is the edge cloud's origin, so the edges stay exact.
    room["points"] = np.concatenate([scene["points"] - scene["points"].min(0), edge])
    assert jnative.available()
    want = jchunks.grid_chunks_for_eval(
        room["points"], room["labels"], room["colors"], room["normals"], 1024,
        rng=np.random.RandomState(0))
    got = tfull.scene_chunks(room, npoints=1024, seed=0)
    for k in ("points", "labels", "colors", "normals", "masks", "orig_idx"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("npoints", [8192, 1024])
def test_scene_chunks_identical_to_jax(scene, npoints):
    want = jchunks.grid_chunks_for_eval(
        scene["points"], scene["labels"], scene["colors"], scene["normals"],
        npoints, rng=np.random.RandomState(0))
    got = tfull.scene_chunks(scene, npoints=npoints, seed=0)
    for k in ("points", "labels", "colors", "normals", "masks", "orig_idx"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["num_vertices"] == len(scene["points"])
    assert got["masks"].sum() == len(scene["points"])


def test_grid_geometry_is_checked(scene):
    with pytest.raises(ValueError, match="2\\*margin"):
        tchunks.full_scene_chunks(scene["points"], [], 1024, np.random.RandomState(0),
                                chunk_size=1.0, margin=0.6)


def test_stitched_labels_agree_with_jax(scene):
    npoints, batch = 2048, 4
    chunks = tfull.scene_chunks(scene, npoints=npoints, seed=0)

    jm = jmodels.get_model("sem_seg_features", num_classes=21, **TINY)
    pts0 = jnp.asarray(chunks["points"][:1])
    f0 = jnp.asarray(np.concatenate([chunks["colors"][:1] / 255.0, chunks["normals"][:1]],
                                    -1).astype(np.float32))
    variables = jax.jit(lambda k, p, f: jm.init(k, p, f, train=False))(
        jax.random.PRNGKey(0), pts0, f0)
    flat = _flat_variables(variables, 1)
    jvars = _unflatten(flat)
    apply = jax.jit(lambda p, f: jm.apply(jvars, p, f, train=False,
                                          capture_intermediates=True,
                                          mutable=["intermediates"]))
    j_inter = {}

    def jax_predict(p, f):
        logits, state = apply(jnp.asarray(p), jnp.asarray(f))
        if not j_inter:
            j_inter.update(state["intermediates"])
        return np.asarray(jnp.argmax(logits, -1))

    tm = tmodels.get_model("sem_seg_features", device="cpu", **TINY)
    load_jax_variables(flat, tm)
    t_inter = {}

    def keep_first(i):
        def hook(mod, args, out):
            t_inter.setdefault(i, out)  # returns None: the output is kept as is
        return hook

    for i in range(4):
        getattr(tm, f"sa{i + 1}").register_forward_hook(keep_first(i))
    t_predict = tfull.make_predict_fn(tm, device="cpu")

    want = jfull.predict_scene_chunks(jax_predict, chunks, True, True, batch)
    got = tfull.predict_scene_chunks(t_predict, chunks, True, True, batch)

    # Index outputs of the first batch at every SA level: FPS picks (through
    # the gathered centres) and ball-query indices are equal.
    for i in range(4):
        jx, _, jidx = j_inter[f"sa{i + 1}"]["__call__"][0]
        tx, _, tidx = t_inter[i]
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    assert got.shape == want.shape == (len(scene["points"]),)
    disagree = int((got != want).sum())
    print(f"stitched labels: {disagree} of {len(want)} vertices disagree")
    assert disagree <= 0.001 * len(want)


def test_predict_fn_returns_uint8_labels(scene):
    tm = tmodels.get_model("sem_seg_features", device="cpu",
                           generator=torch.Generator().manual_seed(0), **TINY)
    fn = tfull.make_predict_fn(tm, device="cpu")
    chunks = tfull.scene_chunks(scene, npoints=512, seed=0)
    feats = np.concatenate([chunks["colors"][:2] / 255.0, chunks["normals"][:2]], -1)
    labels = fn(chunks["points"][:2], feats)
    assert labels.dtype == np.uint8 and labels.shape == (2, 512)
    assert labels.max() < 21
