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
