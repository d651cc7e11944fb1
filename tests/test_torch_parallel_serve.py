"""Serving on a mesh of local devices on the CPU: ``make_sharded_predict_fn``
at two lanes against ``make_predict_fn`` and against the JAX package's
sharded predictor on two virtual devices, and ``ResidentSceneServer(mesh=)``
against the single-device server and the JAX package's mesh server (the
counterpart of ``tests/test_resident_serving.py``'s mesh tests).

Within the port the lanes run the single-device code on their shares, so
labels are equal bit for bit and logits within 1e-5 of one device's (the
same forward on a smaller batch: only the summation order of batch-wide
ops could differ).  Against JAX, from the same flat weights, the sharded
predictor's labels are equal, and the stitched labels agree on >= 99.9 %
of the vertices, as ``tests/test_torch_resident_serving.py`` holds the
single-device servers (each package's mesh labels equal its own
single-device labels exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu import parallel as jparallel
from pointcloud_segmentation_attention_tpu.eval import full_scene as jfull_scene
from pointcloud_segmentation_attention_tpu.eval import resident_serving as jrs
from pointcloud_segmentation_attention_tpu.train import create_state
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import parallel
from pointcloud_segmentation_attention_tpu_torch.eval import full_scene
from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving as rs
from pointcloud_segmentation_attention_tpu_torch.train import load_jax_variables, seg_predict_step
from test_torch_model import TINY, _flat_variables, _unflatten
from test_torch_parallel_ranks import one_thread  # noqa: F401 (an autouse fixture)

NPOINTS = 256


def _scene(n, seed, extent=(6.0, 5.0, 2.5)):
    rng = np.random.RandomState(seed)
    return {"scene_name": f"scene{seed}",
            "points": (rng.rand(n, 3) * extent).astype(np.float32),
            "labels": rng.randint(0, 21, n).astype(np.int32),
            "colors": rng.randint(0, 256, (n, 3)).astype(np.uint8),
            "normals": rng.rand(n, 3).astype(np.float32)}


@pytest.fixture(scope="module")
def weights():
    """(JAX train state, port model) of one set of flat weights."""
    jm = jmodels.get_model("sem_seg_features", num_classes=21, **TINY)
    state = create_state(jm, optax.adam(1e-3), jax.random.PRNGKey(0),
                         jnp.zeros((1, NPOINTS, 3)), jnp.zeros((1, NPOINTS, 6)), train=False)
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, 5)
    tree = _unflatten(flat)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"])
    model = tmodels.get_model("sem_seg_features", device="cpu", **TINY)
    load_jax_variables(flat, model)
    return state, model


@pytest.fixture(scope="module")
def chunks():
    rng = np.random.RandomState(3)
    pts = (rng.rand(4, NPOINTS, 3) * np.array([1.9, 1.9, 2.6])).astype(np.float32)
    return pts, rng.rand(4, NPOINTS, 6).astype(np.float32)


def test_sharded_predict_matches_one_device_and_jax(weights, chunks):
    state, model = weights
    pts, feats = chunks
    labels_fn, mesh = full_scene.make_sharded_predict_fn(model, 2, return_labels=True,
                                                         device="cpu")
    logits_fn, _ = full_scene.make_sharded_predict_fn(model, 2, device="cpu")
    assert mesh.size == 2
    got_labels, got_logits = labels_fn(pts, feats), logits_fn(pts, feats)
    np.testing.assert_array_equal(got_labels, full_scene.make_predict_fn(model, device="cpu")(
        pts, feats))
    assert got_labels.dtype == np.uint8 and got_logits.shape == (4, NPOINTS, 21)
    np.testing.assert_array_equal(got_logits.argmax(-1), got_labels)
    np.testing.assert_allclose(got_logits, seg_predict_step(
        model, torch.from_numpy(pts), torch.from_numpy(feats)).numpy(), rtol=1e-5, atol=1e-5)
    jlabels_fn, _ = jfull_scene.make_sharded_predict_fn(state, n_devices=2, return_labels=True)
    np.testing.assert_array_equal(got_labels, np.asarray(jlabels_fn(pts, feats)))
    with pytest.raises(ValueError, match="does not divide"):
        labels_fn(pts[:3], feats[:3])


def test_sharded_predict_packed_rows(weights, chunks):
    """The packed-row predictor (q16 wire) at two lanes equals one lane."""
    from pointcloud_segmentation_attention_tpu_torch.data.wire import WireSpec, pack_arrays

    _, model = weights
    pts, _ = chunks
    spec = WireSpec(n=NPOINTS, layout="q16", use_colors=True, use_normals=True)
    rng = np.random.RandomState(8)
    rows = pack_arrays(pts, np.zeros(pts.shape[:2], np.uint8), np.ones(pts.shape[:2], np.uint8),
                       rng.randint(0, 256, pts.shape).astype(np.uint8),
                       rng.rand(*pts.shape).astype(np.float32), spec)
    two, _ = full_scene.make_sharded_predict_fn(model, 2, wire_spec=spec, return_labels=True,
                                                device="cpu")
    one = full_scene.make_predict_fn(model, device="cpu", wire_spec=spec)
    np.testing.assert_array_equal(two(rows), one(rows))


SERVE_KW = dict(batch_size=4, layout="q16", pad_multiple=4096, device="cpu")


@pytest.fixture(scope="module")
def served_single(weights):
    """Three scenes and the single-device server's labels of them."""
    _, model = weights
    scenes = [_scene(1200 + 250 * i, 40 + i) for i in range(3)]
    return scenes, dict(rs.ResidentSceneServer(model, NPOINTS, **SERVE_KW).predict_scenes(
        iter(scenes)))


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_mesh_server_bit_identical_to_single_device(weights, served_single, lanes):
    """A scene per lane (two lanes: the odd scene's group padded): labels
    equal the single-device server's bit for bit.  A one-lane mesh is the
    single-device path itself."""
    _, model = weights
    scenes, single = served_single
    server = rs.ResidentSceneServer(model, NPOINTS, mesh=["cpu"] * lanes, **SERVE_KW)
    assert server.n_lanes == lanes and (server.mesh is None) == (lanes == 1)
    if lanes == 1:
        assert server.device == torch.device("cpu")
        return
    served = dict(server.predict_scenes(iter(scenes)))
    assert set(served) == set(single)
    for name in single:
        np.testing.assert_array_equal(served[name], single[name])
    np.testing.assert_array_equal(server.predict_scene(scenes[1]), single["scene41"])


def test_mesh_server_agrees_with_jax_mesh_server(weights):
    state, model = weights
    scenes = [_scene(900 + 100 * i, 70 + i) for i in range(3)]
    kw = dict(batch_size=4, layout="q16", pad_multiple=4096)
    ours = dict(rs.ResidentSceneServer(model, NPOINTS, mesh=parallel.make_mesh(2, device="cpu"),
                                       device="cpu", **kw).predict_scenes(iter(scenes)))
    jsingle = dict(jrs.ResidentSceneServer(state, NPOINTS, **kw).predict_scenes(iter(scenes)))
    theirs = dict(jrs.ResidentSceneServer(state, NPOINTS, mesh=jparallel.make_mesh(2),
                                          **kw).predict_scenes(iter(scenes)))
    for name in jsingle:
        np.testing.assert_array_equal(theirs[name], jsingle[name])
        agree = (ours[name] == theirs[name]).mean()
        assert agree >= 0.999, (name, agree)


def test_mesh_server_refusals(weights):
    """As the JAX server: a 2-D mesh and ``group_size`` with a mesh raise."""
    _, model = weights
    kw = dict(batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        rs.ResidentSceneServer(model, NPOINTS, mesh=parallel.Mesh(
            [["cpu", "cpu"], ["cpu", "cpu"]], axis_names=("data", "model")), **kw)
    with pytest.raises(ValueError, match="exclusive"):
        rs.ResidentSceneServer(model, NPOINTS, mesh=["cpu", "cpu"], group_size=2, **kw)
    with pytest.raises(ValueError, match="axis names"):
        parallel.Mesh([["cpu", "cpu"]])
