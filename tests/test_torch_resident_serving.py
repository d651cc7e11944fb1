"""The port's resident serving (``eval/resident_serving.py``) against the
JAX package's, on the CPU.

One tiny ``sem_seg_features`` (the JAX resident tests' hierarchy), with
seeded non-trivial BN, is carried from JAX into the port with
``load_jax_variables``.  Limits, and why:

- the host twins (``_hash32``, ``chunk_count``, ``deterministic_scene_chunks``,
  ``SceneLayout.pack`` and ``decode_host``) and the chunker: bit for bit,
  integer and f32 arithmetic done op for op;
- the card's-side decode (here on the CPU) equals ``decode_host`` bit for
  bit, q16 included (correctly rounded divisions);
- the port's server equals the port's host path fed the same deterministic
  chunks, label for label: the same chunks, features and model;
- against JAX's server >= 99.9 % of labels: the logits differ by the
  matmuls' summation order, which can flip a near-tie;
- q16 against f32 >= 98 %, JAX's own limit (0.05 mm of quantisation).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.eval import resident_serving as jrs
from pointcloud_segmentation_attention_tpu.train import create_state
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.eval import full_scene
from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving as rs
from pointcloud_segmentation_attention_tpu_torch.train import load_jax_variables
from test_torch_model import _flat_variables, _unflatten

TINY = dict(sa_npoints=(64, 32, 16, 8), sa_radii=(0.2, 0.4, 0.8, 1.2), sa_nsample=8,
            sa_mlps=((8, 8),) * 4, fp_mlps=((8,), (8,), (8,), (8, 8)))
NPOINTS = 256
GEOMETRIES = [(1.5, 0.2), (1.5, 0.0), (1.0, 0.3)]


def _scene(n=2200, seed=0, extent=(6.0, 5.0, 2.5)):
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
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, 3)
    tree = _unflatten(flat)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"])
    model = tmodels.get_model("sem_seg_features", device="cpu", **TINY)
    load_jax_variables(flat, model)
    return state, model


def _server(model, **kw):
    kw = {"batch_size": 4, "layout": "f32", "pad_multiple": 4096, "device": "cpu", **kw}
    return rs.ResidentSceneServer(model, NPOINTS, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_twins_match_jax(seed):
    sc = _scene(1800 + 300 * seed, seed)
    pid = np.arange(4096, dtype=np.int64)
    np.testing.assert_array_equal(rs._hash32(pid, seed), jrs._hash32(pid, seed))
    for geometry in GEOMETRIES:
        assert rs.chunk_count(sc["points"], NPOINTS, *geometry) == \
            jrs.chunk_count(sc["points"], NPOINTS, *geometry)
    feats = [sc["labels"], sc["colors"], sc["normals"]]
    got = rs.deterministic_scene_chunks(sc["points"], feats, NPOINTS, seed=seed)
    want = jrs.deterministic_scene_chunks(sc["points"], feats, NPOINTS, seed=seed)
    for a, b in [(got.points, want.points), (got.masks, want.masks),
                 (got.orig_idx, want.orig_idx)] + list(zip(got.features, want.features)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for kind in ("q16", "f32"):
        mine, theirs = rs.SceneLayout(kind, 4096), jrs.SceneLayout(kind, 4096)
        buf = mine.pack(sc["points"], sc["colors"], sc["normals"])
        assert mine.nbytes == theirs.nbytes == len(buf)
        np.testing.assert_array_equal(buf, theirs.pack(sc["points"], sc["colors"],
                                                       sc["normals"]))
        a, b = mine.decode_host(buf), theirs.decode_host(buf)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        # The decode in tensor ops (the card's) equals the host decode.
        dev = rs._decode_scene(torch.from_numpy(buf), mine)
        for k in a:
            np.testing.assert_array_equal(dev[k].numpy(), a[k], err_msg=f"{kind} {k}")


def test_hash_in_tensor_ops_is_the_twins_and_a_bijection():
    n_pad = 1 << 18
    pid = np.arange(n_pad, dtype=np.int64)
    for seed in (0, 5, 99):
        got = rs._hash32_torch(torch.from_numpy(pid), seed).numpy()
        np.testing.assert_array_equal(got, rs._hash32(pid, seed).astype(np.int64))
        assert len(np.unique(got)) == n_pad  # distinct: one sort key suffices


@pytest.mark.parametrize("chunk_size,margin", GEOMETRIES)
def test_chunker_matches_jax_and_twin(chunk_size, margin):
    sc = _scene(2200, 4)
    layout = rs.SceneLayout("f32", 4096)
    buf = layout.pack(sc["points"], sc["colors"], sc["normals"])
    x = rs.chunk_count(sc["points"], NPOINTS, chunk_size, margin)
    x_cap = -(-x // 8) * 8 + 8
    n = len(sc["points"])
    idx, mask, n_chunks = rs.make_scene_chunker(layout, x_cap, NPOINTS, seed=5,
                                                chunk_size=chunk_size, margin=margin)(
        torch.from_numpy(buf), n)
    assert idx.dtype == torch.int32 and mask.dtype == torch.bool
    assert idx.shape == mask.shape == (x_cap, NPOINTS)
    cs = rs.deterministic_scene_chunks(sc["points"], [], NPOINTS, seed=5,
                                       chunk_size=chunk_size, margin=margin)
    assert int(n_chunks) == len(cs.points) == x
    np.testing.assert_array_equal(idx.numpy()[:x], cs.orig_idx)
    np.testing.assert_array_equal(mask.numpy()[:x], cs.masks)
    assert not mask.numpy()[x:].any() and not idx.numpy()[x:].any()
    jidx, jmask, jn = jrs.make_scene_chunker(jrs.SceneLayout("f32", 4096), x_cap, NPOINTS,
                                             seed=5, chunk_size=chunk_size, margin=margin)(
        jnp.asarray(buf), n)
    assert int(jn) == x
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_server_equals_host_path_and_agrees_with_jax(weights):
    state, model = weights
    sc = _scene(2200, 6)
    got = _server(model, seed=7).predict_scene(sc)
    cs = rs.deterministic_scene_chunks(
        sc["points"], [sc["labels"], sc["colors"], sc["normals"]], NPOINTS, seed=7)
    host_scene = {"points": cs.points, "colors": cs.features[1],
                  "normals": cs.features[2].astype(np.float32), "masks": cs.masks,
                  "orig_idx": cs.orig_idx, "num_vertices": len(sc["points"])}
    want = full_scene.predict_scene_chunks(full_scene.make_predict_fn(model, device="cpu"),
                                           host_scene, True, True, batch_size=4)
    assert got.dtype == np.int32 and got.shape == (len(sc["points"]),)
    np.testing.assert_array_equal(got, want)
    theirs = jrs.ResidentSceneServer(state, NPOINTS, batch_size=4, layout="f32", seed=7,
                                     pad_multiple=4096).predict_scene(sc)
    agree = (got == theirs).mean()
    print(f"port vs JAX resident labels: {agree:.6f}")
    assert agree >= 0.999, agree


def test_q16_close_to_f32(weights):
    _, model = weights
    sc = _scene(2200, 8)
    f32 = _server(model).predict_scene(sc)
    q16 = _server(model, layout="q16").predict_scene(sc)
    assert (f32 == q16).mean() > 0.98, (f32 == q16).mean()


def test_pipelined_scenes_in_order_and_grouped_equal_ungrouped(weights):
    _, model = weights
    scenes = [_scene(1200 + 250 * i, 60 + i) for i in range(5)]
    single = list(_server(model, layout="q16", pipeline_depth=2).predict_scenes(iter(scenes)))
    assert [name for name, _ in single] == [s["scene_name"] for s in scenes]
    for (_, labels), s in zip(single, scenes):
        assert labels.shape == (len(s["points"]),) and labels.dtype == np.int32
        np.testing.assert_array_equal(labels, _server(model, layout="q16").predict_scene(s))
    grouped = list(_server(model, layout="q16", group_size=3).predict_scenes(iter(scenes)))
    assert [name for name, _ in grouped] == [name for name, _ in single]
    for (_, a), (_, b) in zip(grouped, single):
        np.testing.assert_array_equal(a, b)
    one = _server(model, layout="q16", group_size=3).predict_scene(scenes[0])
    np.testing.assert_array_equal(one, single[0][1])


def test_generate_predictions_resident_writes_the_artifacts(weights, tmp_path):
    _, model = weights
    root = str(tmp_path / "scannet")
    splits = tscenes.write_synthetic_dataset(root, n_train=0, n_val=2, n_test=0,
                                             n_points=2000)
    out = str(tmp_path / "preds")
    results = list(rs.generate_predictions_resident(model, root, splits["val"], out,
                                                    npoints=128, batch_size=4, device="cpu"))
    assert [r["scene_name"] for r in results] == list(splits["val"])
    for r in results:
        name = r["scene_name"]
        stored = tscenes.load_scene_mapped(root, name)
        labels = np.load(os.path.join(out, f"{name}_labels.npy"))
        np.testing.assert_array_equal(labels, r["predictions"])
        np.testing.assert_array_equal(np.load(os.path.join(out, f"{name}_gt.npy")),
                                      stored["labels"])
        np.testing.assert_array_equal(np.load(os.path.join(out, f"{name}_points.npy")),
                                      stored["points"])
        assert labels.shape == (2000,)
        with open(os.path.join(out, f"{name}.txt")) as f:
            assert len(f.read().split()) == 2000


def test_chunk_slack_guard_raises(weights):
    """A scene whose card-side chunks outnumber the scheduled predict slots
    raises at the fetch; it never stitches label 0 into the chunks left
    out."""
    _, model = weights
    server = _server(model)
    name, n, n_pad, x_cap, x, dbuf, ready = server._stage(_scene(2200, 9))
    assert x > server.batch_size
    short = (name, n, n_pad, x_cap, server.batch_size, dbuf, ready)  # one batch scheduled
    with pytest.raises(RuntimeError, match="slack was exceeded"):
        server._fetch(server._compute(short))


def test_unported_and_invalid_settings_raise(weights):
    _, model = weights
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        _server(model, mesh=object())
    with pytest.raises(ValueError, match="2\\*margin"):
        _server(model, chunk_size=1.5, margin=0.76)
    with pytest.raises(ValueError, match="unknown scene layout"):
        _server(model, layout="f16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rs.ResidentSceneServer(model, NPOINTS)


@pytest.mark.cuda
def test_chunker_on_the_card_matches_the_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sc = _scene(20000, 11, extent=(9.0, 7.0, 2.5))
    for chunk_size, margin in GEOMETRIES:
        layout = rs.SceneLayout("f32", 32768)
        buf = torch.from_numpy(layout.pack(sc["points"], sc["colors"], sc["normals"]))
        x = rs.chunk_count(sc["points"], 2048, chunk_size, margin)
        idx, mask, n_chunks = rs.make_scene_chunker(
            layout, x + 16, 2048, chunk_size=chunk_size, margin=margin)(buf.cuda(), 20000)
        cs = rs.deterministic_scene_chunks(sc["points"], [], 2048, chunk_size=chunk_size,
                                           margin=margin)
        assert int(n_chunks) == x == len(cs.points)
        np.testing.assert_array_equal(idx.cpu().numpy()[:x], cs.orig_idx)
        np.testing.assert_array_equal(mask.cpu().numpy()[:x], cs.masks)
