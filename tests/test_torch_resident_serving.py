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
- the chunker's two phases compose to ``make_scene_chunker``, and the
  count the server stages from them equals ``chunk_count`` on the decoded
  coordinates and JAX's; the scheduled slots are exactly the batches that
  count needs;
- the port's server equals the port's host path fed the same deterministic
  chunks, and the card's chunker's chunks fed through its predict step,
  label for label: the same chunks, features and model;
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
from torch.profiler import ProfilerActivity, profile

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.eval import resident_serving as jrs
from pointcloud_segmentation_attention_tpu.train import create_state
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.eval import full_scene
from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving as rs
from pointcloud_segmentation_attention_tpu_torch.parallel import Mesh
from pointcloud_segmentation_attention_tpu_torch.train import load_jax_variables
from pointcloud_segmentation_attention_tpu_torch.utils import profiler
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
    name, n, n_pad, x, chunks, ready, request = server._stage(_scene(2200, 9))
    assert x > server.batch_size
    short = (name, n, n_pad, server.batch_size, chunks, ready, request)  # one batch
    with pytest.raises(RuntimeError, match="slack was exceeded"):
        server._fetch(server._compute(short))


def test_unported_and_invalid_settings_raise(weights):
    """Scene-per-device serving runs (``tests/test_torch_parallel_serve.py``);
    a mesh with ``group_size`` and a 2-D mesh raise, as in the JAX server."""
    _, model = weights
    with pytest.raises(ValueError, match="exclusive"):
        _server(model, mesh=["cpu", "cpu"], group_size=2)
    with pytest.raises(ValueError, match="1-D"):
        _server(model, mesh=Mesh([["cpu"], ["cpu"]], axis_names=("data", "model")))
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


# ---- the reduced-feature layouts (xyz only, one feature) and margin 0 ----------------

# (use_colors, use_normals) of the ablation recipes' serving layouts besides
# colors + normals: Table 1 serves xyz only, Table 3 each of the four.
REDUCED_FEATURES = [(False, False), (True, False), (False, True)]


@pytest.mark.parametrize("kind", ["f32", "q16"])
@pytest.mark.parametrize("use_colors, use_normals", REDUCED_FEATURES)
def test_reduced_feature_layouts_match_jax(use_colors, use_normals, kind):
    """``SceneLayout.pack`` and ``decode_host`` against JAX's, and the card's
    decode (here on the CPU) against ``decode_host``, bit for bit, for the
    layouts that leave colors, normals or both out (fed None, as the server
    feeds them)."""
    sc = _scene(2100, 12 + 2 * use_colors + use_normals)
    colors = sc["colors"] if use_colors else None
    normals = sc["normals"] if use_normals else None
    mine = rs.SceneLayout(kind, 4096, use_colors=use_colors, use_normals=use_normals)
    theirs = jrs.SceneLayout(kind, 4096, use_colors=use_colors, use_normals=use_normals)
    buf = mine.pack(sc["points"], colors, normals)
    assert mine.nbytes == theirs.nbytes == len(buf)
    np.testing.assert_array_equal(buf, theirs.pack(sc["points"], colors, normals))
    a, b = mine.decode_host(buf), theirs.decode_host(buf)
    expected = {"points"} | ({"colors"} if use_colors else set()) | (
        {"normals"} if use_normals else set())
    assert set(a) == set(b) == expected
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    dev = rs._decode_scene(torch.from_numpy(buf), mine)
    assert set(dev) == expected
    for k in a:
        np.testing.assert_array_equal(dev[k].numpy(), a[k], err_msg=f"{kind} {k}")


def _carried(name: str, in_features: int):
    """(JAX train state, port model) of one tiny ``name`` fed ``in_features``
    channels, the port's weights carried from JAX's (seeded BN statistics)."""
    jm = jmodels.get_model(name, num_classes=21, **TINY)
    feats = jnp.zeros((1, NPOINTS, in_features)) if in_features else None
    state = create_state(jm, optax.adam(1e-3), jax.random.PRNGKey(1),
                         jnp.zeros((1, NPOINTS, 3)), feats, train=False)
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, 5)
    tree = _unflatten(flat)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"])
    model = tmodels.get_model(name, device="cpu", in_features=in_features, **TINY)
    load_jax_variables(flat, model)
    return state, model


@pytest.mark.parametrize("name, use_colors, use_normals, margin", [
    ("sem_seg", False, False, 0.2),
    ("sem_seg_features", True, False, 0.2),
    ("sem_seg", False, False, 0.0),
])
def test_reduced_feature_server_equals_host_path_and_jax(name, use_colors, use_normals,
                                                         margin):
    """The port's server in the f32 layout, for a tiny xyz-only ``sem_seg``
    and a tiny colors-only ``sem_seg_features`` (Table 1's and Table 3's
    layouts) and at ``margin=0`` (Table 4's cells without context): its
    labels equal the port's host path fed the twin's chunks, and JAX's
    server's fed the same weights, label for label."""
    state, model = _carried(name, 3 * use_colors + 3 * use_normals)
    sc = _scene(2300, 20 + int(10 * margin))
    kw = dict(seed=3, use_colors=use_colors, use_normals=use_normals, margin=margin)
    got = _server(model, **kw).predict_scene(sc)
    cs = rs.deterministic_scene_chunks(sc["points"], [sc["colors"], sc["normals"]], NPOINTS,
                                       seed=3, margin=margin)
    host_scene = {"points": cs.points, "colors": cs.features[0],
                  "normals": cs.features[1].astype(np.float32), "masks": cs.masks,
                  "orig_idx": cs.orig_idx, "num_vertices": len(sc["points"])}
    want = full_scene.predict_scene_chunks(full_scene.make_predict_fn(model, device="cpu"),
                                           host_scene, use_colors, use_normals, batch_size=4)
    assert got.dtype == np.int32 and got.shape == (len(sc["points"]),)
    np.testing.assert_array_equal(got, want)
    theirs = jrs.ResidentSceneServer(state, NPOINTS, batch_size=4, layout="f32",
                                     pad_multiple=4096, **kw).predict_scene(sc)
    np.testing.assert_array_equal(got, theirs)


# ---- the count the server stages from the card's chunker ------------------------------

@pytest.mark.parametrize("chunk_size, margin", GEOMETRIES)
def test_chunker_phases_compose_to_make_scene_chunker(chunk_size, margin):
    """Phase 1 (``_chunk_runs``) once, then phase 2 (``_chunk_table``) at
    several slot counts, equals ``make_scene_chunker`` at each, bit for bit;
    a chunk's composition does not depend on the slot count, and phase 1's
    count is ``chunk_count``'s on the decoded coordinates."""
    sc = _scene(2200, 13)
    layout = rs.SceneLayout("q16", 4096)
    buf = layout.pack(sc["points"], sc["colors"], sc["normals"])
    n = len(sc["points"])
    runs = rs._chunk_runs(rs._decode_scene(torch.from_numpy(buf), layout)["points"], n,
                          NPOINTS, 3, chunk_size, margin)
    x = int(runs.n_chunks)
    assert x == rs.chunk_count(layout.decode_host(buf)["points"][:n], NPOINTS, chunk_size,
                               margin)
    first = None
    for x_cap in (x, x + 1, rs._bucket(x, 16), 2 * x + 7):
        got = rs._chunk_table(runs, x_cap, NPOINTS)
        want = rs.make_scene_chunker(layout, x_cap, NPOINTS, seed=3, chunk_size=chunk_size,
                                     margin=margin)(torch.from_numpy(buf), n)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        idx, mask, n_chunks = (t.numpy() for t in got)
        assert int(n_chunks) == x and idx.shape == (x_cap, NPOINTS)
        assert not idx[x:].any() and not mask[x:].any()
        if first is None:
            first = idx, mask
        np.testing.assert_array_equal(idx[:x], first[0])
        np.testing.assert_array_equal(mask[:x], first[1])


@pytest.mark.parametrize("kind", ["q16", "f32"])
@pytest.mark.parametrize("chunk_size, margin", GEOMETRIES)
@pytest.mark.parametrize("use_colors, use_normals", [(True, True)] + REDUCED_FEATURES)
def test_staged_count_is_the_host_count_and_jax(weights, kind, chunk_size, margin, use_colors,
                                                use_normals):
    """The count ``_stage`` reads back from the chunker (here on the CPU)
    equals ``chunk_count`` on ``decode_host``'s coordinates and JAX's, for
    each layout, geometry and feature set; the staged chunks are
    ``make_scene_chunker``'s at the slots that count needs."""
    _, model = weights
    sc = _scene(2200, 31 + 2 * use_colors + use_normals)
    server = _server(model, layout=kind, seed=2, chunk_size=chunk_size, margin=margin,
                     use_colors=use_colors, use_normals=use_normals)
    name, n, n_pad, x, (scene, idx, mask, n_chunks), ready, request = server._stage(sc)
    assert ready is None and set(scene) == {"points"} | ({"colors"} if use_colors else set()) | (
        {"normals"} if use_normals else set())
    layout = server._layout(n_pad)
    buf = layout.pack(sc["points"], sc["colors"] if use_colors else None,
                      sc["normals"] if use_normals else None)
    decoded = layout.decode_host(buf)["points"][:n]
    assert x == int(n_chunks) == rs.chunk_count(decoded, NPOINTS, chunk_size, margin) == \
        jrs.chunk_count(decoded, NPOINTS, chunk_size, margin)
    assert len(idx) == rs._bucket(x, 4 * server.batch_size)
    want = rs.make_scene_chunker(layout, len(idx), NPOINTS, seed=2, chunk_size=chunk_size,
                                 margin=margin)(torch.from_numpy(buf), n)
    for a, b in zip((idx, mask, n_chunks), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("group_size", [1, 3])
def test_scheduled_slots_are_exactly_the_batches_the_count_needs(weights, group_size):
    """Counters ``serve.slots`` and ``serve.chunks``: a room gets
    ``B * ceil(n_chunks / B)`` slots, no slack; a group's lanes each get
    the batches of its largest room."""
    _, model = weights
    rooms = [_scene(1200 + 400 * i, 40 + i) for i in range(4)]
    batch = 4
    layout = rs.SceneLayout("q16", 4096)
    counts = [rs.chunk_count(layout.decode_host(layout.pack(r["points"], r["colors"],
                                                            r["normals"]))["points"][
        :len(r["points"])], NPOINTS) for r in rooms]
    batches = [-(-c // batch) for c in counts]
    if group_size == 1:
        slots = batch * sum(batches)
    else:
        slots = batch * group_size * sum(max(batches[i:i + group_size])
                                         for i in range(0, len(rooms), group_size))
    server = _server(model, layout="q16", group_size=group_size, batch_size=batch)
    profiler.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            list(server.predict_scenes(iter(rooms)))
        counters = profiler.snapshot()["counters"]
    finally:
        profiler.reset()
    assert counters["serve.chunks"] == sum(counts)
    assert counters["serve.slots"] == slots


@pytest.mark.parametrize("kind", ["q16", "f32"])
def test_served_labels_are_the_chunkers_chunks_through_the_predict_step(weights, kind):
    """``predict_scenes``'s labels equal ``make_scene_chunker``'s chunks,
    at exactly the batches the count needs, fed through
    ``make_resident_predict_step`` and stitched, label for label; and the
    group path's equal them."""
    _, model = weights
    rooms = [_scene(1300 + 350 * i, 50 + i) for i in range(3)]
    served = dict(_server(model, layout=kind, seed=4).predict_scenes(iter(rooms)))
    grouped = dict(_server(model, layout=kind, seed=4, group_size=2).predict_scenes(iter(rooms)))
    layout = rs.SceneLayout(kind, 4096)
    step = rs.make_resident_predict_step(model, layout, 4, NPOINTS)
    for sc in rooms:
        n = len(sc["points"])
        buf = torch.from_numpy(layout.pack(sc["points"], sc["colors"], sc["normals"]))
        x = rs.chunk_count(layout.decode_host(buf.numpy())["points"][:n], NPOINTS)
        slots = 4 * -(-x // 4)
        idx, mask, n_chunks = rs.make_scene_chunker(layout, slots, NPOINTS, seed=4)(buf, n)
        assert int(n_chunks) == x
        scene = rs._decode_scene(buf, layout)
        labels = torch.cat([step(scene, idx[b:b + 4]) for b in range(0, slots, 4)])
        want = rs.make_stitch(layout.n_pad)(labels, idx, mask)[:n].numpy().astype(np.int32)
        np.testing.assert_array_equal(served[sc["scene_name"]], want)
        np.testing.assert_array_equal(grouped[sc["scene_name"]], want)
