"""The port's on-device chunk sampler (``train/device_sampler.py``) and
``ops/geometry.py:prob_sample`` against the JAX package's, on the CPU.

The JAX sampler draws its numbers inside; the port takes them as
``draws``.  Each parity test makes JAX's draws here from the same key, as
JAX's ``sample_chunk_batch`` does (``split`` into B keys, ``randint(
fold_in(k, t), (), 0, length)`` for try t, ``uniform(fold_in(k, 1000),
(npoints,))``), and feeds them to the port.

Tolerances:

- ``prob_sample``: bit-identical on integer-valued weights (every partial
  sum is exact); on random float weights the two ``cumsum``s may associate
  differently, so an index may differ only where its target lies within 1
  ulp of the CDF step between the two candidates;
- ``scene_voxel_sort``, ``stripe_window_len``, the resident buffers,
  ``sub_len`` and ``estimate_bytes``: equal;
- a sampled chunk: points, labels, weights, normals and the kept box
  bit-identical; colors within 1 ulp (the port divides by 255 correctly
  rounded, XLA multiplies by the reciprocal);
- one sampling train step, dropout off: ``tests/test_torch_train.py``'s
  ``_check_step`` limits at the tiny hierarchy (loss rtol 1e-5, gradients
  rel-L2 1e-4, BN statistics 1e-5), as its tiny train-step test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu.data.scannet.chunks import (
    sample_random_chunk as jsample_random_chunk,
)
from pointcloud_segmentation_attention_tpu.ops import geometry as jgeo
from pointcloud_segmentation_attention_tpu.train import device_sampler as jds
from pointcloud_segmentation_attention_tpu.train import trainer as jtrainer
from pointcloud_segmentation_attention_tpu.utils.config import TrainConfig as JConfig
from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import (
    CHUNK_SIZE,
    CONTEXT_MARGIN,
    MAX_TRIES,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import make_synthetic_scene
from pointcloud_segmentation_attention_tpu_torch.ops import prob_sample
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler as ds
from pointcloud_segmentation_attention_tpu_torch.train import (
    best_checkpoint,
    latest_checkpoint,
    load_jax_state,
)
from pointcloud_segmentation_attention_tpu_torch.train import schedules as tsched
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics
from test_torch_model import TINY
from test_torch_train import _check_step, _jax_flat, _pair


def _make_scene(n, rng, extent=(6.0, 5.0, 2.5), labeled=True):
    pts = (rng.rand(n, 3) * extent).astype(np.float32)
    labels = rng.randint(1, 21, n).astype(np.int32) if labeled else np.zeros(n, np.int32)
    if labeled:
        labels[rng.rand(n) < 0.2] = 0
    return {"points": pts, "labels": labels,
            "colors": rng.randint(0, 256, (n, 3)).astype(np.uint8),
            "normals": (rng.rand(n, 3) * 2 - 1).astype(np.float32)}


def _mixed_scenes():
    """Rooms of different lengths: two dense ones (a try passes), a sparse
    one (no try passes: the last tried box), an unlabelled one, a small one
    far away in xy (a window bleeding into a neighbour would show), and a
    dense one unlabelled at x < 1.6 m (boxes there fail, others pass: the
    first passing try is often not the first)."""
    rng = np.random.RandomState(0)
    far = _make_scene(3000, rng, extent=(2.0, 2.0, 2.5))
    far["points"][:, :2] += 100.0
    half = _make_scene(5500, rng, extent=(3.2, 2.0, 2.5))
    half["labels"][half["points"][:, 0] < 1.6] = 0
    return [_make_scene(5000, rng, extent=(2.2, 2.2, 2.5)),
            _make_scene(4000, rng),
            _make_scene(4500, rng, extent=(2.4, 2.0, 2.5), labeled=False),
            far,
            _make_scene(6000, rng, extent=(2.6, 2.6, 2.5)),
            half]


def jax_draws(lengths, key, npoints):
    """JAX's sampler's random numbers for samples of these scene lengths."""
    keys = jax.random.split(key, len(lengths))
    centres = np.stack([
        [int(jax.random.randint(jax.random.fold_in(k, t), (), 0, jnp.int32(n)))
         for t in range(MAX_TRIES)] for k, n in zip(keys, lengths)]).astype(np.int64)
    u = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1000), (npoints,)))
                  for k in keys])
    return torch.from_numpy(centres), torch.from_numpy(u)


def _both(scenes, **kw):
    return jds.ResidentScenes(scenes, **kw), ds.ResidentScenes(scenes, device="cpu", **kw)


def _assert_chunks_equal(got, want, with_box=True):
    for k in ("points", "labels", "weights"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    gf, wf = got["features"].numpy(), np.asarray(want["features"])
    np.testing.assert_array_equal(gf[..., 3:], wf[..., 3:], err_msg="normals")
    ulp = np.spacing(np.abs(wf[..., :3]).astype(np.float32))
    assert (np.abs(gf[..., :3] - wf[..., :3]) <= ulp).all(), "colors beyond 1 ulp"
    if with_box:
        for k in ("chunk_lo", "chunk_hi", "chunk_ok"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ---- prob_sample -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 7, 5), (3, 1000, 64), (1, 1, 3)])
def test_prob_sample_bit_identical_on_integer_weights(shape):
    b, n, m = shape
    rng = np.random.RandomState(n)
    w = rng.randint(0, 4, (b, n)).astype(np.float32)
    w[0, rng.rand(n) < 0.5] = 0.0
    u = rng.rand(b, m).astype(np.float32)
    u[0, 0] = 0.0
    got = prob_sample(torch.from_numpy(w), torch.from_numpy(u))
    want = np.asarray(jgeo.prob_sample(jnp.asarray(w), jnp.asarray(u)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_prob_sample_on_float_weights_within_a_cdf_ulp():
    rng = np.random.RandomState(5)
    w = rng.rand(4, 3000).astype(np.float32) ** 3
    u = rng.rand(4, 512).astype(np.float32)
    got = prob_sample(torch.from_numpy(w), torch.from_numpy(u)).numpy()
    want = np.asarray(jgeo.prob_sample(jnp.asarray(w), jnp.asarray(u)))
    cdf = np.cumsum(w.astype(np.float64), axis=1)
    targets = u * cdf[:, -1:]
    for b, j in zip(*np.nonzero(got != want)):
        lo, hi = sorted((got[b, j], want[b, j]))
        steps = cdf[b, lo:hi]
        assert np.min(np.abs(steps - targets[b, j])) <= 2 * np.spacing(np.float32(cdf[b, -1]))
    assert (got == want).mean() > 0.99


# ---- host side and buffers --------------------------------------------------------------


@pytest.mark.parametrize("geometry", [(CHUNK_SIZE, CONTEXT_MARGIN), (1.0, 0.3)])
def test_scene_voxel_sort_and_stripe_window_match_jax(geometry):
    pts = _make_scene(8000, np.random.RandomState(1))["points"]
    got, want = ds.scene_voxel_sort(pts, *geometry), jds.scene_voxel_sort(pts, *geometry)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert ds.stripe_window_len(got[2]) == jds.stripe_window_len(want[2])
    assert ds.stripe_window_len(np.zeros(5, np.int32)) == jds.stripe_window_len(
        np.zeros(5, np.int32)) == 5


@pytest.mark.parametrize("features", [(True, True), (True, False), (False, False)])
def test_resident_buffers_match_jax(features):
    use_colors, use_normals = features
    scenes = _mixed_scenes()
    j, t = _both(scenes, use_colors=use_colors, use_normals=use_normals)
    assert (t.max_len, t.sub_len) == (j.max_len, j.sub_len) == (6000, 5120)
    for k in ("points", "labels", "colors", "normals", "run_start", "vx", "x_mins"):
        if getattr(j, k) is None:
            assert getattr(t, k) is None, k
            continue
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), k)
    assert t.vx.numpy()[-t.max_len:].tolist() == [2 ** 30] * t.max_len
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.d_lengths.numpy(), np.asarray(j.d_lengths))
    assert t.points.shape[0] == sum(len(s["points"]) for s in scenes) + t.max_len


def test_sub_len_rounds_to_1024_below_max_len():
    rng = np.random.RandomState(2)
    scenes = [_make_scene(12000, rng, extent=(12.0, 2.0, 2.5)) for _ in range(2)]
    j, t = _both(scenes)
    assert t.sub_len == j.sub_len and t.sub_len % 1024 == 0 and t.sub_len < t.max_len


def test_estimate_bytes_and_budget_match_jax():
    lengths = [150_000] * 32
    for uc, un in ((True, True), (True, False), (False, True), (False, False)):
        assert ds.ResidentScenes.estimate_bytes(lengths, uc, un) == \
            jds.ResidentScenes.estimate_bytes(lengths, uc, un)
    assert ds.ResidentScenes.estimate_bytes(lengths) == 33 * 150_000 * 39


class _Unloaded(dict):
    """A scene whose arrays must not be read: only ``len(points)`` is."""

    def __init__(self, n):
        super().__init__(points=np.broadcast_to(np.float32(0), (n, 3)))

    def __getitem__(self, key):
        if key != "points":
            raise AssertionError(f"scene body read ({key}) before the budget check")
        return dict.__getitem__(self, key)


def test_budget_raises_before_any_body_loads():
    with pytest.raises(ValueError, match="budget_mb"):
        ds.ResidentScenes([_Unloaded(100_000)] * 4, device="cpu", budget_mb=1)


def test_empty_list_and_mesh_raise():
    with pytest.raises(ValueError, match="empty scene list"):
        ds.ResidentScenes([], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        ds.ResidentScenes(_mixed_scenes()[:1], device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ds.ResidentScenes(_mixed_scenes()[:1])


# ---- sample_chunk_batch ---------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    return _both(_mixed_scenes())


@pytest.mark.parametrize("occupancy", ["fast", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_chunk_batch_matches_jax(mixed, occupancy, seed):
    j, t = mixed
    ids = np.array([0, 1, 2, 3, 4, 5, 5, 5, 5, 5, 5, 5, 5, 0, 4, 1], np.int32)
    key = jax.random.PRNGKey(seed)
    want = jds.sample_chunk_batch(j, jnp.asarray(ids), key, 128, occupancy=occupancy,
                                  with_box=True)
    draws = jax_draws(j.lengths[ids], key, 128)
    got = ds.sample_chunk_batch(t, torch.from_numpy(ids), draws, 128, occupancy=occupancy,
                                with_box=True)
    _assert_chunks_equal(got, want)
    ok = np.asarray(want["chunk_ok"])
    assert ok[[0, 4]].all() and not ok[[1, 2]].any()  # dense rooms pass, sparse ones do not
    # In the half-labelled room some kept box is not the first try's.
    first = t.points[torch.from_numpy(t.offsets[ids[5:13]]).long() + draws[0][5:13, 0], :2]
    assert ok[5:13].any() and (got["chunk_lo"][5:13] != first - CHUNK_SIZE / 2).any()
    without_box = ds.sample_chunk_batch(t, torch.from_numpy(ids), draws, 128,
                                        occupancy=occupancy)
    assert sorted(without_box) == ["features", "labels", "points", "weights"]
    assert torch.equal(without_box["points"], got["points"])


def test_unlabeled_scene_keeps_last_tried_box(mixed):
    """No try passes in the unlabelled room: the last box with candidates
    is kept (chunk-sized), its weights are all zero."""
    j, t = mixed
    ids = np.array([2, 2, 2], np.int32)
    key = jax.random.PRNGKey(3)
    want = jds.sample_chunk_batch(j, jnp.asarray(ids), key, 128, with_box=True)
    got = ds.sample_chunk_batch(t, torch.from_numpy(ids), jax_draws(j.lengths[ids], key, 128),
                                128, with_box=True)
    _assert_chunks_equal(got, want)
    assert not got["chunk_ok"].any() and got["weights"].max() == 0.0
    np.testing.assert_allclose((got["chunk_hi"] - got["chunk_lo"]).numpy(), CHUNK_SIZE,
                               rtol=1e-5)
    pts, lo, hi = got["points"][..., :2], got["chunk_lo"][:, None], got["chunk_hi"][:, None]
    assert (pts >= lo - CONTEXT_MARGIN - 1e-5).all() and (pts <= hi + CONTEXT_MARGIN + 1e-5).all()


def test_windows_never_bleed_across_scenes(mixed):
    """The far room's stripes start inside its own rows: every sampled point
    lies in its xy range (the last scene's window runs into the padding)."""
    j, t = mixed
    for sid, lo in ((3, 99.0), (4, None)):
        ids = np.full(4, sid, np.int32)
        key = jax.random.PRNGKey(11)
        got = ds.sample_chunk_batch(t, torch.from_numpy(ids),
                                    jax_draws(j.lengths[ids], key, 256), 256)
        want = jds.sample_chunk_batch(j, jnp.asarray(ids), key, 256)
        _assert_chunks_equal(got, want, with_box=False)
        xy = got["points"][..., :2]
        assert (xy >= 99.0).all() if lo else (xy < 50.0).all()


def test_make_draws_range_and_stream():
    _, t = _both(_mixed_scenes())
    ids = torch.tensor([0, 3, 3, 1], dtype=torch.int32)
    c, u = ds.make_draws(t, ids, 64, torch.Generator().manual_seed(0))
    assert c.shape == (4, MAX_TRIES) and c.dtype == torch.int64 and u.shape == (4, 64)
    assert (c >= 0).all() and (c < t.d_lengths[ids.long()][:, None]).all()
    assert (u >= 0).all() and (u < 1).all() and u.dtype == torch.float32
    c2, u2 = ds.make_draws(t, ids, 64, torch.Generator().manual_seed(0))
    assert torch.equal(c, c2) and torch.equal(u, u2)


def test_sampler_statistics_match_host_sampler():
    """Sampled chunks, with the port's own draws, against the host sampler
    on the same room (JAX's ``test_sampler_statistics_match_host_sampler``
    ranges): the mean share of points inside the inner box within 0.15 of
    the host's; every point inside the context box; the labelled share of a
    valid chunk >= 0.7 minus sampling noise; the kept boxes' occupancy."""
    rng = np.random.RandomState(4)
    scene = _make_scene(30000, rng)
    host_inner = []
    for i in range(8):
        _, _, _, _, w = jsample_random_chunk(scene["points"], scene["labels"], scene["colors"],
                                             scene["normals"], 256, np.random.RandomState(i))
        host_inner.append((w > 0).mean())
    t = ds.ResidentScenes([scene], device="cpu")
    ids = torch.zeros(8, dtype=torch.int32)
    batch = ds.sample_chunk_batch(t, ids, ds.make_draws(t, ids, 256,
                                                        torch.Generator().manual_seed(5)),
                                  256, with_box=True)
    labels = batch["labels"].numpy()
    inner = ((batch["points"][..., :2] >= batch["chunk_lo"][:, None])
             & (batch["points"][..., :2] <= batch["chunk_hi"][:, None])).all(-1).numpy()
    dev_inner = (inner & (labels > 0)).mean(axis=1)
    assert abs(np.mean(dev_inner) - np.mean(host_inner)) < 0.15
    assert batch["chunk_ok"].all()
    assert ((labels > 0).mean(axis=1) >= 0.6).all()
    lo, hi = batch["chunk_lo"][:, None], batch["chunk_hi"][:, None]
    xy = batch["points"][..., :2]
    assert ((xy >= lo - CONTEXT_MARGIN) & (xy <= hi + CONTEXT_MARGIN)).all()
    np.testing.assert_array_equal(batch["weights"].numpy() > 0, inner & (labels > 0))


# ---- the sampling train step ----------------------------------------------------------


def test_sampling_step_matches_jax():
    """Two steps of ``make_sampling_train_step`` fed JAX's draws against
    JAX's steps from the same state, dropout off, on synthetic rooms (as
    ``tests/test_torch_train.py``'s train-step tests)."""
    j, t = _both([make_synthetic_scene(4000, seed=s) for s in range(3)])
    init = {"points": np.zeros((1, 128, 3), np.float32),
            "features": np.zeros((1, 128, 6), np.float32)}
    jstate, tstate = _pair(TINY, init, capture=True)
    jstep = jds.make_sampling_train_step(j, 128, donate=False)
    tstep = ds.make_sampling_train_step(t, 128)
    ids = np.array([0, 2], np.int32)
    rng_key = jax.random.PRNGKey(1)
    for s in range(2):
        before = _jax_flat(jstate, jstate.opt_state[1])
        load_jax_state(before, tstate)
        draws = jax_draws(j.lengths[ids], jax.random.fold_in(rng_key, int(jstate.step)), 128)
        jstate, jm = jstep(jstate, jnp.asarray(ids), rng_key)
        tstate, tm = tstep(tstate, torch.from_numpy(ids), 0, draws=draws)
        assert tstate.step == int(jstate.step) == s + 1
        _check_step(before, _jax_flat(jstate, jstate.opt_state[1]), jm, jstate.opt_state[0],
                    tstate, tm, tsched.scannet_learning_rate(s), 1e-4)


def test_sampling_step_augment_keeps_norms_z_and_colors(monkeypatch):
    """``augment=True`` trains on z-rotated chunks: against the unrotated
    chunk of the same draws, norms, z and colors are kept."""
    rng = np.random.RandomState(7)
    _, t = _both([_make_scene(4000, rng, extent=(2.2, 2.2, 2.5))])
    ids = torch.zeros(2, dtype=torch.int32)
    draws = ds.make_draws(t, ids, 64, torch.Generator().manual_seed(1))
    plain = ds.sample_chunk_batch(t, ids, draws, 64)
    seen = []
    monkeypatch.setattr(ds.steps, "seg_train_step",
                        lambda state, batch, seed, **kw: seen.append(batch) or (state, {}))
    ds.make_sampling_train_step(t, 64, augment=True)(type("S", (), {"step": 3})(), ids, 0,
                                                      draws=draws)
    (rot,) = seen
    p, q = plain["points"], rot["points"]
    assert torch.equal(q[..., 2], p[..., 2]) and not torch.equal(q, p)
    torch.testing.assert_close(q[..., :2].norm(dim=-1), p[..., :2].norm(dim=-1),
                               rtol=1e-5, atol=1e-5)
    f, g = plain["features"], rot["features"]
    assert torch.equal(g[..., :3], f[..., :3]) and torch.equal(g[..., 5], f[..., 5])
    torch.testing.assert_close(g[..., 3:5].norm(dim=-1), f[..., 3:5].norm(dim=-1),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(rot["labels"], plain["labels"])


# ---- the trainer's sampler input ------------------------------------------------------

TINY_CFG = {"sa_npoints": [16, 8, 4, 2], "sa_radii": [0.2, 0.4, 0.8, 1.2], "sa_nsample": 4,
            "sa_mlps": [[8, 8], [8, 8], [8, 8], [8, 8]], "fp_mlps": [[8], [8], [8], [8, 8]]}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("sampler_store")
    root = str(d / "scannet")
    splits = tscenes.write_synthetic_dataset(root, n_train=5, n_val=1, n_points=4000)
    base = dict(data_root=root, input="sampler", model="sem_seg_features",
                model_overrides=TINY_CFG, batch_size=2, n_points=128, epochs=2,
                n_epochs_to_val=1, n_devices=1, save_every_epochs=1)
    return d, root, splits, base


@pytest.mark.parametrize("n_train", [5, 1])
def test_scene_id_stream_matches_jax(store, n_train, monkeypatch, tmp_path):
    """The JAX trainer's sampler stream (its step replaced by one that
    records the ids) against the port's ``_scene_id_stream``: a permutation a
    pass, whole batches only, resized to B when there are fewer scenes."""
    d, root, splits, base = store
    split_dir = str(tmp_path / "splits")
    tscenes.write_split(split_dir, "train", splits["train"][:n_train])
    tscenes.write_split(split_dir, "val", splits["val"])
    recorded = []

    def recording_step(scenes, npoints, **kw):
        def step(state, ids, rng):
            recorded.append(np.asarray(ids))
            zero = jnp.zeros((), jnp.float32)
            return state, {"loss": zero, "accuracy": zero, "learning_rate": zero,
                           "confusion": jnp.zeros((21, 21), jnp.float32)}
        return step

    monkeypatch.setattr(jds, "make_sampling_train_step", recording_step)
    cfg = dict(base, split_dir=split_dir, seed=3, n_epochs_to_val=10**6, save_every_epochs=0,
               log_dir=str(tmp_path / "jax"))
    jtrainer.train(JConfig(**cfg), max_steps=7)
    stream = ttrainer._scene_id_stream(TrainConfig(**cfg), n_train, torch.device("cpu"))
    got = [next(stream)["scene_ids"] for _ in range(7)]
    assert len(recorded) == 7
    for g, w in zip(got, recorded):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("geometry", [(1.5, 0.2), (1.0, 0.3)])
def test_onfly_val_chunks_match_jax(store, geometry):
    _, root, splits, _ = store
    got = list(ttrainer._onfly_val_chunks(root, splits["val"], 128, chunk_size=geometry[0],
                                          margin=geometry[1]))
    want = list(jtrainer._onfly_val_chunks(root, splits["val"], 128, chunk_size=geometry[0],
                                           margin=geometry[1]))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _sampler_run(store, tag, **over):
    d, _, _, base = store
    cfg = TrainConfig(**{**base, "log_dir": str(d / tag), **over})
    summary = ttrainer.train(cfg, device="cpu")
    with np.load(latest_checkpoint(cfg.ckpt_dir)) as z:
        final = {k: z[k] for k in z.files}
    records = read_metrics(os.path.join(cfg.log_dir, "train_metrics.jsonl"))
    logged = [{k: v for k, v in r.items() if k not in ("time", "points_per_sec",
                                                        "input_wait_s", "epoch_s")}
              for r in records]
    return cfg, summary, final, logged


def test_sampler_input_trains_validates_and_keeps_best(store):
    """``train(input='sampler')``: two epochs of two steps, validation on
    the fly each epoch, the best checkpoint kept, no precompute directory;
    a second run with the same seed gives the same parameters and logs."""
    cfg, summary, final, logged = _sampler_run(store, "sampler_a")
    assert summary["final_step"] == 4 and np.isfinite(summary["final_train_loss"])
    assert best_checkpoint(cfg.ckpt_dir, "best") is not None
    assert len([r for r in logged if "train_loss" in r]) == 2
    vals = [r for r in logged if "val_miou" in r]
    assert len(vals) == 2 and all(np.isfinite(r["val_loss"]) for r in vals)
    assert not os.path.exists(cfg.precompute_dir)
    _, summary2, final2, logged2 = _sampler_run(store, "sampler_b")
    assert summary2 == summary and logged2 == logged
    assert sorted(final2) == sorted(final)
    for k in final:
        np.testing.assert_array_equal(final2[k], final[k], err_msg=k)


@pytest.mark.parametrize("cache", [True, False])
def test_val_chunks_are_cut_once_when_cached(store, cache, monkeypatch):
    calls = []
    cut = ttrainer._onfly_val_chunks

    def counting(*args, **kwargs):
        calls.append(1)
        return cut(*args, **kwargs)

    monkeypatch.setattr(ttrainer, "_onfly_val_chunks", counting)
    _, summary, _, logged = _sampler_run(store, f"cache_{cache}", cache_val_chunks=cache)
    assert len([r for r in logged if "val_miou" in r]) == 2
    assert len(calls) == (1 if cache else 2)


def test_sampler_budget_is_checked_before_any_scene_loads(store, monkeypatch):
    def refuse(*args):
        raise AssertionError("a scene body was loaded before the budget check")

    monkeypatch.setattr(ttrainer, "load_scene_mapped", refuse)
    d, _, _, base = store
    cfg = TrainConfig(**{**base, "log_dir": str(d / "budget")}, sampler_budget_mb=0)
    with pytest.raises(ValueError, match="sampler_budget_mb"):
        ttrainer.train(cfg, device="cpu")
