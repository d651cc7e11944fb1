"""The port's PointNet++ v1 ScanNet pipeline against the JAX package on the
CPU: ``utils/pc_util.py``, ``data/scannet/v1_compat.py`` and
``train/v1_scannet_trainer.py``.

Every ``pc_util`` function, the three v1 datasets (item by item, from one
synthetic store and seed) and the trainer's batch stream (``get_batch_wdp``
then ``rotate_point_cloud_z``, with the epoch permutations, all from one
``RandomState``) must equal the JAX package's bit for bit: they are numpy
on both sides, with the same draws in the same order.  ``eval_whole_scenes``
with the JAX model's weights carried into the port gives JAX's point
accuracy, mIoU and calibrated voxel accuracy (rtol 1e-12: the logits agree
to ~1e-6 and no argmax here is that close to a tie, so the predictions and
with them the metrics are equal).  The port's trainer runs at the tiny
hierarchy of ``test_torch_model.TINY`` (its ``get_model`` patched), so that
it runs in seconds; its summary's keys are those of the JAX trainer's
vendored run (``RESULTS_family_convergence.json``).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu import ops as jops
from pointcloud_segmentation_attention_tpu import parallel as jparallel
from pointcloud_segmentation_attention_tpu.data.augment import (
    rotate_point_cloud_z as j_rotate_z,
)
from pointcloud_segmentation_attention_tpu.data.scannet import v1_compat as jv1
from pointcloud_segmentation_attention_tpu.train import seg_eval_step as j_seg_eval_step
from pointcloud_segmentation_attention_tpu.train import v1_scannet_trainer as jtrainer
from pointcloud_segmentation_attention_tpu.utils import pc_util as jpc
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import ops as tops
from pointcloud_segmentation_attention_tpu_torch.data.augment import (
    rotate_point_cloud_z as t_rotate_z,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.data.scannet import v1_compat as tv1
from pointcloud_segmentation_attention_tpu_torch.train import v1_scannet_trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.utils import pc_util as tpc
from test_torch_model import TINY
from test_torch_train import _pair

NPOINTS = 256


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A synthetic store (2 train + 1 val rooms of 6000 points), written by
    the port and read by both packages."""
    root = str(tmp_path_factory.mktemp("v1_scannet") / "scannet")
    splits = tscenes.write_synthetic_dataset(root, n_train=2, n_val=1, n_test=0,
                                             n_points=6000, seed=4)
    return root, splits["train"], splits["val"]


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---- pc_util ------------------------------------------------------------------------

def _cloud(n=300, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


PC_UTIL_CASES = {
    "point_cloud_to_volume": lambda m: m.point_cloud_to_volume(_cloud() * 1.2, 12, 1.0),
    "volume_to_point_cloud": lambda m: m.volume_to_point_cloud(
        m.point_cloud_to_volume(_cloud(), 8)),
    "point_cloud_to_volume_batch": lambda m: (
        m.point_cloud_to_volume_batch(np.stack([_cloud(seed=s) for s in range(3)])),
        m.point_cloud_to_volume_batch(np.stack([_cloud(seed=s) for s in range(2)]), 6,
                                      flatten=False)),
    "point_cloud_to_image": lambda m: m.point_cloud_to_image(
        _cloud(2000) * 0.99, 8, 1.0, 16, rng=np.random.RandomState(3)),
    "point_cloud_to_image_batch": lambda m: m.point_cloud_to_image_batch(
        np.stack([_cloud(500, s) * 0.99 for s in range(2)]), 4, 1.0, 8,
        rng=np.random.RandomState(4)),
    "draw_point_cloud": lambda m: (m.draw_point_cloud(_cloud(200), canvas_size=120,
                                                      diameter=9, xrot=0.3, zrot=1.1),
                                   m.draw_point_cloud(None)),
    "rotate_points": lambda m: m.rotate_points(_cloud(), 0.2, -0.7, 1.9),
    "point_cloud_three_views": lambda m: m.point_cloud_three_views(_cloud(150)),
    "point_cloud_label_to_surface_voxel_label": lambda m: (
        m.point_cloud_label_to_surface_voxel_label(
            _cloud(400) * 0.2, np.random.RandomState(5).randint(0, 5, 400), res=0.05),
        m.point_cloud_label_to_surface_voxel_label(
            _cloud(400) * 0.2, np.random.RandomState(6).randint(0, 5, (400, 2)), res=0.05)),
    "point_cloud_label_to_surface_voxel_label_fast": lambda m: (
        m.point_cloud_label_to_surface_voxel_label_fast(
            _cloud(400) * 0.2, np.random.RandomState(5).randint(0, 21, 400), res=0.05),
        m.point_cloud_label_to_surface_voxel_label_fast(
            _cloud(400) * 0.2, np.random.RandomState(6).randint(0, 21, (400, 2)), res=0.05)),
    "calibrated_voxel_accuracy": lambda m: (
        m.CALIBRATION_WEIGHTS,
        m.calibrated_voxel_accuracy(np.arange(20) % 7, np.arange(20) % 9),
        m.calibrated_voxel_accuracy(np.zeros(20), np.zeros(20))),
    "virtual_scan": lambda m: tuple(
        m.virtual_scan(_cloud(3000) * 2 + 2, mode, rng)
        for rng in [np.random.RandomState(7)] for mode in (-1, *range(8), -1)),
    "sample_mesh_points": lambda m: (
        m.sample_mesh_points(_cloud(30), np.random.RandomState(8).randint(0, 30, (40, 3)),
                             500, rng=np.random.RandomState(9)),
        m.sample_mesh_points(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]]), 20,
                             rng=np.random.RandomState(10))),
}


@pytest.mark.parametrize("fn", sorted(PC_UTIL_CASES))
def test_pc_util_equals_jax(fn):
    """Each public function of ``pc_util`` on the same inputs and
    ``RandomState`` draws: bit for bit (``virtual_scan`` for modes -1 and
    0-7 from one ``RandomState``, so its draws stay in step)."""
    case = PC_UTIL_CASES[fn]
    _assert_same(case(tpc), case(jpc))


def test_pc_util_covers_every_public_function():
    public = {n for n in dir(jpc) if not n.startswith("_") and callable(getattr(jpc, n))
              and getattr(getattr(jpc, n), "__module__", "") == jpc.__name__}
    assert public == set(PC_UTIL_CASES), public ^ set(PC_UTIL_CASES)
    assert public == {n for n in dir(tpc) if not n.startswith("_")
                      and callable(getattr(tpc, n))
                      and getattr(getattr(tpc, n), "__module__", "") == tpc.__name__}


# ---- the datasets and the batch stream ---------------------------------------------

def _datasets(mod, store, kind):
    root, train, val = store
    if kind == "chunk":
        return mod.ScannetDataset(root, train, npoints=512, seed=3)
    if kind == "whole":
        return mod.ScannetDatasetWholeScene(root, train + val, npoints=512, seed=3)
    if kind == "whole_train":
        return mod.ScannetDatasetWholeScene(root, train, npoints=512, seed=3, split="train")
    return mod.ScannetDatasetVirtualScan(root, train, npoints=NPOINTS, seed=3)


@pytest.mark.parametrize("kind", ["chunk", "whole", "whole_train", "virtual"])
def test_v1_datasets_equal_jax(store, kind):
    """Label weights, then every item twice over (the second pass continues
    each dataset's ``RandomState``), bit for bit."""
    got, want = _datasets(tv1, store, kind), _datasets(jv1, store, kind)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.labelweights, want.labelweights)
    for _ in range(2):
        for i in range(len(want)):
            _assert_same(got[i], want[i])


@pytest.mark.parametrize("kind", ["whole", "virtual"])
def test_batch_stream_equals_jax(store, kind):
    """The trainer's host stream: the flattened stacks, then two epochs of
    the permutation, ``get_batch_wdp`` (drop ratio, then mask, per sample)
    and ``rotate_point_cloud_z``, all from one ``RandomState``."""
    src = "whole_train" if kind == "whole" else kind
    got_ds = ttrainer._FlattenedStacked(_datasets(tv1, store, src))
    want_ds = jtrainer._FlattenedStacked(_datasets(jv1, store, src))
    assert len(got_ds) == len(want_ds)
    npoints = 512 if kind == "whole" else NPOINTS
    t_rng, j_rng = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(2):
        t_idx, j_idx = t_rng.permutation(len(got_ds)), j_rng.permutation(len(want_ds))
        np.testing.assert_array_equal(t_idx, j_idx)
        for start in range(0, len(want_ds) - 2 + 1, 2):
            got = ttrainer.get_batch_wdp(got_ds, t_idx, start, 2, npoints, t_rng)
            want = jtrainer.get_batch_wdp(want_ds, j_idx, start, 2, npoints, j_rng)
            _assert_same(got, want)
            _assert_same(t_rotate_z(got[0], rng=t_rng), j_rotate_z(want[0], rng=j_rng))


def test_fps_and_ball_query_past_the_cloud_size_equal_jax():
    """``sem_seg`` at 256 points (JAX's own v1 trainer test) samples 1024
    centres from 256: FPS and ball query indices equal JAX's."""
    rng = np.random.RandomState(11)
    xyz = rng.rand(2, NPOINTS, 3).astype(np.float32)
    idx_t = tops.farthest_point_sample(torch.from_numpy(xyz), 1024)
    idx_j = np.asarray(jops.farthest_point_sample(jnp.asarray(xyz), 1024))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    centres = xyz[np.arange(2)[:, None], idx_j]
    got = tops.ball_query(torch.from_numpy(xyz), torch.from_numpy(centres), 0.1, 32)
    want = jops.ball_query(jnp.asarray(xyz), jnp.asarray(centres), 0.1, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- evaluation and training ----------------------------------------------------------

def test_eval_whole_scenes_matches_jax(store):
    root, _, val = store
    t_ds = tv1.ScannetDatasetWholeScene(root, val, npoints=NPOINTS, seed=0)
    j_ds = jv1.ScannetDatasetWholeScene(root, val, npoints=NPOINTS, seed=0)
    example = tv1.ScannetDatasetWholeScene(root, val, npoints=NPOINTS, seed=0)[0][0][:1]
    jstate, tstate = _pair(TINY, {"points": example}, capture=False, name="sem_seg")
    # A steeper last layer, so that the seeded biases do not pick one class
    # for every point and the metrics have something to count.
    fc2 = {**jstate.params["fc2"], "kernel": jstate.params["fc2"]["kernel"] * 50.0}
    jstate = jstate.replace(params={**jstate.params, "fc2": fc2})
    with torch.no_grad():
        tstate.model.fc2.kernel.copy_(torch.from_numpy(np.array(fc2["kernel"])))
    mesh = jparallel.make_mesh(1)
    eval_step = jparallel.data_parallel_jit(j_seg_eval_step, mesh, batch_argnums=(1,),
                                            donate_argnums=())
    want = jtrainer.eval_whole_scenes(jstate, j_ds, 4, mesh, eval_step)
    got = ttrainer.eval_whole_scenes(tstate, t_ds, 4)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-12), k
    assert 0.0 < want["eval_accuracy"] < 1.0 and want["eval_miou"] > 0.0
    assert want["eval_calibrated_vox_accuracy"] > 0.0


def _tiny_sem_seg(real):
    def get_model(name, **kwargs):
        assert name == "sem_seg"
        return real(name, **kwargs, **TINY)
    return get_model


def _no_tensorboard(logger):
    """The metrics logger without its TensorBoard writer (whose import
    takes ~10 s here); the JSON lines are unchanged."""
    return functools.partial(logger, tensorboard=False)


# The keys of the JAX trainer's summary: its vendored run's, less the two the
# recipe adds.
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "RESULTS_family_convergence.json")) as _f:
    JAX_SUMMARY_KEYS = set(json.load(_f)["v1_scannet_whole"]) - {"model", "dataset_kind"}


@pytest.mark.parametrize("kind", ["chunk", "whole", "virtual"])
def test_train_scannet_v1_runs_each_dataset(store, tmp_path, monkeypatch, kind):
    """Two steps of each ``dataset_kind`` on the CPU (one for ``chunk``:
    two training rooms make one B2 batch an epoch, and the run stops after
    its epoch): finite metrics, and the summary's keys equal JAX's."""
    root, train, val = store
    monkeypatch.setattr(ttrainer.models, "get_model", _tiny_sem_seg(tmodels.get_model))
    monkeypatch.setattr(ttrainer, "MetricLogger", _no_tensorboard(ttrainer.MetricLogger))
    log_dir = str(tmp_path / kind)
    summary = ttrainer.train_scannet_v1(root, train, val, npoints=NPOINTS, batch_size=2,
                                        epochs=1, log_dir=log_dir, max_steps=2,
                                        dataset_kind=kind, device="cpu")
    assert set(summary) == JAX_SUMMARY_KEYS
    assert summary["steps"] == (1 if kind == "chunk" else 2)
    assert np.isfinite(summary["train_loss"]) and summary["train_loss"] > 0
    assert 0.0 <= summary["eval_accuracy"] <= 1.0
    assert 0.0 <= summary["eval_calibrated_vox_accuracy"] <= 1.0
    assert os.path.exists(os.path.join(log_dir, "scannet_v1_metrics.jsonl"))


def test_train_scannet_v1_refusals(store):
    root, train, val = store
    with pytest.raises(ValueError, match="does not divide"):
        ttrainer.train_scannet_v1(root, train, val, n_devices=3, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="dataset_kind"):
        ttrainer.train_scannet_v1(root, train, val, dataset_kind="bogus", device="cpu")
