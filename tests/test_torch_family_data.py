"""The port's ModelNet / ShapeNet-part data, augmentation, part IoU, voting,
trainers and family recipes against the JAX package's, on the CPU.

The data modules are numpy in both packages and the port keeps its own
copies: every augmentation, dataset batch and synthetic writer's file must
be bit-identical to the JAX package's from the same seeds (the same
``RandomState`` draws in the same order).  Part IoU and voting must equal
JAX's on the same logits and the same deterministic ``predict_fn``.  The
two trainers run a few CPU steps through their ``main --device cpu``, and
their summaries carry the keys of the JAX package's vendored results
(``RESULTS_family_convergence.json``); the recipes' defaults equal JAX's,
and the recipes and ``main``'s arms run tiny (the v1 ScanNet arm too).
"""
import filecmp
import functools
import inspect
import json
import os

import numpy as np
import pytest

from pointcloud_segmentation_attention_tpu.data import augment as jaug
from pointcloud_segmentation_attention_tpu.data import modelnet as jmn
from pointcloud_segmentation_attention_tpu.data import shapenet_part as jsp
from pointcloud_segmentation_attention_tpu.eval import part_iou as jiou
from pointcloud_segmentation_attention_tpu.eval import voting as jvote
from pointcloud_segmentation_attention_tpu.recipes import family_convergence as jrecipe
from pointcloud_segmentation_attention_tpu_torch.data import augment as taug
from pointcloud_segmentation_attention_tpu_torch.data import modelnet as tmn
from pointcloud_segmentation_attention_tpu_torch.data import shapenet_part as tsp
from pointcloud_segmentation_attention_tpu_torch.eval import part_iou as tiou
from pointcloud_segmentation_attention_tpu_torch.eval import voting as tvote
from pointcloud_segmentation_attention_tpu_torch.recipes import family_convergence as trecipe
from pointcloud_segmentation_attention_tpu_torch.train import cls_trainer as tcls_trainer
from pointcloud_segmentation_attention_tpu_torch.train import partseg_trainer as tps_trainer
from pointcloud_segmentation_attention_tpu_torch.train import v1_scannet_trainer as tv1_trainer

# The tiny sem_seg hierarchy of tests/test_torch_model.py, for the v1 ScanNet arm.
TINY_SEM_SEG = dict(sa_npoints=(16, 8, 4, 2), sa_radii=(0.1, 0.2, 0.4, 0.8), sa_nsample=4,
                    sa_mlps=((4, 8), (8, 8), (8, 8), (8, 8)),
                    fp_mlps=((8,), (8,), (8,), (8, 8)))


def _same_tree(a, b):
    """Every file under ``a`` and ``b`` has the same relative path and bytes."""
    files = []
    for root in (a, b):
        files.append(sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs))
    assert files[0] == files[1] and files[0]
    for rel in files[0]:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


def _batch(c=6, seed=0):
    return np.random.RandomState(seed).randn(3, 64, c).astype(np.float32)


# ---- augmentation -------------------------------------------------------------

RANDOM_AUGMENTS = [
    ("rotate_point_cloud", 3, {}),
    ("rotate_point_cloud_z", 3, {}),
    ("rotate_point_cloud_with_normal", 6, {}),
    ("rotate_perturbation_point_cloud", 3, {}),
    ("rotate_perturbation_point_cloud_with_normal", 6, {}),
    ("jitter_point_cloud", 3, {}),
    ("shift_point_cloud", 3, {}),
    ("random_scale_point_cloud", 3, {}),
    ("random_point_dropout", 6, {}),
    ("shuffle_points", 6, {}),
    ("augment_batch_cls", 3, {"with_normals": False}),
    ("augment_batch_cls", 6, {"with_normals": True}),
]


@pytest.mark.parametrize("name,c,kw", RANDOM_AUGMENTS)
def test_augment_matches_jax_bit_for_bit(name, c, kw):
    data = _batch(c, seed=len(name))
    ra, rb = np.random.RandomState(5), np.random.RandomState(5)
    want = getattr(jaug, name)(data, rng=ra, **kw)
    got = getattr(taug, name)(data, rng=rb, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the same draws in the same order: the streams end in the same state
    assert ra.randint(1 << 30) == rb.randint(1 << 30)
    np.testing.assert_array_equal(data, _batch(c, seed=len(name)))  # input untouched


@pytest.mark.parametrize("name,c", [("rotate_point_cloud_by_angle", 3),
                                    ("rotate_point_cloud_by_angle_with_normal", 6)])
def test_deterministic_rotations_match_jax(name, c):
    data = _batch(c, seed=9)
    for angle in (0.0, 1.3, np.pi):
        np.testing.assert_array_equal(getattr(taug, name)(data, angle),
                                      getattr(jaug, name)(data, angle))


# ---- ModelNet ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def modelnet_roots(tmp_path_factory):
    roots = []
    for mod in (jmn, tmn):
        root = str(tmp_path_factory.mktemp("modelnet"))
        mod.write_synthetic_modelnet(root, num_classes=4, shapes_per_class=3, n_points=160,
                                     seed=2)
        roots.append(root)
    return roots


def test_synthetic_modelnet_writer_matches_jax(modelnet_roots):
    _same_tree(*modelnet_roots)
    np.testing.assert_array_equal(tmn._synthetic_shape(3, 7, 50), jmn._synthetic_shape(3, 7, 50))
    pc = _batch(3, seed=4)[0]
    np.testing.assert_array_equal(tmn.pc_normalize(pc), jmn.pc_normalize(pc))


@pytest.mark.parametrize("normal_channel,augment", [(False, True), (True, True),
                                                    (True, False)])
def test_modelnet_dataset_batches_match_jax(modelnet_roots, normal_channel, augment):
    root = modelnet_roots[0]
    # npoints above the files' 160 points resamples short shapes with replacement
    kw = dict(batch_size=3, npoints=192, split="train", normal_channel=normal_channel, seed=4)
    want_ds, got_ds = jmn.ModelNetDataset(root, **kw), tmn.ModelNetDataset(root, **kw)
    assert len(got_ds) == len(want_ds) == 8 and got_ds.num_channel() == want_ds.num_channel()
    for _ in range(2):  # two epochs, each reset reshuffles
        want_ds.reset()
        got_ds.reset()
        while want_ds.has_next_batch():
            assert got_ds.has_next_batch()
            for w, g in zip(want_ds.next_batch(augment), got_ds.next_batch(augment)):
                np.testing.assert_array_equal(g, w)
        assert not got_ds.has_next_batch()


def test_modelnet_h5_dataset_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(3)
    with open(tmp_path / "list.txt", "w") as f:
        for s in range(2):
            with h5py.File(tmp_path / f"shard{s}.h5", "w") as h5:
                h5.create_dataset("data", data=rng.randn(5, 40, 6).astype(np.float32))
                h5.create_dataset("label", data=rng.randint(0, 4, (5, 1)))
            f.write(f"shard{s}.h5\n")
    kw = dict(batch_size=4, npoints=32, shuffle=True, seed=1)
    want_ds = jmn.ModelNetH5Dataset(str(tmp_path / "list.txt"), **kw)
    got_ds = tmn.ModelNetH5Dataset(str(tmp_path / "list.txt"), **kw)
    while want_ds.has_next_batch():
        for w, g in zip(want_ds.next_batch(True), got_ds.next_batch(True)):
            np.testing.assert_array_equal(g, w)


# ---- ShapeNet-part -------------------------------------------------------------------

@pytest.fixture(scope="module")
def shapenet_roots(tmp_path_factory):
    roots = []
    for mod in (jsp, tsp):
        root = str(tmp_path_factory.mktemp("shapenet"))
        mod.write_synthetic_shapenet_part(root, categories=["Airplane", "Chair", "Mug"],
                                          n_shapes_per_cat=4, n_points=96, seed=3)
        roots.append(root)
    return roots


def test_synthetic_shapenet_part_writer_matches_jax(shapenet_roots):
    _same_tree(*shapenet_roots)


@pytest.mark.parametrize("split,cls_label", [("trainval", True), ("test", False)])
def test_part_normal_dataset_matches_jax(shapenet_roots, split, cls_label):
    root = shapenet_roots[0]
    kw = dict(npoints=128, split=split, return_cls_label=cls_label, seed=5)
    want_ds, got_ds = jsp.PartNormalDataset(root, **kw), tsp.PartNormalDataset(root, **kw)
    assert len(got_ds) == len(want_ds) and got_ds.classes == want_ds.classes
    for i in range(len(want_ds)):
        assert got_ds.category_of(i) == want_ds.category_of(i)
        for w, g in zip(want_ds[i], got_ds[i]):
            np.testing.assert_array_equal(g, w)
    for shuffle in (True, False):
        for w, g in zip(want_ds.batches(2, shuffle), got_ds.batches(2, shuffle)):
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)


def test_shapenet_part_h5_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    lists = []
    for mod, sub in ((jsp, "jax"), (tsp, "port")):
        lists.append(mod.write_synthetic_shapenet_part_h5(str(tmp_path / sub), n_shards=2,
                                                          shapes_per_shard=6, n_points=40,
                                                          seed=4))
    for a, b in zip(*lists):
        assert os.path.basename(a) == os.path.basename(b)
    shard = os.path.join(os.path.dirname(lists[0][0]), "ply_data_0.h5")
    for w, g in zip(jsp.load_h5_with_seg(shard), tsp.load_h5_with_seg(shard)):
        np.testing.assert_array_equal(g, w)
    for shuffle in (True, False):
        kw = dict(batch_size=4, npoints=32, shuffle=shuffle, seed=2)
        want = list(jsp.ShapeNetPartH5Dataset(lists[0][0], **kw).batches())
        got = list(tsp.ShapeNetPartH5Dataset(lists[0][0], **kw).batches())
        assert len(got) == len(want) == 2
        for w, g in zip(want, got):
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)


# ---- part IoU and voting ---------------------------------------------------------------

def test_part_iou_matches_jax():
    rng = np.random.RandomState(6)
    assert tiou.SEG_CLASSES == jiou.SEG_CLASSES and tiou.CATEGORIES == jiou.CATEGORIES
    assert tiou.LABEL_TO_CATEGORY == jiou.LABEL_TO_CATEGORY
    want_acc, got_acc = jiou.PartIoUAccumulator(), tiou.PartIoUAccumulator()
    for s in range(12):
        cat = jiou.CATEGORIES[s % 5]
        logits = rng.randn(64, 50).astype(np.float32)
        gt = rng.choice(jiou.SEG_CLASSES[cat], 64)
        pred = tiou.restrict_logits_to_category(logits, cat)
        np.testing.assert_array_equal(pred, jiou.restrict_logits_to_category(logits, cat))
        assert tiou.shape_iou(pred, gt, cat) == jiou.shape_iou(pred, gt, cat)
        want_acc.add_shape(logits, gt, cat)
        got_acc.add_shape(logits, gt, cat)
    assert got_acc.result() == want_acc.result()
    assert tiou.PartIoUAccumulator().result() == jiou.PartIoUAccumulator().result()


def _linear_predict(out_dim, per_point):
    """A deterministic numpy 'model': a fixed linear map of each point."""
    w = np.random.RandomState(out_dim).randn(6, out_dim).astype(np.float32)

    def predict(points):
        c = points.shape[-1]
        logits = points @ w[:c]
        return logits if per_point else logits.max(axis=1)
    return predict


@pytest.mark.parametrize("with_normals", [False, True])
def test_classification_voting_matches_jax(with_normals):
    rng = np.random.RandomState(7)
    c = 6 if with_normals else 3
    batches = [(rng.randn(4, 32, c).astype(np.float32), rng.randint(0, 5, 4))
               for _ in range(3)]
    fn = _linear_predict(5, per_point=False)
    np.testing.assert_array_equal(
        tvote.vote_predict(fn, batches[0][0], 4, with_normals),
        jvote.vote_predict(fn, batches[0][0], 4, with_normals))
    want = jvote.evaluate_classification(fn, batches, 3, 5, with_normals)
    got = tvote.evaluate_classification(fn, batches, 3, 5, with_normals)
    assert set(got) == set(want)
    assert got["accuracy"] == want["accuracy"]
    assert got["avg_class_accuracy"] == want["avg_class_accuracy"]
    np.testing.assert_array_equal(got["per_class_accuracy"], want["per_class_accuracy"])


def test_partseg_voting_matches_jax(shapenet_roots, tmp_path):
    fn = _linear_predict(50, per_point=True)
    pts = np.random.RandomState(8).randn(2, 40, 6).astype(np.float32)
    np.testing.assert_array_equal(tvote.vote_predict_partseg(fn, pts, 5, seed=3),
                                  jvote.vote_predict_partseg(fn, pts, 5, seed=3))
    kw = dict(npoints=64, split="test", seed=1)
    want = jvote.evaluate_part_segmentation(fn, jsp.PartNormalDataset(shapenet_roots[0], **kw),
                                            batch_size=2, num_votes=3)
    got = tvote.evaluate_part_segmentation(fn, tsp.PartNormalDataset(shapenet_roots[0], **kw),
                                           batch_size=2, num_votes=3)
    assert got == want
    # With ply_dir= both write shape{index:05d}_{category}.ply, the same bytes.
    jvote.evaluate_part_segmentation(fn, jsp.PartNormalDataset(shapenet_roots[0], **kw),
                                     batch_size=2, num_votes=3, ply_dir=str(tmp_path / "j"))
    tvote.evaluate_part_segmentation(fn, tsp.PartNormalDataset(shapenet_roots[0], **kw),
                                     batch_size=2, num_votes=3, ply_dir=str(tmp_path / "t"))
    _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))


# ---- the trainers and the recipes ------------------------------------------------------

# The JAX package's recipe summaries as it vendored them: the trainer's keys
# plus the recipe's ('chance_accuracy' for classification, 'model').
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "RESULTS_family_convergence.json")) as _f:
    JAX_RESULTS = json.load(_f)
RECIPE_KEYS = {"chance_accuracy", "model"}


def test_classification_trainer_main_runs_on_cpu(modelnet_roots, tmp_path):
    """Two CPU steps of ``cls_ssg`` through ``main --device cpu`` with two
    votes: the summary has the JAX trainer's keys, the logs are written and
    the best checkpoint kept (``cls_msg`` with normals trains through the
    recipe in ``test_torch_no_jax.py``)."""
    root = modelnet_roots[1]
    log_dir = str(tmp_path / "cls_ssg")
    got = tcls_trainer.main(["--device", "cpu", "--data_root", root, "--model", "cls_ssg",
                             "--num_point", "128", "--batch_size", "4", "--max_epoch", "1",
                             "--log_dir", log_dir, "--max_steps", "2", "--num_votes", "2"])
    assert set(got) == set(JAX_RESULTS["cls_ssg"]) - RECIPE_KEYS and got["steps"] == 2
    assert 0.0 <= got["best_accuracy"] <= 1.0 and got["last_ortho_loss"] == 0.0
    assert os.path.exists(os.path.join(log_dir, "cls_metrics.jsonl"))
    assert any(f.startswith("best_") and f.endswith(".npz")
               for f in os.listdir(os.path.join(log_dir, "checkpoints")))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tcls_trainer.train_classification(root, n_devices=2, device="cpu")


def test_part_segmentation_trainer_main_runs_on_cpu(shapenet_roots, tmp_path):
    """Two CPU steps of ``part_seg_msg_one_hot`` (the category path)
    through ``main --device cpu`` (``part_seg`` trains through the recipe
    test below)."""
    root = shapenet_roots[1]
    log_dir = str(tmp_path / "one_hot")
    got = tps_trainer.main(["--device", "cpu", "--data_root", root, "--model",
                            "part_seg_msg_one_hot", "--num_point", "128", "--batch_size", "2",
                            "--max_epoch", "1", "--log_dir", log_dir, "--max_steps", "2"])
    assert set(got) == set(JAX_RESULTS["part_seg_msg_one_hot"]) - RECIPE_KEYS
    assert got["steps"] == 2 and 0.0 <= got["best_class_avg_iou"] <= 1.0
    assert os.path.exists(os.path.join(log_dir, "part_seg_metrics.jsonl"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tps_trainer.train_part_segmentation(root, n_devices=4, device="cpu")


@pytest.mark.parametrize("fn", ["run_cls_convergence", "run_partseg_convergence",
                                "run_s3dis_convergence", "run_attention_net_convergence",
                                "run_v1_scannet_convergence", "run_extended"])
def test_recipe_defaults_match_jax(fn):
    want = inspect.signature(getattr(jrecipe, fn)).parameters
    got = inspect.signature(getattr(trecipe, fn)).parameters
    assert list(got) == list(want) + ["device"]
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert got["device"].default == "cuda"


def test_recipes_run_and_unported_arms_raise(tmp_path, monkeypatch):
    summary = trecipe.run_partseg_convergence(str(tmp_path), "part_seg", n_shapes_per_cat=3,
                                              n_points=128, batch_size=2, epochs=1,
                                              device="cpu")
    assert set(summary) == set(JAX_RESULTS["part_seg"])
    assert summary["model"] == "part_seg" and summary["steps"] == 2
    # the corpus is cached behind its sentinel
    data = [d for d in os.listdir(tmp_path) if d.startswith("shapenet_synth")]
    assert len(data) == 1 and os.path.exists(tmp_path / data[0] / "DONE")
    # The v1 ScanNet arm: the recipe, then main's arm, each two steps of the
    # whole-scene dataset at the tiny hierarchy (its get_model patched).
    tiny_v1 = dict(dataset_kind="whole", n_train_scenes=2, n_val_scenes=1, scene_points=3000,
                   npoints=256, batch_size=2, epochs=1, max_steps=2)
    with monkeypatch.context() as mp:
        mp.setattr(tv1_trainer.models, "get_model", functools.partial(
            tv1_trainer.models.get_model, **TINY_SEM_SEG))
        mp.setattr(tv1_trainer, "MetricLogger", functools.partial(
            tv1_trainer.MetricLogger, tensorboard=False))
        summary = trecipe.run_v1_scannet_convergence(str(tmp_path), device="cpu", **tiny_v1)
        assert set(summary) == set(JAX_RESULTS["v1_scannet_whole"])
        assert summary["steps"] == 2 and summary["dataset_kind"] == "whole"
        assert 0.0 <= summary["eval_calibrated_vox_accuracy"] <= 1.0
        mp.setitem(trecipe.ARMS, "v1_scannet_whole",
                   (trecipe.run_v1_scannet_convergence, tiny_v1))
        out = trecipe.main(["--workdir", str(tmp_path), "--device", "cpu", "--arms",
                            "v1_scannet_whole", "--skip_attention"])
        assert set(out) == {"v1_scannet_whole"}
        assert set(out["v1_scannet_whole"]) == set(JAX_RESULTS["v1_scannet_whole"])
    # The PointNet v1 arm runs: one epoch of the recipe's ModelNet (5 steps
    # of B8 x 256) with its T-Net orthogonality loss live.
    out = trecipe.main(["--workdir", str(tmp_path), "--device", "cpu", "--arms",
                        "pointnet1_cls", "--epochs", "1", "--skip_attention"])
    assert set(out) == {"pointnet1_cls"}
    assert set(out["pointnet1_cls"]) == set(JAX_RESULTS["pointnet1_cls"])
    assert out["pointnet1_cls"]["steps"] == 5 and out["pointnet1_cls"]["last_ortho_loss"] > 0
