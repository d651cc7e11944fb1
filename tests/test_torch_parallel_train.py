"""``train(config)`` at ``n_devices=2`` on the CPU against ``n_devices=1``:
every input path (npz, packed, resident, sampler), rank 0's checkpoint read
by the JAX package, and a family trainer.

The ranks are the two gloo processes of
``test_torch_parallel_ranks.shared_pool``, each calling the trainer inside
the process group; TensorBoard is off in both worlds (``PSA_TENSORBOARD=0``).
``train``'s own spawner (called from a plain process) runs in
``tests/test_torch_trainer.py``.
Tiny hierarchy, dropout on, B2 x 128, one epoch of two steps and a
validation.

Tolerances, and why: the logged ``train_loss`` of each epoch rtol 1e-5 and
``val_miou`` atol 1e-3, as ``tests/test_torch_trainer.py`` holds the port
to JAX (eval-mode BN reads running means that carry the noise biases'
updates); the final parameters: the biases whose exact gradient is 0 within
twice Adam's largest summed step, 2 x steps x ADAM_MAX_STEP x lr, the
others rtol 1e-4 / atol 1e-5 (two steps of float32 rounding differences),
and BN running variances rtol 1e-4.
"""
import dataclasses
import os

import numpy as np
import pytest

from pointcloud_segmentation_attention_tpu.train import trainer as jtrainer
from pointcloud_segmentation_attention_tpu.train.checkpoints import (
    latest_checkpoint as jlatest_checkpoint,
)
from pointcloud_segmentation_attention_tpu.train.checkpoints import (
    restore_checkpoint as jrestore_checkpoint,
)
from pointcloud_segmentation_attention_tpu.utils.config import TrainConfig as JConfig
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.data.modelnet import write_synthetic_modelnet
from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.nn import PointConv
from pointcloud_segmentation_attention_tpu_torch.train import (
    cls_trainer,
    latest_checkpoint,
    schedules,
)
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics
from test_torch_parallel_ranks import one_thread, shared_pool  # noqa: F401 (an autouse fixture)

TINY = {"sa_npoints": [16, 8, 4, 2], "sa_radii": [0.2, 0.4, 0.8, 1.2], "sa_nsample": 4,
        "sa_mlps": [[8, 8], [8, 8], [8, 8], [8, 8]], "fp_mlps": [[8], [8], [8], [8, 8]]}
ADAM_MAX_STEP = 0.1 / np.sqrt(0.001)  # |Adam update| <= lr * (1 - b1) / sqrt(1 - b2)
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def pool(request):
    return shared_pool(request.config)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setenv("PSA_TENSORBOARD", "0")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_trainer")
    root = str(d / "scannet")
    splits = tscenes.write_synthetic_dataset(root, n_train=4, n_val=1, n_points=3000)
    pre = str(d / "chunks")
    precompute.precompute_train_chunks(root, splits["train"], pre, epochs=2, npoints=128)
    precompute.precompute_val_chunks(root, splits["val"], pre, npoints=128)
    base = dict(data_root=root, precompute_dir=pre, model="sem_seg_features",
                model_overrides=TINY, batch_size=2, n_points=128, epochs=1, n_epochs_to_val=1,
                save_every_epochs=1)
    return d, base


def _flat(cfg) -> dict:
    with np.load(latest_checkpoint(cfg.ckpt_dir)) as z:
        return {k: z[k] for k in z.files}


def _noise_keys() -> set:
    model = tmodels.get_model("sem_seg_features", device="cpu", in_features=6,
                              **{k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
                                 if isinstance(v, list) else v for k, v in TINY.items()})
    return {"params/" + name.replace(".", "/") + "/bias" for name, mod in model.named_modules()
            if isinstance(mod, PointConv) and mod.bn is not None}


def _hold_runs(one: TrainConfig, two: TrainConfig, s1: dict, s2: dict) -> None:
    assert s1["final_step"] == s2["final_step"] == STEPS
    np.testing.assert_allclose(s2["final_train_loss"], s1["final_train_loss"], rtol=1e-5)
    logs = [read_metrics(os.path.join(c.log_dir, "train_metrics.jsonl")) for c in (one, two)]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]  # one writer
    for a, b in zip(*logs):
        if "train_loss" in a:
            np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=1e-5)
        if "val_miou" in a:
            assert abs(b["val_miou"] - a["val_miou"]) <= 1e-3
    want, got = _flat(one), _flat(two)
    assert sorted(os.listdir(one.ckpt_dir)) == sorted(os.listdir(two.ckpt_dir))
    noise = _noise_keys()
    tol = 2 * STEPS * ADAM_MAX_STEP * schedules.scannet_learning_rate(0, 2, 4)
    for k in want:
        if k in noise or k.endswith("/mean"):  # the noise biases pass into the running means
            assert np.abs(got[k] - want[k]).max() <= tol, k
        elif k.startswith("params/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        elif k.endswith("/var"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("over", [dict(input="npz"), dict(input="packed"),
                                  dict(input="resident", resident_augment=True),
                                  dict(input="sampler", resident_augment=True)],
                         ids=["npz", "packed", "resident", "sampler"])
def test_world2_train_matches_world1(pool, dataset, over):
    d, base = dataset
    tag = over["input"]
    one = TrainConfig(**{**base, **over, "log_dir": str(d / f"{tag}_1")})
    two = dataclasses.replace(one, log_dir=str(d / f"{tag}_2"), n_devices=2)
    s1 = ttrainer.train(one, device="cpu")
    s2 = pool.run(ttrainer.train, two, device="cpu")
    assert s2[0]["final_train_loss"] == s2[1]["final_train_loss"]  # global metrics
    _hold_runs(one, two, s1, s2[0])


def test_rank0_checkpoint_restores_in_jax_and_worlds_refuse(pool, dataset):
    """Rank 0's checkpoint of a world-2 run restores into the JAX package's
    state; a batch that does not divide over the ranks raises in every rank
    (and before any rank starts: ``tests/test_torch_trainer.py``)."""
    d, base = dataset
    cfg = TrainConfig(**{**base, "input": "resident", "log_dir": str(d / "resident_2")})
    if latest_checkpoint(cfg.ckpt_dir) is None:  # the parametrized run was deselected
        pool.run(ttrainer.train, dataclasses.replace(cfg, n_devices=2), device="cpu")
    jcfg = JConfig(**{**base, "log_dir": cfg.log_dir, "n_devices": 1})
    jstate = jrestore_checkpoint(jlatest_checkpoint(cfg.ckpt_dir),
                                 jtrainer.make_eval_state(jcfg))
    assert int(jstate.step) == STEPS
    with pytest.raises(RuntimeError, match="does not divide"):
        pool.run(ttrainer.train, dataclasses.replace(cfg, batch_size=3, n_devices=2),
                 device="cpu")


def test_family_trainer_world2_matches_world1(pool, tmp_path):
    """``train_classification`` (``cls_ssg``, dropout on) for one step and
    its evaluation: the loss of the global batch within rtol 1e-5, rank 0
    alone writing the log and the best checkpoint, whose parameters lie
    within twice Adam's largest step of world size 1's.  (One step: the
    group-all SA's last BN bias has an exact gradient of 0 and Adam turns
    its rounding noise into steps of ``lr``, which move a second step's
    loss, and an untrained net's few test predictions, in either world.)"""
    root = str(tmp_path / "modelnet")
    write_synthetic_modelnet(root, num_classes=4, shapes_per_class=3, n_points=256, seed=1)
    kw = dict(data_root=root, model_name="cls_ssg", num_classes=4, npoints=128, batch_size=4,
              epochs=1, max_steps=1, device="cpu")
    s1 = cls_trainer.train_classification(**kw, log_dir=str(tmp_path / "one"))
    s2 = pool.run(cls_trainer.train_classification, **kw, log_dir=str(tmp_path / "two"),
                  n_devices=2)
    assert s1["steps"] == s2[0]["steps"] == 1
    logs = [read_metrics(str(tmp_path / t / "cls_metrics.jsonl")) for t in ("one", "two")]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]
    np.testing.assert_allclose(logs[1][0]["train_loss"], logs[0][0]["train_loss"], rtol=1e-5)
    ckpts = [os.path.join(tmp_path, t, "checkpoints") for t in ("one", "two")]
    assert sorted(os.listdir(ckpts[0])) == sorted(os.listdir(ckpts[1]))
    want, got = (np.load(latest_checkpoint(c, prefix="best")) for c in ckpts)
    tol = 2 * ADAM_MAX_STEP * 1e-3
    for k in want.files:
        if k.startswith("params/"):
            assert np.abs(got[k] - want[k]).max() <= tol, k
