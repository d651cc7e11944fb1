"""Parity of the port's PointNet v1 training with the JAX package on the
CPU: ``cls_train_step`` with the T-Net orthogonality loss, the v1 joint
part-segmentation step, the S3DIS trainer's block dataset and room
inference, and the three trainers' summaries.

Each step starts both frameworks from the same state (the JAX state bridged
into the port) and is held by ``test_torch_train._check_step``: loss rtol
1e-5, BN statistics within ``STATS_TOL``, gradients per tensor in relative L2 within
``GRAD_REL`` (the exactly-zero gradients, found by a float64 run, below
1e-5 of the largest on both sides), new parameters within Adam's step.  Dropout is off on both
sides.  Batches are B8: the FC stacks' BNs normalise over the batch axis,
and at B2 they magnify float32 rounding (``test_torch_pointnet1.py``).
"""
import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train as ttrain
from pointcloud_segmentation_attention_tpu.data import s3dis as js3dis
from pointcloud_segmentation_attention_tpu.data.shapenet_part import (
    write_synthetic_shapenet_part_h5,
)
from pointcloud_segmentation_attention_tpu.train import cls_steps as jcls_steps
from pointcloud_segmentation_attention_tpu.train import s3dis_trainer as js3dis_trainer
from pointcloud_segmentation_attention_tpu.train import schedules as jsched
from pointcloud_segmentation_attention_tpu.train import v1_partseg_trainer as jv1
from pointcloud_segmentation_attention_tpu.train.train_state import create_state
from pointcloud_segmentation_attention_tpu_torch.data import s3dis as ts3dis
from pointcloud_segmentation_attention_tpu_torch.data.shapenet_part import (
    write_synthetic_shapenet_part,
)
from pointcloud_segmentation_attention_tpu_torch.recipes import family_convergence as trecipe
from pointcloud_segmentation_attention_tpu_torch.train import (
    TrainState,
    cls_train_step,
    load_jax_state,
)
from pointcloud_segmentation_attention_tpu_torch.train import s3dis_trainer as ts3dis_trainer
from pointcloud_segmentation_attention_tpu_torch.train import schedules as tsched
from pointcloud_segmentation_attention_tpu_torch.train import v1_partseg_trainer as tv1
from pointcloud_segmentation_attention_tpu_torch.train.partseg_trainer import (
    train_part_segmentation,
)
from test_torch_model import _unflatten
from test_torch_pointnet1 import NO_DROPOUT, _inputs, bridged_v1, no_jax_dropout  # noqa: F401

# Per-tensor relative L2 of the gradients.  Through the max pools and
# ReLUs a float32 forward's rounding routes some gradient differently (a
# ReLU input or a max-pool choice within rounding of its switch).  For
# ``pointnet1_cls`` the frameworks are 8.4e-5 apart, each 1.6e-3 from a
# float64 run of the port.  The joint model max-pools 2048 channels over
# 128 points and feeds all five conv outputs to its seg head: there JAX's
# float32 gradients lie up to 1.4e-2 and the port's up to 1.4e-2 from the
# float64 run, and 9.6e-3 from each other (``conv5/bn/bias``), as the
# flagship's full-width step does (``test_torch_train.py``, 3e-2).
GRAD_REL = {"pointnet1_cls": 1e-3, "pointnet1_part_seg": 3e-2}
# BN statistics: the FC stacks' BNs (``fc*``, ``tfc*``) take them over the
# 8 clouds of the batch alone, of max-pooled 1024-wide features, and the
# joint seg head's first BN over 4,979-term products: their running
# variances move up to 4.4e-5 apart between the frameworks, so the v1 steps
# hold BN statistics at ``test_torch_pointnet1.py``'s STATS_TOL.
STATS_TOL = dict(rtol=1e-4, atol=1e-4)
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "RESULTS_family_convergence.json")) as _f:
    JAX_RESULTS = json.load(_f)


def _jax_state(name, jm, flat, tx):
    """A JAX train state of registry model ``name`` at ``flat``'s
    variables, with optimizer ``tx``."""
    params = _unflatten({k[7:]: v for k, v in flat.items() if k.startswith("params/")})
    stats = _unflatten({k[12:]: v for k, v in flat.items() if k.startswith("batch_stats/")})
    state = create_state(jm, tx, jax.random.PRNGKey(0),
                         *(jnp.asarray(a) for a in _inputs(name, 2, 32, seed=0)), train=False)
    return state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))


def _captured(lr):
    """Adam at ``lr`` behind the gradient capture."""
    return optax.chain(ttrain._capture(), optax.adam(lr))


def exact_zeros(tstate, batch, step, below=1e-9):
    """Names of the parameters whose gradient is exactly 0: below ``below``
    times the largest gradient in a float64 run of ``step`` from ``tstate``.
    Besides the biases of convolutions feeding a train-mode BN, these are
    the BN biases before a max pool that a train-mode BN follows (a shift
    of a channel alike for every cloud), and at ``seg_weight`` 1.0 the
    joint model's classification head."""
    model = copy.deepcopy(tstate.model).double()
    state = TrainState(model, tstate.lr_schedule, tstate.step)
    step(state, {k: torch.from_numpy(v).double() if v.dtype == np.float32
                 else torch.from_numpy(v) for k, v in batch.items()})
    grads = {n: p.grad.abs().max().item() for n, p in model.named_parameters()}
    return {n for n, g in grads.items() if g < below * max(grads.values())}


def _hold_step(name, jstate, jm_metrics, before, tstate, tm_metrics, lr, zeros):
    """``_check_step`` of the port's step against the JAX step, with
    ``zeros`` held as its noise biases are (below 1e-5 of the largest
    gradient on both sides) and BN statistics within ``STATS_TOL``."""
    after = ttrain._jax_flat(jstate, jstate.opt_state[1])
    stats = {k: STATS_TOL for k in after if k.startswith("batch_stats/")}
    ttrain._check_step(before, after, jm_metrics, jstate.opt_state[0], tstate, tm_metrics, lr,
                       GRAD_REL[name], noise=zeros, stats_tol=stats)
    np.testing.assert_allclose(float(tm_metrics["ortho_loss"]),
                               float(jm_metrics["ortho_loss"]), rtol=1e-4)
    assert float(tm_metrics["ortho_loss"]) > 0


def test_cls_train_step_with_orthogonality_matches_jax(no_jax_dropout):  # noqa: F811
    jm, flat, tm = bridged_v1("pointnet1_cls", **NO_DROPOUT["pointnet1_cls"])
    lr = lambda step: jsched.upstream_learning_rate(step, 1e-3, 8)  # noqa: E731
    jstate = _jax_state("pointnet1_cls", jm, flat, _captured(lr))
    tstate = TrainState(tm, lambda step: tsched.upstream_learning_rate(step, 1e-3, 8))
    before = ttrain._jax_flat(jstate, jstate.opt_state[1])
    load_jax_state(before, tstate)
    pts = _inputs("pointnet1_cls", 8, 128, seed=11)[0]
    batch = {"points": pts, "labels": np.arange(8, dtype=np.int32) * 5 % 40}
    bn = lambda step: jsched.upstream_bn_momentum(step, 8)  # noqa: E731
    jstate, jm_metrics = jax.jit(lambda s, b: jcls_steps.cls_train_step(
        s, b, jax.random.PRNGKey(1), bn_schedule=bn, reg_weight=0.001))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = functools.partial(cls_train_step, reg_weight=0.001,
                             bn_schedule=lambda step: tsched.upstream_bn_momentum(step, 8))
    zeros = exact_zeros(tstate, batch, step)
    assert {"conv5.bn.bias", "transform_net2.tconv3.bn.bias", "fc2.bias"} <= zeros
    tstate, tm_metrics = step(tstate, batch)
    _hold_step("pointnet1_cls", jstate, jm_metrics, before, tstate, tm_metrics, lr(0), zeros)
    assert float(tm_metrics["accuracy"]) == pytest.approx(float(jm_metrics["accuracy"]))


def test_joint_train_step_matches_jax(no_jax_dropout):  # noqa: F811
    """The joint step at seg_weight 1.0 (the trainer's): the classification
    head's gradients are exactly 0 on both sides."""
    jm, flat, tm = bridged_v1("pointnet1_part_seg", **NO_DROPOUT["pointnet1_part_seg"])
    lr = lambda step: jsched.upstream_learning_rate(  # noqa: E731
        step, 1e-3, 8, jv1.V1_PARTSEG_DECAY_STEP, decay_rate=0.5)
    bn = lambda step: jsched.upstream_bn_momentum(step, 8, 2.0 * jv1.V1_PARTSEG_DECAY_STEP)  # noqa: E731
    jstate = _jax_state("pointnet1_part_seg", jm, flat, _captured(lr))
    tstate = TrainState(tm, lambda step: tsched.upstream_learning_rate(
        step, 1e-3, 8, tv1.V1_PARTSEG_DECAY_STEP, decay_rate=0.5))
    before = ttrain._jax_flat(jstate, jstate.opt_state[1])
    load_jax_state(before, tstate)
    rng = np.random.RandomState(12)
    batch = {"points": rng.rand(8, 128, 3).astype(np.float32),
             "cls": rng.randint(0, 16, 8).astype(np.int32),
             "labels": rng.randint(0, 50, (8, 128)).astype(np.int32)}
    jstate, jm_metrics = jax.jit(lambda s, b: jv1.joint_train_step(
        s, b, jax.random.PRNGKey(1), bn_schedule=bn))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = functools.partial(tv1.joint_train_step, bn_schedule=lambda step: (
        tsched.upstream_bn_momentum(step, 8, 2.0 * tv1.V1_PARTSEG_DECAY_STEP)))
    zeros = exact_zeros(tstate, batch, step)
    assert {n for n, _ in tm.named_parameters() if n.startswith("cla_")} <= zeros
    tstate, tm_metrics = step(tstate, batch)
    _hold_step("pointnet1_part_seg", jstate, jm_metrics, before, tstate, tm_metrics, lr(0),
               zeros)
    assert float(tstate.model.cla_fc3.kernel.grad.abs().max()) == 0.0
    for k in ("label_accuracy", "seg_accuracy"):
        assert float(tm_metrics[k]) == pytest.approx(float(jm_metrics[k]))
    got = tv1.joint_eval_step(tstate, batch)
    assert set(got) == {"label_accuracy", "seg_accuracy"} and tstate.model.training


# ---- the trainers -----------------------------------------------------------------

def test_v1_partseg_trainer_summary_matches_jax(tmp_path):
    """Two steps of the JAX and the port's v1 joint trainers on the same h5
    shards: the same summary keys and step count, a live orthogonality
    loss, the best checkpoint kept."""
    train_list, val_list = write_synthetic_shapenet_part_h5(str(tmp_path / "h5"), n_points=64)
    kw = dict(npoints=64, batch_size=4, epochs=1, max_steps=2)
    want = jv1.train_v1_part_segmentation(train_list, val_list, log_dir=str(tmp_path / "jax"),
                                          n_devices=1, **kw)
    got = tv1.train_v1_part_segmentation(train_list, val_list, log_dir=str(tmp_path / "port"),
                                         device="cpu", **kw)
    assert set(got) == set(want) == {"last_ortho_loss", "best_seg_accuracy", "steps"}
    assert got["steps"] == want["steps"] == 2 and got["last_ortho_loss"] > 0
    assert 0.0 <= got["best_seg_accuracy"] <= 1.0
    assert os.path.exists(tmp_path / "port" / "v1_part_seg_metrics.jsonl")
    assert any(f.startswith("best_") for f in os.listdir(tmp_path / "port" / "checkpoints"))
    with pytest.raises(ValueError, match="does not divide"):
        tv1.train_v1_part_segmentation(train_list, val_list, n_devices=3, batch_size=4,
                                       device="cpu")


def test_partseg_trainer_feeds_pointnet1_seg_xyz_with_orthogonality(tmp_path):
    root = str(tmp_path / "shapenet")
    write_synthetic_shapenet_part(root, n_shapes_per_cat=3, n_points=64, seed=1)
    got = train_part_segmentation(root, "pointnet1_seg", npoints=64, batch_size=2, epochs=1,
                                  log_dir=str(tmp_path / "log"), max_steps=2, device="cpu")
    assert set(got) == set(JAX_RESULTS["pointnet1_seg"]) - {"model"}
    assert got["steps"] == 2 and got["last_ortho_loss"] > 0


def test_s3dis_blocks_and_room_inference_match_jax(no_jax_dropout):  # noqa: F811
    """``rooms_to_block_dataset`` bit for bit; ``predict_room`` and
    ``evaluate_rooms`` from the same weights: logits within rtol 1e-4 /
    atol 1e-5, equal predictions, mIoU and accuracy."""
    rooms = [ts3dis.make_synthetic_room(2500, seed=s) for s in (4, 5)]
    got = ts3dis_trainer.rooms_to_block_dataset(rooms, 128, seed=3)
    want = js3dis_trainer.rooms_to_block_dataset(rooms, 128, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jm, flat, tm = bridged_v1("pointnet1_sem_seg")
    jstate = _jax_state("pointnet1_sem_seg", jm, flat, optax.adam(1e-3))
    tstate = TrainState(tm)
    g_logits, g_labels = ts3dis_trainer.predict_room(tstate, rooms[0], 128, 4)
    w_logits, w_labels = js3dis_trainer.predict_room(jstate, rooms[0], 128, 4)
    np.testing.assert_array_equal(g_labels, w_labels)
    np.testing.assert_allclose(g_logits, w_logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(g_logits.argmax(-1), w_logits.argmax(-1))
    g_eval = ts3dis_trainer.evaluate_rooms(tstate, rooms, 128, 4)
    w_eval = js3dis_trainer.evaluate_rooms(jstate, rooms, 128, 4)
    assert g_eval[0] == pytest.approx(w_eval[0], rel=1e-9) and g_eval[1] == w_eval[1]
    assert js3dis.NUM_CLASSES == ts3dis_trainer.NUM_CLASSES


def test_s3dis_recipe_runs_with_jax_summary_keys(tmp_path):
    got = trecipe.run_s3dis_convergence(str(tmp_path), n_train_rooms=2, n_test_rooms=1,
                                        room_points=2500, num_point=128, batch_size=4,
                                        epochs=1, device="cpu")
    assert set(got) == set(JAX_RESULTS["pointnet1_sem_seg"])
    assert got["model"] == "pointnet1_sem_seg" and got["steps"] > 0
    assert 0.0 <= got["best_miou"] <= 1.0
    assert os.path.exists(tmp_path / "s3dis" / "s3dis_metrics.jsonl")
    with pytest.raises(ValueError, match="does not divide"):
        trecipe.run_s3dis_convergence(str(tmp_path / "dp"), n_devices=5, batch_size=4,
                                      device="cpu")
