"""Parity of the port's classification and part-segmentation train steps
with the JAX package's on the CPU.

One ``cls_train_step`` (``cls_ssg`` xyz only, ``cls_msg`` with normals)
and one ``partseg_train_step`` (``part_seg``, ``part_seg_msg_one_hot``)
from the same weights (JAX variables with seeded BN statistics, carried by
the checkpoint bridge) and the same batch, dropout off on both sides, at
the upstream schedules.  The JAX step runs jitted with an optax stage in
front of Adam that keeps its gradients (``test_torch_train._capture``).

Tolerances, and why: the train-mode forward differs by float32 summation
order amplified through up to 12 batch-statistics BNs
(``test_torch_family_models.TRAIN_TOL``), so the loss is held to that
tolerance too (measured 5.7e-4 apart for ``cls_ssg``, 1e-6 for the part
segmenters), the gradients per tensor in relative L2 (``GRAD_REL``; a ReLU and
max-pool network's gradient is discontinuous in its forward values), the
new BN statistics to rtol 1e-3 / atol 1e-4 (measured 1.8e-4 apart on 0.9 in
the classifier head, whose BNs normalise over the batch of 2), and the new parameters within
twice Adam's largest step of JAX's everywhere and to rtol 1e-5 / atol 1e-6
wherever the two gradients agree to 1 % (there Adam's update is
determined).  Biases feeding a train-mode BN have an exact gradient of 0
and are held below ``NOISE`` of the model's largest gradient on both sides
(measured up to 1.5e-5: a sum over B x npoint x nsample terms rounds to
that); so is any tensor whose gradient lies below that on both sides, which
here are
the BN biases of the last layer of ``sa3`` and of some MSG ``sa2``
branches (measured ~1e-9 of the largest gradient): they shift a channel
uniformly over every point of every cloud after the max-pool, and the next
train-mode BN removes such a shift.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pointcloud_segmentation_attention_tpu.train import cls_steps as jsteps
from pointcloud_segmentation_attention_tpu.train import schedules as jsched
from pointcloud_segmentation_attention_tpu.train.checkpoints import _flatten
from pointcloud_segmentation_attention_tpu.train.train_state import TrainState as JState
from pointcloud_segmentation_attention_tpu_torch.train import (
    TrainState,
    cls_eval_step,
    cls_train_step,
    export_jax_state,
    load_jax_state,
    partseg_eval_step,
    partseg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train import schedules as tsched
from test_torch_family_models import (  # noqa: F401
    TRAIN_TOL,
    _unflatten,
    bridged_family_model,
    no_jax_dropout,
)
from test_torch_train import ADAM_MAX_STEP, _capture, _jax_flat, _noise_biases

# Per-tensor relative L2 of the gradients, port against JAX.
GRAD_REL = 3e-2
# Rounding noise of an exactly-zero gradient, relative to the largest gradient.
NOISE = 1e-4


def _pair(name, b, n, seed):
    """(jax state with the gradient capture, port state, JAX batch, port
    batch) of registry model ``name`` from the same weights, dropout off."""
    jm, flat, tm, jargs, targs = bridged_family_model(name, b, n, seed, dropout_rate=0.0)
    tx = optax.chain(_capture(), optax.adam(jsched.upstream_learning_rate))
    variables = _unflatten(flat)
    jstate = JState.create(jm.apply, variables["params"], variables["batch_stats"], tx)
    rng = np.random.RandomState(seed + 5)
    if name.startswith("cls"):
        points = (np.concatenate([a.numpy() for a in targs], -1) if len(targs) == 2
                  else targs[0].numpy())
        batch = {"points": points, "labels": rng.randint(0, 40, b).astype(np.int32)}
    else:
        batch = {"points": targs[0].numpy(),
                 "labels": rng.randint(0, 50, (b, n)).astype(np.int32)}
        if len(targs) == 2:
            batch["cls"] = targs[1].numpy()
    return jstate, TrainState(tm, tsched.upstream_learning_rate), batch


def _check(before, jstate, jm, tstate, tm):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TRAIN_TOL)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), atol=1e-6)
    assert float(tm["ortho_loss"]) == float(jm["ortho_loss"]) == 0.0
    after = _jax_flat(jstate, jstate.opt_state[1])
    got = export_jax_state(tstate)
    model = tstate.model
    noise = _noise_biases(model)
    g_want = {"params/" + k: np.asarray(v) for k, v in _flatten(jstate.opt_state[0]).items()}
    g_max = max(np.abs(v).max() for v in g_want.values())
    lr = tsched.upstream_learning_rate(0)
    for name, p in model.named_parameters():
        key = "params/" + name.replace(".", "/")
        g, g_got = g_want[key], p.grad.numpy()
        small = max(np.abs(g_got).max(), np.abs(g).max()) < NOISE * g_max
        if name in noise or small:
            assert small, key
            firm = np.zeros(g.shape, bool)
        else:
            rel = np.linalg.norm(g_got - g) / np.linalg.norm(g)
            assert rel <= GRAD_REL, (key, rel)
            firm = (np.abs(g_got - g) <= 0.01 * np.abs(g)) & (np.abs(g) >= 1e-6)
        assert np.abs(got[key] - after[key]).max() <= 2 * ADAM_MAX_STEP * lr, key
        np.testing.assert_allclose(got[key][firm], after[key][firm], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        assert np.abs(got[key] - before[key]).max() > 0 or name in noise, key
    for name, _ in model.named_buffers():
        key = "batch_stats/" + name.replace(".", "/")
        np.testing.assert_allclose(got[key], after[key], rtol=1e-3, atol=1e-4, err_msg=key)
    assert int(got["opt_state/0/.count"]) == int(after["opt_state/0/.count"]) == 1


@pytest.mark.parametrize("name", ["cls_ssg", "cls_msg"])
def test_cls_train_step_matches_jax(name, no_jax_dropout):  # noqa: F811
    jstate, tstate, batch = _pair(name, 2, 512, seed=50)
    before = _jax_flat(jstate, jstate.opt_state[1])
    load_jax_state(before, tstate)
    jstate, jm = jax.jit(jsteps.cls_train_step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    tstate, tm = cls_train_step(tstate, batch)
    assert tstate.step == int(jstate.step) == 1
    assert tm["learning_rate"] == pytest.approx(tsched.upstream_learning_rate(0), rel=1e-7)
    _check(before, jstate, jm, tstate, tm)
    ev = cls_eval_step(tstate, batch)
    assert ev["logits"].shape == (2, 40) and tstate.model.training
    assert ev["predictions"].shape == (2,)


@pytest.mark.parametrize("name", ["part_seg", "part_seg_msg_one_hot"])
def test_partseg_train_step_matches_jax(name, no_jax_dropout):  # noqa: F811
    jstate, tstate, batch = _pair(name, 2, 512, seed=60)
    before = _jax_flat(jstate, jstate.opt_state[1])
    load_jax_state(before, tstate)
    jstate, jm = jax.jit(jsteps.partseg_train_step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    tstate, tm = partseg_train_step(tstate, batch)
    assert tstate.step == int(jstate.step) == 1
    _check(before, jstate, jm, tstate, tm)
    got = partseg_eval_step(tstate, batch)
    assert got["logits"].shape == (2, 512, 50) and got["predictions"].shape == (2, 512)
    assert tstate.model.training


def test_reg_weight_is_a_no_op_without_a_transform():
    """No ported model returns a T-Net transform, so ``reg_weight`` changes
    nothing, as in the JAX package for these models."""
    _, a, batch = _pair("cls_ssg", 2, 256, seed=70)
    _, b, _ = _pair("cls_ssg", 2, 256, seed=70)
    _, ma = cls_train_step(a, batch, reg_weight=0.0)
    _, mb = cls_train_step(b, batch, reg_weight=0.001)
    assert float(ma["loss"]) == float(mb["loss"]) and float(mb["ortho_loss"]) == 0.0
