"""Training parity of the port's full attention networks with the JAX
package on the CPU: one ``seg_train_step`` of ``attention_net`` at the
registry's widths, and ``run_attention_net_convergence`` through
``train(config)`` with the on-device sampler.

The step starts both frameworks from the same state (JAX's ``model.init``
parameters with seeded BN statistics, bridged into the port) on
the same B2 x 1024 batch of chunks with colors and normals, dropout off on
both sides, and is held by ``test_torch_train._check_step``: loss rtol
1e-5, BN statistics 1e-5, gradients per tensor in relative L2 within
``GRAD_REL`` (the exactly-zero ones below ``NOISE_REL`` of the largest
on both sides), new parameters within Adam's step.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import linen as fnn

import test_torch_train as ttrain
from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.models import attention_nets as jattnets
from pointcloud_segmentation_attention_tpu.train import schedules as jsched
from pointcloud_segmentation_attention_tpu.train import steps as jsteps
from pointcloud_segmentation_attention_tpu.train.checkpoints import _flatten
from pointcloud_segmentation_attention_tpu.train.train_state import create_state
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.recipes import family_convergence as trecipe
from pointcloud_segmentation_attention_tpu_torch.train import (
    TrainState,
    load_jax_state,
    load_jax_variables,
    seg_train_step,
)
from test_torch_model import _flat_variables, _unflatten
from test_torch_pointnet1_train import exact_zeros
from test_torch_train import scene  # noqa: F401

# Per-tensor relative L2 of the gradients.  The frameworks are up to 6.4e-3
# apart (``l2/inner0/feed_forward/layer_3/bias``), while JAX's float32
# gradients lie up to 8.6e-3 and the port's up to 5.3e-3 from a float64
# run of the port: the flagship's full-width bound (``test_torch_train.py``).
GRAD_REL = 3e-2
# Exactly-zero gradients, from the float64 run: a shift alike for every
# point that a train-mode BN removes (the FP convolutions' biases, l4's
# value and last feed-forward biases), or the attention pool's key bias,
# which the softmax over the group cancels; and l2-l4's query and key
# projections, whose features are 1e-4..1e-8 at these weights.  The float64
# run leaves them up to 1.4e-7 of the largest gradient (its own rounding,
# magnified by the BNs), so the cut is 1e-6.  In float32 the same
# magnification leaves them up to 1.2e-5 of the largest gradient (0.27 of
# 22,037: ``head/fp1/mlp/conv0/bias``), held below NOISE_REL.
ZERO_BELOW = 1e-6
NOISE_REL = 1e-4
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "RESULTS_family_convergence.json")) as _f:
    JAX_RESULTS = json.load(_f)


class _NoDropout(fnn.Module):
    rate: float = 0.5

    @fnn.compact
    def __call__(self, x, *, deterministic: bool):
        return x


def test_attention_net_train_step_matches_jax(scene, monkeypatch):  # noqa: F811
    monkeypatch.setattr(jattnets, "Dropout", _NoDropout)
    batch = ttrain._batch(scene, 2, 1024, seed=33)
    jm = jmodels.get_model("attention_net", num_classes=21)
    tx = optax.chain(ttrain._capture(), optax.adam(jsched.scannet_learning_rate))
    state = create_state(jm, tx, jax.random.PRNGKey(0), jnp.asarray(batch["points"][:1]),
                         jnp.asarray(batch["features"][:1]), train=False)
    # JAX's init parameters (zero biases, identity BN affines) with seeded BN
    # running statistics.  At random weights each attention level shrinks
    # its features ~100x (0.04, 4e-4, 3e-6, 4e-8 at l1-l4), and the FP
    # head's train-mode BNs scale them back up: seeded biases put a constant
    # under those small signals whose float32 rounding the BNs then magnify
    # (the port's own float32 logits 2e-2 from its float64 run, 7e-6 with
    # the init's zero biases).
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, 1)
    flat.update({f"params/{k}": np.asarray(v) for k, v in _flatten(state.params).items()})
    params = _unflatten({k[7:]: v for k, v in flat.items() if k.startswith("params/")})
    stats = _unflatten({k[12:]: v for k, v in flat.items() if k.startswith("batch_stats/")})
    jstate = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    tm = tmodels.get_model("attention_net", device="cpu", in_features=6, dropout_rate=0.0)
    load_jax_variables(flat, tm)
    tstate = TrainState(tm)
    before = ttrain._jax_flat(jstate, jstate.opt_state[1])
    load_jax_state(before, tstate)

    jstate, jm_metrics = jax.jit(jsteps.seg_train_step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    noise = exact_zeros(tstate, batch, seg_train_step, below=ZERO_BELOW)
    assert ttrain._noise_biases(tm) <= noise and "l1.attention_pool.key_net.bias" in noise
    tstate, tm_metrics = seg_train_step(tstate, batch)
    ttrain._check_step(before, ttrain._jax_flat(jstate, jstate.opt_state[1]), jm_metrics,
                       jstate.opt_state[0], tstate, tm_metrics,
                       float(jsched.scannet_learning_rate(0)), GRAD_REL, noise=noise,
                       noise_rel=NOISE_REL)
    np.testing.assert_array_equal(tm_metrics["confusion"].numpy(),
                                  np.asarray(jm_metrics["confusion"]))


def test_attention_net_recipe_runs_with_jax_summary_keys(tmp_path):
    """Three sampler steps of ``attention_net`` at full width on small
    rooms, with a validation: the summary has the keys of the JAX
    package's vendored ``attention_net`` result."""
    got = trecipe.run_attention_net_convergence(
        str(tmp_path), n_train_scenes=2, n_val_scenes=1, scene_points=3000, n_points=1024,
        batch_size=2, max_steps=3, device="cpu")
    assert set(got) == set(JAX_RESULTS["attention_net"])
    assert got["final_step"] == 3 and got["model"] == "attention_net"
    assert np.isfinite(got["final_train_loss"]) and 0.0 <= got["best_val_miou"] <= 1.0
    with pytest.raises(ValueError, match="does not divide"):
        trecipe.run_attention_net_convergence(str(tmp_path / "dp"), n_devices=3, device="cpu")
