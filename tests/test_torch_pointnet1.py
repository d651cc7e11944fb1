"""Parity of the port's PointNet v1 family and its S3DIS data with the JAX
package on the CPU.

The JAX model's ``model.init`` variables, with seeded non-trivial biases,
BN statistics and T-Net transforms, are carried into the port by
``load_jax_variables``; the same seeded numpy inputs go through both.
Eval outputs and the T-Net ``transform`` within ``TOL`` (rtol 1e-4, atol
1e-5: XLA and PyTorch sum the channel products of the 1024- and 2048-wide
layers in another order); train-mode outputs within ``TRAIN_TOL`` and the
updated BN statistics within ``STATS_TOL``, both stated below.  Train mode
runs with dropout off (the JAX models' ``Dropout`` an identity, the port's
models built with rate 0).  ``data/s3dis.py`` must equal the JAX package's
bit for bit.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.data import s3dis as js3dis
from pointcloud_segmentation_attention_tpu.models import pointnet1 as jpn1
from pointcloud_segmentation_attention_tpu.train.checkpoints import _flatten
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.data import s3dis as ts3dis
from pointcloud_segmentation_attention_tpu_torch.models import pointnet1 as tpn1
from pointcloud_segmentation_attention_tpu_torch.train import (
    export_jax_variables,
    load_jax_variables,
)
from test_torch_model import _flat_variables, _unflatten

TOL = dict(rtol=1e-4, atol=1e-5)
# Train mode: every BN normalises by its batch statistics, and the FC
# stacks' (the heads' and the T-Nets') BNs over the batch axis alone.  At
# B2 such a BN maps each channel to about +-1 and magnifies the float32
# rounding of the two samples' difference: the logits of both frameworks
# lie up to 4.9e-3 (JAX) and 1.7e-3 (port) from a float64 run of the port.
# At B8 both are within 1.9e-4 of it, so the train-mode test runs at B8 and
# holds the logits within TRAIN_TOL (as ``test_torch_family_models.py``).
TRAIN_TOL = dict(rtol=2e-3, atol=2e-3)
STATS_TOL = dict(rtol=1e-4, atol=1e-4)
V1 = ("pointnet1_cls_basic", "pointnet1_cls", "pointnet1_seg", "pointnet1_part_seg",
      "pointnet1_sem_seg")
# Dropout-off port arguments per model (PointNetSeg has no dropout).
NO_DROPOUT = {"pointnet1_cls_basic": dict(dropout_rate=0.0),
              "pointnet1_cls": dict(dropout_rate=0.0),
              "pointnet1_seg": {},
              "pointnet1_part_seg": dict(cls_dropout_rate=0.0, seg_dropout_rate=0.0),
              "pointnet1_sem_seg": dict(dropout_rate=0.0)}


class _NoDropout(fnn.Module):
    rate: float = 0.5

    @fnn.compact
    def __call__(self, x, *, deterministic: bool):
        return x


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jpn1, "Dropout", _NoDropout)


def _inputs(name, b, n, seed):
    """The model's positional inputs: a unit-cube cloud (S3DIS: nine
    channels), and for the joint model the one-hot object class."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(b, n, 9 if name == "pointnet1_sem_seg" else 3).astype(np.float32)
    if name != "pointnet1_part_seg":
        return (pts,)
    return pts, np.eye(16, dtype=np.float32)[rng.randint(0, 16, b)]


@functools.lru_cache(maxsize=None)
def v1_variables(name, seed=0):
    """(JAX model, flat variables with seeded biases, BN statistics and
    T-Net transforms); made once at B2 x 32."""
    jm = jmodels.get_model(name)
    variables = jax.jit(lambda k, *a: jm.init(k, *a, train=False))(
        jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in _inputs(name, 2, 32, seed)))
    flat = _flat_variables(variables, seed + 1)
    rng = np.random.RandomState(seed + 2)
    for k in flat:  # the transforms start at zero: make them non-trivial
        if k.endswith("transform_w") or k.endswith("transform_b"):
            flat[k] = (rng.randn(*flat[k].shape) * 0.01).astype(np.float32)
    return jm, flat


def bridged_v1(name, **port_kwargs):
    jm, flat = v1_variables(name)
    tm = tmodels.get_model(name, device="cpu", **port_kwargs)
    load_jax_variables(flat, tm)
    return jm, flat, tm


def _outputs(out):
    """(tensors to compare, the transform or None) of a model's output."""
    if not isinstance(out, tuple):
        return [out], None
    return list(out[:-1]), out[-1]["transform"]


@pytest.mark.parametrize("name", V1)
def test_v1_eval_forward_matches_jax(name):
    jm, flat, tm = bridged_v1(name)
    args = _inputs(name, 2, 256, seed=3)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        _unflatten(flat), *(jnp.asarray(a) for a in args))
    tm.eval()
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args))
    (g_outs, g_t), (w_outs, w_t) = _outputs(got), _outputs(want)
    for g, w in zip(g_outs, w_outs):
        assert tuple(g.shape) == w.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if name in ("pointnet1_cls_basic", "pointnet1_sem_seg"):
        assert g_t is None and w_t is None
    else:
        k = 128 if name == "pointnet1_part_seg" else 64
        assert g_t.shape == w_t.shape == (2, k, k)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(w_t), **TOL)
        np.testing.assert_allclose(float(tpn1.orthogonality_loss(g_t)),
                                   float(jpn1.orthogonality_loss(w_t)), rtol=1e-4)


@pytest.mark.parametrize("name", ["pointnet1_cls", "pointnet1_part_seg", "pointnet1_sem_seg"])
def test_v1_train_forward_matches_jax(name, no_jax_dropout):
    jm, flat, tm = bridged_v1(name, **NO_DROPOUT[name])
    args = _inputs(name, 8, 128, seed=4)
    want, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, bn_momentum=0.8, mutable=["batch_stats"]))(
        _unflatten(flat), *(jnp.asarray(a) for a in args))
    tm.train()
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args), bn_momentum=0.8)
    for g, w in zip(_outputs(got)[0], _outputs(want)[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRAIN_TOL)
    back = export_jax_variables(tm)
    for k, v in _flatten(mutated["batch_stats"]).items():
        np.testing.assert_allclose(back["batch_stats/" + k], np.asarray(v), err_msg=k,
                                   **STATS_TOL)


def test_orthogonality_loss_matches_jax():
    t = np.random.RandomState(5).randn(3, 64, 64).astype(np.float32) * 0.2 + np.eye(64)
    t = t.astype(np.float32)
    got = float(tpn1.orthogonality_loss(torch.from_numpy(t)))
    want = float(jpn1.orthogonality_loss(jnp.asarray(t)))
    assert got == pytest.approx(want, rel=1e-6)
    eye = torch.eye(8).expand(4, 8, 8)
    assert float(tpn1.orthogonality_loss(eye)) == 0.0


@pytest.mark.parametrize("name", V1)
def test_v1_bridge_round_trip_and_identity_transform(name):
    """The flax names map onto the state dict (export gives the same keys
    and bits back); a freshly built model's T-Nets start at the identity."""
    _, flat, tm = bridged_v1(name)
    back = export_jax_variables(tm)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fresh = tmodels.seeded_model(name, seed=1, device="cpu")
    for mod in fresh.modules():
        if isinstance(mod, tpn1.TransformNet):
            assert mod.transform_w.abs().sum() == 0 and mod.transform_b.abs().sum() == 0
    if name != "pointnet1_cls_basic" and name != "pointnet1_sem_seg":
        assert "params/transform_net2/transform_w" in flat
        assert "batch_stats/transform_net1/tfc2/bn/var" in flat
    with pytest.raises(ValueError, match="in_features"):
        tmodels.get_model(name, device="cpu", in_features=3)


# ---- S3DIS data: the port's copy equals the JAX package's ------------------------

def test_synthetic_room_and_blocks_match_jax():
    for seed in (0, 3):
        room = ts3dis.make_synthetic_room(3000, seed=seed)
        np.testing.assert_array_equal(room, js3dis.make_synthetic_room(3000, seed=seed))
    for kw in (dict(num_point=256), dict(num_point=128, block_size=1.5, stride=0.5,
                                         min_points=40)):
        got = ts3dis.room_to_blocks_normalized(room, rng=np.random.RandomState(7), **kw)
        want = js3dis.room_to_blocks_normalized(room, rng=np.random.RandomState(7), **kw)
        assert got[0].shape[0] > 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    empty = ts3dis.room_to_blocks_normalized(room[:10], 64)
    assert empty[0].shape == (0, 64, 9) and empty[1].shape == (0, 64)


def test_collect_room_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    for name in ("chair_1", "wall_2", "stairs_1", "table_3"):  # 'stairs' counts as clutter
        np.savetxt(os.path.join(tmp_path, f"{name}.txt"),
                   np.concatenate([rng.rand(20, 3) * 4, rng.randint(0, 256, (20, 3))], 1))
    (tmp_path / "notes.md").write_text("skipped")
    got, want = ts3dis.collect_room(str(tmp_path)), js3dis.collect_room(str(tmp_path))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (80, 7) and (got[:, :3].min(axis=0) == 0).all()
    assert ts3dis.CLASSES == js3dis.CLASSES and ts3dis.NUM_CLASSES == 13
