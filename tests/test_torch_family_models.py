"""Parity of the port's PointNet++ classification and part-segmentation
families with the JAX package on the CPU.

The same seeded numpy inputs and the same weights (JAX variables with
seeded non-trivial BN statistics, carried into the port by the checkpoint
bridge) go through both packages.  Index outputs (kNN, grouping) must be
equal; features and logits within rtol = atol = 1e-4 (float32 matmuls sum
in another order in each framework), train-mode logits within the wider
``TRAIN_TOL`` stated below.  Train-mode forwards
run with dropout off on both sides (the JAX model's ``Dropout`` replaced by
an identity for the test, the port's models built with ``dropout_rate=0``)
and also compare the updated BN running statistics.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.models import cls as jcls
from pointcloud_segmentation_attention_tpu.models import part_seg as jpartseg
from pointcloud_segmentation_attention_tpu.nn import modules as jmodules
from pointcloud_segmentation_attention_tpu.ops import geometry as jgeo
from pointcloud_segmentation_attention_tpu.train.checkpoints import _flatten
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.nn import modules as tmodules
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as tgeo
from pointcloud_segmentation_attention_tpu_torch.train import (
    export_jax_variables,
    load_jax_variables,
)
from test_torch_model import _flat_variables, _unflatten

TOL = dict(rtol=1e-4, atol=1e-4)
# Train mode: every BN normalises by its batch statistics, float32
# reductions whose summation order differs between XLA and PyTorch (~1e-5
# relative at SA1), and each of up to 12 BN layers amplifies that; the
# classifier head's BNs normalise over the batch axis of B2 alone.  Measured
# max |diff| of the logits at B2 x 512: 5.4e-4 (cls_ssg, logits up to 2.4);
# of the head's BN running mean 1.4e-5 on values of ~0.02.
TRAIN_TOL = dict(rtol=2e-3, atol=2e-3)
TRAIN_STATS_TOL = dict(rtol=1e-4, atol=1e-4)
FAMILY = ("cls_ssg", "cls_msg", "part_seg", "part_seg_msg_one_hot")
FAMILY_N_POINTS = {"cls_ssg": 1024, "cls_msg": 1024, "part_seg": 2048,
                   "part_seg_msg_one_hot": 2048}  # ModelNet's and ShapeNet-part's N


class _NoDropout(fnn.Module):
    """The JAX models' ``Dropout`` with dropout off."""

    rate: float = 0.5

    @fnn.compact
    def __call__(self, x, *, deterministic: bool):
        return x


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jcls, "Dropout", _NoDropout)
    monkeypatch.setattr(jpartseg, "Dropout", _NoDropout)


def _cloud(b, n, c, seed):
    """A unit-sphere-normalised cloud of ``c`` channels (xyz, then normals)."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(b, n, 3).astype(np.float32)
    xyz /= np.abs(xyz).max(axis=(1, 2), keepdims=True)
    if c == 3:
        return xyz
    normals = rng.randn(b, n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return np.concatenate([xyz, normals], axis=-1)


# ---- knn_point and the grouping functions -------------------------------------

@pytest.mark.parametrize("k,n", [(16, 300), (32, 20)])  # k > N repeats the farthest
def test_knn_point_matches_jax(k, n):
    rng = np.random.RandomState(k)
    xyz = rng.rand(2, n, 3).astype(np.float32)
    centres = rng.rand(2, 40, 3).astype(np.float32)
    xyz[:, 5] = xyz[:, 9]  # duplicate points: a tie goes to the lower index
    want_d, want_i = jgeo.knn_point(k, jnp.asarray(xyz), jnp.asarray(centres))
    got_d, got_i = tgeo.knn_point(k, torch.from_numpy(xyz), torch.from_numpy(centres))
    assert got_i.dtype == torch.int32 and got_i.shape == (2, 40, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_xyz", [True, False])
@pytest.mark.parametrize("with_points", [True, False])
def test_sample_and_group_all_matches_jax(use_xyz, with_points):
    xyz = _cloud(2, 50, 3, seed=1)
    pts = np.random.RandomState(2).rand(2, 50, 5).astype(np.float32) if with_points else None
    want = jmodules.sample_and_group_all(jnp.asarray(xyz),
                                         None if pts is None else jnp.asarray(pts), use_xyz)
    got = tmodules.sample_and_group_all(torch.from_numpy(xyz),
                                        None if pts is None else torch.from_numpy(pts), use_xyz)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("knn,use_xyz", [(True, True), (True, False), (False, False)])
def test_sample_and_group_knn_and_use_xyz_match_jax(knn, use_xyz):
    xyz = _cloud(2, 200, 3, seed=3)
    pts = np.random.RandomState(4).rand(2, 200, 4).astype(np.float32)
    want = jmodules.sample_and_group(32, 0.3, 8, jnp.asarray(xyz), jnp.asarray(pts), knn,
                                     use_xyz)
    got = tmodules.sample_and_group(32, 0.3, 8, torch.from_numpy(xyz), torch.from_numpy(pts),
                                    knn, use_xyz)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # idx
    for w, g in zip(want[:2] + want[3:], got[:2] + got[3:]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# ---- the SA modules, train and eval mode --------------------------------------

def _module_pair(jmod, tmod, args, seed):
    """JAX variables of ``jmod`` (seeded BN statistics) loaded into ``tmod``."""
    variables = jmod.init(jax.random.PRNGKey(seed), *args, train=False)
    flat = _flat_variables(variables, seed + 1)
    load_jax_variables(flat, tmod)
    return flat


def _check_module(jmod, tmod, xyz, pts, seed):
    jargs = (jnp.asarray(xyz), None if pts is None else jnp.asarray(pts))
    targs = (torch.from_numpy(xyz), None if pts is None else torch.from_numpy(pts))
    flat = _module_pair(jmod, tmod, jargs, seed)
    variables = _unflatten(flat)
    tmod.eval()
    with torch.no_grad():
        got = tmod(*targs)
    want = jmod.apply(variables, *jargs, train=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # new_xyz
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    tmod.train()
    with torch.no_grad():
        got = tmod(*targs, bn_momentum=0.7)
    want, mutated = jmod.apply(variables, *jargs, train=True, bn_momentum=0.7,
                               mutable=["batch_stats"])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    stats = {f"batch_stats/{k}": np.asarray(v)
             for k, v in _flatten(mutated["batch_stats"]).items()}
    back = export_jax_variables(tmod)
    for k, v in stats.items():
        np.testing.assert_allclose(back[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_group_all_set_abstraction_matches_jax(use_xyz):
    xyz = _cloud(2, 64, 3, seed=5)
    pts = np.random.RandomState(6).randn(2, 64, 12).astype(np.float32)
    jmod = jmodules.SetAbstraction(None, None, None, (16, 32), group_all=True, use_xyz=use_xyz)
    tmod = tmodules.SetAbstraction(None, None, None, 12, (16, 32), group_all=True,
                                   use_xyz=use_xyz)
    _check_module(jmod, tmod, xyz, pts, seed=7)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_knn_set_abstraction_matches_jax(use_xyz):
    xyz = _cloud(2, 128, 3, seed=8)
    pts = np.random.RandomState(9).randn(2, 128, 6).astype(np.float32)
    jmod = jmodules.SetAbstraction(32, None, 16, (16, 32), knn=True, use_xyz=use_xyz)
    tmod = tmodules.SetAbstraction(32, None, 16, 6, (16, 32), knn=True, use_xyz=use_xyz)
    _check_module(jmod, tmod, xyz, pts, seed=10)


@pytest.mark.parametrize("with_points,use_xyz", [(True, True), (True, False), (False, True)])
def test_set_abstraction_msg_matches_jax(with_points, use_xyz):
    xyz = _cloud(2, 256, 3, seed=11)
    pts = (np.random.RandomState(12).randn(2, 256, 7).astype(np.float32)
           if with_points else None)
    mlps = ((8, 16), (16, 16, 24), (8, 12))
    jmod = jmodules.SetAbstractionMSG(64, (0.1, 0.3, 0.6), (4, 16, 32), mlps, use_xyz=use_xyz)
    tmod = tmodules.SetAbstractionMSG(64, (0.1, 0.3, 0.6), (4, 16, 32),
                                      7 if with_points else 0, mlps, use_xyz=use_xyz)
    assert tmod.out_channels == 16 + 24 + 12
    _check_module(jmod, tmod, xyz, pts, seed=13)


# ---- the four registry models ------------------------------------------------------

def _model_inputs(name, b, n, seed):
    """(JAX positional inputs, port positional inputs, port model kwargs)."""
    if name.startswith("cls"):
        c = 6 if name == "cls_msg" else 3  # cls_msg with normals, cls_ssg xyz only
        cloud = _cloud(b, n, c, seed)
        xs = (cloud[..., :3], cloud[..., 3:]) if c == 6 else (cloud,)
        return xs, xs, dict(num_classes=40, in_features=c - 3)
    cloud = _cloud(b, n, 6, seed)
    if name == "part_seg":
        return (cloud,), (cloud,), {}
    labels = np.arange(b, dtype=np.int32) * 5 % 16
    return (cloud, labels), (cloud, labels), {}


@functools.lru_cache(maxsize=None)
def _family_variables(name, seed):
    """(JAX model, its variables with seeded BN statistics as flat keys);
    the variables do not depend on the input's size, so they are made once
    at B1 x 128."""
    jm = jmodels.get_model(name, **({"num_classes": 40} if name.startswith("cls") else {}))
    jx, _, _ = _model_inputs(name, 1, 128, seed)
    variables = jax.jit(lambda k, *a: jm.init(k, *a, train=False))(
        jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in jx))
    return jm, _flat_variables(variables, seed + 1)


def bridged_family_model(name, b, n, seed, **port_kwargs):
    """(JAX model, its flat variables, the port's model loaded from them,
    JAX inputs (B, N), port inputs)."""
    jx, tx, kw = _model_inputs(name, b, n, seed)
    jm, flat = _family_variables(name, seed)
    tm = tmodels.get_model(name, device="cpu", **kw, **port_kwargs)
    load_jax_variables(flat, tm)
    return jm, flat, tm, tuple(jnp.asarray(a) for a in jx), tuple(torch.from_numpy(a) for a in tx)


@pytest.mark.parametrize("name", FAMILY)
def test_family_model_eval_forward_matches_jax(name):
    n = FAMILY_N_POINTS[name]
    jm, flat, tm, jargs, targs = bridged_family_model(name, 2, n, seed=20)
    want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        _unflatten(flat), *jargs))
    tm.eval()
    with torch.no_grad():
        got = tm(*targs).numpy()
    assert got.shape == ((2, 40) if name.startswith("cls") else (2, n, 50))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", FAMILY)
def test_family_model_train_forward_matches_jax(name, no_jax_dropout):
    jm, flat, tm, jargs, targs = bridged_family_model(name, 2, 512, seed=20, dropout_rate=0.0)
    want, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, bn_momentum=0.8, mutable=["batch_stats"]))(_unflatten(flat), *jargs)
    tm.train()
    with torch.no_grad():
        got = tm(*targs, bn_momentum=0.8).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TRAIN_TOL)
    back = export_jax_variables(tm)
    for k, v in _flatten(mutated["batch_stats"]).items():
        np.testing.assert_allclose(back["batch_stats/" + k], np.asarray(v), err_msg=k,
                                   **TRAIN_STATS_TOL)


@pytest.mark.parametrize("name", FAMILY)
def test_family_bridge_round_trip(name):
    """Each model loads a JAX variable tree and exports it back bit for
    bit, with the flax names of its MSG branches, group-all level and head;
    a key missing or extra raises."""
    _, flat, tm, _, _ = bridged_family_model(name, 1, 128, seed=20)
    back = export_jax_variables(tm)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert "params/sa3/mlp/conv2/kernel" in flat and "params/head/fc1/bn/scale" in flat
    if name.endswith("msg") or name.endswith("one_hot"):
        assert "batch_stats/sa1/branch2/conv1/bn/var" in flat
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables({k: v for k, v in flat.items() if k != "params/head/fc1/kernel"},
                           tm)


def test_registry_builds_the_family_with_seeded_weights():
    for name in FAMILY:
        a = tmodels.seeded_model(name, seed=3, device="cpu")
        b = tmodels.seeded_model(name, seed=3, device="cpu")
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    assert {"cls_ssg", "cls_msg", "part_seg", "part_seg_msg_one_hot"} <= set(
        tmodels.available_models())
    with pytest.raises(ValueError, match="feature channels"):
        tmodels.get_model("cls_ssg", device="cpu").eval()(torch.zeros(1, 32, 3),
                                                          torch.zeros(1, 32, 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILY)
def test_cuda_family_forward_matches_cpu(cuda_device, name):
    """The family's eval forward on the card (the kernels) against the CPU
    (the plain versions) from the same weights: logits within 1e-3, as
    ``chip_smoke.py`` holds them."""
    _, _, tm, _, targs = bridged_family_model(name, 2, FAMILY_N_POINTS[name], seed=20)
    tm.eval()
    with torch.no_grad():
        want = tm(*targs)
        got = tm.to(cuda_device)(*(a.to(cuda_device) for a in targs)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
