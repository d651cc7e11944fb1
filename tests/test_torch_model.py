"""Parity of the PyTorch port's layers, modules and SemSegNet with the JAX
package, through the weight bridge.

The JAX model is initialised from a PRNG key; its BatchNorm statistics,
BN affine parameters and biases are then set to seeded non-trivial values
(so eval-mode BN is not the identity), flattened under the keys
``save_checkpoint`` writes, and bridged into the port.  Eval-mode outputs
agree within rtol=1e-4, atol=1e-4: the channel products are summed in another
order by XLA's and PyTorch's CPU matmuls, and the difference grows through
~20 layers.  Geometry indices are exact, so no grouping differs.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.nn import layers as jlayers
from pointcloud_segmentation_attention_tpu.nn import modules as jmodules
from pointcloud_segmentation_attention_tpu.train.checkpoints import (
    _flatten,
    save_checkpoint,
)
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.nn import layers as tlayers
from pointcloud_segmentation_attention_tpu_torch.nn import modules as tmodules
from pointcloud_segmentation_attention_tpu_torch.train import (
    export_jax_variables,
    load_jax_checkpoint,
    load_jax_variables,
    seg_predict_step,
)

TOL = dict(rtol=1e-4, atol=1e-4)
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)
TINY = dict(  # __graft_entry__.py's tiny flagship config
    sa_npoints=(16, 8, 4, 2),
    sa_radii=(0.1, 0.2, 0.4, 0.8),
    sa_nsample=4,
    sa_mlps=((4, 8), (8, 8), (8, 8), (8, 8)),
    fp_mlps=((8,), (8,), (8,), (8, 8)),
)


def _flat_variables(variables, seed: int) -> dict:
    """Flat save_checkpoint keys with seeded non-trivial BN stats/affines and
    biases (numpy, so both frameworks see the same values)."""
    rng = np.random.RandomState(seed)
    flat = {f"params/{k}": v for k, v in _flatten(variables["params"]).items()}
    flat.update({f"batch_stats/{k}": v
                 for k, v in _flatten(variables["batch_stats"]).items()})
    for k in sorted(flat):
        shape = flat[k].shape
        if k.endswith("/mean"):
            flat[k] = (rng.randn(*shape) * 0.1).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k.endswith("/scale"):
            flat[k] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif k.endswith("/bias"):
            flat[k] = (rng.randn(*shape) * 0.05).astype(np.float32)
    return flat


def _unflatten(flat: dict) -> dict:
    out = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return out


def _inputs(b, n, seed=3):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(b, n, 3) * EXTENT).astype(np.float32)
    feats = rng.rand(b, n, 6).astype(np.float32)
    return pts, feats


def _bridged(name, kwargs, pts, feats, seed=0):
    """(jax logits, port logits) of one model from the same flat weights."""
    jm = jmodels.get_model(name, num_classes=21, **kwargs)
    f_in = jnp.asarray(feats) if feats is not None else None
    variables = jax.jit(lambda k, p, f: jm.init(k, p, f, train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(pts[:1]), None if f_in is None else f_in[:1])
    flat = _flat_variables(variables, seed + 1)
    want = np.asarray(jax.jit(lambda v, p, f: jm.apply(v, p, f, train=False))(
        _unflatten(flat), jnp.asarray(pts), f_in))
    tm = tmodels.get_model(name, device="cpu", **kwargs)
    load_jax_variables(flat, tm)
    t_feats = torch.from_numpy(feats) if feats is not None else None
    got = seg_predict_step(tm, torch.from_numpy(pts), t_feats).numpy()
    return want, got, flat, tm


@pytest.mark.parametrize("name", ["sem_seg_features", "sem_seg"])
def test_tiny_semseg_matches_jax(name):
    pts, feats = _inputs(2, 256)
    want, got, _, _ = _bridged(name, TINY, pts, feats if name == "sem_seg_features" else None)
    assert got.shape == (2, 256, 21)
    np.testing.assert_allclose(got, want, **TOL)


def test_full_width_semseg_features_matches_jax():
    """Registry widths (npoint 1024/256/64/16, nsample 32) at B1 x 2048."""
    pts, feats = _inputs(1, 2048, seed=5)
    want, got, _, _ = _bridged("sem_seg_features", {}, pts, feats)
    assert got.shape == (1, 2048, 21) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_bridge_round_trip_and_key_checks(tmp_path):
    pts, feats = _inputs(1, 64)
    _, _, flat, tm = _bridged("sem_seg_features", TINY, pts, feats)
    back = export_jax_variables(tm)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])

    with pytest.raises(ValueError, match="missing"):
        load_jax_variables({k: v for k, v in flat.items()
                            if k != "batch_stats/fp4/mlp/conv1/bn/var"}, tm)
    with pytest.raises(ValueError, match="not in model"):
        load_jax_variables({**flat, "params/sa9/mlp/conv0/kernel": np.zeros(1)}, tm)
    bad = dict(flat)
    bad["params/sa1/mlp/conv0/kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(bad, tm)

    # The JAX package's own writer: opt_state and step are ignored.
    params = _unflatten({k[len("params/"):]: v for k, v in flat.items()
                         if k.startswith("params/")})
    stats = _unflatten({k[len("batch_stats/"):]: v for k, v in flat.items()
                        if k.startswith("batch_stats/")})
    state = types.SimpleNamespace(params=params, batch_stats=stats,
                                  opt_state={"mu": params}, step=7)
    path = save_checkpoint(str(tmp_path), state, step=7)
    fresh = tmodels.get_model("sem_seg_features", device="cpu", **TINY)
    load_jax_checkpoint(path, fresh)
    for k, v in export_jax_variables(fresh).items():
        np.testing.assert_array_equal(v, flat[k])


def test_unported_names_and_poolings_raise():
    with pytest.raises(KeyError):
        tmodels.get_model("cls_ssg", device="cpu")
    with pytest.raises(ValueError, match="unknown pooling"):
        tmodels.get_model("sem_seg_features", device="cpu",
                          sa_pooling=("max", "median", "max", "max"))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.get_model("sem_seg_features")


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_jax(train):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    mean = (rng.randn(6) * 0.3).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    jbn = jlayers.ScheduledBatchNorm()
    want, upd = jbn.apply(variables, jnp.asarray(x), train=train, momentum=0.7,
                          mutable=["batch_stats"])
    tbn = tlayers.ScheduledBatchNorm(6)
    load_jax_variables({"params/scale": scale, "params/bias": bias,
                        "batch_stats/mean": mean, "batch_stats/var": var}, tbn)
    tbn.train(train)
    got = tbn(torch.from_numpy(x), momentum=0.7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


def test_dropout_modes():
    x = torch.rand(4, 64, 16) + 0.5
    dp = tlayers.Dropout(0.25)
    dp.eval()
    assert dp(x) is x
    dp.train()
    y = dp(x, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert 0.6 < kept.float().mean().item() < 0.9
    torch.testing.assert_close(dp(x, generator=torch.Generator().manual_seed(0)), y)


def _module_parity(jmod, tmod, args_np, seed=0, **call_kw):
    jargs = [None if a is None else jnp.asarray(a) for a in args_np]
    variables = jmod.init(jax.random.PRNGKey(seed), *jargs, train=False)
    flat = _flat_variables(variables, seed + 1)
    want = jmod.apply(_unflatten(flat), *jargs, train=False)
    load_jax_variables(flat, tmod)
    tmod.eval()
    with torch.no_grad():
        got = tmod(*[None if a is None else torch.from_numpy(a) for a in args_np])
    return want, got


def test_set_abstraction_matches_jax():
    pts, feats = _inputs(2, 512, seed=8)
    jsa = jmodules.SetAbstraction(npoint=64, radius=0.2, nsample=16, mlp=(16, 32))
    tsa = tmodules.SetAbstraction(64, 0.2, 16, 6, (16, 32))
    (jx, jp, ji), (tx, tp, ti) = _module_parity(jsa, tsa, [pts, feats])
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_feature_propagation_matches_jax():
    rng = np.random.RandomState(9)
    xyz1 = (rng.rand(2, 256, 3) * EXTENT).astype(np.float32)
    xyz2 = (rng.rand(2, 64, 3) * EXTENT).astype(np.float32)
    p1 = rng.randn(2, 256, 5).astype(np.float32)
    p2 = rng.randn(2, 64, 12).astype(np.float32)
    jfp = jmodules.FeaturePropagation(mlp=(16, 8))
    tfp = tmodules.FeaturePropagation(17, (16, 8))
    want, got = _module_parity(jfp, tfp, [xyz1, xyz2, p1, p2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
