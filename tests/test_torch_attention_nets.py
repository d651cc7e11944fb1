"""Parity of the port's full attention networks (``attention_net``,
``attention_net_mlp``, ``pooling_attention_net``) with the JAX package on
the CPU.

The JAX model's ``model.init`` variables, with seeded non-trivial biases
and BN statistics, are carried into the port by ``load_jax_variables``
(a key missing or extra raises); the same seeded numpy inputs go through
both.  Geometry indices are compared exactly; features and logits within
``TOL`` (rtol 1e-4, atol 1e-5): XLA and PyTorch sum the channel products
in another order, a few float32 roundings apart through the ~25 layers,
two softmaxes and the 16-head pooling of a level.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.models import attention_nets as jattnets
from pointcloud_segmentation_attention_tpu.ops import geometry as jgeo
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.models import attention_nets as tattnets
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as tgeo
from pointcloud_segmentation_attention_tpu_torch.train import (
    export_jax_variables,
    load_jax_variables,
    seg_predict_step,
)
from test_torch_model import _flat_variables, _unflatten

TOL = dict(rtol=1e-4, atol=1e-5)
NETS = ("attention_net", "attention_net_mlp", "pooling_attention_net")


def _cloud(b, n, seed, c_feats=6):
    """Points in a 1.5 m cube (radius-0.1 balls hold a few neighbours at N
    1024) and ``c_feats`` feature channels in [0, 1)."""
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3) * 1.5).astype(np.float32)
    feats = rng.rand(b, n, c_feats).astype(np.float32) if c_feats else None
    return xyz, feats


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_plain_fps_and_ball_query_match_jax_past_n():
    """At npoint > N (the JAX package's own model tests run these nets at N
    64 against npoint 1024) JAX's FPS repeats index 0 once every point is
    taken; the port's plain FPS and ball query give the same indices."""
    xyz, _ = _cloud(2, 64, seed=1, c_feats=0)
    want = np.asarray(jgeo.farthest_point_sample(jnp.asarray(xyz), 100))
    got = tgeo.farthest_point_sample(torch.from_numpy(xyz), 100).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 64:] == 0).all() and sorted(got[0, :64]) == list(range(64))
    centres = np.take_along_axis(xyz, want[..., None].astype(np.int64), axis=1)
    w_idx, w_cnt = jgeo.ball_query(jnp.asarray(xyz), jnp.asarray(centres), 0.1, 32)
    g_idx, g_cnt = tgeo.ball_query(torch.from_numpy(xyz), torch.from_numpy(centres), 0.1, 32)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(g_cnt.numpy(), np.asarray(w_cnt))


@pytest.mark.parametrize("inner_kind, inner_dims", [("attention", (8,)), ("mlp", (8, 6, 8))])
def test_attention_net_layer_matches_jax(inner_kind, inner_dims):
    """One ``AttentionNetLayer`` alone; the MLP variant with three inner
    blocks, so its ReLU between blocks (and none after the last) shows."""
    xyz, feats = _cloud(2, 256, seed=2, c_feats=5)
    jl = jattnets.AttentionNetLayer(npoint=32, out_dim=8, inner_dimensions=inner_dims,
                                    radius=0.3, nsample=8, inner_kind=inner_kind)
    tl = tattnets.AttentionNetLayer(32, 8, inner_dims, 5, radius=0.3, nsample=8,
                                    inner_kind=inner_kind)
    variables = jl.init(jax.random.PRNGKey(3), _j(xyz), _j(feats), train=False)
    flat = _flat_variables(variables | {"batch_stats": {}}, 4)
    load_jax_variables(flat, tl)
    w_xyz, w_pooled, w_idx = jl.apply(_unflatten(flat), _j(xyz), _j(feats), train=False)
    with torch.no_grad():
        g_xyz, g_pooled, g_idx = tl.eval()(_t(xyz), _t(feats))
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(g_xyz.numpy(), np.asarray(w_xyz))
    assert g_pooled.shape == (2, 32, 16 * 8)
    np.testing.assert_allclose(g_pooled.numpy(), np.asarray(w_pooled), **TOL)
    with pytest.raises(ValueError, match="inner_kind"):
        tattnets.AttentionNetLayer(32, 8, (8,), 5, inner_kind="conv")


def test_pooling_attention_net_layer_matches_jax():
    """One ``PoolingAttentionNetLayer`` (the centroid-queried pooling over a
    conv MLP), eval and train mode with its BN statistics."""
    xyz, feats = _cloud(2, 256, seed=5, c_feats=4)
    jl = jattnets.PoolingAttentionNetLayer(npoint=32, out_dim=4, mlp=(8, 12), radius=0.3,
                                           nsample=8)
    tl = tattnets.PoolingAttentionNetLayer(32, 4, (8, 12), 4, radius=0.3, nsample=8)
    flat = _flat_variables(jl.init(jax.random.PRNGKey(6), _j(xyz), _j(feats), train=False), 7)
    load_jax_variables(flat, tl)
    _, w_eval, _ = jl.apply(_unflatten(flat), _j(xyz), _j(feats), train=False)
    (_, w_train, _), mutated = jl.apply(_unflatten(flat), _j(xyz), _j(feats), train=True,
                                        bn_momentum=0.8, mutable=["batch_stats"])
    with torch.no_grad():
        g_eval = tl.eval()(_t(xyz), _t(feats))[1]
        g_train = tl.train()(_t(xyz), _t(feats), bn_momentum=0.8)[1]
    np.testing.assert_allclose(g_eval.numpy(), np.asarray(w_eval), **TOL)
    np.testing.assert_allclose(g_train.numpy(), np.asarray(w_train), **TOL)
    back = export_jax_variables(tl)
    for k, v in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]):
        key = "batch_stats/" + "/".join(p.key for p in k)
        np.testing.assert_allclose(back[key], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=key)


@functools.lru_cache(maxsize=None)
def _net_variables(name, c_feats, seed=0):
    """(JAX model, flat variables with seeded BN statistics); the variables
    do not depend on N, so they are made once at B1 x 64."""
    jm = jmodels.get_model(name, num_classes=21)
    xyz, feats = _cloud(1, 64, seed, c_feats)
    variables = jax.jit(lambda k, p, f: jm.init(k, p, f, train=False))(
        jax.random.PRNGKey(seed), _j(xyz), _j(feats))
    return jm, _flat_variables(variables, seed + 1)


def _bridged_net(name, c_feats):
    jm, flat = _net_variables(name, c_feats)
    tm = tmodels.get_model(name, device="cpu", in_features=c_feats)
    load_jax_variables(flat, tm)
    return jm, flat, tm


@pytest.mark.parametrize("name", NETS)
def test_attention_nets_eval_forward_match_jax(name):
    """B1 x 1024 with colors and normals (the trainer's default input), the
    registry's full widths: levels of 128 / 256 / 512 / 1024 channels
    (``pooling_attention_net``: 1024 / 2048 / 4096 / 8192)."""
    jm, flat, tm = _bridged_net(name, 6)
    xyz, feats = _cloud(1, 1024, seed=8)
    want = np.asarray(jax.jit(lambda v, p, f: jm.apply(v, p, f, train=False))(
        _unflatten(flat), _j(xyz), _j(feats)))
    got = seg_predict_step(tm, _t(xyz), _t(feats)).numpy()
    assert got.shape == (1, 1024, 21) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    widths = [getattr(tm, f"l{i}").out_channels for i in range(1, 5)]
    scale = 8 if name == "pooling_attention_net" else 1
    assert widths == [128 * scale, 256 * scale, 512 * scale, 1024 * scale]


def test_attention_net_xyz_only_past_n_matches_jax():
    """The JAX package's own test size: B1 x 64, xyz only, npoint 1024 > N."""
    jm, flat, tm = _bridged_net("attention_net", 0)
    xyz, _ = _cloud(1, 64, seed=9, c_feats=0)
    want = np.asarray(jax.jit(lambda v, p: jm.apply(v, p, None, train=False))(
        _unflatten(flat), _j(xyz)))
    got = seg_predict_step(tm, _t(xyz)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", NETS)
def test_attention_net_bridge_round_trip(name):
    """Every flax name maps onto the state dict; export gives the same
    keys and bits back; a key missing raises."""
    _, flat, tm = _bridged_net(name, 6)
    back = export_jax_variables(tm)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert {"params/l1/attention_pool/value_net/kernel", "params/head/fc1/kernel",
            "batch_stats/head/fp1/mlp/conv0/bn/mean"} <= set(flat)
    if name == "attention_net":
        assert "params/l1/inner0/pre_feed_forward/layer_1/kernel" in flat
        assert "params/l4/inner0/attention/query_net/bias" in flat
    elif name == "attention_net_mlp":
        assert "params/l2/inner0/layer_4/kernel" in flat
    else:
        assert "batch_stats/l3/mlp/conv2/bn/var" in flat
        assert flat["params/l1/attention_pool/query_net/kernel"].shape == (3, 1024)
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables({k: v for k, v in flat.items()
                            if k != "params/l1/attention_pool/key_net/bias"}, tm)


def test_attention_nets_refuse_the_wrong_feature_width():
    m = tmodels.get_model("attention_net", device="cpu")
    with pytest.raises(ValueError, match="feature channels"):
        m(torch.zeros(1, 64, 3), torch.zeros(1, 64, 6))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NETS)
def test_cuda_attention_net_forward_matches_cpu(cuda_device, name):
    """The eval forward on the card (the kernels) against the CPU (the
    plain versions) from the same weights: logits within 1e-3, as
    ``chip_smoke.py`` holds them."""
    _, _, tm = _bridged_net(name, 6)
    xyz, feats = _cloud(2, 2048, seed=10)
    want = seg_predict_step(tm, _t(xyz), _t(feats))
    tm.to(cuda_device)
    got = seg_predict_step(tm, _t(xyz).to(cuda_device), _t(feats).to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
