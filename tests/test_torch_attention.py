"""Parity of the port's attention layers, attention poolings and attention
models with the JAX package on the CPU.

The same seeded numpy inputs and weights (bridged by name from the Flax
variables, biases and BN statistics set to seeded non-trivial values) go
through the JAX package and the port.  Tolerances:

- ``TOL`` (rtol = atol = 1e-5) for the layers, the SA poolings and the tiny
  models: the channel products are summed in another order by XLA's and
  PyTorch's CPU matmuls, a few float32 roundings apart through the few
  layers of a tiny model.
- ``WIDE_TOL`` (1e-4) at full width, as ``test_torch_model.py`` holds the
  flagship there: the differences grow through ~20 wide layers.
- Geometry indices (sampled centres, ball-query idx) are compared exactly.
- Train steps go through ``test_torch_train.train_steps_match_jax``, whose
  ``_check_step`` states its limits (loss rtol 1e-5, BN statistics 1e-5),
  with gradients per tensor in relative L2 within ``ATTENTION_GRAD_REL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import attention_pool_oracle, feed_forward_oracle, inner_attention_oracle
from pointcloud_segmentation_attention_tpu.nn import attention as jatt
from pointcloud_segmentation_attention_tpu.nn import modules as jmodules
from pointcloud_segmentation_attention_tpu.train import steps as jsteps
from pointcloud_segmentation_attention_tpu.train.checkpoints import _flatten, save_checkpoint
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.nn import attention as tatt
from pointcloud_segmentation_attention_tpu_torch.nn import modules as tmodules
from pointcloud_segmentation_attention_tpu_torch.train import (
    TrainState,
    export_jax_state,
    export_jax_variables,
    load_jax_checkpoint,
    load_jax_variables,
)
from test_torch_model import TINY, _bridged, _flat_variables, _inputs, _unflatten
from test_torch_train import _batch, _pair, scene, train_steps_match_jax  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
WIDE_TOL = dict(rtol=1e-4, atol=1e-4)
# TINY's radii at 256 points leave most SA1 balls holding their centre only:
# fed xyz alone, SA1's first layer then sees exact zeros and its train-mode
# BN a variance near 0, where the float32 gradients of both frameworks are
# noise (tens of per cent from a float64 run).  Wider balls for xyz-only
# training.
XYZ_ONLY_RADII = (0.3, 0.5, 0.8, 1.2)
# Gradients per tensor in relative L2 through the attention poolings: over
# these three steps the largest distance from a float64 run of the port is
# 9.4e-5 for JAX's float32 gradients and 3.3e-5 for the port's (SA1's
# query_net bias, through the softmax), so the two frameworks may be 1.3e-4
# apart.
ATTENTION_GRAD_REL = 3e-4
ATTENTION_MODELS = [
    ("sem_seg_attention", {}),
    ("sem_seg_attention_single_layer", {"layer_idx": 0}),
    ("sem_seg_attention_single_layer", {"layer_idx": 3}),
    ("sem_seg_attention_and_pooling", {}),
]
# Attention at SA2 and SA3 alone: Table 1's att_L2 and att_L3 arms.
MIDDLE_SINGLE_LAYERS = [
    ("sem_seg_attention_single_layer", {"layer_idx": 1}),
    ("sem_seg_attention_single_layer", {"layer_idx": 2}),
]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flax_flat(jmod, args, seed=0, **kw) -> dict:
    """The module's Flax variables under ``save_checkpoint``'s flat keys,
    biases (and BN statistics) set to seeded non-trivial values."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    variables = dict(jmod.init(jax.random.PRNGKey(seed), *jargs, **kw))
    variables.setdefault("batch_stats", {})
    return _flat_variables(variables, seed + 1)


def _weights(flat, *names):
    return [flat[f"params/{n}/{w}"] for n in names for w in ("kernel", "bias")]


# ---- the attention layers ------------------------------------------------------

@pytest.mark.parametrize("c, c_query, heads", [(16, 16, 4), (8, 3, 2), (32, 32, 8)])
def test_attention_pool_matches_jax_and_oracle(c, c_query, heads):
    rng = np.random.RandomState(c + c_query)
    inp = rng.randn(2, 5, 7, c).astype(np.float32)
    query = rng.randn(2, 5, 1, c_query).astype(np.float32)
    jmod = jatt.AttentionPool(output_dim=4, key_dim=4, num_heads=heads)
    flat = _flax_flat(jmod, [inp, query])
    want = np.asarray(jmod.apply(_unflatten(flat), jnp.asarray(inp), jnp.asarray(query)))
    tmod = tatt.AttentionPool(c, c_query, output_dim=4, key_dim=4, num_heads=heads)
    load_jax_variables(flat, tmod)
    got = tmod(_t(inp), _t(query)).detach().numpy()
    assert got.shape == (2, 5, heads * 4)
    np.testing.assert_allclose(got, want, **TOL)
    oracle = attention_pool_oracle(inp, query, *_weights(flat, "query_net", "key_net",
                                                         "value_net"), heads, 4)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("c, out_dim, key_dim", [(12, 12, 4), (6, 10, 3)])
def test_inner_attention_matches_jax_and_oracle(c, out_dim, key_dim):
    rng = np.random.RandomState(c * out_dim)
    x = rng.randn(2, 4, 6, c).astype(np.float32)
    jmod = jatt.InnerAttention(output_dim=out_dim, key_dim=key_dim)
    flat = _flax_flat(jmod, [x])
    want = np.asarray(jmod.apply(_unflatten(flat), jnp.asarray(x)))
    tmod = tatt.InnerAttention(c, out_dim, key_dim)
    load_jax_variables(flat, tmod)
    got = tmod(_t(x)).detach().numpy()
    assert got.shape == (2, 4, 6, out_dim)
    np.testing.assert_allclose(got, want, **TOL)
    oracle = inner_attention_oracle(x, *_weights(flat, "query_net", "key_net", "value_net",
                                                 "out_net"), 5, key_dim)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("c, io_dim, inner", [(8, 8, 16), (5, 7, 6)])
def test_feed_forward_matches_jax_and_oracle(c, io_dim, inner):
    rng = np.random.RandomState(c + inner)
    x = rng.randn(3, 4, 5, c).astype(np.float32)
    jmod = jatt.FeedForward(io_dim, inner, dropout=0.5)
    flat = _flax_flat(jmod, [x])
    want = np.asarray(jmod.apply(_unflatten(flat), jnp.asarray(x), deterministic=True))
    tmod = tatt.FeedForward(c, io_dim, inner, dropout=0.5)
    load_jax_variables(flat, tmod)
    tmod.eval()
    got = tmod(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    layers = [(flat[f"params/layer_{i}/kernel"], flat[f"params/layer_{i}/bias"])
              for i in range(1, 5)]
    np.testing.assert_allclose(got, feed_forward_oracle(x, layers), **TOL)
    # Train mode: dropout draws from the generator passed in.
    tmod.train()
    a = tmod(_t(x), generator=torch.Generator().manual_seed(1))
    b = tmod(_t(x), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, torch.from_numpy(got))


def test_inner_attention_block_matches_jax_and_oracle():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 4, 6).astype(np.float32)
    jmod = jatt.InnerAttentionBlock(out_dim=10, key_dim=4)
    flat = _flax_flat(jmod, [x])
    want = np.asarray(jmod.apply(_unflatten(flat), jnp.asarray(x)))
    tmod = tatt.InnerAttentionBlock(6, 10, 4)
    load_jax_variables(flat, tmod)
    tmod.eval()
    got = tmod(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)

    def ff(prefix, v):
        return feed_forward_oracle(v, [(flat[f"params/{prefix}/layer_{i}/kernel"],
                                        flat[f"params/{prefix}/layer_{i}/bias"])
                                       for i in range(1, 5)])

    h = ff("pre_feed_forward", x)
    h = inner_attention_oracle(h, *[flat[f"params/attention/{n}/{w}"]
                                    for n in ("query_net", "key_net", "value_net", "out_net")
                                    for w in ("kernel", "bias")], 5, 4)
    np.testing.assert_allclose(got, ff("feed_forward", h) + h, **TOL)


# ---- SetAbstraction: every pooling ---------------------------------------------

def _sa_parity(pooling, train, mlp2=None, c_feats=6):
    """(JAX, port) outputs of one SA module at TINY's SA1 widths, from the
    same bridged weights; in train mode also the updated BN statistics."""
    pts, feats = _inputs(2, 256, seed=8)
    feats = feats[..., :c_feats] if c_feats else None
    args = [pts, feats]
    jsa = jmodules.SetAbstraction(npoint=16, radius=0.4, nsample=8, mlp=(4, 8), mlp2=mlp2,
                                  pooling=pooling)
    flat = _flax_flat(jsa, args, train=False)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    if train:
        want, upd = jsa.apply(_unflatten(flat), *jargs, train=True, bn_momentum=0.7,
                              mutable=["batch_stats"])
        stats = {f"batch_stats/{k}": v for k, v in _flatten(upd["batch_stats"]).items()}
    else:
        want, stats = jsa.apply(_unflatten(flat), *jargs, train=False), None
    tsa = tmodules.SetAbstraction(16, 0.4, 8, c_feats, (4, 8), pooling=pooling, mlp2=mlp2)
    load_jax_variables(flat, tsa)
    tsa.train(train)
    with torch.no_grad():
        got = tsa(*[None if a is None else _t(a) for a in args], bn_momentum=0.7)
    return want, got, stats, tsa, flat


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("pooling", tmodules.POOLINGS)
def test_set_abstraction_pooling_matches_jax(pooling, train):
    (jx, jp, ji), (tx, tp, ti), stats, tsa, _ = _sa_parity(pooling, train)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tp.shape == (2, 16, tsa.out_channels) == np.asarray(jp).shape
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    if train:
        got = {k: v for k, v in export_jax_variables(tsa).items() if k.startswith("batch_stats/")}
        assert set(got) == set(stats)
        for k, v in stats.items():
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("pooling, c_feats", [("max_and_avg", 6), ("attention_centroid", 0),
                                              ("weighted_avg", 0)])
def test_set_abstraction_mlp2_and_xyz_only_match_jax(pooling, c_feats):
    """The mlp2 stage after the pooling (its input 2C after 'max_and_avg'),
    train mode, with and without features; the bridge carries its keys."""
    (jx, jp, ji), (tx, tp, ti), stats, tsa, flat = _sa_parity(pooling, True, mlp2=(8, 4),
                                                              c_feats=c_feats)
    assert tsa.out_channels == 4 and any(k.startswith("params/mlp2/conv1/") for k in flat)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    got = export_jax_variables(tsa)
    for k, v in stats.items():
        np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)


def test_attention_pooling_checks_its_width_and_names():
    with pytest.raises(ValueError, match="divisible by 4"):
        tmodules.SetAbstraction(16, 0.4, 8, 0, (4, 6), pooling="attention")
    with pytest.raises(ValueError, match="divisible by 4"):
        jmodules.SetAbstraction(npoint=16, radius=0.4, nsample=8, mlp=(4, 6),
                                pooling="attention").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 3)), None, train=False)
    with pytest.raises(ValueError, match="unknown pooling"):
        tmodules.SetAbstraction(16, 0.4, 8, 0, (4, 8), pooling="median")
    sa = tmodules.SetAbstraction(16, 0.4, 8, 0, (4, 8), pooling="attention_and_pool")
    names = {k for k, _ in sa.named_parameters()} | {k for k, _ in sa.named_buffers()}
    assert {"attention_pool.query_net.kernel", "attention_pool.key_net.bias",
            "attention_pool.value_net.kernel", "attention_bn.scale", "attention_bn.mean",
            "attention_bn.var"} <= names
    assert tmodules.SetAbstraction(16, 0.4, 8, 0, (4, 8), pooling="max_and_avg").out_channels == 16


# ---- the registry models ---------------------------------------------------------

@pytest.mark.parametrize("name, kwargs", ATTENTION_MODELS + MIDDLE_SINGLE_LAYERS)
def test_tiny_attention_models_match_jax(name, kwargs):
    pts, _ = _inputs(2, 256)
    want, got, flat, tm = _bridged(name, {**TINY, **kwargs}, pts, None)
    assert got.shape == (2, 256, 21)
    np.testing.assert_allclose(got, want, **TOL)
    levels = {k.split("/")[1] for k in flat if "/attention_pool/" in k}
    if name == "sem_seg_attention_single_layer":
        assert levels == {f"sa{kwargs['layer_idx'] + 1}"}
    else:
        assert levels == {"sa1", "sa2", "sa3", "sa4"}


def test_full_width_attention_matches_jax():
    """Registry widths (npoint 1024/256/64/16, nsample 32, heads 16-128) at
    B1 x 2048, xyz only."""
    pts, _ = _inputs(1, 2048, seed=5)
    want, got, _, _ = _bridged("sem_seg_attention", {}, pts, None)
    assert got.shape == (1, 2048, 21) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **WIDE_TOL)


def test_registry_names_defaults_and_overrides():
    assert tmodels.available_models() == [
        "attention_net", "attention_net_mlp", "cls_msg", "cls_ssg", "part_seg",
        "part_seg_msg_one_hot", "point_transformer_seg", "pointnet1_cls",
        "pointnet1_cls_basic", "pointnet1_part_seg",
        "pointnet1_seg", "pointnet1_sem_seg", "pooling_attention_net",
        "sem_seg", "sem_seg_attention", "sem_seg_attention_and_pooling",
        "sem_seg_attention_single_layer", "sem_seg_features"]
    pools = {name: [getattr(tmodels.get_model(name, device="cpu", **kw, **TINY),
                            f"sa{i}").pooling for i in range(1, 5)]
             for name, kw in ATTENTION_MODELS[:2] + ATTENTION_MODELS[3:]}
    assert pools == {"sem_seg_attention": ["attention"] * 4,
                     "sem_seg_attention_single_layer": ["attention", "max", "max", "max"],
                     "sem_seg_attention_and_pooling": ["attention_and_pool"] * 4}
    # xyz only by default; an explicit in_features overrides any name's default.
    assert tmodels.get_model("sem_seg_attention", device="cpu", **TINY).in_features == 0
    m = tmodels.get_model("sem_seg_attention", device="cpu", in_features=6, **TINY)
    assert m.in_features == 6 and m.sa1.mlp.conv0.kernel.shape[0] == 9
    assert tmodels.get_model("sem_seg_features", device="cpu", in_features=0,
                             **TINY).in_features == 0
    with pytest.raises(TypeError, match="layer_idx"):
        tmodels.get_model("sem_seg_attention_single_layer", device="cpu", **TINY)
    with pytest.raises(ValueError, match="layer_idx"):
        tmodels.get_model("sem_seg_attention_single_layer", device="cpu", layer_idx=4, **TINY)
    # seeded_model draws every kernel, attention and BN of each name from the seed.
    for name, kw in ATTENTION_MODELS:
        a = tmodels.seeded_model(name, seed=3, device="cpu", **kw, **TINY)
        b = tmodels.seeded_model(name, seed=3, device="cpu", **kw, **TINY)
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
        q = a.sa4.attention_pool.query_net if name != "sem_seg_attention_single_layer" else \
            getattr(a, f"sa{kw['layer_idx'] + 1}").attention_pool.query_net
        assert q.kernel.abs().sum() > 0 and q.bias.abs().sum() == 0


# ---- training and the checkpoint bridge --------------------------------------

@pytest.mark.parametrize("name, kwargs",
                         ATTENTION_MODELS[:2] + ATTENTION_MODELS[3:] + MIDDLE_SINGLE_LAYERS)
def test_attention_train_steps_match_jax(scene, name, kwargs):  # noqa: F811
    """Three tiny steps, xyz only, each held to the JAX step."""
    train_steps_match_jax(scene, name, {**TINY, **kwargs, "sa_radii": XYZ_ONLY_RADII}, 2, 256,
                          3, ATTENTION_GRAD_REL, features=False)


def test_attention_checkpoint_bridge_carries_every_new_key(scene, tmp_path):  # noqa: F811
    """A JAX checkpoint of an attention model after one JAX step (parameters,
    BN statistics, Adam's state) loads into the port and exports back to
    the same keys and bits; a missing attention key raises."""
    batch = _batch(scene, 2, 256, seed=50, features=False)
    jstate, _ = _pair(TINY, batch, capture=False, name="sem_seg_attention_and_pooling")
    jstate, _ = jax.jit(jsteps.seg_train_step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    path = save_checkpoint(str(tmp_path / "jax"), jstate, step=1)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    new = {k for k in flat if "/attention_pool/" in k or "/attention_bn/" in k}
    for level in ("sa1", "sa2", "sa3", "sa4"):
        for sub in ("query_net", "key_net", "value_net"):
            for w in ("kernel", "bias"):
                assert f"params/{level}/attention_pool/{sub}/{w}" in new
                for moment in (".mu", ".nu"):
                    assert f"opt_state/0/{moment}/{level}/attention_pool/{sub}/{w}" in new
        assert {f"params/{level}/attention_bn/scale", f"params/{level}/attention_bn/bias",
                f"batch_stats/{level}/attention_bn/mean",
                f"batch_stats/{level}/attention_bn/var"} <= new
    tstate = TrainState(tmodels.get_model("sem_seg_attention_and_pooling", device="cpu",
                                          dropout_rate=0.0, **TINY))
    load_jax_checkpoint(path, tstate)
    back = export_jax_state(tstate)
    assert set(back) == set(flat) and tstate.step == 1
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fresh = tmodels.get_model("sem_seg_attention_and_pooling", device="cpu", **TINY)
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables({k: v for k, v in flat.items()
                            if k != "batch_stats/sa2/attention_bn/var"}, fresh)
