"""Mixed precision (``compute_dtype=bfloat16``) in the port against the JAX
package on the CPU.

JAX casts both operands of every ``PointConv``, ``Dense`` and attention
product to ``compute_dtype`` and takes the product with a float32 result
(``preferred_element_type``); its backward takes each cotangent product in
float32 and rounds it to bf16 before the cast's VJP widens it again.  The
port's ``nn/layers.py:mixed_matmul`` does the same.  The same seeded numpy
inputs and weights (bridged by name with ``load_jax_variables``) go through
both.  Tolerances, and why:

- ``LAYER_TOL`` (rtol = atol = 1e-5) for the layers, outputs and
  gradients: both sum the same exact products of the same bf16 values, in
  another order (measured: outputs within 4.8e-7 of values up to 4.4, the
  gradients equal).
- ``MODEL_TOL`` (rtol = atol = 2e-3) for whole models in eval mode: a
  float32 difference of summation order that moves a value across a bf16
  rounding boundary changes it by 2^-8 of itself, and such flips compound
  through the later layers.  Measured: 3.7e-8 (tiny ``sem_seg_features``),
  0 (tiny ``sem_seg_attention``), 5.9e-4 (``pointnet1_cls_basic``, whose
  1024-wide layers flip).  ``ARGMAX_SHARE`` (99 %) of the per-point argmax
  must agree.
- The train step: loss rtol 1e-5 and the BN statistics 1e-5, as the float32
  step tests; gradients per tensor in relative L2 within ``BF16_GRAD_REL``
  (3e-2).  The cotangents are rounded to bf16 at every product, where a
  float32 difference of summation order flips a rounding; the largest
  measured distance is 1.7e-2 (SA1's first BN bias, a sum over every
  group that cancels), against 1e-4 for the float32 step.  New parameters
  as ``test_torch_train._check_step`` holds them.

Beyond the numerics: every registry name runs in bf16, every kernel input
stays float32 in both packages, ``train(config)`` runs a bf16 config whose
checkpoint JAX restores, and a BN-folded bf16 model matches JAX's and
serves through ``ResidentSceneServer``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu import ops as jops
from pointcloud_segmentation_attention_tpu.nn import attention as jatt
from pointcloud_segmentation_attention_tpu.nn import layers as jlayers
from pointcloud_segmentation_attention_tpu.train import checkpoints as jckpt
from pointcloud_segmentation_attention_tpu.train.bn_fold import (
    fold_batchnorm_for_inference as jfold,
)
from pointcloud_segmentation_attention_tpu.train import schedules as jsched
from pointcloud_segmentation_attention_tpu.train import steps as jsteps
from pointcloud_segmentation_attention_tpu.train import trainer as jtrainer
from pointcloud_segmentation_attention_tpu.train.checkpoints import _flatten
from pointcloud_segmentation_attention_tpu.train.steps import seg_predict_step as jpredict
from pointcloud_segmentation_attention_tpu.train.train_state import create_state
from pointcloud_segmentation_attention_tpu.utils.config import TrainConfig as JConfig
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import ops as tops
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.eval import ResidentSceneServer
from pointcloud_segmentation_attention_tpu_torch.nn import attention as tatt
from pointcloud_segmentation_attention_tpu_torch.nn import layers as tlayers
from pointcloud_segmentation_attention_tpu_torch.train import (
    TrainState,
    export_jax_state,
    latest_checkpoint,
    load_jax_state,
    load_jax_variables,
    restore_checkpoint,
    seg_predict_step,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.bn_fold import (
    fold_batchnorm_for_inference,
)
from pointcloud_segmentation_attention_tpu_torch.train import schedules as tsched
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from test_torch_attention import _flax_flat, _t
from test_torch_model import TINY, _flat_variables, _unflatten
from test_torch_pointnet1 import _inputs as v1_inputs
from test_torch_pointnet1 import v1_variables
from test_torch_train import _batch, _capture, _check_step, _jax_flat, scene  # noqa: F401

BF16 = (jnp.bfloat16, torch.bfloat16)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
ARGMAX_SHARE = 0.99
BF16_GRAD_REL = 3e-2
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)


# ---- the products and the layers -------------------------------------------------

def test_mixed_matmul_has_float32_results_and_jax_backward():
    """The product is float32 and not a bf16 rounding of itself; its
    gradients are JAX's: each cotangent product rounded to bf16."""
    rng = np.random.RandomState(0)
    a = rng.randn(6, 3, 40).astype(np.float32)
    w = rng.randn(40, 5).astype(np.float32)
    at, wt = _t(a).requires_grad_(), _t(w).requires_grad_()
    out = tlayers.mixed_matmul(at, wt, torch.bfloat16)
    assert out.dtype == torch.float32 and out.shape == (6, 3, 5)
    assert not torch.equal(out, out.bfloat16().float())
    want = at.detach().bfloat16().float() @ wt.detach().bfloat16().float()
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), **LAYER_TOL)
    g = rng.randn(6, 3, 5).astype(np.float32)
    out.backward(_t(g))

    def f(a, w):
        return jnp.einsum("...i,io->...o", a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(w))
    ga, gw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), **LAYER_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **LAYER_TOL)
    assert torch.equal(at.grad, at.grad.bfloat16().float())  # rounded to bf16
    # float32 stays torch.matmul
    assert torch.equal(tlayers.mixed_matmul(at, wt), at @ wt)


def _layer_pair(kind, x, q):
    """(flax module, port module, positional inputs) of one layer in bf16."""
    jd, td = BF16
    c = x.shape[-1]
    if kind == "dense":
        return jlayers.Dense(24, compute_dtype=jd), tlayers.Dense(c, 24, td), [x]
    if kind == "pointconv":
        return (jlayers.PointConv(12, compute_dtype=jd),
                tlayers.PointConv(c, 12, compute_dtype=td), [x])
    if kind == "attention_pool":
        return (jatt.AttentionPool(output_dim=4, key_dim=4, num_heads=4, compute_dtype=jd),
                tatt.AttentionPool(c, q.shape[-1], 4, 4, 4, compute_dtype=td), [x, q])
    return (jatt.InnerAttention(output_dim=12, key_dim=4, compute_dtype=jd),
            tatt.InnerAttention(c, 12, 4, compute_dtype=td), [x])


@pytest.mark.parametrize("kind", ["dense", "pointconv", "attention_pool", "inner_attention"])
def test_bf16_layer_matches_jax(kind):
    """Output, input gradient and parameter gradients of one bf16 layer
    (``pointconv`` in train mode, its BN on batch statistics) through a fixed
    linear read-out, against JAX's; and the bf16 output is not the float32
    one."""
    rng = np.random.RandomState(len(kind))
    x = rng.randn(2, 5, 7, 16).astype(np.float32)
    q = rng.randn(2, 5, 1, 16).astype(np.float32)
    jmod, tmod, args = _layer_pair(kind, x, q)
    kw = dict(train=True) if kind == "pointconv" else {}
    flat = _flax_flat(jmod, args, **kw)
    variables = _unflatten(flat)
    load_jax_variables(flat, tmod)

    def japply(v, *a):
        if not kw:
            return jmod.apply(v, *a)
        return jmod.apply(v, *a, **kw, mutable=["batch_stats"])[0]

    want = np.asarray(jax.jit(japply)(variables, *map(jnp.asarray, args)))
    readout = rng.randn(*want.shape).astype(np.float32)
    grads = jax.jit(jax.grad(lambda v, *a: jnp.sum(japply(v, *a) * readout), argnums=(0, 1)))(
        variables, *map(jnp.asarray, args))
    tmod.train()
    x_t = _t(args[0]).requires_grad_()
    got = tmod(x_t, *map(_t, args[1:]))
    (got * _t(readout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **LAYER_TOL)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(grads[1]), **LAYER_TOL)
    g_want = {k: np.asarray(v) for k, v in _flatten(grads[0]["params"]).items()}
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[name.replace(".", "/")],
                                   err_msg=name, **LAYER_TOL)
    for m in tmod.modules():  # the same layer in float32
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    f32 = tmod(*map(_t, args)).detach().numpy()
    assert np.abs(f32 - want).max() > 1e-4  # the bf16 rounding shows


# ---- whole models ----------------------------------------------------------------

def _model_inputs(b, n, seed, features):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(b, n, 3) * EXTENT).astype(np.float32)
    return pts, (rng.rand(b, n, 6).astype(np.float32) if features else None)


@pytest.mark.parametrize("name", ["sem_seg_features", "sem_seg_attention",
                                  "pointnet1_cls_basic"])
def test_bf16_model_matches_jax(name):
    """Eval-mode forward of a bf16 model from the same seeded weights:
    within ``MODEL_TOL``, and ``ARGMAX_SHARE`` of the argmax equal."""
    jd, td = BF16
    if name.startswith("pointnet1"):
        _, flat = v1_variables(name)
        jm = jmodels.get_model(name, compute_dtype=jd)
        args = v1_inputs(name, 8, 128, seed=5)
        tm = tmodels.get_model(name, device="cpu", compute_dtype=td)
    else:
        pts, feats = _model_inputs(2, 256, 5, name == "sem_seg_features")
        args = (pts, feats)
        jm = jmodels.get_model(name, num_classes=21, compute_dtype=jd, **TINY)
        variables = jax.jit(lambda k, p, f: jm.init(k, p, f, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(pts[:1]), None if feats is None
            else jnp.asarray(feats[:1]))
        flat = _flat_variables(variables, 1)
        tm = tmodels.get_model(name, device="cpu", compute_dtype=td, **TINY)
    load_jax_variables(flat, tm)
    want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        _unflatten(flat), *(None if a is None else jnp.asarray(a) for a in args)))
    tm.eval()
    with torch.no_grad():
        got = tm(*(None if a is None else _t(a) for a in args)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= ARGMAX_SHARE


def test_bf16_train_step_matches_jax(scene):
    """One bf16 ``seg_train_step`` of the tiny flagship (dropout off) from
    the JAX state: loss, gradients, new parameters and BN statistics."""
    jd, td = BF16
    batch = _batch(scene, 2, 256, seed=60)
    jm = jmodels.get_model("sem_seg_features", num_classes=21, dropout_rate=0.0,
                           compute_dtype=jd, **TINY)
    tx = optax.chain(_capture(), optax.adam(jsched.scannet_learning_rate))
    state = create_state(jm, tx, jax.random.PRNGKey(0), jnp.asarray(batch["points"][:1]),
                         jnp.asarray(batch["features"][:1]), train=False)
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, 1)
    params = _unflatten({k[7:]: v for k, v in flat.items() if k.startswith("params/")})
    stats = _unflatten({k[12:]: v for k, v in flat.items() if k.startswith("batch_stats/")})
    jstate = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    before = _jax_flat(jstate, jstate.opt_state[1])
    tstate = TrainState(tmodels.get_model("sem_seg_features", device="cpu", dropout_rate=0.0,
                                          compute_dtype=td, **TINY))
    load_jax_state(before, tstate)
    jstate, jm_out = jax.jit(jsteps.seg_train_step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    tstate, tm_out = seg_train_step(tstate, batch)
    _check_step(before, _jax_flat(jstate, jstate.opt_state[1]), jm_out, jstate.opt_state[0],
                tstate, tm_out, tsched.scannet_learning_rate(0), BF16_GRAD_REL)
    for p in tstate.model.parameters():
        assert p.dtype == torch.float32


# ---- the registry, the kernels' inputs, the trainer ---------------------------------

@pytest.mark.parametrize("name", tmodels.available_models())
def test_every_registry_model_runs_bf16(name):
    """Each registry name builds with ``compute_dtype=torch.bfloat16`` and
    runs a CPU eval forward: float32 parameters and finite float32 outputs."""
    kw = {"layer_idx": 0} if name == "sem_seg_attention_single_layer" else {}
    model = tmodels.get_model(name, device="cpu", compute_dtype=torch.bfloat16, **kw)
    rng = np.random.RandomState(0)
    if name.startswith("pointnet1"):
        args = [_t(a) for a in v1_inputs(name, 2, 64, seed=0)]
    elif name.startswith("part_seg"):
        args = [_t(rng.rand(2, 64, 6).astype(np.float32))]
        if name == "part_seg_msg_one_hot":
            args.append(torch.tensor([1, 5]))
    else:
        args = [_t(rng.rand(2, 64, 3).astype(np.float32))]
        if name in ("sem_seg_features", "point_transformer_seg"):  # colors and normals
            args.append(_t(rng.rand(2, 64, 6).astype(np.float32)))
    model.eval()
    with torch.no_grad():
        out = model(*args)
    outs = [o for o in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(o)]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for o in outs:
        assert o.dtype == torch.float32 and torch.isfinite(o).all()


_KERNEL_OPS = ("farthest_point_sample", "gather_point", "ball_query",
               "group_point_with_counts", "three_nn", "three_interpolate")


def _record_dtypes(monkeypatch, module, seen, dtype_of):
    for op in _KERNEL_OPS:
        fn = getattr(module, op)

        def wrapped(*args, _fn=fn, _op=op, **kwargs):
            seen.extend((_op, dtype_of(a)) for a in args if hasattr(a, "dtype"))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, op, wrapped)


# The tiny flagship with every attention pooling at SA2-4.
POOLED = dict(TINY, sa_pooling=("max", "attention", "attention_and_pool", "attention_centroid"))


def test_kernel_inputs_stay_float32_under_bf16(monkeypatch, scene):
    """Every tensor that reaches a kernel wrapper (FPS, the gathers, ball
    query, three-NN, the interpolation) is float32 or an index under bf16,
    in a train step of the port and in JAX's train-mode forward and
    backward, traced (the dtypes are the trace's)."""
    jd, td = BF16
    t_seen, j_seen = [], []
    _record_dtypes(monkeypatch, tops, t_seen, lambda a: a.dtype)
    _record_dtypes(monkeypatch, jops, j_seen, lambda a: a.dtype)
    batch = _batch(scene, 2, 256, seed=61)
    pts, feats = jnp.asarray(batch["points"]), jnp.asarray(batch["features"])
    jm = jmodels.get_model("sem_seg_features", num_classes=21, compute_dtype=jd, **POOLED)

    def init_and_grad(key):
        variables = jm.init(key, pts, feats, train=False)

        def loss(params):
            out, _ = jm.apply({**variables, "params": params}, pts, feats, train=True,
                              mutable=["batch_stats"], rngs={"dropout": key})
            return jnp.sum(out)

        return jax.grad(loss)(variables["params"])

    jax.make_jaxpr(init_and_grad)(jax.random.PRNGKey(0))  # traced, not compiled
    seg_train_step(TrainState(tmodels.get_model("sem_seg_features", device="cpu",
                                                compute_dtype=td, **POOLED)), batch)
    assert {op for op, _ in t_seen} == {op for op, _ in j_seen} == set(_KERNEL_OPS)
    for op, dt in t_seen:
        assert dt == torch.float32 or not dt.is_floating_point, (op, dt)
    for op, dt in j_seen:
        assert dt == jnp.float32 or not jnp.issubdtype(dt, jnp.floating), (op, dt)


def test_train_config_bf16_runs_and_restores_in_jax(tmp_path, monkeypatch):
    """``train(TrainConfig(compute_dtype='bfloat16'))`` runs two steps on the
    CPU (the sampler input, no precompute); its checkpoint holds float32
    parameters that the JAX trainer's bf16 template restores."""
    root = str(tmp_path / "scannet")
    tscenes.write_synthetic_dataset(root, n_train=2, n_val=1, n_points=1500)
    tiny = {k: [list(v) if isinstance(v, tuple) else v for v in vals]
            if isinstance(vals, tuple) else vals for k, vals in TINY.items()}
    base = dict(data_root=root, log_dir=str(tmp_path / "logs"), compute_dtype="bfloat16",
                input="sampler", batch_size=2, n_points=256, epochs=2, n_epochs_to_val=1,
                save_every_epochs=1, model_overrides=tiny)
    cfg = TrainConfig(**base)
    monkeypatch.setattr(ttrainer, "MetricLogger",
                        functools.partial(ttrainer.MetricLogger, tensorboard=False))
    model = ttrainer.select_model(cfg, device="cpu")
    assert {m.compute_dtype for m in model.modules() if hasattr(m, "compute_dtype")} == \
        {torch.bfloat16}
    summary = ttrainer.train(cfg, max_steps=2, device="cpu")
    assert summary["final_step"] == 2 and np.isfinite(summary["final_train_loss"])
    path = latest_checkpoint(cfg.ckpt_dir)
    jstate = jckpt.restore_checkpoint(path, jtrainer.make_eval_state(JConfig(**base)))
    assert int(jstate.step) == 2
    tstate = restore_checkpoint(path, ttrainer.make_eval_state(cfg, device="cpu"))
    got = export_jax_state(tstate)
    for k, v in _flatten(jstate.params).items():
        assert np.asarray(v).dtype == np.float32
        np.testing.assert_array_equal(got["params/" + k], np.asarray(v), err_msg=k)


def test_bf16_bn_fold_matches_jax_and_serves():
    """BN folding is a parameter transform in both packages, the folded
    float32 kernel cast to bf16 at run time: the port's folded bf16 model
    matches JAX's folded bf16 state (``MODEL_TOL``, ``ARGMAX_SHARE``), and
    serves a room through ``ResidentSceneServer`` with the unfolded bf16
    model's labels (>= 99 %, bf16 rounding falls elsewhere once folded)."""
    jd, td = BF16
    rng = np.random.RandomState(9)
    pts = (rng.rand(2, 128, 3) * EXTENT).astype(np.float32)
    feats = rng.rand(2, 128, 6).astype(np.float32)
    jm = jmodels.get_model("sem_seg_features", num_classes=21, compute_dtype=jd, **TINY)
    state = create_state(jm, optax.adam(1e-3), jax.random.PRNGKey(0), jnp.asarray(pts[:1]),
                         jnp.asarray(feats[:1]), train=False)
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, 7)
    tree = _unflatten(flat)
    jfolded, jn = jfold(state.replace(params=tree["params"], batch_stats=tree["batch_stats"]))
    want = np.asarray(jpredict(jfolded, jnp.asarray(pts), jnp.asarray(feats)))
    tm = tmodels.get_model("sem_seg_features", device="cpu", compute_dtype=td, **TINY)
    load_jax_variables(flat, tm)
    folded, n = fold_batchnorm_for_inference(tm)
    assert n == jn
    got = seg_predict_step(folded, _t(pts), _t(feats)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= ARGMAX_SHARE
    scene = {"points": (rng.rand(2000, 3) * [5.0, 4.0, 2.5]).astype(np.float32),
             "colors": rng.randint(0, 256, (2000, 3)).astype(np.uint8),
             "normals": rng.rand(2000, 3).astype(np.float32)}
    kw = dict(batch_size=4, layout="f32", pad_multiple=2048, device="cpu")
    base = ResidentSceneServer(tm, 128, **kw).predict_scene(scene)
    fold = ResidentSceneServer(folded, 128, **kw).predict_scene(scene)
    assert base.shape == (2000,) and (base == fold).mean() >= ARGMAX_SHARE
