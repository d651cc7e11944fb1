"""Parity of the PyTorch port's training path with the JAX package.

The same seeded numpy inputs go through the JAX package (its XLA functions,
its Pallas backward kernels in interpret mode, its jitted train step) and
through the port on the CPU.  Each test states its tolerance and why.

Two facts shape the tolerances of the train-step tests:

- The bias of a ``PointConv`` that feeds a train-mode BatchNorm has an exact
  gradient of 0 (BN subtracts the batch mean); numerically it is rounding
  noise whose sign neither framework controls.  Adam's first update is
  ``lr * g / (|g| + eps)``, so such noise moves the parameter by up to lr in
  either direction.  New parameters are therefore held to twice Adam's
  largest step everywhere and tightly wherever the two gradients agree.
- A ReLU network's gradient is discontinuous in its forward values, so two
  float32 forwards that differ by rounding can route some gradient
  differently; gradients are compared per tensor in relative L2 (see
  ``test_seg_train_step_matches_jax`` for the measured sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu.data import pipeline as jpipeline
from pointcloud_segmentation_attention_tpu.data.scannet import chunks as jchunks
from pointcloud_segmentation_attention_tpu.ops import geometry as jgeo
from pointcloud_segmentation_attention_tpu.ops.pallas.group_gather_kernel import group_gather
from pointcloud_segmentation_attention_tpu.ops.pallas.interpolate_kernel import (
    three_interpolate_pallas,
)
from pointcloud_segmentation_attention_tpu.train import losses as jlosses
from pointcloud_segmentation_attention_tpu.train import metrics as jmetrics
from pointcloud_segmentation_attention_tpu.train import schedules as jsched
from pointcloud_segmentation_attention_tpu.train import steps as jsteps
from pointcloud_segmentation_attention_tpu.train.checkpoints import (
    _flatten,
    restore_checkpoint,
    save_checkpoint,
)
from pointcloud_segmentation_attention_tpu.train.train_state import create_state
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import ops as tops
from pointcloud_segmentation_attention_tpu_torch.data import pipeline as tpipeline
from pointcloud_segmentation_attention_tpu_torch.data.scannet import chunks as tchunks
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (
    make_synthetic_scene,
)
from pointcloud_segmentation_attention_tpu_torch.nn import PointConv
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as tgeo
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import refuse_grad
from pointcloud_segmentation_attention_tpu_torch.train import (
    TrainState,
    export_jax_state,
    load_jax_checkpoint,
    load_jax_state,
    load_jax_variables,
    save_jax_checkpoint,
    seg_eval_step,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train import losses as tlosses
from pointcloud_segmentation_attention_tpu_torch.train import metrics as tmetrics
from pointcloud_segmentation_attention_tpu_torch.train import schedules as tsched
from pointcloud_segmentation_attention_tpu_torch.train import steps as tsteps
from test_torch_model import TINY, _flat_variables, _unflatten

BWD_TOL = dict(rtol=1e-5, atol=1e-5)  # as tests/test_pallas_kernels.py holds the VJP
ADAM_MAX_STEP = 0.1 / np.sqrt(0.001)  # |Adam update| <= lr * (1 - b1) / sqrt(1 - b2)
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def rng():
    return np.random.RandomState(21)


# ---- the two backward kernels' plain versions ------------------------------

@pytest.mark.parametrize("radius", [0.05, 0.2, 0.9])  # empty, mixed, saturated balls
def test_group_point_backward_matches_jax(rng, radius):
    b, n, c, npoint, ns = 2, 300, 9, 40, 16
    xyz = (rng.rand(b, n, 3) * EXTENT * 0.3).astype(np.float32)
    pts = rng.rand(b, n, c).astype(np.float32)
    centres = tgeo.gather_point(_t(xyz), tgeo.farthest_point_sample(_t(xyz), npoint))
    idx, cnt = tgeo.ball_query(_t(xyz), centres, radius, ns)
    g = rng.randn(b, npoint, ns, c).astype(np.float32)
    if radius == 0.05:
        assert int(cnt.min()) <= 1
    if radius == 0.9:
        assert int(cnt.min()) == ns
    got = tgeo.group_point_backward(_t(g), idx, n).numpy()
    jidx, jcnt = jnp.asarray(idx.numpy()), jnp.asarray(cnt.numpy())
    _, vjp_pallas = jax.vjp(lambda p: group_gather(p, jidx, jcnt, True), jnp.asarray(pts))
    _, vjp_xla = jax.vjp(lambda p: jgeo.group_point(p, jidx), jnp.asarray(pts))
    np.testing.assert_allclose(got, np.asarray(vjp_pallas(jnp.asarray(g))[0]), **BWD_TOL)
    np.testing.assert_allclose(got, np.asarray(vjp_xla(jnp.asarray(g))[0]), **BWD_TOL)


@pytest.mark.parametrize("m,c", [(64, 12), (3, 5)])
def test_three_interpolate_backward_matches_jax(rng, m, c):
    b, n = 2, 256
    xyz1 = (rng.rand(b, n, 3) * EXTENT).astype(np.float32)
    xyz2 = (rng.rand(b, m, 3) * EXTENT).astype(np.float32)
    dist, idx = tgeo.three_nn(_t(xyz1), _t(xyz2))
    w = tgeo.interpolation_weights(dist).numpy()
    pts = rng.randn(b, m, c).astype(np.float32)
    g = rng.randn(b, n, c).astype(np.float32)
    dp, dw = tgeo.three_interpolate_backward(_t(g), idx, _t(w), _t(pts))
    jidx = jnp.asarray(idx.numpy())
    _, vjp = jax.vjp(lambda p, ww: three_interpolate_pallas(p, jidx, ww, True),
                     jnp.asarray(pts), jnp.asarray(w))
    want_dp, want_dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dp.numpy(), np.asarray(want_dp), **BWD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **BWD_TOL)


def test_backward_oracles_match_autograd(rng):
    """The explicit backward functions equal autograd of the plain forward
    to 1e-6 (the same sums, in another order)."""
    xyz = _t((rng.rand(2, 200, 3) * EXTENT * 0.3).astype(np.float32))
    pts = _t(rng.rand(2, 200, 7).astype(np.float32)).requires_grad_()
    centres = tgeo.gather_point(xyz, tgeo.farthest_point_sample(xyz, 30))
    idx, _ = tgeo.ball_query(xyz, centres, 0.2, 8)
    g = _t(rng.randn(2, 30, 8, 7).astype(np.float32))
    (want,) = torch.autograd.grad(tgeo.group_point(pts, idx), pts, g)
    torch.testing.assert_close(tgeo.group_point_backward(g, idx, 200), want,
                               rtol=1e-6, atol=1e-6)

    dist, nidx = tgeo.three_nn(xyz, centres)
    w = tgeo.interpolation_weights(dist).requires_grad_()
    feats = _t(rng.randn(2, 30, 11).astype(np.float32)).requires_grad_()
    g = _t(rng.randn(2, 200, 11).astype(np.float32))
    want_dp, want_dw = torch.autograd.grad(tgeo.three_interpolate(feats, nidx, w), (feats, w), g)
    dp, dw = tgeo.three_interpolate_backward(g, nidx, w.detach(), feats.detach())
    torch.testing.assert_close(dp, want_dp, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dw, want_dw, rtol=1e-6, atol=1e-6)


def test_kernel_without_backward_refuses_grad():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("three_nn", x)
    with torch.no_grad():
        refuse_grad("three_nn", x)
    refuse_grad("three_nn", x.detach())


# ---- losses, metrics, schedules, Adam --------------------------------------

@pytest.mark.parametrize("zero_weights", [False, True])
def test_losses_match_jax(rng, zero_weights):
    logits = (rng.randn(2, 50, 21) * 3).astype(np.float32)
    labels = rng.randint(0, 21, (2, 50)).astype(np.int32)
    weights = (rng.rand(2, 50) * (rng.rand(2, 50) > 0.3)).astype(np.float32)
    if zero_weights:
        weights[:] = 0.0
    got = tlosses.weighted_softmax_cross_entropy(_t(logits), _t(labels), _t(weights))
    want = jlosses.weighted_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                  jnp.asarray(weights))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tlosses.softmax_cross_entropy(_t(logits), _t(labels)).numpy(),
        np.asarray(jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.mean_softmax_cross_entropy(_t(logits), _t(labels))),
        float(jlosses.mean_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


def test_metrics_match_jax(rng):
    labels = rng.randint(0, 21, (3, 400)).astype(np.int32)
    preds = np.where(rng.rand(3, 400) < 0.6, labels, rng.randint(0, 21, (3, 400))).astype(np.int32)
    valid = labels > 0
    got = tmetrics.update_confusion(torch.ones(21, 21), _t(labels), _t(preds), _t(valid))
    want = jmetrics.update_confusion(jnp.ones((21, 21), jnp.float32), jnp.asarray(labels),
                                     jnp.asarray(preds), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        float(tmetrics.accuracy(_t(labels), _t(preds), _t(valid))),
        float(jmetrics.accuracy(jnp.asarray(labels), jnp.asarray(preds), jnp.asarray(valid))),
        rtol=1e-7)
    t_miou, t_iou = tmetrics.miou_from_confusion(got.numpy())
    j_miou, j_iou = jmetrics.miou_from_confusion(np.asarray(want))
    assert t_miou == j_miou
    np.testing.assert_array_equal(t_iou, j_iou)
    ts, js = tmetrics.StreamingMeanIoU(), jmetrics.StreamingMeanIoU()
    for s in (ts, js):
        s.update(labels, preds, valid)
        s.update_confusion(np.asarray(want))
    np.testing.assert_array_equal(ts.confusion, js.confusion)
    assert ts.result()[0] == js.result()[0]


# Around the staircase boundaries: 1201 scenes x 80 / batch 16 = 6005 steps
# per decay; upstream 200000 / 16 = 12500; far out, the LR floor of 1e-5.
@pytest.mark.parametrize("step", [0, 1, 6004, 6005, 6006, 12009, 12010, 12499, 12500,
                                  60049, 60050, 10 ** 6])
def test_schedules_match_jax(step):
    pairs = [(tsched.scannet_learning_rate, jsched.scannet_learning_rate),
             (tsched.scannet_bn_momentum, jsched.scannet_bn_momentum),
             (tsched.upstream_learning_rate, jsched.upstream_learning_rate),
             (tsched.upstream_bn_momentum, jsched.upstream_bn_momentum)]
    for port_fn, jax_fn in pairs:
        got = port_fn(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(jax_fn(step)), rtol=1e-6)
    assert tsched.scannet_learning_rate(10 ** 6) == float(np.float32(1e-5))
    assert tsched.scannet_bn_momentum(10 ** 6) == float(np.float32(0.99))


def test_adam_matches_optax(rng):
    """Three given gradients: the port's Adam (torch.optim.Adam with the LR
    set at the pre-increment step) against optax.adam with the same
    schedule, whose staircase drops between steps 1 and 2.  Parameters
    within rtol 1e-6 / atol 1e-9 (a few float32 ulps), moments likewise."""
    def lr(s):
        return jsched.scannet_learning_rate(s, 40, 1)

    init = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-4, 1)).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    tx = optax.adam(lr)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(_t(v)))
    state = TrainState(module, lr_schedule=lambda s: tsched.scannet_learning_rate(s, 40, 1))
    lrs = []
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state)
        params = optax.apply_updates(params, updates)
        for k, v in g.items():
            getattr(module, k).grad = _t(v)
        lrs.append(state.apply_gradients())
        for k in init:
            np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6, atol=1e-9)
    assert lrs[0] == lrs[1] == float(np.float32(1e-3)) and lrs[2] < lrs[1]
    flat = export_jax_state(state)
    for k, v in _flatten(opt_state).items():
        np.testing.assert_allclose(flat["opt_state/" + k], np.asarray(v), rtol=1e-6, atol=1e-12)


# ---- the data feeding the step ----------------------------------------------

@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(20000, seed=3)


def _random_chunks(mod, scene, rng, n_chunks, npoints, **kw):
    out = []
    for _ in range(n_chunks):
        p, lab, col, nrm, w = mod.sample_random_chunk(
            scene["points"], scene["labels"], scene["colors"], scene["normals"], npoints, rng,
            **kw)
        out.append({"points": p, "labels": lab, "colors": col, "normals": nrm, "weights": w})
    return out


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sample_random_chunk_matches_jax(scene):
    got = _random_chunks(tchunks, scene, np.random.RandomState(5), 4, 1024)
    want = _random_chunks(jchunks, scene, np.random.RandomState(5), 4, 1024)
    for g, w in zip(got, want):
        _assert_dicts_equal(g, w)
    # No features, a custom weight table, and a scene too sparsely labelled
    # for any try to pass (the last candidate is kept).
    table = np.linspace(0.0, 2.0, 21)
    sparse = dict(scene, labels=np.where(np.arange(len(scene["labels"])) % 3 == 0,
                                         scene["labels"], 0))
    for kw in (dict(weight_table=table), dict(chunk_size=0.8, margin=0.1)):
        got = tchunks.sample_random_chunk(sparse["points"], sparse["labels"], None, None, 256,
                                          np.random.RandomState(9), **kw)
        want = jchunks.sample_random_chunk(sparse["points"], sparse["labels"], None, None, 256,
                                           np.random.RandomState(9), **kw)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


def test_full_scene_chunks_weights_match_jax(scene):
    feats = [scene["labels"], scene["colors"], scene["normals"]]
    got = tchunks.full_scene_chunks(scene["points"], feats, npoints=2048,
                                    rng=np.random.RandomState(2), get_sample_weights=True)
    want = jchunks.full_scene_chunks(scene["points"], feats, True, 2048,
                                     np.random.RandomState(2))
    for field in ("points", "masks", "orig_idx", "weights"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.weights.dtype == np.float32
    for g, w in zip(got.features, want.features):
        np.testing.assert_array_equal(g, w)
    plain = tchunks.full_scene_chunks(scene["points"], feats, npoints=2048,
                                      rng=np.random.RandomState(2))
    assert plain.weights is None
    np.testing.assert_array_equal(plain.orig_idx, got.orig_idx)


@pytest.mark.parametrize("wire", ["f32", "compact"])
def test_make_batch_matches_jax(scene, wire):
    chunks = _random_chunks(tchunks, scene, np.random.RandomState(6), 3, 512)
    got = tpipeline.make_batch(chunks, True, True, wire)
    _assert_dicts_equal(got, jpipeline.make_batch(chunks, True, True, wire))
    _assert_dicts_equal(tpipeline.make_batch(chunks, False, True, wire),
                        jpipeline.make_batch(chunks, False, True, wire))
    expanded = tsteps.expand_wire_batch({k: _t(v) for k, v in got.items()})
    want = jsteps.expand_wire_batch({k: jnp.asarray(v) for k, v in got.items()})
    assert sorted(expanded) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(expanded[k].numpy(), np.asarray(want[k]), err_msg=k)
    # The packed formats are ported: the same bytes as the JAX package, and
    # decoding one needs its WireSpec.
    _assert_dicts_equal(tpipeline.make_batch(chunks, True, True, "packed_q16"),
                        jpipeline.make_batch(chunks, True, True, "packed_q16"))
    with pytest.raises(ValueError, match="wire_spec"):
        tsteps.expand_wire_batch({"packed": _t(np.zeros((1, 4), np.uint8))})


# ---- the train and eval steps -----------------------------------------------

def _capture():
    """An optax stage that keeps the step's gradients in its state and
    passes them on unchanged: chained before Adam it shows the gradients of
    the jitted JAX step itself."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _batch(scene, b, npoints, seed, features=True):
    """A batch of random chunks, with colors and normals or (``features``
    False) xyz only."""
    chunks = _random_chunks(tchunks, scene, np.random.RandomState(seed), b, npoints)
    return tpipeline.make_batch(chunks, features, features, "f32")


def _pair(kwargs, batch, capture, seed=0, name="sem_seg_features"):
    """(jax state, port state) of registry model ``name`` with the same
    seeded weights, dropout off."""
    jm = jmodels.get_model(name, num_classes=21, dropout_rate=0.0, **kwargs)
    adam = optax.adam(jsched.scannet_learning_rate)
    tx = optax.chain(_capture(), adam) if capture else adam
    feats = batch.get("features")
    state = create_state(jm, tx, jax.random.PRNGKey(seed), jnp.asarray(batch["points"][:1]),
                         None if feats is None else jnp.asarray(feats[:1]), train=False)
    flat = _flat_variables({"params": state.params, "batch_stats": state.batch_stats}, seed + 1)
    params = _unflatten({k[7:]: v for k, v in flat.items() if k.startswith("params/")})
    stats = _unflatten({k[12:]: v for k, v in flat.items() if k.startswith("batch_stats/")})
    jstate = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    tm = tmodels.get_model(name, device="cpu", dropout_rate=0.0, **kwargs)
    load_jax_variables(flat, tm)
    return jstate, TrainState(tm)


def _noise_biases(model):
    """Names of the biases whose exact gradient is 0: those of convolutions
    feeding a train-mode BN, and the affine bias of an attention pooling's
    BN (a constant shift of a channel that reaches the loss only through
    convolutions followed by a train-mode BN)."""
    return {name + ".bias" for name, mod in model.named_modules()
            if (isinstance(mod, PointConv) and mod.bn is not None)
            or name.endswith("attention_bn")}


def _jax_flat(jstate, adam) -> dict:
    """A JAX train state under ``save_checkpoint``'s keys (``adam`` is the
    optax.adam part of its optimizer state)."""
    flat = {f"params/{k}": np.asarray(v) for k, v in _flatten(jstate.params).items()}
    flat.update({f"batch_stats/{k}": np.asarray(v)
                 for k, v in _flatten(jstate.batch_stats).items()})
    flat.update({f"opt_state/{k}": np.asarray(v) for k, v in _flatten(adam).items()})
    flat["step"] = np.asarray(jstate.step)
    return flat


def _check_step(before, after, jm, grads, tstate, tm, lr, grad_rel):
    """One step of the port from the JAX state ``before`` against the JAX
    step to ``after`` (flat keys; ``grads`` the JAX step's gradients).

    Loss rtol 1e-5; BN statistics rtol = atol = 1e-5.  Gradients: per tensor
    ``||g - g_jax|| <= grad_rel * ||g_jax||``; the noise biases below 1e-5
    of the model's largest gradient on both sides.  New parameters: within
    twice Adam's largest step of each other everywhere, and rtol 1e-5 /
    atol 1e-6 wherever the two gradients agree to 1 % (there Adam's update
    is determined)."""
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    model = tstate.model
    noise = _noise_biases(model)
    got = export_jax_state(tstate)
    g_want = {"params/" + k: np.asarray(v) for k, v in _flatten(grads).items()}
    g_max = max(np.abs(v).max() for v in g_want.values())
    for name, p in model.named_parameters():
        key = "params/" + name.replace(".", "/")
        g, g_got = g_want[key], p.grad.numpy()
        if name in noise:
            assert max(np.abs(g_got).max(), np.abs(g).max()) < 1e-5 * g_max, key
            firm = np.zeros(g.shape, bool)
        else:
            rel = np.linalg.norm(g_got - g) / np.linalg.norm(g)
            assert rel <= grad_rel, (key, rel)
            firm = (np.abs(g_got - g) <= 0.01 * np.abs(g)) & (np.abs(g) >= 1e-6)
        assert np.abs(got[key] - after[key]).max() <= 2 * ADAM_MAX_STEP * lr, key
        np.testing.assert_allclose(got[key][firm], after[key][firm], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for name, _ in model.named_buffers():
        key = "batch_stats/" + name.replace(".", "/")
        np.testing.assert_allclose(got[key], after[key], rtol=1e-5, atol=1e-5, err_msg=key)


# Gradient tolerance (per-tensor relative L2).  A ReLU network's gradient
# is discontinuous in its forward values: where a ReLU input or a max-pool
# choice lies within rounding of its switch, XLA's and PyTorch's float32
# forwards may pick differently.  At full width and B1 x 2048 this moves the
# gradients by up to 1.2e-2 between the frameworks, while each framework's
# float32 gradient is itself 2.8e-3 (port) and 1.1e-2 (JAX) from a float64
# run of the port; summation order in the backward alone moves them by 2e-6.
@pytest.mark.parametrize("config,b,npoints,steps,grad_rel", [
    ("tiny", 2, 256, 3, 1e-4),
    ("full", 1, 2048, 1, 3e-2),  # registry widths: npoint 1024/256/64/16, nsample 32
])
def test_seg_train_step_matches_jax(scene, config, b, npoints, steps, grad_rel):
    kwargs = TINY if config == "tiny" else {}
    tstate = train_steps_match_jax(scene, "sem_seg_features", kwargs, b, npoints, steps,
                                   grad_rel)
    with pytest.raises(ValueError, match="remat"):
        seg_train_step(tstate, _batch(scene, b, npoints, seed=30), remat="bogus")


def train_steps_match_jax(scene, name, kwargs, b, npoints, steps, grad_rel, features=True):
    """``steps`` steps of registry model ``name``, each held to the JAX step
    by ``_check_step``; before each, the port takes the JAX state through
    the checkpoint bridge, so every step starts from the same state (Adam's
    counts and the schedules advance with it).  Returns the port's state."""
    batches = [_batch(scene, b, npoints, seed=30 + s, features=features) for s in range(steps)]
    jstate, tstate = _pair(kwargs, batches[0], capture=True, name=name)
    jstep = jax.jit(jsteps.seg_train_step)
    for s, batch in enumerate(batches):
        before = _jax_flat(jstate, jstate.opt_state[1])
        load_jax_state(before, tstate)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        tstate, tm = seg_train_step(tstate, batch)
        assert tstate.step == int(jstate.step) == s + 1
        assert tm["learning_rate"] == pytest.approx(float(jm["learning_rate"]), rel=1e-7)
        _check_step(before, _jax_flat(jstate, jstate.opt_state[1]), jm, jstate.opt_state[0],
                    tstate, tm, tsched.scannet_learning_rate(s), grad_rel)
        np.testing.assert_array_equal(tm["confusion"].sum(1).numpy(),
                                      np.asarray(jm["confusion"]).sum(1))
    return tstate


def test_seg_eval_step_matches_jax(scene):
    batch = _batch(scene, 2, 256, seed=40)
    jstate, tstate = _pair(TINY, batch, capture=False)
    want = jax.jit(jsteps.seg_eval_step)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = seg_eval_step(tstate, batch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    # Logits agree to ~1e-6 here and no argmax is that close to a tie.
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    assert float(got["accuracy"]) == pytest.approx(float(want["accuracy"]), rel=1e-7)
    assert tstate.model.training


def test_checkpoint_bridge_carries_adam_state(scene, tmp_path):
    """A JAX checkpoint written after one JAX step loads into the port
    (parameters, BN statistics, Adam's moments and counts); one more step
    matches in both; the port's export round-trips exactly and the JAX
    package restores the port's checkpoint."""
    b1, b2 = _batch(scene, 2, 256, seed=50), _batch(scene, 2, 256, seed=51)
    jstate, _ = _pair(TINY, b1, capture=False)
    jstep = jax.jit(jsteps.seg_train_step)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b1.items()}, jax.random.PRNGKey(0))
    path = save_checkpoint(str(tmp_path / "jax"), jstate, step=1)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    assert {"opt_state/0/.count", "opt_state/1/.count"} <= set(flat)

    tstate = TrainState(tmodels.get_model("sem_seg_features", device="cpu", dropout_rate=0.0,
                                          **TINY))
    load_jax_checkpoint(path, tstate)
    assert tstate.step == 1
    back = export_jax_state(tstate)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    # One more step in both, from the same state (the noise rule for one
    # step); the JAX step runs with the gradient capture in front of Adam.
    captured = jstate.replace(
        tx=optax.chain(_capture(), jstate.tx),
        opt_state=(jax.tree_util.tree_map(jnp.zeros_like, jstate.params), jstate.opt_state))
    captured, jm = jstep(captured, {k: jnp.asarray(v) for k, v in b2.items()},
                         jax.random.PRNGKey(0))
    tstate, tm = seg_train_step(tstate, b2)
    after = _jax_flat(captured, captured.opt_state[1])
    _check_step(flat, after, jm, captured.opt_state[0], tstate, tm,
                tsched.scannet_learning_rate(1), grad_rel=1e-4)
    got = export_jax_state(tstate)
    for k in ("opt_state/0/.count", "opt_state/1/.count"):
        assert int(got[k]) == int(after[k]) == 2

    # The port's checkpoint restores into the JAX package's template state.
    port_path = save_jax_checkpoint(str(tmp_path / "port.npz"), tstate)
    restored = restore_checkpoint(port_path, jstate)
    assert int(restored.step) == 2
    for section in ("params", "batch_stats", "opt_state"):
        for k, v in _flatten(getattr(restored, section)).items():
            np.testing.assert_array_equal(np.asarray(v), got[f"{section}/{k}"], err_msg=k)


# ---- on the card: autograd through the kernels ------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_autograd_through_kernels_matches_plain(cuda_device, rng):
    """Backward kernels against the plain versions, and a train-mode
    SemSegNet's parameter gradients on the card against the CPU path."""
    xyz = _t((rng.rand(2, 2048, 3) * EXTENT).astype(np.float32)).to(cuda_device)
    centres = tgeo.gather_point(xyz, tops.farthest_point_sample(xyz, 256))
    idx, _ = tops.ball_query(xyz, centres, 0.2, 32)
    g = torch.randn(2, 256, 32, 67, device=cuda_device)
    from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
        group_gather,
        three_interpolate,
    )

    # Both backwards' dP sum in the CPU's index_add_ order: bit-identical to CPU copies.
    torch.testing.assert_close(group_gather.group_point_backward(g, idx, 2048).cpu(),
                               tgeo.group_point_backward(g.cpu(), idx.cpu(), 2048),
                               rtol=0, atol=0)
    dist, nidx = tops.three_nn(xyz, centres)
    w = tgeo.interpolation_weights(dist)
    feats = torch.randn(2, 256, 128, device=cuda_device)
    g = torch.randn(2, 2048, 128, device=cuda_device)
    dp, dw = three_interpolate.three_interpolate_backward(g, nidx, w, feats)
    pdp, pdw = tgeo.three_interpolate_backward(g.cpu(), nidx.cpu(), w.cpu(), feats.cpu())
    torch.testing.assert_close(dp.cpu(), pdp, rtol=0, atol=0)
    torch.testing.assert_close(dw.cpu(), pdw, **BWD_TOL)

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = tmodels.seeded_model("sem_seg_features", seed=0, device="cpu", dropout_rate=0.0,
                               **TINY)
    card = tmodels.seeded_model("sem_seg_features", seed=0, device=cuda_device,
                                dropout_rate=0.0, **TINY)
    pts = (rng.rand(2, 512, 3) * EXTENT).astype(np.float32)
    fts = rng.rand(2, 512, 6).astype(np.float32)
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        model.train()
        model(_t(pts).to(dev), _t(fts).to(dev)).square().mean().backward()
    noise = _noise_biases(cpu)
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if name not in noise:
            torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-3,
                                       atol=1e-5 * float(p.grad.abs().max()))
