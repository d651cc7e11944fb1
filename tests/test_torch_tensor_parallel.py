"""The port's tensor parallelism on the CPU: the counterparts of
``tests/test_tensor_parallel.py``, on four gloo ranks (one
``parallel.RankPool(4, device="cpu", threads=1)`` for the module) at the JAX
file's tiny widths (SA npoints 16/8/4/2, nsample 4, widths 8) of the
flagship with colors and normals, as ``tests/test_torch_parallel.py`` runs
it (xyz alone, as the JAX file's ``sem_seg`` takes it, leaves the first
level's BN inputs so narrow that the noise biases read 1e-3 of the largest
gradient in both worlds), and B8 x 64 chunks of a synthetic room.
Tolerances, and why:

- the sharding rule: equal to JAX's ``state_sharding`` parameter for
  parameter;
- the 2 x 2 step against world size 1 from the same weights and batch,
  dropout on (``tests/test_torch_parallel.py``'s limits): loss rtol 1e-6,
  confusion equal, BN running statistics rtol 1e-5 / atol 1e-6, gradients
  1e-4 in relative L2 a tensor, and the parameters after Adam (gathered by
  ``unshard_state``) rtol 1e-5 / atol 1e-6 wherever Adam's update is
  determined (the two gradients agree to 1 %, as
  ``test_torch_train._check_step`` holds them) and within twice Adam's
  largest step everywhere.  The gradients whose exact value is 0 are
  rounding noise in both worlds, which Adam turns into steps of up to
  ``lr``: the noise biases (a convolution's bias before a train-mode BN)
  are held below 1e-5 of the largest gradient instead, and other elements
  whose exact gradient is 0 fall outside the determined elements;
- the 2 x 2 step against JAX's ``model_parallel_jit`` on ``make_mesh_2d(2,
  2)`` of the virtual CPU devices, from the same weights, dropout off: loss
  rtol 1e-5 (``test_torch_train``'s limit between the frameworks);
- predictions: labels equal, logits rtol 1e-5 / atol 1e-6;
- checkpoints: bit for bit;
- the other layer kinds (attention poolings, the attention nets' ``Dense``
  chains, the T-Net's ``transform_w``, a sharded 50-class classifier), a
  train-mode forward and backward on 2 x 2: outputs rtol = atol = 1e-4,
  kernel gradients 1e-4 in relative L2 at the tiny widths and 3e-2 at the
  registry's full widths (``tests/test_torch_train.py``'s full-width limit
  between two float32 forwards: a ReLU and max-pool network routes some
  gradient differently for forwards that differ by rounding).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pointcloud_segmentation_attention_tpu import models as jmodels
from pointcloud_segmentation_attention_tpu import parallel as jparallel
from pointcloud_segmentation_attention_tpu.train import checkpoints as jckpt
from pointcloud_segmentation_attention_tpu.train import schedules as jsched
from pointcloud_segmentation_attention_tpu.train import steps as jsteps
from pointcloud_segmentation_attention_tpu.train.train_state import create_state
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import parallel
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.nn import PointConv
from pointcloud_segmentation_attention_tpu_torch.parallel import dist_selftest, tp
from pointcloud_segmentation_attention_tpu_torch.train import (
    TrainState,
    checkpoints,
    export_jax_state,
    restore_checkpoint,
)
from test_torch_model import _flatten
from test_torch_parallel_ranks import forward_backward
from test_torch_parallel_ranks import one_thread  # noqa: F401 (an autouse fixture)
from test_torch_train import _batch, _pair

TINY = dict(sa_npoints=(16, 8, 4, 2), sa_radii=(0.1, 0.2, 0.4, 0.8), sa_nsample=4,
            sa_mlps=((8, 8), (8, 8), (8, 8), (8, 8)), fp_mlps=((8,), (8,), (8,), (8, 8)))
NAME = "sem_seg_features"
RANKS = 4
NOISE_REL = 1e-5
ADAM_MAX_STEP = 0.1 / np.sqrt(0.001)  # |Adam update| <= lr * (1 - b1) / sqrt(1 - b2)


@pytest.fixture(scope="module")
def pool():
    with parallel.RankPool(RANKS, device="cpu", threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def batch():
    return _batch(tscenes.make_synthetic_scene(4000, seed=9), 8, 64, seed=31)


@pytest.fixture(scope="module")
def outcomes(pool, batch):
    """World size 1 and the tensor-parallel steps (dropout on), made once
    and shared: ``outcomes(n_model)`` runs ``n_model``'s step on the first
    call."""
    kw = dict(model_name=NAME, model_kw=TINY, seed=2, dropout_seed=5, device="cpu")
    made = {None: dist_selftest.step_outcome(batch, **kw)}

    def get(n_model):
        if n_model not in made:
            made[n_model] = pool.run(dist_selftest.step_outcome, batch, n_model=n_model, **kw)
        return made[n_model]

    return get


def _noise_biases(model) -> set:
    return {name + ".bias" for name, mod in model.named_modules()
            if isinstance(mod, PointConv) and mod.bn is not None}


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


@pytest.mark.parametrize("n_model", [2, 4])
def test_state_sharding_rule_matches_jax(n_model):
    """The port shards exactly the parameters that JAX's ``state_sharding``
    shards over 'model' (names through the checkpoint bridge), and
    replicates every other parameter and BN statistic."""
    jmodel = jmodels.get_model(NAME, num_classes=21, **TINY)
    jstate = create_state(jmodel, optax.adam(1e-3), jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)),
                          jnp.zeros((1, 64, 6)), train=False)
    jsh = jparallel.state_sharding(jstate, jparallel.make_mesh_2d(8 // n_model, n_model))
    want = {}
    for section in ("params", "batch_stats"):
        for path, s in jax.tree_util.tree_flatten_with_path(getattr(jsh, section))[0]:
            want[f"{section}/{_path(path)}"] = tuple(s.spec)
    tmodel = tmodels.get_model(NAME, device="cpu", **TINY)
    got_by_name = parallel.state_sharding(tmodel, parallel.make_mesh_2d(1, n_model, device="cpu"))
    got = {k: got_by_name[name] for k, name in checkpoints._jax_keys(tmodel).items()}
    assert sorted(got) == sorted(want)
    sharded = {k for k, s in want.items() if s and s[-1] == "model"}
    assert sharded == {k for k, s in got.items() if s and s[-1] == "model"}
    assert "params/fc2/kernel" not in sharded and "params/fc1/kernel" in sharded
    assert all(got[k] == () for k in got if k not in sharded)


def _hold_tp(one: dict, ranks: list, noise: set) -> None:
    """Every rank of a tensor-parallel step against world size 1 (the
    module's docstring), and the ranks hold one replica."""
    lr = jsched.scannet_learning_rate(0)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_array_equal(r["confusion"], one["confusion"])
        assert r["accuracy"] == pytest.approx(one["accuracy"], rel=1e-6)
        for k in one["buffers"]:
            np.testing.assert_allclose(r["buffers"][k], one["buffers"][k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        g_max = max(np.abs(g).max() for k, g in one["grads"].items() if k not in noise)
        for k, g in one["grads"].items():
            got = r["grads"][k]
            assert got.shape == g.shape, k
            if k in noise:
                assert max(np.abs(got).max(), np.abs(g).max()) < NOISE_REL * g_max, k
                continue
            rel = np.linalg.norm(got - g) / np.linalg.norm(g)
            assert rel <= 1e-4, (k, rel)
            firm = (np.abs(got - g) <= 0.01 * np.abs(g)) & (np.abs(g) >= 1e-6)
            p, q = r["params"][k], one["params"][k]
            assert np.abs(p - q).max() <= 2 * ADAM_MAX_STEP * lr, k
            np.testing.assert_allclose(p[firm], q[firm], rtol=1e-5, atol=1e-6, err_msg=k)
    for r in ranks[1:]:
        for k in ranks[0]["params"]:
            np.testing.assert_array_equal(r["params"][k], ranks[0]["params"][k], err_msg=k)


def test_tp_step_matches_world1(outcomes):
    """One ``seg_train_step`` on a 2 x 2 mesh (``model_parallel``), dropout
    on: every rank computes world size 1's step."""
    one, ranks = outcomes(None), outcomes(2)
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["world_size"] for r in ranks] == [2] * RANKS
    model = tmodels.get_model(NAME, device="cpu", **TINY)
    _hold_tp(one, ranks, _noise_biases(model))


def test_tp_step_matches_jax_model_parallel(pool, batch):
    """The port's 2 x 2 step against ``model_parallel_jit(seg_train_step,
    make_mesh_2d(2, 2))`` of the JAX package, from JAX's weights carried
    over (numpy -> ``load_jax_variables`` -> ``shard_state`` on the ranks),
    dropout off."""
    jstate, tstate = _pair(TINY, batch, capture=False, name=NAME)
    mesh = jparallel.make_mesh_2d(2, 2)
    jstep = jparallel.model_parallel_jit(jsteps.seg_train_step, mesh, jstate, batch_argnums=(1,))
    _, jm = jstep(jparallel.shard_state(jstate, mesh),
                  jparallel.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
                  jax.random.PRNGKey(0))
    state_dict = {k: v.numpy() for k, v in tstate.model.state_dict().items()}
    ranks = pool.run(dist_selftest.step_outcome, batch, model_name=NAME,
                     model_kw=dict(TINY, dropout_rate=0.0), state_dict=state_dict, n_model=2,
                     device="cpu")
    for r in ranks:
        np.testing.assert_allclose(r["loss"][0], float(jm["loss"]), rtol=1e-5)


def test_tp_parameter_memory_sharded():
    """Per-rank parameter + Adam bytes of the flagship (colors and normals)
    at n_model 4 fall below half the full state's, and a sharded kernel's
    block is exactly 1/n_model of it; in one process, at each model
    coordinate (``make_mesh_2d(coords=)``)."""
    n_model = 4
    full_state = TrainState(tmodels.get_model(NAME, device="cpu"))
    full = tp.state_bytes(full_state)
    kernel = full_state.model.sa1.mlp.conv0.kernel
    for m in range(n_model):
        state = copy.deepcopy(full_state)
        mesh = parallel.make_mesh_2d(1, n_model, device="cpu", coords=(0, m))
        assert parallel.shard_state(state, mesh) is state
        assert tp.state_bytes(state) < 0.5 * full, (tp.state_bytes(state), full)
        block = state.model.sa1.mlp.conv0.kernel
        assert block.numel() * n_model == kernel.numel() and block.is_contiguous()
        c = kernel.shape[-1] // n_model
        np.testing.assert_array_equal(block.detach().numpy(),
                                      kernel.detach().numpy()[:, m * c:(m + 1) * c])
        params = set(state.model.parameters())
        assert set(state.optimizer.state) == params  # no stale optimizer keys
        for p in params:
            assert state.optimizer.state[p]["exp_avg"].shape == p.shape
        assert state.model.fc2.kernel.shape == (128, 21)  # replicated: 21 does not divide


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_collective_audit(outcomes, n_model):
    """The counterpart of ``test_tp_hlo_no_full_kernel_allgathers`` (2 x 2
    and 1 x 4): no all-gather rebuilds a full weight kernel, none has a
    rank-2 (weight-shaped) result, every one is led by the rank's batch; the
    gradient all-reduce runs."""
    ranks = outcomes(n_model)
    model = tmodels.get_model(NAME, device="cpu", **TINY)
    kernels = [tuple(p.shape) for p in model.parameters()
               if p.dim() >= 2 and p.shape[-1] % n_model == 0]
    assert kernels
    rows = 8 // (RANKS // n_model)
    for r in ranks:
        stats = r["collectives"]
        assert parallel.full_kernel_allgathers(stats, kernels) == []
        shapes = stats["all-gather"]["shapes"]
        assert shapes and all(len(s) != 2 and s[0] == rows for s in shapes), shapes
        assert stats["all-reduce"]["count"] > 0 and stats["reduce-scatter"]["count"] > 0


def test_tp_predict_matches_world1(pool, batch):
    """``seg_predict_step`` under ``model_parallel`` on 2 x 2, from seeded
    weights and BN statistics: each rank's rows' labels equal world size
    1's."""
    state_dict = {k: v.numpy() for k, v in
                  tmodels.seeded_model(NAME, seed=4, device="cpu", **TINY).state_dict().items()}
    kw = dict(model_name=NAME, model_kw=TINY, state_dict=state_dict, device="cpu")
    one = dist_selftest.predict_outcome(batch["points"], batch["features"], **kw)
    ranks = pool.run(dist_selftest.predict_outcome, batch["points"], batch["features"],
                     n_model=2, **kw)
    for r in ranks:
        a, b = r["rows"]
        np.testing.assert_array_equal(r["labels"], one["labels"][a:b])
        np.testing.assert_allclose(r["logits"], one["logits"][a:b], rtol=1e-5, atol=1e-6)
        assert r["collectives"]["all-gather"]["count"] > 0


def test_tp_checkpoint_restores_in_world1_and_jax(pool, batch, tmp_path):
    """A 2 x 2 state saved by ``save_checkpoint`` (every rank; the rank at
    (0, 0) writes) holds the full arrays: world size 1's restore and the JAX
    package's ``restore_checkpoint`` read them bit for bit, and they equal
    the ranks' gathered parameters."""
    ranks = pool.run(dist_selftest.step_outcome, batch, model_name=NAME, model_kw=TINY,
                     seed=2, dropout_seed=5, n_model=2, checkpoint_dir=str(tmp_path),
                     device="cpu")
    path = checkpoints.latest_checkpoint(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_00000001.json",
                                                           "ckpt_00000001.npz"]
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    state = restore_checkpoint(path, TrainState(tmodels.get_model(NAME, device="cpu", **TINY)))
    assert state.step == 1
    back = export_jax_state(state)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    for name, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(flat["params/" + name.replace(".", "/")], value)
    jmodel = jmodels.get_model(NAME, num_classes=21, **TINY)
    template = create_state(jmodel, optax.adam(jsched.scannet_learning_rate),
                            jax.random.PRNGKey(1), jnp.zeros((1, 64, 3)), jnp.zeros((1, 64, 6)),
                            train=False)
    jstate = jckpt.restore_checkpoint(path, template)
    assert int(jstate.step) == 1
    for section in ("params", "batch_stats", "opt_state"):
        for k, v in _flatten(getattr(jstate, section)).items():
            np.testing.assert_array_equal(np.asarray(v), flat[f"{section}/{k}"], err_msg=k)


# name -> (model kwargs, B, N, input channels, kernel-gradient limit)
FAMILIES = {
    "sem_seg_attention": (dict(TINY, dropout_rate=0.0), 4, 64, 3, 1e-4),
    "attention_net": (dict(dropout_rate=0.0), 4, 1024, 3, 3e-2),
    "pointnet1_cls": (dict(dropout_rate=0.0), 4, 32, 3, 3e-2),
    "part_seg": (dict(dropout_rate=0.0), 4, 512, 6, 3e-2),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_tp_forward_backward_other_layers(pool, name):
    """The column-parallel forms of every other layer that holds a sharded
    kernel, through the registry models that hold them: attention poolings
    (``sem_seg_attention``), the attention nets' inner attention and
    feed-forward ``Dense`` chains (``attention_net``), the T-Nets'
    ``transform_w`` (``pointnet1_cls``: K 64 divides, K 3 does not) and a
    sharded classifier (``part_seg``'s 50 classes).  One train-mode forward
    and backward on 2 x 2 against world size 1."""
    kw, b, n, c, grad_rel = FAMILIES[name]
    chunk = _batch(tscenes.make_synthetic_scene(20000, seed=9), b, n, seed=31)
    inputs = (chunk["points"] if c == 3 else
              np.concatenate([chunk["points"], chunk["features"][..., 3:]], -1),)
    shapes = [o.shape for o in forward_backward(name, kw, inputs, ())["outputs"]]
    rng = np.random.RandomState(0)
    weights = tuple(rng.rand(*sh).astype(np.float32) for sh in shapes)
    one = forward_backward(name, kw, inputs, weights)
    ranks = pool.run(forward_backward, name, kw, inputs, weights, n_model=2)
    sharded = {k for k, spec in parallel.state_sharding(
        tmodels.get_model(name, device="cpu", **kw),
        parallel.make_mesh_2d(2, 2, device="cpu")).items() if spec}
    assert sharded
    for r in ranks:
        a, z = r["rows"]
        for got, want in zip(r["outputs"], one["outputs"]):
            np.testing.assert_allclose(got, want[a:z], rtol=1e-4, atol=1e-4)
        for k in sharded:
            g, diff = one["grads"][k], np.linalg.norm(r["grads"][k] - one["grads"][k])
            assert diff <= grad_rel * np.linalg.norm(g), (k, diff, np.linalg.norm(g))
