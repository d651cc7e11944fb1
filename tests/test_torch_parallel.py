"""The port's data parallelism on the CPU: world size 2 against world size 1,
against the JAX package's ``data_parallel_jit`` on two virtual devices, the
global loss normaliser, the collective audit, ``host_shard``, the
two-process self-test and the build lock.

Two gloo ranks (``parallel.RankPool``) with one thread each are shared
with the other data-parallel test modules of the process
(``test_torch_parallel_ranks.shared_pool``).  The module's first test
starts them, and the processes of the two-process self-test and of the
concurrent build, so that they start up while the JAX programs compile.
Tolerances, and why:

- world 2 against world 1 from the same weights and global batch, dropout
  on: loss rtol 1e-6, confusion equal, BN running statistics rtol 1e-5 /
  atol 1e-6, and the parameters after one Adam step rtol 1e-5 / atol 1e-6.
  The biases whose exact gradient is 0 (``_noise_biases``: those feeding a
  train-mode BN) are rounding noise in both worlds, which Adam turns into
  steps of up to ``lr``; they are held below 1e-5 of the largest gradient
  instead, as ``tests/test_torch_train.py`` holds them;
- world 2 against JAX: ``tests/test_torch_train.py``'s train-step limits
  (``_check_step``: loss rtol 1e-5, BN statistics 1e-5, gradients rel L2
  1e-4 a tensor, new parameters rtol 1e-5 / atol 1e-6 where the gradients
  agree).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu import parallel as jparallel
from pointcloud_segmentation_attention_tpu.parallel.dist import host_shard as jhost_shard
from pointcloud_segmentation_attention_tpu.train import losses as jlosses
from pointcloud_segmentation_attention_tpu.train import schedules as jsched
from pointcloud_segmentation_attention_tpu.train import steps as jsteps
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import native, parallel
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.nn import PointConv, ScheduledBatchNorm
from pointcloud_segmentation_attention_tpu_torch.parallel import dist_selftest
from test_torch_parallel_ranks import (  # noqa: F401 (one_thread: an autouse fixture)
    one_thread,
    rows_of_draw,
    shared_pool,
    weighted_ce_total,
)
from pointcloud_segmentation_attention_tpu_torch.train import TrainState
from test_torch_model import TINY
from test_torch_train import _batch, _check_step, _jax_flat, _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISE_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def pool(request):
    return shared_pool(request.config)


@pytest.fixture(scope="module")
def scene():
    return tscenes.make_synthetic_scene(4000, seed=9)


def _unequal(batch: dict) -> dict:
    """The batch with most weights of its second half zeroed: rank 0 and
    rank 1 hold different counts of non-zero weights."""
    out = dict(batch)
    w = batch["weights"].copy()
    half = len(w) // 2
    w[half:, : w.shape[1] * 3 // 4] = 0.0
    out["weights"] = w
    return out


def _noise_biases(model) -> set:
    return {name + ".bias" for name, mod in model.named_modules()
            if (isinstance(mod, PointConv) and mod.bn is not None)
            or name.endswith("attention_bn")}


def _hold_worlds(one: dict, two: list, noise: set) -> None:
    """World size 2's ranks against world size 1 (see the module's
    docstring)."""
    for r in two:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_array_equal(r["confusion"], one["confusion"])
        assert r["accuracy"] == pytest.approx(one["accuracy"], rel=1e-6)
        for k in one["buffers"]:
            np.testing.assert_allclose(r["buffers"][k], one["buffers"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        g_max = max(np.abs(g).max() for k, g in one["grads"].items() if k not in noise)
        for k in one["params"]:
            if k in noise:
                assert max(np.abs(r["grads"][k]).max(), np.abs(one["grads"][k]).max()) \
                    < NOISE_REL * g_max, k
                continue
            np.testing.assert_allclose(r["params"][k], one["params"][k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for k in two[0]["params"]:  # the ranks hold one replica
        np.testing.assert_array_equal(two[0]["params"][k], two[1]["params"][k])


def _start_selftest(workdir: str) -> list:
    """The two processes of the self-test, joined by ``initialize_distributed``
    (gloo, the JAX package's environment variables)."""
    tscenes.write_synthetic_dataset(os.path.join(workdir, "scannet"), n_train=4, n_val=0,
                                    n_test=0, n_points=4000)
    port = parallel.mesh._free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                   PROCESS_ID=str(pid), GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pointcloud_segmentation_attention_tpu_torch.parallel."
             "dist_selftest", "--workdir", workdir, "--npoints", "64", "--device", "cpu"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module", autouse=True)
def processes(tmp_path_factory):
    """The self-test's and the concurrent build's processes, started with
    the module and read by their tests."""
    selftest_dir = str(tmp_path_factory.mktemp("dist_selftest"))
    root = tmp_path_factory.mktemp("concurrent_build")
    build_dir, log = str(root / "_build"), str(root / "compiles.txt")
    procs = dict(
        selftest=(selftest_dir, _start_selftest(selftest_dir)),
        build=(build_dir, log, [subprocess.Popen(
            [sys.executable, "-c", _BUILD, build_dir, log], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for _ in range(2)]))
    yield procs
    for p in procs["selftest"][1] + procs["build"][2]:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("n_items,count", [(7, 2), (10, 3), (3, 4)])
def test_host_shard_matches_jax(n_items, count):
    items = [f"scene{i:04d}_00" for i in range(n_items)]
    shards = [parallel.host_shard(items, i, count) for i in range(count)]
    assert shards == [jhost_shard(items, i, count) for i in range(count)]
    assert sorted(x for s in shards for x in s) == sorted(items)  # disjoint and covering
    assert parallel.host_shard(items) == items  # one node


def test_world2_step_matches_jax_data_parallel(pool, scene):
    """World size 2 of the port against ``data_parallel_jit(seg_train_step,
    make_mesh(2))`` on two virtual CPU devices, from the same weights,
    dropout off."""
    batch = _batch(scene, 4, 128, seed=34)
    jstate, tstate = _pair(TINY, batch, capture=True)
    before = _jax_flat(jstate, jstate.opt_state[1])
    mesh = jparallel.make_mesh(2)
    jstep = jparallel.data_parallel_jit(lambda s, b, r: jsteps.seg_train_step(s, b, r), mesh,
                                        batch_argnums=(1,), donate_argnums=())
    jstate, jm = jstep(jstate, jparallel.shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh), jax.random.PRNGKey(0))
    state_dict = {k: v.numpy() for k, v in tstate.model.state_dict().items()}
    two = pool.run(dist_selftest.step_outcome, batch, model_kw=dict(dropout_rate=0.0, **TINY),
                   state_dict=state_dict, device="cpu")
    got = two[0]
    model = tstate.model
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(got["params"][k]))
            p.grad = torch.from_numpy(got["grads"][k])
        for k, b in model.named_buffers():
            b.copy_(torch.from_numpy(got["buffers"][k]))
    tm = {"loss": torch.tensor(got["loss"][0])}
    _check_step(before, _jax_flat(jstate, jstate.opt_state[1]), jm, jstate.opt_state[0],
                TrainState(model), tm, jsched.scannet_learning_rate(0), 1e-4)
    np.testing.assert_array_equal(got["confusion"], np.asarray(jm["confusion"]))


def test_global_normaliser_with_unequal_weight_counts(pool):
    """Rank 0 holds 4x rank 1's non-zero weights: the ranks' shares sum to
    JAX's ``sum(w * ce) / count(w != 0)`` of the global batch, which the
    mean of per-rank weighted losses misses."""
    rng = np.random.RandomState(4)
    logits = rng.randn(4, 64, 21).astype(np.float32)
    labels = rng.randint(0, 21, (4, 64)).astype(np.int32)
    weights = rng.rand(4, 64).astype(np.float32) + 0.5
    weights[2:, 16:] = 0.0
    jce = jax.jit(jlosses.weighted_softmax_cross_entropy)
    want = float(jce(logits, labels, weights))
    got = pool.run(weighted_ce_total, logits, labels, weights)
    np.testing.assert_allclose(got, [want, want], rtol=1e-6)
    per_rank = [float(jce(logits[s], labels[s], weights[s])) for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(per_rank) - want) > 1e-3 * want


@pytest.mark.parametrize("name", ["sem_seg_features", "sem_seg_attention"])
def test_world2_step_matches_world1(pool, scene, name):
    """One ``seg_train_step`` with dropout on (rate 0.5), B4: BN statistics,
    the loss normaliser, gradients, metrics and the dropout masks are the
    global batch's on both ranks."""
    batch = _unequal(_batch(scene, 4, 128, seed=31))
    kw = dict(model_name=name, model_kw=dict(in_features=6, **TINY), seed=2, dropout_seed=5,
              device="cpu")
    one = dist_selftest.step_outcome(batch, **kw)
    two = pool.run(dist_selftest.step_outcome, batch, **kw)
    assert [r["world_size"] for r in two] == [2, 2] and one["world_size"] == 1
    model = tmodels.get_model(name, device="cpu", in_features=6, **TINY)
    _hold_worlds(one, two, _noise_biases(model))


def test_world2_remat_step_matches_world1(pool, scene):
    """``remat='full'`` recomputes the forward in the backward: its BN
    statistics and dropout masks are the global batch's there too."""
    batch = _batch(scene, 4, 128, seed=32)
    kw = dict(model_kw=dict(in_features=6, **TINY), seed=3, dropout_seed=6, device="cpu")
    one = dist_selftest.step_outcome(batch, **kw)
    two = pool.run(dist_selftest.step_outcome, batch, remat="full", **kw)
    model = tmodels.get_model("sem_seg_features", device="cpu", in_features=6, **TINY)
    _hold_worlds(one, two, _noise_biases(model))


def test_collective_audit(pool, scene):
    """The counterpart of ``test_dp_hlo_collective_audit``: a step moves
    only all-reduces, at least the parameter bytes (the flat gradient
    all-reduce) and at most those plus the BN statistics (the forward's
    sums, count and centred squares, the backward's two sums, a channel
    each) and the metric tree (the loss normaliser, the confusion matrix,
    the correct and valid counts and the loss)."""
    batch = _batch(scene, 4, 128, seed=33)
    two = pool.run(dist_selftest.step_outcome, batch, model_kw=dict(in_features=6, **TINY),
                   device="cpu")
    model = tmodels.get_model("sem_seg_features", device="cpu", in_features=6, **TINY)
    param_bytes = sum(p.numel() * 4 for p in model.parameters())
    bn_bytes = sum((4 * m.scale.numel() + 1) * 4 for m in model.modules()
                   if isinstance(m, ScheduledBatchNorm))
    metric_bytes = 4 + (21 * 21 + 3) * 4
    for r in two:
        assert set(r["collectives"]) == {"all-reduce"}
        moved = r["collectives"]["all-reduce"]["bytes"]
        assert param_bytes <= moved <= param_bytes + bn_bytes + metric_bytes
        assert moved == param_bytes + bn_bytes + metric_bytes  # nothing else rides along


def test_mesh_refusals_and_local_rows(pool):
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_batch({"a": np.zeros((3, 2))}, parallel.Mesh(["cpu"], world_size=2))
    assert pool.run(rows_of_draw, 3) == [[0, 1, 2], [3, 4, 5]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parallel.make_mesh(2)
    elif torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match="CUDA devices"):
            parallel.make_mesh(8)


def test_dist_selftest_two_processes(processes):
    """Two processes joined by ``initialize_distributed`` (gloo, the JAX
    package's environment variables), each precomputing its node's scene
    shard: rank 0's ``DISTLOSS`` equals the one-process control."""
    workdir, procs = processes["selftest"]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    lines = [ln for out in outs for ln in out.splitlines() if ln.startswith("DISTLOSS ")]
    assert len(lines) == 1, outs  # only rank 0 reports
    names = tscenes.read_split(os.path.join(workdir, "scannet", "splits"), "train")
    control = dist_selftest.one_dp_step(os.path.join(workdir, "chunks"), names, npoints=64,
                                        device="cpu")
    assert np.isfinite(control)
    np.testing.assert_allclose(float(lines[0].split()[1]), control, rtol=1e-6)


_BUILD = """
import sys
from pointcloud_segmentation_attention_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
compile_ = native._compile
def counted(path):
    with open(sys.argv[2], "a") as f:
        f.write("compile\\n")
    compile_(path)
native._compile = counted
print(native.build()._name)
"""


def test_concurrent_builds_compile_once(processes):
    """Two processes that build at once (the ranks of a data-parallel run):
    one compiles under the build lock, both load the same library."""
    build_dir, log, procs = processes["build"]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip().splitlines()[-1] for o in outs}
    assert len(paths) == 1 and os.path.dirname(paths.pop()) == build_dir
    with open(log) as f:
        assert f.read().split() == ["compile"]
    assert os.path.basename(native.library_path()).startswith("libpsa_native_")
