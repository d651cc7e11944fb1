"""Activation rematerialisation of the port's train step
(``train/steps.py:seg_train_step(remat=)``): ``'full'`` recomputes the
forward and the loss in the backward, ``'dots'`` keeps only the matmul
outputs (``jax.checkpoint_policies.dots_saveable``).  Both must give the
step of ``'none'`` bit for bit, dropout on: the loss, every gradient, the
new parameters, Adam's moments and the BN running statistics (so the EMA is
applied once and the recomputation draws the same dropout masks).  The
file imports no JAX, so its ``cuda`` test also runs on the card's machine.
"""
import copy
import os

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes
from pointcloud_segmentation_attention_tpu_torch.train import latest_checkpoint, steps, trainer
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics

TINY = dict(sa_npoints=(16, 8, 4, 2), sa_radii=(0.2, 0.4, 0.8, 1.2), sa_nsample=4,
            sa_mlps=((8, 8),) * 4, fp_mlps=((8,), (8,), (8,), (8, 8)))
MODELS = ["sem_seg_features", "sem_seg_attention"]


def _batch(model, b=2, n=128, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"points": (rng.rand(b, n, 3) * [1.9, 1.9, 2.6]).astype(np.float32),
             "labels": rng.randint(0, 21, (b, n)).astype(np.int32),
             "weights": rng.rand(b, n).astype(np.float32)}
    if model.in_features:
        batch["features"] = rng.rand(b, n, model.in_features).astype(np.float32)
    return batch


def _steps(model, remat, device, n_steps=2):
    """``n_steps`` steps from ``model`` (copied), dropout on; the loss of
    each step, the last step's gradients and the final state dict and Adam
    state."""
    m = copy.deepcopy(model).to(device)
    state = TrainState(m)
    losses = []
    for s in range(n_steps):
        _, met = steps.seg_train_step(state, _batch(model, seed=s), 7, remat=remat)
        losses.append(met["loss"].cpu())
    grads = {k: p.grad.cpu() for k, p in m.named_parameters()}
    sd = {k: v.cpu() for k, v in m.state_dict().items()}
    adam = {f"{k}/{n}": v.cpu() for k, p in m.named_parameters()
            for n, v in state.optimizer.state[p].items()}
    return losses, grads, sd, adam


def _assert_same(got, want):
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                assert torch.equal(a[k], b[k]), k
        else:
            for x, y in zip(a, b):
                assert torch.equal(x, y)


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("name", MODELS)
def test_remat_equals_none(name, remat):
    model = models.seeded_model(name, seed=0, device="cpu", **TINY)
    assert model.dp1.rate == 0.5
    want = _steps(model, "none", "cpu")
    _assert_same(_steps(model, remat, "cpu"), want)
    # The BN statistics moved once a step: a second EMA would move them further.
    assert not torch.equal(want[2]["fc1.bn.mean"], model.state_dict()["fc1.bn.mean"])


def test_remat_recomputes_and_dots_keeps_matmuls(monkeypatch):
    """'full' and 'dots' run the forward twice a step; under 'dots' the
    policy keeps ``mm`` outputs in the first forward."""
    model = models.seeded_model("sem_seg_features", seed=0, device="cpu", **TINY)
    calls = []
    model.sa1.register_forward_hook(lambda *a: calls.append(1))
    for remat, expect in (("none", 1), ("full", 2), ("dots", 2)):
        calls.clear()
        steps.seg_train_step(TrainState(model), _batch(model), remat=remat)
        assert len(calls) == expect, remat
    seen = []
    policy = steps._dots_saveable

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        seen.append((ctx.is_recompute, op, out))
        return out

    monkeypatch.setattr(steps, "_dots_saveable", recording)
    steps.seg_train_step(TrainState(model), _batch(model), remat="dots")
    saved = {op for again, op, out in seen
             if not again and out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert torch.ops.aten.mm.default in saved


def test_unknown_remat_raises():
    model = models.seeded_model("sem_seg_features", seed=0, device="cpu", **TINY)
    with pytest.raises(ValueError, match="remat must be 'none'\\|'dots'\\|'full'"):
        steps.seg_train_step(TrainState(model), _batch(model), remat="bogus")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("remat_store")
    root = str(d / "scannet")
    scenes.write_synthetic_dataset(root, n_train=4, n_val=1, n_points=4000)
    return d, dict(data_root=root, input="sampler", model="sem_seg_features",
                   model_overrides={k: list(v) if isinstance(v, tuple) else v
                                    for k, v in TINY.items()},
                   batch_size=2, n_points=128, epochs=2, n_epochs_to_val=1, n_devices=1,
                   save_every_epochs=1)


def _trainer_run(store, remat):
    d, base = store
    cfg = TrainConfig(**base, remat=remat, log_dir=str(d / remat))
    summary = trainer.train(cfg, device="cpu")
    with np.load(latest_checkpoint(cfg.ckpt_dir)) as z:
        final = {k: z[k] for k in z.files}
    logged = [{k: v for k, v in r.items()
               if k not in ("time", "points_per_sec", "input_wait_s", "epoch_s")}
              for r in read_metrics(os.path.join(cfg.log_dir, "train_metrics.jsonl"))]
    return summary, final, logged


def test_trainer_remat_runs_equal_none(store):
    """``TrainConfig.remat`` reaches the step: the sampler trainer's runs
    with 'dots' and 'full' equal its 'none' run (summary, logs, final
    checkpoint)."""
    want = _trainer_run(store, "none")
    assert want[0]["final_step"] == 4
    for remat in ("dots", "full"):
        got = _trainer_run(store, remat)
        assert got[0] == want[0] and got[2] == want[2], remat
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=f"{remat} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODELS)
def test_remat_equals_none_on_the_card(name):
    """On the card the kernels' autograd functions are recomputed too (their
    backward scratch taken afresh): 'dots' and 'full' equal 'none'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    model = models.seeded_model(name, seed=0, device="cpu", **TINY)
    want = _steps(model, "none", "cuda")
    for remat in ("dots", "full"):
        _assert_same(_steps(model, remat, "cuda"), want)
