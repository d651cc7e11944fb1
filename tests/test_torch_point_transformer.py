"""The port's ``point_transformer_seg`` against the plain reference
``tests/plain_point_transformer.py`` on the CPU, at its published widths.

The reference comparisons run two clouds of 4,096 points (level 5 then
holds 16 points, so no kNN asks for more neighbours than its level has),
seeded weights with non-zero biases and random BN statistics, and
train-mode BN.  Both sides run float32 on the CPU with the same indices
(the kNN, FPS and three-NN orders are exact), so what differs is the order
of float sums:

- eval-mode logits: rtol 1e-4, atol 1e-4, as the port's model tests hold
  its 20-layer forward to the JAX package; the two sums of the
  interpolation (three products added in order, and ``sum`` over them)
  may round apart, and the difference passes through 18 attention layers;
- the train step's loss: rtol 1e-5; the running BN statistics: rtol 1e-4,
  atol 1e-5; each parameter's gradient: an L2 gap under 1e-3 of its norm,
  or of the median parameter's gradient norm where its own is smaller
  (biases ahead of a train-mode BN, whose exact gradient is 0, read
  rounding noise alone; the worst such gap read 3.4e-5 of the median).
  Train-mode BN over two clouds divides by batch deviations, which
  magnifies rounding, and a max over a group routes its gradient by the
  float order of near-ties.

The step through the sampler and the trainer's ``input='sampler'`` run
take smaller chunks (1,024 points), where level 5 holds 4 points and the
kNN repeats its farthest neighbour, as ``knn_point`` pads.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import plain_point_transformer as plain
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch import ops
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.models import point_transformer as ptm
from pointcloud_segmentation_attention_tpu_torch.ops import geometry
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler, losses
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.train.steps import SCANNET_CLASS_WEIGHTS
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils import profiler
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig

CFG = dict(planes=list(ptm.PLANES), blocks=list(ptm.BLOCKS), nsample=list(ptm.NSAMPLE),
           stride=list(ptm.STRIDE), share_planes=ptm.SHARE_PLANES)
B, N = 2, 4096
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BN_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-3
MOMENTUM = 0.5


def seeded_model(seed: int, **kw):
    """``point_transformer_seg`` with every kernel, bias and BN entry drawn
    from ``seed``: biases in [-0.05, 0.05], BN scale in [0.8, 1.2], bias
    normal(0, 0.05), running mean normal(0, 0.1), variance in [0.5, 1.5]."""
    model = tmodels.seeded_model("point_transformer_seg", seed=seed, device="cpu", **kw)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") and ".bn." not in name:
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * 0.05)
    return model


def batch(b: int, n: int, seed: int) -> dict:
    """A room-sized chunk: points in a 1.5 x 1.5 x 3 m box, colors in [0, 1]
    and unit normals, labels 0-20 with ScanNet's class weights."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(b, n, 3).astype(np.float32) * np.float32([1.5, 1.5, 3.0])
    normals = rng.randn(b, n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    feats = np.concatenate([rng.rand(b, n, 3).astype(np.float32), normals], axis=-1)
    labels = rng.randint(0, 21, (b, n)).astype(np.int32)
    weights = np.float32(SCANNET_CLASS_WEIGHTS)[labels]
    return {k: torch.from_numpy(v) for k, v in dict(points=pts, features=feats, labels=labels,
                                                     weights=weights).items()}


def rel_l2(a: torch.Tensor, b: torch.Tensor, floor: float) -> float:
    return float((a - b).norm() / max(float(b.norm()), floor))


@pytest.fixture(scope="module")
def step_pair():
    """One train-mode forward and backward of the port and of the reference
    from the same weights and batch; and both eval-mode logits."""
    torch.manual_seed(0)
    model = seeded_model(5)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    data = batch(B, N, 7)
    with torch.no_grad():
        got_eval = model.eval()(data["points"], data["features"])
    want_eval = plain.logits(state, CFG, data["points"], data["features"])
    model.train()
    out = model(data["points"], data["features"], bn_momentum=MOMENTUM)
    loss = losses.weighted_softmax_cross_entropy(out, data["labels"], data["weights"])
    loss.backward()
    got = {"loss": loss.detach(), "grads": {n: p.grad for n, p in model.named_parameters()},
           "buffers": dict(model.named_buffers())}
    want_loss, want_grads, want_buffers = plain.loss_and_grads(state, CFG, data, MOMENTUM)
    want = {"loss": want_loss, "grads": want_grads, "buffers": want_buffers}
    return (got_eval, want_eval), got, want


def test_registry_builds_the_published_widths():
    m = tmodels.get_model("point_transformer_seg", device="cpu")
    assert "point_transformer_seg" in tmodels.available_models()
    assert m.in_features == 6 and m.nsample == (8, 16, 16, 16, 16)
    assert m.enc1.down.linear.kernel.shape == (9, 32) and m.enc1.down.linear.bias is None
    for i, (planes, blocks) in enumerate(zip((32, 64, 128, 256, 512), (2, 3, 4, 6, 3))):
        enc, dec = getattr(m, f"enc{i + 1}"), getattr(m, f"dec{i + 1}")
        assert len(enc.blocks) == blocks - 1 and len(dec.blocks) == 1
        assert enc.down.stride == (1 if i == 0 else 4)
        att = enc.blocks[0].attention if blocks > 1 else dec.blocks[0].attention
        assert att.q.kernel.shape == (planes, planes) and att.kv.kernel.shape[1] == 2 * planes
        assert att.w1.kernel.shape == (planes // 8, planes // 8)
    layers = sum(len(s.blocks) for s in m.children() if isinstance(s, ptm._Stage))
    assert layers == 18
    assert m.dec5.up.linear1.kernel.shape == (1024, 512)
    assert m.dec4.up.linear2.kernel.shape == (512, 256)
    assert m.fc1.kernel.shape == (32, 32) and m.fc2.kernel.shape == (32, 21)
    # The published model's size: 7.8 M parameters (the paper's table of S3DIS).
    n = sum(p.numel() for p in m.parameters())
    assert 7.7e6 < n < 7.9e6
    with pytest.raises(ValueError, match="feature channels"):
        m(torch.zeros(1, 64, 3))


def test_eval_logits_match_the_plain_reference(step_pair):
    (got, want), _, _ = step_pair
    assert got.shape == (B, N, 21) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **LOGIT_TOL)


def test_train_step_loss_and_bn_statistics_match(step_pair):
    _, got, want = step_pair
    torch.testing.assert_close(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=0)
    assert set(got["buffers"]) == set(want["buffers"])
    for k, v in want["buffers"].items():
        torch.testing.assert_close(got["buffers"][k], v, **BN_TOL, msg=k)


def test_train_step_gradients_match(step_pair):
    _, got, want = step_pair
    assert set(got["grads"]) == set(want["grads"])
    median = float(np.median([float(g.norm()) for g in want["grads"].values()]))
    worst = {k: rel_l2(got["grads"][k], g, median) for k, g in want["grads"].items()}
    name = max(worst, key=worst.get)
    assert worst[name] < GRAD_REL, (name, worst[name])


@pytest.mark.parametrize("k, n, m", [(8, 300, 300), (16, 200, 50), (16, 10, 7), (3, 33, 5)])
def test_knn_dispatch_equals_the_plain_version_on_cpu(k, n, m):
    rng = np.random.RandomState(k + n)
    xyz = torch.from_numpy(rng.rand(2, n, 3).astype(np.float32))
    xyz[:, 1::4] = xyz[:, ::4][:, :xyz[:, 1::4].shape[1]]  # duplicated points: exact ties
    new = xyz[:, :m].contiguous()
    got_d, got_i = ops.knn_point(k, xyz, new)
    want_d, want_i = geometry.knn_point(k, xyz, new)
    assert got_i.dtype == torch.int32 and got_i.shape == (2, m, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    _, ref_i = plain.nearest(k, xyz, new, pad_far=True)
    assert torch.equal(got_i.long(), ref_i)


def test_spans_and_counters_leave_the_outputs_bit_identical():
    """Under a profiler the forward records its spans and kNN counters (9 kNN
    calls a forward: a self kNN a level and one a downward transition) and
    gives the same logits, bit for bit, as without."""
    model = seeded_model(3).eval()
    data = batch(1, 1024, 2)
    with torch.no_grad():
        off = model(data["points"], data["features"])
    profiler.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                on = model(data["points"], data["features"])
        snap = profiler.snapshot()
    finally:
        profiler.reset()
    assert torch.equal(on, off)
    sizes = [1024, 256, 64, 16, 4]
    pairs = sum(n * n for n in sizes) + sum(n * m for n, m in zip(sizes, sizes[1:]))
    assert snap["counters"] == {"knn.calls": 9, "knn.queries": sum(sizes) + sum(sizes[1:]),
                                "knn.pairs": pairs}
    spans = snap["spans"]
    assert spans["nn.knn"]["count"] == 9 and spans["nn.vector_attention"]["count"] == 18
    assert spans["nn.transition_down"]["count"] == 5 and spans["nn.transition_up"]["count"] == 5


def test_the_two_reference_copies_give_equal_logits():
    from port_bench.reference import point_transformer as bench_copy

    model = seeded_model(9)
    state = model.state_dict()
    data = batch(1, 1024, 4)
    cfg = {**CFG, "num_classes": 21}
    want = plain.logits(state, cfg, data["points"], data["features"], train=True)
    with torch.no_grad():
        got = bench_copy.forward(state, cfg, data["points"], data["features"], train=True)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def rooms():
    return [tscenes.make_synthetic_scene(6000, seed=40 + s) for s in range(3)]


def test_one_sampling_train_step(rooms):
    """One ``make_sampling_train_step`` step (the benchmark's path): a finite
    loss, every parameter moved or its gradient exactly 0, BN statistics
    updated."""
    scenes = device_sampler.ResidentScenes(rooms, device="cpu")
    model = seeded_model(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model)
    step = device_sampler.make_sampling_train_step(scenes, 1024, num_classes=21)
    state, m = step(state, torch.tensor([0, 2], dtype=torch.int32), seed=3)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    after = model.state_dict()
    for name, p in model.named_parameters():
        assert not torch.equal(after[name], before[name]) or float(p.grad.abs().max()) == 0, name
    assert not torch.equal(after["enc3.blocks.0.attention.w_norm.bn.mean"],
                           before["enc3.blocks.0.attention.w_norm.bn.mean"])


def test_train_config_sampler_runs(tmp_path, monkeypatch):
    """``train(TrainConfig(model='point_transformer_seg', input='sampler'))``
    runs two steps on the CPU and writes a checkpoint of the model's state."""
    root = str(tmp_path / "scannet")
    tscenes.write_synthetic_dataset(root, n_train=2, n_val=1, n_points=3000)
    cfg = TrainConfig(data_root=root, log_dir=str(tmp_path / "logs"), input="sampler",
                      model="point_transformer_seg", batch_size=2, n_points=1024, epochs=1,
                      n_epochs_to_val=1, save_every_epochs=1)
    monkeypatch.setattr(ttrainer, "MetricLogger",
                        functools.partial(ttrainer.MetricLogger, tensorboard=False))
    summary = ttrainer.train(cfg, max_steps=2, device="cpu")
    assert summary["final_step"] == 2 and np.isfinite(summary["final_train_loss"])
