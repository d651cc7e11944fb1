"""The port's trainer entry point against the JAX trainer, and its config.

One synthetic dataset is written and precomputed once.  The JAX package's
initial state (``make_eval_state``) is saved as a step-0 checkpoint into
the JAX run's and the port's checkpoint directories, and both trainers run
with ``resume=True`` from it: ``sem_seg_features`` at a tiny hierarchy,
dropout off, B2 x 128, two epochs of two steps, validation every epoch.

Tolerances, and why:

- the logged ``train_loss`` of each epoch: rtol 1e-5, the first-step loss
  limit of ``tests/test_torch_train.py`` (a train-mode BatchNorm cancels a
  bias's rounding noise, so later steps' losses stay that close);
- ``val_loss`` rtol 1e-3 and ``val_miou`` atol 1e-3: eval-mode BatchNorm
  uses running means, which carry the noise biases' updates (each up to
  Adam's step; see ``tests/test_torch_train.py``);
- the final parameters: within twice Adam's largest summed step,
  2 x steps x ADAM_MAX_STEP x lr, everywhere; BN running means to the same
  bound (they carry the noise biases), running variances rtol 1e-4.

The port's packed-f32 run must equal its npz run bit for bit when both
carry the same values: the f32 packed record holds normals as f16, as the
compact wire does, so the npz run it is held to uses ``wire_format=
'compact'``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu.data.scannet import precompute as jprecompute
from pointcloud_segmentation_attention_tpu.data.scannet import scenes as jscenes
from pointcloud_segmentation_attention_tpu.train import trainer as jtrainer
from pointcloud_segmentation_attention_tpu.train.checkpoints import (
    save_checkpoint as jsave_checkpoint,
)
from pointcloud_segmentation_attention_tpu.utils.config import TrainConfig as JConfig
from pointcloud_segmentation_attention_tpu.utils.logging import read_metrics as jread_metrics
from pointcloud_segmentation_attention_tpu_torch.train import (
    latest_checkpoint,
    schedules,
)
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger, read_metrics

TINY_HIERARCHY = {"sa_npoints": [16, 8, 4, 2], "sa_radii": [0.2, 0.4, 0.8, 1.2],
                  "sa_nsample": 4, "sa_mlps": [[8, 8], [8, 8], [8, 8], [8, 8]],
                  "fp_mlps": [[8], [8], [8], [8, 8]], "dropout_rate": 0.0}
ADAM_MAX_STEP = 0.1 / np.sqrt(0.001)  # |Adam update| <= lr * (1 - b1) / sqrt(1 - b2)
STEPS = 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer")
    root = str(d / "scannet")
    splits = jscenes.write_synthetic_dataset(root, n_train=4, n_val=1, n_points=3000)
    pre = str(d / "chunks")
    jprecompute.precompute_train_chunks(root, splits["train"], pre, epochs=2, npoints=128)
    jprecompute.precompute_val_chunks(root, splits["val"], pre, npoints=128)
    base = dict(data_root=root, precompute_dir=pre, model="sem_seg_features",
                model_overrides=TINY_HIERARCHY, batch_size=2, n_points=128, epochs=2,
                n_epochs_to_val=1, n_devices=1, save_every_epochs=1, resume=True)
    init = jtrainer.make_eval_state(JConfig(**base))
    return d, base, init


def _run_port(d, base, tag, init, **over):
    cfg = TrainConfig(**{**base, "log_dir": str(d / tag), **over})
    jsave_checkpoint(cfg.ckpt_dir, init, 0)
    summary = ttrainer.train(cfg, device="cpu")
    return cfg, summary


def _final_flat(cfg):
    path = latest_checkpoint(cfg.ckpt_dir)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _records(path, key):
    return [r for r in read_metrics(path) if key in r]


def test_port_trainer_matches_jax_trainer(dataset):
    d, base, init = dataset
    jcfg = JConfig(**{**base, "log_dir": str(d / "jax")})
    jsave_checkpoint(jcfg.ckpt_dir, init, 0)
    jsum = jtrainer.train(jcfg)
    tcfg, tsum = _run_port(d, base, "port", init)

    assert tsum["final_step"] == jsum["final_step"] == STEPS
    jlog = os.path.join(jcfg.log_dir, "train_metrics.jsonl")
    tlog = os.path.join(tcfg.log_dir, "train_metrics.jsonl")
    jtrain, ttrain = _records(jlog, "train_loss"), _records(tlog, "train_loss")
    assert [r["step"] for r in ttrain] == [r["step"] for r in jtrain] == [2, 4]
    for j, t in zip(jtrain, ttrain):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5)
        # The LR of the epoch's last step: the schedule at its pre-increment step.
        assert t["learning_rate"] == pytest.approx(j["learning_rate"], rel=1e-7)
        assert t["learning_rate"] == schedules.scannet_learning_rate(t["step"] - 1, 2, 4)
    jval, tval = _records(jlog, "val_miou"), _records(tlog, "val_miou")
    assert len(jval) == len(tval) == 2
    for j, t in zip(jval, tval):
        np.testing.assert_allclose(t["val_loss"], j["val_loss"], rtol=1e-3)
        assert abs(t["val_miou"] - j["val_miou"]) <= 1e-3
    assert tsum["best_val_miou"] == pytest.approx(jsum["best_val_miou"], abs=1e-3)

    want, got = _final_flat(jcfg), _final_flat(tcfg)
    assert sorted(got) == sorted(want)
    tol = 2 * STEPS * ADAM_MAX_STEP * schedules.scannet_learning_rate(0, 2, 4)
    for k in want:
        if k.startswith("params/"):
            assert np.abs(got[k] - want[k]).max() <= tol, k
        elif k.endswith("/mean"):  # the noise biases' updates pass into the running means
            assert np.abs(got[k] - want[k]).max() <= tol, k
        elif k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
        elif k.endswith(".count") or k == "step":
            assert int(got[k]) == int(want[k]) == STEPS, k
    best = sorted(f for f in os.listdir(tcfg.ckpt_dir) if f.startswith("best"))
    assert best == sorted(f for f in os.listdir(jcfg.ckpt_dir) if f.startswith("best"))


def test_packed_f32_run_is_bit_identical_to_npz(dataset):
    d, base, init = dataset
    npz_cfg, npz_sum = _run_port(d, base, "npz_compact", init, wire_format="compact")
    pk_cfg, pk_sum = _run_port(d, base, "packed_f32", init, input="packed",
                               wire_format="packed")
    assert pk_sum == npz_sum
    a, b = _final_flat(npz_cfg), _final_flat(pk_cfg)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert os.path.isdir(os.path.join(base["precompute_dir"], "pack_f32_c1n1_p128"))
    la = _records(os.path.join(npz_cfg.log_dir, "train_metrics.jsonl"), "train_loss")
    lb = _records(os.path.join(pk_cfg.log_dir, "train_metrics.jsonl"), "train_loss")
    assert [r["train_loss"] for r in la] == [r["train_loss"] for r in lb]
    # The q16 store trains too, from the same replay order.
    q_cfg, q_sum = _run_port(d, base, "packed_q16x2", init, wire_format="packed_q16x2")
    assert q_sum["final_step"] == STEPS and np.isfinite(q_sum["final_train_loss"])


def test_budgeted_run_writes_final_checkpoint_and_resumes(dataset):
    d, base, init = dataset
    cfg, s = _run_port(d, base, "budget", init, resume=False)
    cfg2 = TrainConfig(**{**dataclasses.asdict(cfg), "log_dir": str(d / "budget2"),
                          "ckpt_dir": str(d / "budget2" / "ckpt"), "resume": False})
    s2 = ttrainer.train(cfg2, max_seconds=0.0, device="cpu")
    assert s2["final_step"] == 0
    assert os.path.basename(latest_checkpoint(cfg2.ckpt_dir)) == "ckpt_00000000.npz"
    cfg3 = TrainConfig(**{**dataclasses.asdict(cfg), "resume": True})
    s3 = ttrainer.train(cfg3, max_steps=1, device="cpu")
    assert s3["final_step"] == s["final_step"] + 1


# ---- config, input modes and the CLI -----------------------------------------------


def test_config_json_round_trips_both_ways(tmp_path):
    kw = dict(data_root="/x", batch_size=32, epochs=9, wire_format="packed_q16",
              model_overrides={"sa_nsample": 8}, n_devices=1)
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    assert json.loads(jcfg.to_json()) == json.loads(tcfg.to_json())
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    assert dataclasses.asdict(TrainConfig.from_json(jcfg.to_json())) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(JConfig.from_json(tcfg.to_json())) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JConfig())


def test_config_file_and_cli_precedence(tmp_path):
    cfg = TrainConfig(data_root="/x", batch_size=32, epochs=9)
    path = str(tmp_path / "c.json")
    open(path, "w").write(cfg.to_json())
    c2 = TrainConfig.from_args(["--config", path])
    assert c2.batch_size == 32 and c2.epochs == 9 and c2.data_root == "/x"
    c3 = TrainConfig.from_args(["--config", path, "--epochs", "3", "--resume", "true",
                                "--model_overrides", '{"sa_nsample": 8}'])
    assert c3.epochs == 3 and c3.batch_size == 32 and c3.resume is True
    assert c3.model_overrides == {"sa_nsample": 8}
    argv = ["--config", path, "--epochs", "3", "--n_devices", "1"]
    assert dataclasses.asdict(TrainConfig.from_args(argv)) == \
        dataclasses.asdict(JConfig.from_args(argv))


INPUT_CASES = [
    dict(input="auto"), dict(input="auto", wire_format="packed_q16"),
    dict(input="auto", device_replay=True), dict(input="npz"),
    dict(input="packed"), dict(input="packed", wire_format="packed"),
    dict(input="bogus"), dict(input="npz", wire_format="packed"),
    dict(input="sampler", wire_format="packed_q16"), dict(input="sampler", device_replay=True),
    dict(input="npz", device_replay=True), dict(input="packed", device_replay=True),
    dict(input="resident"), dict(input="sampler"),
]


@pytest.mark.parametrize("case", INPUT_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_resolve_input_mode_matches_jax(case):
    def outcome(fn, cfg):
        try:
            return fn(cfg)
        except ValueError:
            return "ValueError"

    assert outcome(ttrainer.resolve_input_mode, TrainConfig(**case)) == \
        outcome(jtrainer.resolve_input_mode, JConfig(**case))


@pytest.mark.parametrize("over,message", [
    (dict(n_devices=2), "ROADMAP Queue 1 item 7"),
    (dict(compute_dtype="bfloat16"), "ROADMAP Queue 1 item 4"),
])
def test_unported_paths_raise(tmp_path, over, message):
    cfg = TrainConfig(data_root=str(tmp_path), **over)
    with pytest.raises(NotImplementedError, match=message):
        ttrainer.train(cfg, device="cpu")


@pytest.mark.parametrize("over", [dict(input="resident"), dict(device_replay=True)],
                         ids=["resident", "device_replay"])
def test_resident_configs_train_one_step(dataset, over):
    """The device-resident corpus (``train/device_replay.py``): with the
    default wire_format the records are the q16 pack store's, as in JAX's
    ``test_resident_input_mode_default_wire``."""
    d, base, init = dataset
    cfg = TrainConfig(**{**base, "log_dir": str(d / ("one_" + "_".join(map(str, over))))},
                      **over)
    jsave_checkpoint(cfg.ckpt_dir, init, 0)
    summary = ttrainer.train(cfg, max_steps=1, device="cpu")
    assert summary["final_step"] == 1
    assert os.path.exists(os.path.join(base["precompute_dir"], "pack_q16_c1n1_p128",
                                       "meta.json"))


def test_train_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.train(TrainConfig(data_root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.make_eval_state(TrainConfig(data_root=str(tmp_path)))


def test_main_takes_device_and_config_flags(dataset, capsys):
    d, base, init = dataset
    log_dir = str(d / "cli")
    argv = ["--device=cpu", f"--data_root={base['data_root']}",
            f"--precompute_dir={base['precompute_dir']}", f"--log_dir={log_dir}",
            "--batch_size=2", "--n_points=128", "--epochs=1", "--n_epochs_to_val=1",
            "--model_overrides=" + json.dumps(TINY_HIERARCHY)]
    ttrainer.main(argv)
    assert "'final_step': 2" in capsys.readouterr().out
    saved = TrainConfig.from_json(open(os.path.join(log_dir, "config.json")).read())
    assert saved.n_points == 128 and saved.model_overrides == TINY_HIERARCHY


def test_metric_logger_matches_jax_format(tmp_path):
    log = MetricLogger(str(tmp_path), "t", tensorboard=False)
    log.log(3, {"a": np.float32(1.5), "b": 2})
    log.close()
    rec = jread_metrics(str(tmp_path / "t_metrics.jsonl"))
    assert rec == read_metrics(str(tmp_path / "t_metrics.jsonl"))
    assert rec[0]["step"] == 3 and rec[0]["a"] == 1.5 and rec[0]["b"] == 2.0
