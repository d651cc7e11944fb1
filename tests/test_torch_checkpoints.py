"""The port's checkpoint manager against the JAX package's.

A port checkpoint must restore into the JAX trainer's ``make_eval_state``
template through the JAX ``restore_checkpoint``, and a JAX checkpoint into
the port's; the restored weights give eval logits within the 1e-3 of
``tests/test_torch_model.py``'s full-width check (rtol = atol; the two CPU
matmuls sum in different orders).  The manifests behave alike: ``latest``,
``best``, ``keep_best_only`` pruning and ``BestKeeper`` reseeding from disk.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu.train import checkpoints as jckpt
from pointcloud_segmentation_attention_tpu.train import trainer as jtrainer
from pointcloud_segmentation_attention_tpu.utils.config import TrainConfig as JConfig
from pointcloud_segmentation_attention_tpu_torch.data import pipeline as tpipeline
from pointcloud_segmentation_attention_tpu_torch.data.scannet import chunks as tchunks
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes
from pointcloud_segmentation_attention_tpu_torch.train import checkpoints as tckpt
from pointcloud_segmentation_attention_tpu_torch.train import (
    export_jax_state,
    seg_predict_step,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from test_torch_trainer import TINY_HIERARCHY

LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
CONFIG = dict(model="sem_seg_features", model_overrides=TINY_HIERARCHY, n_points=256)


def _batch(seed, b=2, n=256):
    scene = tscenes.make_synthetic_scene(4000, seed=seed)
    rng = np.random.RandomState(seed)
    chunks = []
    for _ in range(b):
        p, l, c, nrm, w = tchunks.sample_random_chunk(scene["points"], scene["labels"],
                                                      scene["colors"], scene["normals"], n, rng)
        chunks.append(dict(points=p, labels=l, colors=c, normals=nrm, weights=w))
    return tpipeline.make_batch(chunks, True, True)


@pytest.fixture(scope="module")
def trained_port_state():
    """The port's eval-state template after three training steps: non-zero
    Adam moments, moved BN statistics, step 3."""
    state = ttrainer.make_eval_state(TrainConfig(**CONFIG), device="cpu")
    for s in range(3):
        seg_train_step(state, _batch(s))
    return state


def _jax_logits(jstate, batch):
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    return np.asarray(jstate.apply_fn(variables, jnp.asarray(batch["points"]),
                                      jnp.asarray(batch["features"]), train=False))


def _port_logits(state, batch):
    return seg_predict_step(state.model, torch.from_numpy(batch["points"]),
                            torch.from_numpy(batch["features"])).numpy()


def test_port_checkpoint_restores_in_jax_and_back(trained_port_state, tmp_path):
    state = trained_port_state
    path = tckpt.save_checkpoint(str(tmp_path / "port"), state, 3, metric=0.25)
    assert os.path.basename(path) == "ckpt_00000003.npz"
    jstate = jckpt.restore_checkpoint(path, jtrainer.make_eval_state(JConfig(**CONFIG)))
    assert int(jstate.step) == 3
    flat = export_jax_state(state)
    jflat = {f"params/{k}": v for k, v in jckpt._flatten(jstate.params).items()}
    jflat.update({f"batch_stats/{k}": v for k, v in jckpt._flatten(jstate.batch_stats).items()})
    jflat.update({f"opt_state/{k}": v for k, v in jckpt._flatten(jstate.opt_state).items()})
    assert sorted(jflat) == sorted(k for k in flat if k != "step")
    for k, v in jflat.items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    batch = _batch(10)
    np.testing.assert_allclose(_port_logits(state, batch), _jax_logits(jstate, batch),
                               **LOGIT_TOL)

    # The JAX package writes it again; the port restores that bit for bit.
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 3)
    fresh = ttrainer.make_eval_state(TrainConfig(**CONFIG), device="cpu")
    assert tckpt.restore_checkpoint(jpath, fresh) is fresh and fresh.step == 3
    again = export_jax_state(fresh)
    assert sorted(again) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k], err_msg=k)
    np.testing.assert_array_equal(_port_logits(fresh, batch), _port_logits(state, batch))


def test_jax_checkpoint_restores_in_port(tmp_path):
    jstate = jtrainer.make_eval_state(JConfig(**CONFIG))
    path = jckpt.save_checkpoint(str(tmp_path), jstate, 0)
    state = tckpt.restore_checkpoint(path, ttrainer.make_eval_state(TrainConfig(**CONFIG),
                                                                    device="cpu"))
    batch = _batch(11)
    np.testing.assert_allclose(_port_logits(state, batch), _jax_logits(jstate, batch),
                               **LOGIT_TOL)
    narrower = ttrainer.make_eval_state(TrainConfig(**{**CONFIG, "use_colors": False}),
                                        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, narrower)
    attention = ttrainer.make_eval_state(TrainConfig(**{**CONFIG, "model": "sem_seg_attention"}),
                                         device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore_checkpoint(path, attention)


def test_manifests_behave_like_jax(trained_port_state, tmp_path):
    state = trained_port_state
    jstate = jtrainer.make_eval_state(JConfig(**CONFIG))
    dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    saves = [(1, None, False, "ckpt"), (4, 0.2, False, "ckpt"), (2, 0.5, False, "ckpt"),
             (3, None, False, "ckpt"), (2, 0.3, True, "best"), (5, 0.6, True, "best")]
    for step, metric, keep, prefix in saves:
        tckpt.save_checkpoint(dirs["port"], state, step, metric, keep, prefix)
        jckpt.save_checkpoint(dirs["jax"], jstate, step, metric, keep, prefix)
    listing = sorted(os.listdir(dirs["port"]))
    assert listing == sorted(os.listdir(dirs["jax"]))
    assert [f for f in listing if f.startswith("best")] == ["best_00000005.json",
                                                             "best_00000005.npz"]
    for mod, d in ((tckpt, dirs["port"]), (jckpt, dirs["jax"])):
        assert os.path.basename(mod.latest_checkpoint(d)) == "ckpt_00000004.npz"
        assert os.path.basename(mod.best_checkpoint(d)) == "ckpt_00000002.npz"
        assert os.path.basename(mod.best_checkpoint(d, "best")) == "best_00000005.npz"
        assert mod.latest_checkpoint(d, "none") is None
    for name in listing:
        if name.endswith(".json"):
            assert open(os.path.join(dirs["port"], name)).read() == \
                open(os.path.join(dirs["jax"], name)).read()

    keeper = tckpt.BestKeeper(dirs["port"])
    assert keeper.best == jckpt.BestKeeper(dirs["jax"]).best == 0.6
    assert not keeper.maybe_save(state, 6, 0.55)
    assert keeper.maybe_save(state, 7, 0.7)
    assert sorted(f for f in os.listdir(dirs["port"]) if f.startswith("best")) == \
        ["best_00000007.json", "best_00000007.npz"]
    assert tckpt.BestKeeper(str(tmp_path / "empty")).best == -np.inf
