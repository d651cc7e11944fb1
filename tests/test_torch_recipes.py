"""The port's recipes (``recipes/``) on the CPU at a tiny size: each runs
end to end through its ``run_*`` function and returns the JAX recipe's
result keys; the arms and reference constants equal the JAX package's;
every ``main`` takes ``--device``.

The learning parity of ``synthetic_convergence`` at the size of
``RESULTS_synthetic_convergence.json`` (32 rooms of 20k points, B4 x 2048,
1600 steps: 0.934 trainer / 0.938 offline mIoU) is the one ``slow`` test:
Tier-1 does not run it.  It runs on the card when there is one (an hour
on a CPU).
"""
import json
import os

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu.recipes import attention_ablation as jablation
from pointcloud_segmentation_attention_tpu.recipes import context_margin as jmargin
from pointcloud_segmentation_attention_tpu.recipes import feature_ablation as jfeature
from pointcloud_segmentation_attention_tpu_torch import recipes
from pointcloud_segmentation_attention_tpu_torch.recipes import (
    attention_ablation,
    attention_wire_parity,
    context_margin,
    diversity_matched,
    feature_ablation,
    synthetic_convergence,
    zero_precompute,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"sa_npoints": [64, 32, 16, 8], "sa_radii": [0.2, 0.4, 0.8, 1.2], "sa_nsample": 8,
        "sa_mlps": [[8, 8]] * 4, "fp_mlps": [[8], [8], [8], [8, 8]]}
SMALL = dict(scene_points=4000, n_points=128, batch_size=2, model_overrides=TINY,
             device="cpu")


def _finite_miou(v):
    return np.isfinite(v) and 0.0 <= v <= 1.0


def test_reference_constants_and_arms_equal_jax():
    assert attention_ablation.REFERENCE_TABLE1_VAL_MIOU == jablation.REFERENCE_TABLE1_VAL_MIOU
    assert attention_ablation.ARMS == jablation.ARMS
    assert feature_ablation.REFERENCE_TABLE3_VAL_MIOU == jfeature.REFERENCE_TABLE3_VAL_MIOU
    assert feature_ablation.ARMS == jfeature.ARMS
    assert context_margin.REFERENCE_TABLE4 == jmargin.REFERENCE_TABLE4
    assert attention_ablation.REFERENCE_TABLE1_VAL_MIOU["att_L2"] == 0.326
    assert feature_ablation.REFERENCE_TABLE3_VAL_MIOU["normals"] == 0.509
    assert context_margin.REFERENCE_TABLE4["with_context"] == 0.517


def test_zero_precompute_recipe(tmp_path):
    out = recipes.run_zero_precompute(str(tmp_path), n_train_scenes=3, n_val_scenes=1,
                                      epochs=2, results_path=str(tmp_path / "r.json"), **SMALL)
    assert set(out) == {"offline_mean_iou", "loss_curve", "final_loss", "best_val_miou",
                        "median_points_per_sec", "config"}
    assert _finite_miou(out["offline_mean_iou"]) and np.isfinite(out["final_loss"])
    assert [r["step"] for r in out["loss_curve"]] == [1, 2]
    assert out["median_points_per_sec"] > 0
    assert not os.path.exists(str(tmp_path / "scannet_synth" / "precomputed"))
    assert json.load(open(tmp_path / "r.json"))["config"]["epochs"] == 2


def test_synthetic_convergence_recipe(tmp_path):
    out = recipes.run_synthetic_convergence(str(tmp_path), n_train_scenes=2, n_val_scenes=1,
                                            precompute_epochs=1, epochs=2, n_epochs_to_val=1,
                                            **SMALL)
    assert set(out) == {"trainer_best_val_miou", "offline_mean_iou", "offline_per_class",
                        "final_step", "config"}
    assert out["final_step"] == 2 and _finite_miou(out["offline_mean_iou"])
    assert os.path.exists(tmp_path / "results.txt")


def test_attention_ablation_recipe(tmp_path):
    out = recipes.run_attention_ablation(str(tmp_path), n_train_scenes=6, n_val_scenes=1,
                                         max_steps=2, arms=("baseline", "att_L2"), **SMALL)
    assert set(out) == {"arms", "ordering_by_offline_miou", "reference_ordering", "config"}
    assert set(out["arms"]) == {"baseline", "att_L2"}
    for arm, r in out["arms"].items():
        assert np.isfinite(r["final_train_loss"]) and _finite_miou(r["offline_mean_iou"]), arm
    assert out["arms"]["att_L2"]["attention_single_layer"] == 1
    assert out["arms"]["att_L2"]["reference_val_miou"] == 0.326
    assert sorted(out["ordering_by_offline_miou"]) == ["att_L2", "baseline"]


def test_feature_ablation_recipe(tmp_path):
    out = recipes.run_feature_ablation(str(tmp_path), n_train_scenes=4, n_val_scenes=1,
                                       max_steps=3, arms=("baseline", "normals"), **SMALL)
    assert set(out["arms"]) == {"baseline", "normals"}
    r = out["arms"]["normals"]
    assert (r["use_colors"], r["use_normals"], r["reference_val_miou"]) == (False, True, 0.509)
    assert all(_finite_miou(a["offline_mean_iou"]) for a in out["arms"].values())
    assert out["reference_ordering"][0] == "both"


def test_context_margin_recipe(tmp_path):
    out = recipes.run_context_margin(str(tmp_path), margins=(0.0, 0.2), n_train_scenes=2,
                                     n_val_scenes=1, max_steps=2, **SMALL)
    assert set(out) == {"offline_miou_by_margin", "delta_with_minus_without", "best_val_miou",
                        "reference_table4", "config"}
    assert set(out["offline_miou_by_margin"]) == {"0.0", "0.2"}
    assert all(_finite_miou(v) for v in out["offline_miou_by_margin"].values())
    assert out["reference_table4"]["with_context"] == 0.517


def test_diversity_matched_recipe(tmp_path):
    out = recipes.run_diversity_matched(str(tmp_path), budget_s=3.0, n_train_scenes=2,
                                        n_val_scenes=1, replay_epochs=2, **SMALL)
    assert set(out) == {"budget_s", "arms", "config"}
    assert set(out["arms"]) == {"sampler", "replay_deep"}
    assert out["arms"]["sampler"]["steps"] >= 1 and out["arms"]["sampler"]["precompute_s"] == 0
    assert _finite_miou(out["arms"]["sampler"]["offline_mean_iou"])
    assert out["arms"]["replay_deep"]["corpus_distinct_chunks"] == 4


def test_attention_wire_parity_recipe(tmp_path):
    out = recipes.run_attention_wire_parity(str(tmp_path), n_train_scenes=2, epochs=1,
                                            precompute_epochs=1, **SMALL)
    assert out["model"] == "sem_seg_attention" and set(out["arms"]) == {"f32", "q16_resident"}
    for arm in out["arms"].values():
        assert arm["final_step"] == 1 and _finite_miou(arm["offline_mean_iou"])


MAINS = [(zero_precompute, "run_zero_precompute"),
         (synthetic_convergence, "run_synthetic_convergence"),
         (attention_ablation, "run_attention_ablation"),
         (feature_ablation, "run_feature_ablation"),
         (context_margin, "run_context_margin"),
         (diversity_matched, "run_diversity_matched"),
         (attention_wire_parity, "run_attention_wire_parity")]


@pytest.mark.parametrize("module,fn", MAINS, ids=[m[1] for m in MAINS])
def test_main_takes_device(module, fn, monkeypatch, tmp_path, capsys):
    seen = {}

    def fake(*args, **kwargs):
        seen.update(kwargs)
        return {"ok": 1}

    monkeypatch.setattr(module, fn, fake)
    module.main(["--device", "cpu", "--workdir", str(tmp_path)])
    assert seen["device"] == "cpu" and '"ok": 1' in capsys.readouterr().out


@pytest.mark.parametrize("fn", ["run_zero_precompute", "run_synthetic_convergence",
                                "run_attention_ablation"])
def test_run_refuses_devices_and_missing_card(fn, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        getattr(recipes, fn)(str(tmp_path), n_devices=2, device="cpu")
    assert not os.listdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(recipes, fn)(str(tmp_path))


@pytest.mark.slow
def test_synthetic_convergence_learning_parity(tmp_path):
    """The port learns as the JAX package did at
    ``RESULTS_synthetic_convergence.json``'s size (0.934 trainer / 0.938
    offline mIoU): both within 0.05 of it."""
    with open(os.path.join(ROOT, "RESULTS_synthetic_convergence.json")) as f:
        ref = json.load(f)
    cfg = ref["config"]
    out = recipes.run_synthetic_convergence(
        str(tmp_path), n_train_scenes=cfg["n_train_scenes"], n_val_scenes=cfg["n_val_scenes"],
        scene_points=cfg["scene_points"], n_points=cfg["n_points"],
        batch_size=cfg["batch_size"], precompute_epochs=cfg["precompute_epochs"],
        epochs=cfg["epochs"], n_epochs_to_val=25, seed=cfg["seed"],
        device="cuda" if torch.cuda.is_available() else "cpu")
    assert out["final_step"] == ref["final_step"] == 1600
    assert abs(out["trainer_best_val_miou"] - ref["trainer_best_val_miou"]) <= 0.05, out
    assert abs(out["offline_mean_iou"] - ref["offline_mean_iou"]) <= 0.05, out
