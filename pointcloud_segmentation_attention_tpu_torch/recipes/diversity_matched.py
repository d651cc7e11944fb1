"""Sampling against a deep replay corpus at matched wall-clock cost, a
copy of the JAX package's recipe.

Both arms get the same wall-clock budget: the sampler arm
(``input='sampler'``) spends all of it training; the replay arm first
precomputes a deep corpus (32 epochs by default) and trains on it resident
on the device (``input='resident'``, ``packed_q16``) with what is left.
Same scenes, seeds and model; each arm's final state is served whole
(resident serving, f32 layout) and scored.

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.diversity_matched
[--device cuda|cpu]``
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (
    read_split,
    write_synthetic_dataset,
)
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.recipes.common import (
    check_devices,
    restore_state,
    stitched_miou,
)
from pointcloud_segmentation_attention_tpu_torch.train import trainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig


def _offline_eval(config: TrainConfig, data_root: str, val_scenes, workdir: str, arm: str,
                  device) -> float:
    """The stitched mIoU of the arm's newest checkpoint (NaN without one)."""
    state, ckpt = restore_state(config, device, first="ckpt", then="best")
    if ckpt is None:
        return float("nan")
    pred_dir = os.path.join(workdir, f"pred_{arm}")
    return stitched_miou(state, data_root, val_scenes, pred_dir,
                         os.path.join(workdir, "groundtruth"), n_points=config.n_points,
                         batch_size=config.batch_size, device=device, layout="f32")


def run_diversity_matched(
    workdir: Optional[str] = None,
    budget_s: float = 1200.0,
    n_train_scenes: int = 8,
    n_val_scenes: int = 2,
    scene_points: int = 16000,
    n_points: int = 2048,
    batch_size: int = 4,
    replay_epochs: int = 32,
    n_devices: Optional[int] = None,
    seed: int = 0,
    results_path: Optional[str] = None,
    model_overrides: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Both arms within ``budget_s`` seconds each (the replay arm's
    precompute included); returns per-arm steps, seconds and mIoUs."""
    dev = resolve(device)
    check_devices(n_devices, batch_size, dev)
    workdir = workdir or tempfile.mkdtemp(prefix="psa_div_matched_")
    data_root = os.path.join(workdir, "scannet_synth")
    write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                            n_points=scene_points, seed=seed, color_coded=True)
    val_scenes = read_split(f"{data_root}/splits", "val")
    train_scenes = read_split(f"{data_root}/splits", "train")
    huge_epochs = 100000  # the wall clock stops both arms
    common = dict(data_root=data_root, model="sem_seg_features", n_points=n_points,
                  batch_size=batch_size, epochs=huge_epochs, seed=seed, n_epochs_to_val=50,
                  save_every_epochs=0, n_devices=n_devices, model_overrides=model_overrides)
    arms = {}

    cfg_s = TrainConfig(input="sampler", log_dir=os.path.join(workdir, "logs_sampler"),
                        **common)
    t0 = time.time()
    s = trainer.train(cfg_s, max_seconds=budget_s, device=dev)
    arms["sampler"] = {
        "steps": s["final_step"], "precompute_s": 0.0,
        "train_wall_s": round(time.time() - t0, 1),
        "best_val_miou": s.get("best_val_miou"),
        "offline_mean_iou": _offline_eval(cfg_s, data_root, val_scenes, workdir, "sampler",
                                          dev),
    }

    pre_dir = os.path.join(data_root, "precomputed")
    t0 = time.time()
    precompute.precompute_train_chunks(data_root, train_scenes, pre_dir, epochs=replay_epochs,
                                       npoints=n_points, seed=seed)
    precompute.precompute_val_chunks(data_root, val_scenes, pre_dir, npoints=n_points,
                                     seed=seed)
    t_pre = time.time() - t0
    cfg_r = TrainConfig(input="resident", wire_format="packed_q16",
                        log_dir=os.path.join(workdir, "logs_replay"), **common)
    t0 = time.time()
    r = trainer.train(cfg_r, max_seconds=max(0.0, budget_s - t_pre), device=dev)
    arms["replay_deep"] = {
        "steps": r["final_step"], "precompute_s": round(t_pre, 1),
        "train_wall_s": round(time.time() - t0, 1),
        "corpus_distinct_chunks": replay_epochs * n_train_scenes,
        "best_val_miou": r.get("best_val_miou"),
        "offline_mean_iou": _offline_eval(cfg_r, data_root, val_scenes, workdir, "replay",
                                          dev),
    }
    results = {
        "budget_s": budget_s,
        "arms": arms,
        "config": {"n_train_scenes": n_train_scenes, "scene_points": scene_points,
                   "n_points": n_points, "batch_size": batch_size,
                   "replay_epochs": replay_epochs, "seed": seed},
    }
    if results_path:
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None)
    p.add_argument("--budget_s", type=float, default=1200.0)
    p.add_argument("--replay_epochs", type=int, default=32)
    p.add_argument("--results_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run_diversity_matched(args.workdir, budget_s=args.budget_s,
                                replay_epochs=args.replay_epochs,
                                results_path=args.results_path, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
