"""Zero-precompute training: raw scenes -> the device sampler -> stitched
eval, the port's copy of the JAX package's recipe.

A synthetic dataset is written and trained on with ``TrainConfig(input=
'sampler')`` (raw scenes on the device, a fresh chunk cut there every step,
validation on chunks cut on the fly): no precompute directory ever appears.
The final checkpoint is restored and every val scene served through
``ResidentSceneServer`` (q16), then scored by ``benchmark.evaluate``.

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.zero_precompute
[--device cuda|cpu]``
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

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
from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics


def run_zero_precompute(
    workdir: str,
    n_train_scenes: int = 8,
    n_val_scenes: int = 2,
    scene_points: int = 16000,
    n_points: int = 2048,
    batch_size: int = 4,
    epochs: int = 100,
    n_devices: Optional[int] = None,
    seed: int = 0,
    results_path: Optional[str] = None,
    n_epochs_to_val: Optional[int] = None,
    model_overrides: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Dataset -> ``train(input='sampler')`` -> resident-serving stitched
    eval; returns the offline mIoU, the last 10 epochs' losses, the final
    loss, the best val mIoU and the median of the per-epoch points/s."""
    dev = resolve(device)
    check_devices(n_devices, batch_size, dev)
    data_root = os.path.join(workdir, "scannet_synth")
    write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                            n_points=scene_points, seed=seed, color_coded=True)
    val_scenes = read_split(f"{data_root}/splits", "val")
    config = TrainConfig(
        data_root=data_root, model="sem_seg_features", input="sampler",
        log_dir=os.path.join(workdir, "logs"), n_points=n_points, batch_size=batch_size,
        epochs=epochs, seed=seed, n_epochs_to_val=n_epochs_to_val or max(1, epochs // 4),
        save_every_epochs=epochs, n_devices=n_devices, model_overrides=model_overrides)
    summary = trainer.train(config, device=dev)
    assert not os.path.exists(config.precompute_dir), \
        "zero-precompute trained, yet a precompute dir appeared"

    state, _ = restore_state(config, dev, first="ckpt", then="best")
    offline = stitched_miou(state, data_root, val_scenes, os.path.join(workdir, "predictions"),
                            os.path.join(workdir, "groundtruth"), n_points=n_points,
                            batch_size=batch_size, device=dev)
    records = read_metrics(os.path.join(config.log_dir, "train_metrics.jsonl"))
    loss_curve = [{"step": r["step"], "loss": r["train_loss"]}
                  for r in records if "train_loss" in r]
    pps = [r["points_per_sec"] for r in records if "points_per_sec" in r]
    results = {
        "offline_mean_iou": offline,
        "loss_curve": loss_curve[-10:],
        "final_loss": summary.get("final_train_loss", float("nan")),
        "best_val_miou": summary.get("best_val_miou"),
        # The median of the trainer's per-epoch rates (wall clock, host
        # pipeline included; the median skips the validating epochs).
        "median_points_per_sec": float(np.median(pps)) if pps else None,
        "config": {"n_train_scenes": n_train_scenes, "scene_points": scene_points,
                   "n_points": n_points, "batch_size": batch_size, "epochs": epochs,
                   "seed": seed},
    }
    if results_path:
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
    return results


def main(argv=None):
    import argparse
    import tempfile

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--n_train_scenes", type=int, default=8)
    p.add_argument("--n_val_scenes", type=int, default=2)
    p.add_argument("--n_epochs_to_val", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene_points", type=int, default=16000)
    p.add_argument("--n_points", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--results_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="psa_zero_pre_")
    out = run_zero_precompute(workdir, n_train_scenes=args.n_train_scenes,
                              n_val_scenes=args.n_val_scenes,
                              scene_points=args.scene_points, n_points=args.n_points,
                              batch_size=args.batch_size, epochs=args.epochs,
                              n_epochs_to_val=args.n_epochs_to_val, seed=args.seed,
                              results_path=args.results_path, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
