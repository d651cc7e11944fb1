"""The Report's Table 3 feature ablation through the port, a copy of the
JAX package's recipe.

The PointNet++ baseline on xyz alone, then the features model with colors,
normals, and both, all on the full train set of one synthetic corpus that
carries both signals (``geometry_coded`` and ``color_coded``), at matched
steps through ``input='sampler'``; each arm's feature flags reach the
trainer and the resident-serving eval.  The published val mIoUs (Report
Table 3, full train set):

    baseline .456 < +colors .461 < +normals .509 < +both .533

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.feature_ablation
[--device cuda|cpu]``
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

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

# Report Table 3 (val mIoU, full train set).
REFERENCE_TABLE3_VAL_MIOU = {
    "baseline": 0.456,
    "colors": 0.461,
    "normals": 0.509,
    "both": 0.533,
}

# arm -> (registry model name, use_colors, use_normals)
ARMS = {
    "baseline": ("sem_seg", False, False),
    "colors": ("sem_seg_features", True, False),
    "normals": ("sem_seg_features", False, True),
    "both": ("sem_seg_features", True, True),
}


def run_feature_ablation(
    workdir: str,
    n_train_scenes: int = 12,
    n_val_scenes: int = 3,
    scene_points: int = 40000,
    n_points: int = 2048,
    batch_size: int = 4,
    max_steps: int = 600,
    n_devices: Optional[int] = None,
    seed: int = 0,
    arms=None,
    results_path: Optional[str] = None,
    model_overrides: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Train every feature arm on the same corpus (the full train split) for
    ``max_steps`` and evaluate each; returns {'arms': {arm: metrics}, the
    ordering, the reference ordering, config}."""
    dev = resolve(device)
    check_devices(n_devices, batch_size, dev)
    data_root = os.path.join(workdir, "scannet_synth")
    if not os.path.exists(os.path.join(data_root, "splits")):
        write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                                n_points=scene_points, seed=seed, color_coded=True,
                                geometry_coded=True)
    val_scenes = read_split(f"{data_root}/splits", "val")

    results = {}
    for arm in (arms or ARMS):
        model, use_colors, use_normals = ARMS[arm]
        t0 = time.time()
        config = TrainConfig(
            data_root=data_root, model=model, input="sampler", use_colors=use_colors,
            use_normals=use_normals, log_dir=os.path.join(workdir, f"arm_{arm}"),
            n_points=n_points, batch_size=batch_size, seed=seed, epochs=10**6,
            save_every_epochs=0, n_devices=n_devices,
            # ~12 validations an arm, keyed to the step budget.
            n_epochs_to_val=max(1, max_steps // max(1, n_train_scenes // batch_size) // 12),
            model_overrides=model_overrides)
        summary = trainer.train(config, max_steps=max_steps, device=dev)
        state, _ = restore_state(config, dev)
        offline = stitched_miou(state, data_root, val_scenes,
                                os.path.join(workdir, f"preds_{arm}"),
                                os.path.join(workdir, "groundtruth"), n_points=n_points,
                                batch_size=batch_size, device=dev, use_colors=use_colors,
                                use_normals=use_normals)
        results[arm] = {
            "model": model, "use_colors": use_colors, "use_normals": use_normals,
            "best_val_miou": summary.get("best_val_miou"),
            "offline_mean_iou": offline,
            "final_train_loss": summary.get("final_train_loss"),
            "steps": max_steps,
            "wall_seconds": round(time.time() - t0, 1),
            "reference_val_miou": REFERENCE_TABLE3_VAL_MIOU.get(arm),
        }
        print(json.dumps({arm: results[arm]}), flush=True)

    out = {
        "arms": results,
        "ordering_by_offline_miou": sorted(results, key=lambda a: -results[a]["offline_mean_iou"]),
        "reference_ordering": ["both", "normals", "colors", "baseline"],
        "config": {
            "n_train_scenes": n_train_scenes, "n_val_scenes": n_val_scenes,
            "scene_points": scene_points, "n_points": n_points, "batch_size": batch_size,
            "max_steps": max_steps, "seed": seed,
            "corpus": "geometry_coded + color_coded (both signals)",
        },
    }
    if results_path:
        with open(results_path, "w") as f:
            json.dump(out, f, indent=1, default=float)
    return out


def main(argv=None):
    import argparse
    import tempfile

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None)
    p.add_argument("--max_steps", type=int, default=600)
    p.add_argument("--scene_points", type=int, default=40000)
    p.add_argument("--results_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="psa_featabl_")
    out = run_feature_ablation(workdir, max_steps=args.max_steps,
                               scene_points=args.scene_points,
                               results_path=args.results_path, device=args.device)
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
