"""The Report's Table 1 attention ablation through the port, a copy of the
JAX package's recipe.

The PointNet++ baseline, the all-attention model, the four single-layer
variants (L1..L4) and attention-plus-pooling train on the same first-third
subset of one synthetic corpus at matched steps, xyz only (as the
reference's attention arms), through ``input='sampler'``; each arm is then
evaluated on its best-val checkpoint through resident serving.  The
published val mIoUs (Report Table 1, the third subset):

    baseline .361 > att-L4 .337 > att-L2 .326 > att-L3 .325 > att-L1 .293
    > att-all .178

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.attention_ablation
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
    refuse_devices,
    restore_state,
    stitched_miou,
)
from pointcloud_segmentation_attention_tpu_torch.train import trainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig

# Report Table 1, val mIoU on the third subset; att+pool has no row.
REFERENCE_TABLE1_VAL_MIOU = {
    "baseline": 0.361,
    "att_all": 0.178,
    "att_L1": 0.293,
    "att_L2": 0.326,
    "att_L3": 0.325,
    "att_L4": 0.337,
    "att_pool": None,
}

# arm -> (registry model name, extra TrainConfig fields)
ARMS = {
    "baseline": ("sem_seg", {}),
    "att_all": ("sem_seg_attention", {}),
    "att_L1": ("sem_seg_attention_single_layer", {"attention_single_layer": 0}),
    "att_L2": ("sem_seg_attention_single_layer", {"attention_single_layer": 1}),
    "att_L3": ("sem_seg_attention_single_layer", {"attention_single_layer": 2}),
    "att_L4": ("sem_seg_attention_single_layer", {"attention_single_layer": 3}),
    "att_pool": ("sem_seg_attention_and_pooling", {}),
}


def run_attention_ablation(
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
    """Train every arm on the same corpus (``use_subset=True``: the first
    third of the train split) for ``max_steps`` and evaluate each; returns
    {'arms': {arm: metrics}, the ordering, the reference ordering, config}."""
    dev = resolve(device)
    refuse_devices(n_devices)
    data_root = os.path.join(workdir, "scannet_synth")
    if not os.path.exists(os.path.join(data_root, "splits")):
        # geometry_coded: the arms see xyz only, so labels must follow from
        # geometry for held-out rooms to be learnable at all.
        write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                                n_points=scene_points, seed=seed, color_coded=True,
                                geometry_coded=True)
    val_scenes = read_split(f"{data_root}/splits", "val")

    results = {}
    for arm in (arms or ARMS):
        model, extra = ARMS[arm]
        t0 = time.time()
        config = TrainConfig(
            data_root=data_root, model=model, input="sampler", use_colors=False,
            use_normals=False, use_subset=True, log_dir=os.path.join(workdir, f"arm_{arm}"),
            n_points=n_points, batch_size=batch_size, seed=seed, epochs=10**6,
            save_every_epochs=0, n_devices=n_devices,
            # ~12 validations an arm: an epoch of the subset is a few steps.
            n_epochs_to_val=max(
                1, max_steps // max(1, (n_train_scenes // 3) // batch_size) // 12),
            model_overrides=model_overrides, **extra)
        summary = trainer.train(config, max_steps=max_steps, device=dev)
        state, _ = restore_state(config, dev)
        offline = stitched_miou(state, data_root, val_scenes,
                                os.path.join(workdir, f"preds_{arm}"),
                                os.path.join(workdir, "groundtruth"), n_points=n_points,
                                batch_size=batch_size, device=dev, use_colors=False,
                                use_normals=False)
        results[arm] = {
            "model": model, **extra,
            "best_val_miou": summary.get("best_val_miou"),
            "offline_mean_iou": offline,
            "final_train_loss": summary.get("final_train_loss"),
            "steps": max_steps,
            "wall_seconds": round(time.time() - t0, 1),
            "reference_val_miou": REFERENCE_TABLE1_VAL_MIOU.get(arm),
        }
        print(json.dumps({arm: results[arm]}), flush=True)

    out = {
        "arms": results,
        "ordering_by_offline_miou": sorted(results, key=lambda a: -results[a]["offline_mean_iou"]),
        "reference_ordering": ["baseline", "att_L4", "att_L2", "att_L3", "att_L1", "att_all"],
        "config": {
            "n_train_scenes": n_train_scenes, "use_subset": True,
            "n_val_scenes": n_val_scenes, "scene_points": scene_points,
            "n_points": n_points, "batch_size": batch_size, "max_steps": max_steps,
            "seed": seed, "features": "xyz only (like ref Table 1 arms)",
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
    workdir = args.workdir or tempfile.mkdtemp(prefix="psa_ablation_")
    out = run_attention_ablation(workdir, max_steps=args.max_steps,
                                 scene_points=args.scene_points,
                                 results_path=args.results_path, device=args.device)
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
