"""The Report's Table 4 context-margin ablation through the port, a copy
of the JAX package's recipe.

Whole-scene eval cells grown by a context margin carry neighbouring points
as context while only home-cell points are stitched back; the Report
credits this with val mIoU 0.490 -> 0.517, same model, eval time only.
One ``sem_seg_features`` model trains through ``input='sampler'``, then the
resident-serving eval runs at every margin (0: cells only; 0.2: the
default).

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.context_margin
[--device cuda|cpu]``
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

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

REFERENCE_TABLE4 = {"without_context": 0.490, "with_context": 0.517}


def run_context_margin(
    workdir: str,
    margins: Sequence[float] = (0.0, 0.2),
    n_train_scenes: int = 8,
    n_val_scenes: int = 3,
    scene_points: int = 40000,
    n_points: int = 2048,
    batch_size: int = 4,
    max_steps: int = 400,
    n_devices: Optional[int] = None,
    seed: int = 0,
    results_path: Optional[str] = None,
    model_overrides: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Train once (default margin) and evaluate at every margin; returns
    the offline mIoU by margin, the last minus the first, the best val
    mIoU and the reference numbers."""
    dev = resolve(device)
    check_devices(n_devices, batch_size, dev)
    data_root = os.path.join(workdir, "scannet_synth")
    if not os.path.exists(os.path.join(data_root, "splits")):
        write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                                n_points=scene_points, seed=seed, color_coded=True)
    val_scenes = read_split(f"{data_root}/splits", "val")
    config = TrainConfig(
        data_root=data_root, model="sem_seg_features", input="sampler",
        log_dir=os.path.join(workdir, "train"), n_points=n_points, batch_size=batch_size,
        seed=seed, epochs=10**6,
        n_epochs_to_val=max(1, max_steps // max(1, n_train_scenes // batch_size) // 8),
        save_every_epochs=0, n_devices=n_devices, model_overrides=model_overrides)
    summary = trainer.train(config, max_steps=max_steps, device=dev)
    state, _ = restore_state(config, dev)
    per_margin = {
        str(m): stitched_miou(state, data_root, val_scenes,
                              os.path.join(workdir, f"preds_margin{m}"),
                              os.path.join(workdir, "groundtruth"), n_points=n_points,
                              batch_size=batch_size, device=dev, margin=m)
        for m in margins}
    out = {
        "offline_miou_by_margin": per_margin,
        "delta_with_minus_without": per_margin[str(margins[-1])] - per_margin[str(margins[0])],
        "best_val_miou": summary.get("best_val_miou"),
        "reference_table4": REFERENCE_TABLE4,
        "config": {
            "margins": list(margins), "n_train_scenes": n_train_scenes,
            "n_val_scenes": n_val_scenes, "scene_points": scene_points,
            "n_points": n_points, "batch_size": batch_size, "max_steps": max_steps,
            "seed": seed,
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
    p.add_argument("--max_steps", type=int, default=400)
    p.add_argument("--results_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="psa_margin_")
    out = run_context_margin(workdir, max_steps=args.max_steps,
                             results_path=args.results_path, device=args.device)
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
