"""End-to-end convergence on synthetic ScanNet, the port's copy of the JAX
package's recipe: the whole reference training recipe in one command.

1. ``write_synthetic_dataset(color_coded=True)``: rooms whose colors and
   normals encode the labels;
2. ``precompute_train_chunks`` / ``precompute_val_chunks``;
3. ``train.trainer.train`` on ``sem_seg_features`` with the real schedules,
   class-weighted loss, streaming val mIoU and the best checkpoint;
4. the best checkpoint restored, the val scenes predicted whole
   (``eval/full_scene.py``: grid chunks with context margins, masked
   stitch) and exported as benchmark txt files;
5. the ground truth exported and scored by ``benchmark.evaluate``, beside
   the trainer's streaming val mIoU.

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.synthetic_convergence
[--device cuda|cpu]``
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (
    load_scene,
    read_split,
    write_synthetic_dataset,
)
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.eval import benchmark
from pointcloud_segmentation_attention_tpu_torch.eval.full_scene import (
    generate_predictions,
    make_predict_fn,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.common import refuse_devices
from pointcloud_segmentation_attention_tpu_torch.train import trainer
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import (
    best_checkpoint,
    restore_checkpoint,
)
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig


def run_synthetic_convergence(
    workdir: str,
    n_train_scenes: int = 8,
    n_val_scenes: int = 2,
    scene_points: int = 16000,
    n_points: int = 2048,
    batch_size: int = 4,
    precompute_epochs: int = 4,
    epochs: int = 100,
    n_epochs_to_val: int = 10,
    n_devices: Optional[int] = None,
    seed: int = 0,
    results_path: Optional[str] = None,
    model: str = "sem_seg_features",
    use_colors: bool = True,
    use_normals: bool = True,
    wire_format: str = "f32",
    device_replay: bool = False,
    resident_augment: bool = False,
    model_overrides: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Run the pipeline; returns ``trainer_best_val_miou`` (the streaming
    metric on val chunks) and ``offline_mean_iou`` (the benchmark evaluator
    on stitched whole scenes), with the per-class IoUs."""
    dev = resolve(device)
    refuse_devices(n_devices)
    data_root = os.path.join(workdir, "scannet_synth")
    pred_dir = os.path.join(workdir, "predictions")
    gt_dir = os.path.join(workdir, "groundtruth")
    write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                            n_points=scene_points, seed=seed, color_coded=True)
    train_scenes = read_split(f"{data_root}/splits", "train")
    val_scenes = read_split(f"{data_root}/splits", "val")
    pre_dir = os.path.join(data_root, "precomputed")
    precompute.precompute_train_chunks(data_root, train_scenes, pre_dir,
                                       epochs=precompute_epochs, npoints=n_points, seed=seed)
    precompute.precompute_val_chunks(data_root, val_scenes, pre_dir, npoints=n_points,
                                     seed=seed)

    config = TrainConfig(
        data_root=data_root, n_points=n_points, model=model, use_colors=use_colors,
        use_normals=use_normals, epochs=epochs, batch_size=batch_size,
        n_epochs_to_val=n_epochs_to_val, seed=seed, log_dir=os.path.join(workdir, "logs"),
        n_devices=n_devices, save_every_epochs=0, wire_format=wire_format,
        device_replay=device_replay, resident_augment=resident_augment,
        model_overrides=model_overrides)
    summary = trainer.train(config, device=dev)

    ckpt = best_checkpoint(config.ckpt_dir, prefix="best")
    if ckpt is None:
        raise RuntimeError("training saved no best checkpoint")
    state = trainer.make_eval_state(config, device=dev)
    restore_checkpoint(ckpt, state)
    predict_fn = make_predict_fn(state.model, device=dev)
    pred_files = [
        os.path.join(pred_dir, f"{res['scene_name']}.txt")
        for res in generate_predictions(predict_fn, data_root, val_scenes, pred_dir,
                                        use_colors=use_colors, use_normals=use_normals,
                                        batch_size=batch_size, npoints=n_points,
                                        save_npy=False)]
    os.makedirs(gt_dir, exist_ok=True)
    gt_files = []
    for name in val_scenes:
        path = os.path.join(gt_dir, f"{name}.txt")
        benchmark.export_ids(path, load_scene(data_root, name)["labels"].astype(np.int64))
        gt_files.append(path)
    offline = benchmark.evaluate(pred_files, gt_files,
                                 output_file=os.path.join(workdir, "results.txt"))

    results = {
        "trainer_best_val_miou": summary.get("best_val_miou"),
        "offline_mean_iou": offline["mean_iou"],
        "offline_per_class": {k: v for k, v in offline.items()
                              if k != "mean_iou" and not np.isnan(v)},
        "final_step": summary.get("final_step"),
        "config": {
            "model": model, "n_train_scenes": n_train_scenes, "n_val_scenes": n_val_scenes,
            "scene_points": scene_points, "n_points": n_points, "batch_size": batch_size,
            "epochs": epochs, "precompute_epochs": precompute_epochs, "seed": seed,
        },
    }
    if results_path:
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="logs/synthetic_convergence")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--n_train_scenes", type=int, default=8)
    p.add_argument("--n_val_scenes", type=int, default=2)
    p.add_argument("--scene_points", type=int, default=16000)
    p.add_argument("--precompute_epochs", type=int, default=4)
    p.add_argument("--n_points", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    results = run_synthetic_convergence(
        args.workdir, n_train_scenes=args.n_train_scenes, n_val_scenes=args.n_val_scenes,
        scene_points=args.scene_points, precompute_epochs=args.precompute_epochs,
        epochs=args.epochs, n_points=args.n_points, batch_size=args.batch_size,
        results_path=os.path.join(args.workdir, "results.json"), device=args.device)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
