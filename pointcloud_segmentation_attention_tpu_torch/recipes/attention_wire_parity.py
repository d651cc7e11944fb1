"""Attention-model learning parity of the q16 wire with the resident
corpus against f32, a copy of the JAX package's recipe: the same short
convergence run of ``sem_seg_attention`` twice, ``packed_q16`` with
``device_replay`` and the ``f32`` control, on the same scenes and seeds.

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.attention_wire_parity
[--device cuda|cpu]``
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

from pointcloud_segmentation_attention_tpu_torch.recipes.synthetic_convergence import (
    run_synthetic_convergence,
)


def run_attention_wire_parity(
    workdir: Optional[str] = None,
    n_train_scenes: int = 16,
    scene_points: int = 20000,
    n_points: int = 2048,
    batch_size: int = 4,
    epochs: int = 200,                 # 4 steps an epoch: 800 steps
    precompute_epochs: int = 4,
    n_devices: Optional[int] = None,
    seed: int = 0,
    results_path: Optional[str] = None,
    model_overrides: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Both arms through ``run_synthetic_convergence``; returns each arm's
    trainer and offline mIoU, steps and seconds."""
    workdir = workdir or tempfile.mkdtemp(prefix="psa_att_parity_")
    arms = {}
    for name, kw in (("f32", dict(wire_format="f32", device_replay=False)),
                     ("q16_resident", dict(wire_format="packed_q16", device_replay=True))):
        t0 = time.time()
        out = run_synthetic_convergence(
            os.path.join(workdir, name), model="sem_seg_attention",
            n_train_scenes=n_train_scenes, n_val_scenes=2, scene_points=scene_points,
            n_points=n_points, batch_size=batch_size, precompute_epochs=precompute_epochs,
            epochs=epochs, n_epochs_to_val=max(1, epochs // 8), n_devices=n_devices,
            seed=seed, model_overrides=model_overrides, device=device, **kw)
        arms[name] = {
            "trainer_best_val_miou": out["trainer_best_val_miou"],
            "offline_mean_iou": out["offline_mean_iou"],
            "final_step": out["final_step"],
            "wall_s": round(time.time() - t0, 1),
        }
    results = {
        "model": "sem_seg_attention",
        "arms": arms,
        "config": {"n_train_scenes": n_train_scenes, "scene_points": scene_points,
                   "n_points": n_points, "batch_size": batch_size, "epochs": epochs,
                   "precompute_epochs": precompute_epochs, "seed": seed},
    }
    if results_path:
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--n_train_scenes", type=int, default=16)
    p.add_argument("--results_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run_attention_wire_parity(args.workdir, epochs=args.epochs,
                                    n_train_scenes=args.n_train_scenes,
                                    results_path=args.results_path, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
