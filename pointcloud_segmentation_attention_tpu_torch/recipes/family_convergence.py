"""Convergence runs of the PointNet++ classification and part-segmentation
families, each through its own trainer and evaluator: the port of the JAX
package's ``recipes/family_convergence.py``.

- ``run_cls_convergence``: synthetic ModelNet (class-distinctive ellipsoid
  shells) -> ``train_classification`` -> the multi-angle voting evaluator.
- ``run_partseg_convergence``: synthetic ShapeNet-part (z-slice parts of
  category-distinctive ellipsoids) -> ``train_part_segmentation`` ->
  per-category part IoU.
- ``run_attention_convergence``: the ScanNet pipeline with attention
  pooling (``synthetic_convergence`` with an attention model).

The PointNet v1 and full-attention-net arms (``run_s3dis_convergence``,
``run_v1_scannet_convergence``, ``run_attention_net_convergence`` and
``run_extended``, which trains some of them) raise ``NotImplementedError``:
those families are not ported yet (ROADMAP Queue 1 item 6).  Defaults equal
the JAX package's; every ``run_*`` takes ``device`` (default cuda).
"""
from __future__ import annotations

import json
import os
from typing import Optional

from pointcloud_segmentation_attention_tpu_torch.data.modelnet import write_synthetic_modelnet
from pointcloud_segmentation_attention_tpu_torch.data.shapenet_part import (
    write_synthetic_shapenet_part,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.synthetic_convergence import (
    run_synthetic_convergence,
)
from pointcloud_segmentation_attention_tpu_torch.train.cls_trainer import train_classification
from pointcloud_segmentation_attention_tpu_torch.train.partseg_trainer import (
    train_part_segmentation,
)

_CACHE_SENTINEL = "DONE"
_NOT_PORTED = ("the PointNet v1 and full-attention-net families are not ported yet "
               "(ROADMAP Queue 1 item 6)")


def _cache_complete(data_root: str) -> bool:
    """Only the sentinel written after a finished generation marks a cached
    corpus valid: a crashed generation leaves a partial directory."""
    return os.path.exists(os.path.join(data_root, _CACHE_SENTINEL))


def _mark_cache_complete(data_root: str) -> None:
    with open(os.path.join(data_root, _CACHE_SENTINEL), "w") as f:
        f.write("ok\n")


def run_cls_convergence(
    workdir: str,
    model_name: str = "cls_ssg",
    num_classes: int = 8,
    shapes_per_class: int = 6,
    n_points: int = 256,
    batch_size: int = 8,
    epochs: int = 30,
    num_votes: int = 3,
    n_devices: Optional[int] = None,
    seed: int = 0,
    normal_channel: bool = False,
    *,
    device="cuda",
) -> dict:
    """Train a classifier on a synthetic ModelNet and evaluate it with
    voting; the summary's ``best_accuracy`` against ``chance_accuracy``
    (1 / num_classes) shows learning.  ``normal_channel`` feeds the normals
    as features (the reference's '+normals' MSG configuration)."""
    # The cache key carries every generation parameter.
    data_root = os.path.join(
        workdir, f"modelnet_synth_c{num_classes}_s{shapes_per_class}"
                 f"_n{max(n_points, 256)}_{seed}")
    if not _cache_complete(data_root):
        write_synthetic_modelnet(data_root, num_classes=num_classes,
                                 shapes_per_class=shapes_per_class,
                                 n_points=max(n_points, 256), seed=seed)
        _mark_cache_complete(data_root)
    summary = train_classification(
        data_root, model_name=model_name, num_classes=num_classes, npoints=n_points,
        batch_size=batch_size, epochs=epochs, num_votes=num_votes,
        log_dir=os.path.join(workdir, f"cls_{model_name}"), n_devices=n_devices, seed=seed,
        normal_channel=normal_channel, device=device)
    summary["chance_accuracy"] = 1.0 / num_classes
    summary["model"] = model_name
    return summary


def run_partseg_convergence(
    workdir: str,
    model_name: str = "part_seg",
    n_shapes_per_cat: int = 8,
    n_points: int = 256,
    batch_size: int = 4,
    epochs: int = 30,
    n_devices: Optional[int] = None,
    seed: int = 0,
    *,
    device="cuda",
) -> dict:
    """Train a part segmenter on a synthetic ShapeNet-part and evaluate the
    per-category part IoU (``best_class_avg_iou``)."""
    data_root = os.path.join(
        workdir, f"shapenet_synth_s{n_shapes_per_cat}_n{max(n_points, 256)}_{seed}")
    if not _cache_complete(data_root):
        write_synthetic_shapenet_part(data_root, n_shapes_per_cat=n_shapes_per_cat,
                                      n_points=max(n_points, 256), seed=seed)
        _mark_cache_complete(data_root)
    summary = train_part_segmentation(
        data_root, model_name=model_name, npoints=n_points, batch_size=batch_size,
        epochs=epochs, log_dir=os.path.join(workdir, f"partseg_{model_name}"),
        n_devices=n_devices, seed=seed, device=device)
    summary["model"] = model_name
    return summary


def run_attention_convergence(workdir: str, model: str = "sem_seg_attention",
                              **kwargs) -> dict:
    """The full ScanNet pipeline (precompute -> train -> stitched full-scene
    evaluation) with attention pooling; ``kwargs`` (``device`` among them)
    go to ``run_synthetic_convergence``."""
    results = run_synthetic_convergence(os.path.join(workdir, f"attention_{model}"),
                                        model=model, **kwargs)
    results["model"] = model
    return results


def run_s3dis_convergence(workdir: str, **kwargs) -> dict:
    """PointNet v1 S3DIS semantic segmentation: not ported yet."""
    raise NotImplementedError(f"run_s3dis_convergence: {_NOT_PORTED}")


def run_v1_scannet_convergence(workdir: str, **kwargs) -> dict:
    """The upstream ScanNet v1 trainer: not ported yet."""
    raise NotImplementedError(f"run_v1_scannet_convergence: {_NOT_PORTED}")


def run_attention_net_convergence(workdir: str, **kwargs) -> dict:
    """The Keras-style AttentionNet family: not ported yet."""
    raise NotImplementedError(f"run_attention_net_convergence: {_NOT_PORTED}")


def run_extended(workdir: str, **kwargs) -> dict:
    """The extension arms, which train ``pointnet1_seg``, ``attention_net``
    and the v1 whole-scene trainer besides the ported families: not ported
    yet.  Their ported arms run alone through ``main --arms``."""
    raise NotImplementedError(f"run_extended: {_NOT_PORTED}")


# main's arms: name -> (function, keyword arguments besides epochs).  The
# JAX main runs cls_ssg, pointnet1_cls, part_seg, pointnet1_sem_seg and the
# attention arm; cls_msg and part_seg_msg_one_hot are its extended arms.
ARMS = {
    "cls_ssg": (run_cls_convergence, dict(model_name="cls_ssg")),
    "cls_msg": (run_cls_convergence, dict(model_name="cls_msg", normal_channel=True)),
    "part_seg": (run_partseg_convergence, dict(model_name="part_seg")),
    "part_seg_msg_one_hot": (run_partseg_convergence,
                             dict(model_name="part_seg_msg_one_hot")),
}
UNPORTED_ARMS = ("pointnet1_cls", "pointnet1_seg", "pointnet1_sem_seg", "attention_net",
                 "v1_scannet_whole")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="logs/family_convergence")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--attention_epochs", type=int, default=100)
    p.add_argument("--results", default=None)
    p.add_argument("--arms", nargs="+", default=["cls_ssg", "part_seg"],
                   help=f"any of {sorted(ARMS)}; {list(UNPORTED_ARMS)} are not ported yet")
    p.add_argument("--skip_attention", action="store_true")
    p.add_argument("--extended", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    unported = [a for a in args.arms if a in UNPORTED_ARMS]
    if args.extended or unported:
        raise NotImplementedError(f"{'--extended' if args.extended else unported}: "
                                  f"{_NOT_PORTED}")
    unknown = [a for a in args.arms if a not in ARMS]
    if unknown:
        raise ValueError(f"unknown arms {unknown}; available: {sorted(ARMS)}")
    os.makedirs(args.workdir, exist_ok=True)
    results = {}
    for arm in args.arms:
        fn, kw = ARMS[arm]
        results[arm] = fn(args.workdir, epochs=args.epochs, device=args.device, **kw)
    if not args.skip_attention:
        results["sem_seg_attention"] = run_attention_convergence(
            args.workdir, epochs=args.attention_epochs, n_train_scenes=8, n_val_scenes=2,
            scene_points=16000, n_points=2048, batch_size=4, precompute_epochs=4,
            n_epochs_to_val=max(args.attention_epochs // 10, 1), device=args.device)
    out = args.results or os.path.join(args.workdir, "results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
