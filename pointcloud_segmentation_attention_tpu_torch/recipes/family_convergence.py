"""Convergence runs of every trainable model family, each through its own
trainer and evaluator: the port of the JAX package's
``recipes/family_convergence.py``.

- ``run_cls_convergence``: synthetic ModelNet (class-distinctive ellipsoid
  shells) -> ``train_classification`` -> the multi-angle voting evaluator
  (the PointNet++ classifiers and ``pointnet1_cls``, whose T-Net
  orthogonality loss is live).
- ``run_partseg_convergence``: synthetic ShapeNet-part (z-slice parts of
  category-distinctive ellipsoids) -> ``train_part_segmentation`` ->
  per-category part IoU.
- ``run_s3dis_convergence``: synthetic S3DIS rooms -> 1 m blocks ->
  ``train_s3dis`` (``pointnet1_sem_seg``) -> the rooms' block mIoU.
- ``run_attention_convergence``: the ScanNet pipeline with attention
  pooling (``synthetic_convergence`` with an attention model).
- ``run_attention_net_convergence``: the full attention nets through
  ``train(config)`` with the on-device sampler.
- ``run_v1_scannet_convergence``: geometry-coded synthetic ScanNet ->
  ``train_scannet_v1`` (``sem_seg``, xyz only) -> the whole-scene
  evaluator with the calibrated surface-voxel accuracy.
- ``run_extended`` (``main --extended``): the extension arms, ``cls_msg``
  with normals, ``part_seg_msg_one_hot`` against ``part_seg``,
  ``pointnet1_seg``, ``attention_net`` and the v1 whole-scene trainer.

Defaults equal the JAX package's; every ``run_*`` takes ``device`` (default
cuda).
"""
from __future__ import annotations

import json
import os
from typing import Optional

from pointcloud_segmentation_attention_tpu_torch.data.modelnet import write_synthetic_modelnet
from pointcloud_segmentation_attention_tpu_torch.data.s3dis import make_synthetic_room
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (
    read_split,
    write_synthetic_dataset,
)
from pointcloud_segmentation_attention_tpu_torch.data.shapenet_part import (
    write_synthetic_shapenet_part,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.synthetic_convergence import (
    run_synthetic_convergence,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.common import check_devices
from pointcloud_segmentation_attention_tpu_torch.train import trainer
from pointcloud_segmentation_attention_tpu_torch.train.cls_trainer import train_classification
from pointcloud_segmentation_attention_tpu_torch.train.partseg_trainer import (
    train_part_segmentation,
)
from pointcloud_segmentation_attention_tpu_torch.train.s3dis_trainer import train_s3dis
from pointcloud_segmentation_attention_tpu_torch.train.v1_scannet_trainer import (
    train_scannet_v1,
)
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig

_CACHE_SENTINEL = "DONE"


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
    check_devices(n_devices, batch_size, device)
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
    check_devices(n_devices, batch_size, device)
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


def run_s3dis_convergence(
    workdir: str,
    n_train_rooms: int = 4,
    n_test_rooms: int = 2,
    room_points: int = 8000,
    num_point: int = 512,
    batch_size: int = 8,
    epochs: int = 20,
    n_devices: Optional[int] = None,
    seed: int = 0,
    *,
    device="cuda",
) -> dict:
    """PointNet v1 S3DIS semantic segmentation: synthetic rooms -> block
    dataset -> ``train_s3dis`` -> the test rooms' block mIoU
    (``best_miou``).  Only floor, ceiling and wall are predictable from the
    geometry (the furniture blobs' classes are random per room), so the
    target is an mIoU well above chance from those classes."""
    check_devices(n_devices, batch_size, device)
    rooms = [make_synthetic_room(room_points, seed=seed + i)
             for i in range(n_train_rooms + n_test_rooms)]
    summary = train_s3dis(rooms[:n_train_rooms], rooms[n_train_rooms:], num_point=num_point,
                          batch_size=batch_size, epochs=epochs,
                          log_dir=os.path.join(workdir, "s3dis"), n_devices=n_devices,
                          seed=seed, device=device)
    summary["model"] = "pointnet1_sem_seg"
    return summary


def run_v1_scannet_convergence(
    workdir: str,
    dataset_kind: str = "whole",
    n_train_scenes: int = 6,
    n_val_scenes: int = 2,
    scene_points: int = 20000,
    npoints: int = 2048,
    batch_size: int = 4,
    epochs: int = 8,
    n_devices: Optional[int] = None,
    seed: int = 0,
    max_steps: Optional[int] = None,
    *,
    device="cuda",
) -> dict:
    """The upstream ScanNet v1 trainer end to end: whole-scene (or chunk or
    virtual-scan) training batches with weighted point dropout, then the
    whole-scene evaluator with point accuracy, mIoU and the calibrated
    surface-voxel accuracy.  The rooms are geometry-coded: the v1 trainer
    feeds xyz only, so their blob labels must be predictable from the
    geometry for the held-out mIoU to show learning."""
    check_devices(n_devices, batch_size, device)
    data_root = os.path.join(
        workdir, f"scannet_v1g_{n_train_scenes}_{n_val_scenes}_{scene_points}_{seed}")
    if not _cache_complete(data_root):
        write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                                n_points=scene_points, seed=seed, color_coded=True,
                                geometry_coded=True)
        _mark_cache_complete(data_root)
    splits = os.path.join(data_root, "splits")
    summary = train_scannet_v1(
        data_root, read_split(splits, "train"), read_split(splits, "val"), npoints=npoints,
        batch_size=batch_size, epochs=epochs,
        log_dir=os.path.join(workdir, f"v1_scannet_{dataset_kind}"), n_devices=n_devices,
        seed=seed, dataset_kind=dataset_kind, max_steps=max_steps, device=device)
    summary["model"] = "sem_seg (v1 trainer)"
    summary["dataset_kind"] = dataset_kind
    return summary


def run_attention_net_convergence(
    workdir: str,
    model: str = "attention_net",
    n_train_scenes: int = 8,
    n_val_scenes: int = 2,
    scene_points: int = 16000,
    n_points: int = 2048,
    batch_size: int = 4,
    max_steps: int = 200,
    n_devices: Optional[int] = None,
    seed: int = 0,
    *,
    device="cuda",
) -> dict:
    """A full attention net (``attention_net``, ``attention_net_mlp`` or
    ``pooling_attention_net``) through ``train(config)`` with the
    on-device sampler, its validation and best checkpoint: the trainer's
    summary (``final_train_loss``, ``best_val_miou``, ``final_step``)."""
    check_devices(n_devices, batch_size, device)
    data_root = os.path.join(
        workdir, f"scannet_attnet_{n_train_scenes}_{n_val_scenes}_{scene_points}_{seed}")
    if not _cache_complete(data_root):
        write_synthetic_dataset(data_root, n_train=n_train_scenes, n_val=n_val_scenes,
                                n_points=scene_points, seed=seed, color_coded=True)
        _mark_cache_complete(data_root)
    config = TrainConfig(
        data_root=data_root, model=model, input="sampler",
        log_dir=os.path.join(workdir, f"attnet_{model}"), n_points=n_points,
        batch_size=batch_size, seed=seed, epochs=10**6,
        n_epochs_to_val=max(1, max_steps // max(1, n_train_scenes // batch_size) // 6),
        save_every_epochs=0, n_devices=n_devices)
    summary = trainer.train(config, max_steps=max_steps, device=device)
    summary["model"] = model
    return summary


def run_extended(workdir: str, epochs: int = 60, n_devices: Optional[int] = None,
                 seed: int = 0, *, device="cuda") -> dict:
    """The extension arms: every family beyond the default arms trained to
    shown learning.  ``part_seg_msg_one_hot`` trains on the same corpus and
    seed as ``part_seg``, and the difference of their class-average IoU is
    recorded (``one_hot_minus_plain_class_avg_iou``): what the object-class
    conditioning adds.  The attention net and the v1 whole-scene arm run at
    their own defaults."""
    common = dict(n_devices=n_devices, seed=seed, device=device)
    results = {"cls_msg": run_cls_convergence(workdir, "cls_msg", epochs=epochs,
                                              normal_channel=True, **common)}
    plain = run_partseg_convergence(workdir, "part_seg", epochs=epochs, **common)
    onehot = run_partseg_convergence(workdir, "part_seg_msg_one_hot", epochs=epochs, **common)
    results["part_seg"] = plain
    results["part_seg_msg_one_hot"] = onehot
    results["one_hot_minus_plain_class_avg_iou"] = (
        onehot.get("best_class_avg_iou", 0.0) - plain.get("best_class_avg_iou", 0.0))
    results["pointnet1_seg"] = run_partseg_convergence(workdir, "pointnet1_seg",
                                                       epochs=epochs, **common)
    results["attention_net"] = run_attention_net_convergence(workdir, **common)
    results["v1_scannet_whole"] = run_v1_scannet_convergence(workdir, dataset_kind="whole",
                                                             **common)
    return results


# main's arms: name -> (function, keyword arguments).  main passes --epochs
# to every arm but the v1 whole-scene one, which keeps its 8 epochs as in
# ``run_extended``.  The default arms are the JAX main's (cls_ssg,
# pointnet1_cls, part_seg, pointnet1_sem_seg, then the attention arm); the
# others are its extended arms, each alone.
ARMS = {
    "cls_ssg": (run_cls_convergence, dict(model_name="cls_ssg")),
    "pointnet1_cls": (run_cls_convergence, dict(model_name="pointnet1_cls")),
    "part_seg": (run_partseg_convergence, dict(model_name="part_seg")),
    "pointnet1_sem_seg": (run_s3dis_convergence, {}),
    "cls_msg": (run_cls_convergence, dict(model_name="cls_msg", normal_channel=True)),
    "part_seg_msg_one_hot": (run_partseg_convergence,
                             dict(model_name="part_seg_msg_one_hot")),
    "pointnet1_seg": (run_partseg_convergence, dict(model_name="pointnet1_seg")),
    "v1_scannet_whole": (run_v1_scannet_convergence, dict(dataset_kind="whole")),
}
DEFAULT_ARMS = ("cls_ssg", "pointnet1_cls", "part_seg", "pointnet1_sem_seg")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="logs/family_convergence")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--attention_epochs", type=int, default=100)
    p.add_argument("--results", default=None)
    p.add_argument("--arms", nargs="+", default=list(DEFAULT_ARMS),
                   help=f"any of {sorted(ARMS)}")
    p.add_argument("--skip_attention", action="store_true")
    p.add_argument("--extended", action="store_true",
                   help="run the extension arms (run_extended) instead, into "
                        "results_ext.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.extended:
        results = run_extended(args.workdir, epochs=args.epochs, device=args.device)
        out = args.results or os.path.join(args.workdir, "results_ext.json")
        with open(out, "w") as f:
            json.dump(results, f, indent=2, default=float)
        print(json.dumps(results, indent=2, default=float))
        return results
    unknown = [a for a in args.arms if a not in ARMS]
    if unknown:
        raise ValueError(f"unknown arms {unknown}; available: {sorted(ARMS)}")
    results = {}
    for arm in args.arms:
        fn, kw = ARMS[arm]
        # The JAX main caps the S3DIS arm at 30 epochs.
        epochs = min(args.epochs, 30) if fn is run_s3dis_convergence else args.epochs
        if fn is not run_v1_scannet_convergence:
            kw = dict(kw, epochs=epochs)
        results[arm] = fn(args.workdir, device=args.device, **kw)
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
