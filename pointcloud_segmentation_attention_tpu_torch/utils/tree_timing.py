"""End-to-end times of one checkout of this repository on the card, so that
two checkouts (a parent commit and a change) can be run in turns in one
session on one card.

    python3 pointcloud_segmentation_attention_tpu_torch/utils/tree_timing.py TREE [--tag NAME]
        [--model NAME [--layer-idx I]]

Imports the package from the checkout at ``TREE``, not from the tree this
file lives in, builds its kernels, and measures a full-width registry model
(``--model``, default ``sem_seg_features``; ``--layer-idx`` for
``sem_seg_attention_single_layer``) with seeded weights (TF32 off), fed
colors and normals where the model takes them, else xyz only:

- ``forward_ms``: one B16 x 8192 eval forward, CUDA events around bursts of
  5, median of 20 bursts; ``forward_device_ms``: the device time of one
  forward, the profiler's kernel, copy and set events over 5 forwards;
- ``step_ms``: median of 10 ``seg_train_step``s at B16 x 8192 after 3 warm-up
  steps, CUDA events around each, on batches of random chunks of synthetic
  150k-point rooms made before the window; ``step_device_ms`` likewise from
  the profiler over 3 steps;
- ``serve_points_per_s``: one synthetic 150k-point room served (chunk,
  predict in B16 batches, stitch) after one warm-up room;
- ``interp_levels``: at FP1-4 of one B16 x 8192 forward's geometry, the
  device ms of the interpolation kernel, of its backward with dw and
  without (the train step's case), from the profiler over 10 calls each;
- ``gather_levels``: at SA2-4 of the same geometry (ball-query idx, C
  67/131/259) and at the large N of ``chip_smoke.py`` (2 x 4096 x 32 random
  idx into 33,024 rows, C 64), the device ms of the gather backward, from
  the profiler over 10 calls each.

Prints one JSON line with the card's name and power limit.  Needs a CUDA
card; it does not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

EXTENT = np.array([1.9, 1.9, 2.6], np.float32)
BATCH, NPOINTS = 16, 8192


def _device_ms(fn, calls: int) -> float:
    """Device time of one call: kernel, copy and set events, summed."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / calls


def _events_ms(fn, reps: int, burst: int) -> list:
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / burst)
    return out


def _kernel_levels(dev) -> tuple:
    """(interp_levels, gather_levels): the backward kernels' device ms per
    level on one B16 x 8192 forward's geometry."""
    from pointcloud_segmentation_attention_tpu_torch import ops
    from pointcloud_segmentation_attention_tpu_torch.models import sem_seg
    from pointcloud_segmentation_attention_tpu_torch.ops import geometry as plain
    from pointcloud_segmentation_attention_tpu_torch.ops.cuda import group_gather as gg
    from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_interpolate as ti

    rng = np.random.RandomState(0)
    gen = torch.Generator(dev).manual_seed(0)
    xyz = torch.from_numpy((rng.rand(BATCH, NPOINTS, 3) * EXTENT).astype(np.float32)).to(dev)
    levels = [xyz]
    gather = {}
    for i, npoint in enumerate(sem_seg.SA_NPOINTS):
        centres = plain.gather_point(levels[-1], ops.farthest_point_sample(levels[-1], npoint))
        if i > 0:  # SA1's input carries no gradient
            idx, _ = ops.ball_query(levels[-1], centres, sem_seg.SA_RADII[i], sem_seg.SA_NSAMPLE)
            g = torch.randn(BATCH, npoint, sem_seg.SA_NSAMPLE, (67, 131, 259)[i - 1], device=dev,
                            generator=gen)
            n = levels[-1].shape[1]
            gather[f"SA{i + 1}"] = _device_ms(lambda: gg.group_point_backward(g, idx, n), 10)
        levels.append(centres)
    n_big = (1 << 15) + 256
    big_idx = torch.randint(0, n_big, (2, 4096, 32), device=dev, dtype=torch.int32, generator=gen)
    g_big = torch.randn(2, 4096, 32, 64, device=dev, generator=gen)
    gather["large N"] = _device_ms(lambda: gg.group_point_backward(g_big, big_idx, n_big), 10)
    out = {}
    for i, c in enumerate((512, 256, 256, 128)):
        xyz1, xyz2 = levels[3 - i], levels[4 - i]
        dist, idx = ops.three_nn(xyz1, xyz2)
        w = plain.interpolation_weights(dist)
        p = torch.randn(BATCH, xyz2.shape[1], c, device=dev, generator=gen)
        g = torch.randn(BATCH, xyz1.shape[1], c, device=dev, generator=gen)
        out[f"FP{i + 1}"] = {
            "forward": _device_ms(lambda: ti.three_interpolate(p, idx, w), 10),
            "backward_dp_dw": _device_ms(lambda: ti.three_interpolate_backward(g, idx, w, p), 10),
            "backward_dp": _device_ms(
                lambda: ti.three_interpolate_backward(g, idx, w, p, need_dw=False), 10),
        }
    return out, gather


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", help="root of the checkout whose package is measured")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--model", default="sem_seg_features", help="registry name")
    ap.add_argument("--layer-idx", type=int, default=None,
                    help="the attention level of sem_seg_attention_single_layer")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tree_timing measures the card; CUDA is not available")
    sys.path.insert(0, os.path.abspath(args.tree))
    from pointcloud_segmentation_attention_tpu_torch import models
    from pointcloud_segmentation_attention_tpu_torch.data.pipeline import make_batch
    from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import (
        sample_random_chunk,
    )
    from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (
        make_synthetic_scene,
    )
    from pointcloud_segmentation_attention_tpu_torch.eval.full_scene import (
        make_predict_fn,
        predict_scene_chunks,
        scene_chunks,
    )
    from pointcloud_segmentation_attention_tpu_torch.ops import cuda as kernels
    from pointcloud_segmentation_attention_tpu_torch.train import (
        TrainState,
        seg_predict_step,
        seg_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels.build()
    res = {"tag": args.tag or args.tree, "package": os.path.dirname(kernels.CSRC),
           "model": args.model}
    kw = {} if args.layer_idx is None else {"layer_idx": args.layer_idx}

    def seeded():
        return models.seeded_model(args.model, seed=0, device=dev, **kw)

    model = seeded()
    use_feats = model.in_features > 0
    rng = np.random.RandomState(2)
    pts = torch.from_numpy((rng.rand(BATCH, NPOINTS, 3) * EXTENT).astype(np.float32)).to(dev)
    feats = (torch.from_numpy(rng.rand(BATCH, NPOINTS, 6).astype(np.float32)).to(dev)
             if use_feats else None)

    def forward():
        return seg_predict_step(model, pts, feats)

    forward()
    forward()
    res["forward_ms"] = float(np.median(_events_ms(forward, 20, 5)))

    scenes = [make_synthetic_scene(150_000, seed=100 + s) for s in range(2)]
    predict = make_predict_fn(model, device=dev)
    predict_scene_chunks(predict, scene_chunks(scenes[0], NPOINTS, seed=0), use_feats, use_feats,
                         BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = predict_scene_chunks(predict, scene_chunks(scenes[1], NPOINTS, seed=0), use_feats,
                                  use_feats, BATCH)
    torch.cuda.synchronize()
    res["serve_points_per_s"] = len(labels) / (time.perf_counter() - t0)

    rooms = [make_synthetic_scene(150_000, seed=200 + s) for s in range(2)]
    brng = np.random.RandomState(11)
    batches = []
    for _ in range(13):
        chunks = []
        for _ in range(BATCH):
            sc = rooms[brng.randint(len(rooms))]
            p, lab, col, nrm, w = sample_random_chunk(sc["points"], sc["labels"], sc["colors"],
                                                      sc["normals"], NPOINTS, brng)
            chunks.append({"points": p, "labels": lab, "colors": col, "normals": nrm,
                           "weights": w})
        batches.append(make_batch(chunks, use_feats, use_feats, "f32"))
    state = TrainState(seeded())
    for b in batches[:3]:
        seg_train_step(state, b)
    steps = iter(batches[3:])
    res["step_ms"] = float(np.median(_events_ms(lambda: seg_train_step(state, next(steps)),
                                                10, 1)))

    # Profiled last: a process that has run the profiler may launch more slowly.
    res["forward_device_ms"] = _device_ms(forward, 5)
    res["step_device_ms"] = _device_ms(lambda: seg_train_step(state, batches[3]), 3)
    res["interp_levels"], res["gather_levels"] = _kernel_levels(dev)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
