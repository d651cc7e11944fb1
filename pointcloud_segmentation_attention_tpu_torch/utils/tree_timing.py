"""End-to-end times of one checkout of this repository on the card, so that
two checkouts (a parent commit and a change) can be run in turns in one
session on one card.

    python3 pointcloud_segmentation_attention_tpu_torch/utils/tree_timing.py TREE [--tag NAME]

Imports the package from the checkout at ``TREE``, not from the tree this
file lives in, builds its kernels, and measures full-width
``sem_seg_features`` with seeded weights (TF32 off):

- ``forward_ms``: one B16 x 8192 eval forward, CUDA events around bursts of
  5, median of 20 bursts; ``forward_device_ms``: the device time of one
  forward, the profiler's kernel, copy and set events over 5 forwards;
- ``step_ms``: median of 10 ``seg_train_step``s at B16 x 8192 after 3 warm-up
  steps, CUDA events around each, on batches of random chunks of synthetic
  150k-point rooms made before the window; ``step_device_ms`` likewise from
  the profiler over 3 steps;
- ``serve_points_per_s``: one synthetic 150k-point room served (chunk,
  predict in B16 batches, stitch) after one warm-up room.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", help="root of the checkout whose package is measured")
    ap.add_argument("--tag", default=None)
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
    res = {"tag": args.tag or args.tree, "package": os.path.dirname(kernels.CSRC)}

    model = models.seeded_model("sem_seg_features", seed=0, device=dev)
    rng = np.random.RandomState(2)
    pts = torch.from_numpy((rng.rand(BATCH, NPOINTS, 3) * EXTENT).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.rand(BATCH, NPOINTS, 6).astype(np.float32)).to(dev)

    def forward():
        return seg_predict_step(model, pts, feats)

    forward()
    forward()
    res["forward_ms"] = float(np.median(_events_ms(forward, 20, 5)))

    scenes = [make_synthetic_scene(150_000, seed=100 + s) for s in range(2)]
    predict = make_predict_fn(model, device=dev)
    predict_scene_chunks(predict, scene_chunks(scenes[0], NPOINTS, seed=0), True, True, BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = predict_scene_chunks(predict, scene_chunks(scenes[1], NPOINTS, seed=0), True, True,
                                  BATCH)
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
        batches.append(make_batch(chunks, True, True, "f32"))
    state = TrainState(models.seeded_model("sem_seg_features", seed=0, device=dev))
    for b in batches[:3]:
        seg_train_step(state, b)
    steps = iter(batches[3:])
    res["step_ms"] = float(np.median(_events_ms(lambda: seg_train_step(state, next(steps)),
                                                10, 1)))

    # Profiled last: a process that has run the profiler may launch more slowly.
    res["forward_device_ms"] = _device_ms(forward, 5)
    res["step_device_ms"] = _device_ms(lambda: seg_train_step(state, batches[3]), 3)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
