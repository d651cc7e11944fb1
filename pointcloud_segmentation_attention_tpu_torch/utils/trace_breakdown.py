"""Where the serving and training time goes on the card: a profiler breakdown.

    python -m pointcloud_segmentation_attention_tpu_torch.utils.trace_breakdown

Runs full-width ``sem_seg_features`` (seeded weights) on CUDA and profiles
three windows with ``torch.profiler`` (CPU + CUDA activities):

1. ``forward``: ``STEPS`` eval forwards at B16 x 8192, the serving batch.
2. ``serve``: one synthetic 150k-point room through the whole serving path
   (chunk, predict in batches, stitch), with the host time of each stage on
   the host clock.
3. ``train``: ``STEPS`` training steps (``seg_train_step``) at B16 x 8192 on
   batches of random chunks of synthetic rooms, made before the window.

For each window it prints the device time per kernel group (the CUDA
kernels of ``csrc/`` by name, GEMMs, the rest), the window's wall time and
the device's busy share (kernel time over wall).  The JSON result and a
Chrome trace of each window go to the output directory ``OUT``.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.pipeline import (
    assemble_features,
    make_batch,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import sample_random_chunk
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

# Substrings of the csrc/ kernels' names; each is a group of its own.  The
# interpolation backward is its CSR passes (interp_csr_walk/scan/fused), the
# consuming pass and, with dw over several column blocks, dw_combine_kernel.
OWN_KERNELS = ("fps_regs_kernel", "fps_mem_kernel", "ball_query_kernel", "group_gather_kernel",
               "group_gather_bwd_kernel", "three_nn_kernel", "three_interpolate_kernel",
               "interp_csr_", "three_interpolate_bwd_kernel", "dw_combine_kernel")
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)
BATCH, NPOINTS, STEPS, SCENE_POINTS, SEED = 16, 8192, 5, 150_000, 0
OUT = "chiprun_out"
TOP_KERNELS = 12


def _group(name: str) -> str:
    for k in OWN_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "reduce_kernel" in low:
        return "reductions (BN statistics, sums)"
    if "elementwise_kernel" in low:
        return "elementwise"
    return "other kernels"


def device_breakdown(prof, wall_s: float) -> dict:
    """Device microseconds per kernel group from the profiler's CUDA events."""
    groups = defaultdict(float)
    count = defaultdict(int)
    by_name = defaultdict(float)
    for evt in prof.events():
        # A GPU user annotation (e.g. ``Optimizer.step#Adam.step``) spans the
        # kernels it encloses; counting it would count them twice.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        g = _group(evt.name)
        us = evt.time_range.elapsed_us()
        groups[g] += us
        count[g] += 1
        by_name[evt.name[:100]] += us
    busy_us = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (wall_s * 1e6) if wall_s > 0 else None,
        "groups": {g: {"ms": us / 1e3, "count": count[g], "share_of_busy": us / busy_us}
                   for g, us in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n, "ms": us / 1e3, "share_of_busy": us / busy_us}
                        for n, us in top],
    }


def _print(title: str, res: dict) -> None:
    print(f"== {title}: wall {res['wall_ms']:.3f} ms, device busy {res['device_busy_ms']:.3f} ms "
          f"(busy share {res['device_busy_share']:.3f})", flush=True)
    for g, v in res["groups"].items():
        print(f"   {g:26s} {v['ms']:10.3f} ms  {v['count']:6d} launches  "
              f"{100 * v['share_of_busy']:5.1f} % of busy", flush=True)
    print("   top kernels by device time:")
    for k in res["top_kernels"]:
        print(f"     {k['ms']:9.3f} ms {100 * k['share_of_busy']:5.1f} %  {k['name']}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("trace_breakdown measures the card; CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    kernels.build()
    model = models.seeded_model("sem_seg_features", seed=SEED, device=dev)
    rng = np.random.RandomState(SEED)
    pts = torch.from_numpy((rng.rand(BATCH, NPOINTS, 3) * EXTENT)
                           .astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.rand(BATCH, NPOINTS, 6).astype(np.float32)).to(dev)
    for _ in range(3):
        seg_predict_step(model, pts, feats)
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            seg_predict_step(model, pts, feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fwd = device_breakdown(prof, wall)
    fwd["per_forward_ms"] = wall * 1e3 / STEPS
    prof.export_chrome_trace(os.path.join(OUT, "trace_forward.json"))
    _print(f"forward x{STEPS} (B{BATCH} x {NPOINTS})", fwd)

    # Serving one scene, stage by stage on the host clock.
    predict = make_predict_fn(model, device=dev)
    warm = make_synthetic_scene(SCENE_POINTS, seed=SEED + 1)
    scene = make_synthetic_scene(SCENE_POINTS, seed=SEED + 2)
    wc = scene_chunks(warm, NPOINTS, seed=0)
    predict(wc["points"][:BATCH], assemble_features(
        wc["colors"][:BATCH], wc["normals"][:BATCH], True, True))
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        chunks = scene_chunks(scene, NPOINTS, seed=0)
        t1 = time.perf_counter()
        labels = predict_scene_chunks(predict, chunks, True, True, BATCH)
        t2 = time.perf_counter()
    stages = {"chunk_ms": (t1 - t0) * 1e3, "predict_and_stitch_ms": (t2 - t1) * 1e3}
    srv = device_breakdown(prof, t2 - t0)
    srv.update(stages, chunks=len(chunks["points"]), points=len(labels))
    prof.export_chrome_trace(os.path.join(OUT, "trace_serve.json"))
    _print(f"serve one scene ({len(labels)} points, {len(chunks['points'])} chunks)", srv)
    print(f"   host stages: chunk {stages['chunk_ms']:.1f} ms, predict + stitch "
          f"{stages['predict_and_stitch_ms']:.1f} ms", flush=True)

    # Training: batches of random chunks, made before the window.
    rooms = [make_synthetic_scene(SCENE_POINTS, seed=SEED + 3 + s) for s in range(2)]
    brng = np.random.RandomState(SEED)
    batches = []
    for _ in range(3 + STEPS):
        chunks = []
        for _ in range(BATCH):
            room = rooms[brng.randint(len(rooms))]
            p, lab, col, nrm, w = sample_random_chunk(room["points"], room["labels"],
                                                      room["colors"], room["normals"],
                                                      NPOINTS, brng)
            chunks.append({"points": p, "labels": lab, "colors": col, "normals": nrm,
                           "weights": w})
        batches.append(make_batch(chunks, True, True, "f32"))
    state = TrainState(models.seeded_model("sem_seg_features", seed=SEED, device=dev))
    for b in batches[:3]:
        seg_train_step(state, b)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            seg_train_step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trn = device_breakdown(prof, wall)
    trn["per_step_ms"] = wall * 1e3 / STEPS
    prof.export_chrome_trace(os.path.join(OUT, "trace_train.json"))
    _print(f"train x{STEPS} (B{BATCH} x {NPOINTS})", trn)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    result = {"device": torch.cuda.get_device_name(0), "card": card, "forward": fwd, "serve": srv,
              "train": trn, "batch": BATCH, "npoints": NPOINTS}
    with open(os.path.join(OUT, "trace_breakdown.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"forward_ms": fwd["per_forward_ms"],
                      "forward_busy_share": fwd["device_busy_share"],
                      "serve_busy_share": srv["device_busy_share"],
                      "train_step_ms": trn["per_step_ms"],
                      "train_busy_share": trn["device_busy_share"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
