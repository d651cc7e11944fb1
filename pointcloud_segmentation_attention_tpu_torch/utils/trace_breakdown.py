"""Where the serving and training time goes on the card: a profiler breakdown.

    python -m pointcloud_segmentation_attention_tpu_torch.utils.trace_breakdown [--model NAME]
        [--compute_dtype float32|bfloat16]

Runs a full-width registry model (``--model``, default ``sem_seg_features``;
seeded weights; fed colors and normals where it takes them, else xyz only;
bf16 products with ``--compute_dtype bfloat16``) on CUDA and profiles three
windows with ``torch.profiler`` (CPU + CUDA activities):

1. ``forward``: ``STEPS`` eval forwards at B16 x 8192, the serving batch.
2. ``serve``: one synthetic 150k-point room through the whole serving path
   (chunk, predict in batches, stitch), with the host time of each stage on
   the host clock.
   ``serve_resident``: three such rooms through ``ResidentSceneServer`` (q16,
   two rooms in flight) after a warm-up room; before the window, one room
   stage by stage: the host stage (pack, decode, chunk count) on the host clock,
   then upload, chunker (decode included), forwards, stitch and the label
   fetch between CUDA events on one stream (each span includes any wait
   for the host to queue it).
3. ``train``: ``STEPS`` training steps (``seg_train_step``) at B16 x 8192 on
   batches of random chunks of synthetic rooms, made before the window.

For each window it prints the device time per kernel group (the CUDA
kernels of ``csrc/`` by name, GEMMs, the rest), the window's wall time and
the device's busy share (kernel time over wall).  The JSON result and a
Chrome trace of each window go to the output directory ``OUT`` (named with
the model for any but ``sem_seg_features``, and ``_bf16`` for bf16).
"""
from __future__ import annotations

import argparse
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
from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving as rs
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

# Substrings of the csrc/ kernels' names; each is a group of its own.  Both
# backwards build a CSR with csrc/csr.cuh's passes (csr_walk/scan/fused_kernel),
# whose last template argument tells the interpolation's (true: (E, w) pairs)
# from the gather's (false); then the gather backward's consuming pass
# (group_gather_bwd_kernel), and the interpolation's (three_interpolate_bwd_kernel
# and, with dw over several column blocks, dw_combine_kernel).
OWN_KERNELS = ("fps_regs_kernel", "fps_mem_kernel", "ball_query_kernel", "group_gather_kernel",
               "group_gather_bwd_kernel", "three_nn_kernel", "three_interpolate_kernel",
               "three_interpolate_bwd_kernel", "dw_combine_kernel")
CSR_GROUPS = {True: "interpolation CSR (csr.cuh)", False: "gather CSR (csr.cuh)"}
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)
BATCH, NPOINTS, STEPS, SCENE_POINTS, SEED = 16, 8192, 5, 150_000, 0
OUT = "chiprun_out"
TOP_KERNELS = 12


def _group(name: str) -> str:
    if "csr::csr_" in name:
        return CSR_GROUPS[name.split(">(")[0].endswith("true")]
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


def resident_stages(server: rs.ResidentSceneServer, scene: dict) -> dict:
    """One room through the resident pipeline's pieces, one after another:
    the host stage's pack, ``decode_host`` and ``chunk_count`` ms (host
    clock), then upload, chunker, forwards, stitch and fetch ms between CUDA
    events on the current stream."""
    dev = server.device
    points = scene["points"]
    n = len(points)
    n_pad = server._n_pad(n)
    layout = server._layout(n_pad)
    t0 = time.perf_counter()
    buf = layout.pack(points, scene["colors"], scene["normals"])
    t1 = time.perf_counter()
    decoded = layout.decode_host(buf)["points"][:n]
    t2 = time.perf_counter()
    x = server._slots(rs.chunk_count(decoded, server.npoints, server.chunk_size, server.margin))
    t3 = time.perf_counter()
    host = {"pack_ms": (t1 - t0) * 1e3, "decode_host_ms": (t2 - t1) * 1e3,
            "chunk_count_ms": (t3 - t2) * 1e3, "stage_ms": (t3 - t0) * 1e3}
    b = server.batch_size
    x_cap, nb = rs._bucket(x, 4 * b), -(-x // b)
    predict = rs.make_resident_predict_step(server.model, layout, b, server.npoints)
    stitch = rs.make_stitch(n_pad)
    pinned = torch.from_numpy(buf).pin_memory()
    out = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    dbuf = pinned.to(dev, non_blocking=True)
    ev[1].record()
    decoded = rs._decode_scene(dbuf, layout)
    idx, mask, _ = rs._chunk_points(decoded["points"], n, x_cap, server.npoints, server.seed,
                                    server.chunk_size, server.margin)
    ev[2].record()
    labels = torch.cat([predict(decoded, idx[i * b:(i + 1) * b]) for i in range(nb)])
    ev[3].record()
    stitched = stitch(labels, idx[:nb * b], mask[:nb * b])
    ev[4].record()
    out.copy_(stitched[:n], non_blocking=True)
    ev[5].record()
    ev[5].synchronize()
    names = ("upload_ms", "chunker_ms", "forwards_ms", "stitch_ms", "fetch_ms")
    spans = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}
    return {**host, **spans, "batches": nb, "upload_bytes": len(buf)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="sem_seg_features", help="registry name")
    ap.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"))
    args = ap.parse_args()
    name = args.model
    dtype = {"compute_dtype": getattr(torch, args.compute_dtype)}
    if not torch.cuda.is_available():
        raise SystemExit("trace_breakdown measures the card; CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    suffix = ("" if name == "sem_seg_features" else f"_{name}") + (
        "_bf16" if args.compute_dtype == "bfloat16" else "")
    kernels.build()
    model = models.seeded_model(name, seed=SEED, device=dev, **dtype)
    use_feats = model.in_features > 0
    rng = np.random.RandomState(SEED)
    pts = torch.from_numpy((rng.rand(BATCH, NPOINTS, 3) * EXTENT)
                           .astype(np.float32)).to(dev)
    feats = (torch.from_numpy(rng.rand(BATCH, NPOINTS, 6).astype(np.float32)).to(dev)
             if use_feats else None)
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
    prof.export_chrome_trace(os.path.join(OUT, f"trace_forward{suffix}.json"))
    _print(f"{name} forward x{STEPS} (B{BATCH} x {NPOINTS})", fwd)

    # Serving one scene, stage by stage on the host clock.
    predict = make_predict_fn(model, device=dev)
    warm = make_synthetic_scene(SCENE_POINTS, seed=SEED + 1)
    scene = make_synthetic_scene(SCENE_POINTS, seed=SEED + 2)
    wc = scene_chunks(warm, NPOINTS, seed=0)
    predict(wc["points"][:BATCH], assemble_features(
        wc["colors"][:BATCH], wc["normals"][:BATCH], use_feats, use_feats))
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        chunks = scene_chunks(scene, NPOINTS, seed=0)
        t1 = time.perf_counter()
        labels = predict_scene_chunks(predict, chunks, use_feats, use_feats, BATCH)
        t2 = time.perf_counter()
    stages = {"chunk_ms": (t1 - t0) * 1e3, "predict_and_stitch_ms": (t2 - t1) * 1e3}
    srv = device_breakdown(prof, t2 - t0)
    srv.update(stages, chunks=len(chunks["points"]), points=len(labels))
    prof.export_chrome_trace(os.path.join(OUT, f"trace_serve{suffix}.json"))
    _print(f"serve one scene ({len(labels)} points, {len(chunks['points'])} chunks)", srv)
    print(f"   host stages: chunk {stages['chunk_ms']:.1f} ms, predict + stitch "
          f"{stages['predict_and_stitch_ms']:.1f} ms", flush=True)

    # Resident serving: one room stage by stage, then three pipelined.
    rooms = [dict(make_synthetic_scene(SCENE_POINTS, seed=SEED + 10 + s), scene_name=str(s))
             for s in range(4)]
    server = rs.ResidentSceneServer(model, NPOINTS, batch_size=BATCH, layout="q16",
                                    pipeline_depth=2, use_colors=use_feats,
                                    use_normals=use_feats, device=dev)
    server.predict_scene(rooms[0])
    parts = resident_stages(server, rooms[1])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        served = list(server.predict_scenes(iter(rooms[1:])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = device_breakdown(prof, wall)
    n_res = sum(len(labels) for _, labels in served)
    res.update(parts, rooms=len(served), points=n_res, per_room_ms=wall * 1e3 / len(served),
               points_per_s=n_res / wall)
    prof.export_chrome_trace(os.path.join(OUT, f"trace_serve_resident{suffix}.json"))
    _print(f"serve resident, {len(served)} rooms ({n_res} points, q16, pipelined)", res)
    print("   one room stage by stage: " + ", ".join(
        f"{k} {parts[k]:.2f}" for k in ("stage_ms", "pack_ms", "decode_host_ms",
                                        "chunk_count_ms", "upload_ms", "chunker_ms",
                                        "forwards_ms", "stitch_ms", "fetch_ms"))
          + f" ({parts['batches']} batches, {parts['upload_bytes']} bytes uploaded)", flush=True)

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
        batches.append(make_batch(chunks, use_feats, use_feats, "f32"))
    state = TrainState(models.seeded_model(name, seed=SEED, device=dev, **dtype))
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
    prof.export_chrome_trace(os.path.join(OUT, f"trace_train{suffix}.json"))
    _print(f"{name} train x{STEPS} (B{BATCH} x {NPOINTS})", trn)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    result = {"device": torch.cuda.get_device_name(0), "card": card, "model": name,
              "compute_dtype": args.compute_dtype,
              "forward": fwd, "serve": srv, "serve_resident": res, "train": trn,
              "batch": BATCH, "npoints": NPOINTS}
    with open(os.path.join(OUT, f"trace_breakdown{suffix}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"model": name, "compute_dtype": args.compute_dtype,
                      "forward_ms": fwd["per_forward_ms"],
                      "forward_busy_share": fwd["device_busy_share"],
                      "serve_busy_share": srv["device_busy_share"],
                      "serve_resident_points_per_s": res["points_per_s"],
                      "serve_resident_busy_share": res["device_busy_share"],
                      "train_step_ms": trn["per_step_ms"],
                      "train_busy_share": trn["device_busy_share"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
