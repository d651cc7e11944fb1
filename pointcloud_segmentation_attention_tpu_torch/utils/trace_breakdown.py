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
   two rooms in flight) after a warm-up room, with the server's own spans
   (``serve.*``: the staging thread's stage, pack, upload and the card's
   chunk count with its wait; the queueing of each room's program; the
   label wait) and its
   counters, a room each.
3. ``train``: ``STEPS`` training steps (``seg_train_step``) at B16 x 8192 on
   batches of random chunks of synthetic rooms, made before the window, with
   the step's ``train.*`` spans.

For each window it prints the device time per kernel group (the CUDA
kernels of ``csrc/`` by name, GEMMs, the rest), the window's wall time, the
device's busy share (the union of kernel intervals over wall), the kernel
time by the innermost program span around each launch, and the longest
idle gaps labelled by the program spans open across them.  The JSON result
and a Chrome trace of each window (every thread the window starts
included) go to the output directory ``OUT`` (named with the model for any
but ``sem_seg_features``, and ``_bf16`` for bf16).
"""
from __future__ import annotations

import argparse
import bisect
import itertools
import json
import os
import subprocess
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

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
from pointcloud_segmentation_attention_tpu_torch.utils import profiler

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
TOP_GAPS = 10


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def _group(name: str) -> str:
    if "csr::csr_" in name:
        return CSR_GROUPS[name.split(">(")[0].endswith("true")]
    for k in OWN_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if _is_copy(name):
        return "memcpy/memset"
    if "reduce_kernel" in low:
        return "reductions (BN statistics, sums)"
    if "elementwise_kernel" in low:
        return "elementwise"
    return "other kernels"


def _device_events(prof):
    """The profiler's device events: kernels, copies and sets (a GPU user
    annotation, e.g. ``Optimizer.step#Adam.step``, spans the kernels it
    encloses; counting it would count them twice)."""
    return [evt for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]


def _union(intervals):
    """Sorted disjoint intervals covering ``intervals`` ((start, end) pairs)."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_breakdown(prof, wall_s: float) -> dict:
    """Device time by kernel group from the profiler's CUDA events:
    ``device_ms``, every kernel, copy and set summed; ``busy_ms``, the
    union of the kernels' intervals (streams that overlap counted once,
    copies and sets not counted), and its share of ``wall_s``."""
    groups = defaultdict(float)
    count = defaultdict(int)
    by_name = defaultdict(float)
    kernels = []
    for evt in _device_events(prof):
        g = _group(evt.name)
        us = evt.time_range.elapsed_us()
        groups[g] += us
        count[g] += 1
        by_name[evt.name[:100]] += us
        if not _is_copy(evt.name):
            kernels.append((evt.time_range.start, evt.time_range.end))
    device_us = sum(groups.values())
    busy_us = sum(b - a for a, b in _union(kernels))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": device_us / 1e3,
        "busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (wall_s * 1e6) if wall_s > 0 else None,
        "groups": {g: {"ms": us / 1e3, "count": count[g], "share": us / device_us}
                   for g, us in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n, "ms": us / 1e3, "share": us / device_us}
                        for n, us in top],
    }


def _is_span(name: str) -> bool:
    return name.startswith(profiler.SPAN_PREFIXES)


def _span_index(events) -> dict:
    """Per thread, the program spans on the timeline sorted by start (an
    enclosing span before a nested one that starts with it), their starts,
    and the latest end of each prefix."""
    by_thread = defaultdict(list)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and _is_span(e.name):
            by_thread[e.thread].append((e.time_range.start, e.time_range.end, e.name))
    index = {}
    for thread, spans in by_thread.items():
        spans.sort(key=lambda x: (x[0], -x[1]))
        index[thread] = ([x[0] for x in spans], list(itertools.accumulate(
            (x[1] for x in spans), max)), spans)
    return index


def _innermost(entry, t) -> Optional[str]:
    """The innermost span of one thread's ``_span_index`` entry open at
    ``t``: the latest-starting one that contains it."""
    starts, reach, spans = entry
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and reach[i] > t:
        if spans[i][1] > t:
            return spans[i][2]
        i -= 1
    return None


def _open_at(index: dict, t) -> str:
    """The innermost program span open at ``t`` on each thread, joined."""
    return "+".join(sorted(n for n in (_innermost(e, t) for e in index.values()) if n))


def kernel_spans(prof) -> list:
    """(span, kernel event) for each kernel (copies and sets left out): the
    innermost program span (``utils/profiler.span``) around the kernel's
    launch.  The launch is the CUDA API event that shares the kernel's
    correlation id (an ATen op's launch, the ctypes launches of
    ``ops/cuda`` and a CUDA graph's launch alike); its span is the first
    program span among its CPU parents, else the innermost one open on its
    thread at the launch, and on a thread with no program span (autograd's
    backward threads) the innermost ones open on the other threads.
    Kernels with none get ``(no program span)``."""
    events = prof.events()
    index = _span_index(events)
    launches = {e.id: e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cu") and "Launch" in e.name}
    out = []
    for k in _device_events(prof):
        if _is_copy(k.name):
            continue
        launch, label = launches.get(k.id), None
        if launch is not None:
            owner = launch.cpu_parent
            while owner is not None and not _is_span(owner.name):
                owner = owner.cpu_parent
            if owner is not None:
                label = owner.name
            elif launch.thread in index:
                label = _innermost(index[launch.thread], launch.time_range.start)
            else:
                label = _open_at(index, launch.time_range.start)
        out.append((label or "(no program span)", k))
    return out


def kernel_ms_by_span(prof) -> dict:
    """Kernel time (copies and sets left out) by the innermost program span
    around each kernel's launch (``kernel_spans``)."""
    out = defaultdict(float)
    for label, k in kernel_spans(prof):
        out[label] += k.time_range.elapsed_us() / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_gaps(prof, top: int = TOP_GAPS) -> list:
    """The ``top`` longest stretches of the profiled window (first host
    event to last event) in which no kernel ran, longest first, as
    ``[label, ms]``: the label joins, over threads, the innermost program
    span open at the stretch's midpoint."""
    events = prof.events()
    if not events:
        return []
    w0 = min(e.time_range.start for e in events)
    w1 = max(e.time_range.end for e in events)
    merged = _union([(e.time_range.start, e.time_range.end) for e in _device_events(prof)
                     if not _is_copy(e.name)])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)[:top]
    index = _span_index(events)
    return [[_open_at(index, (a + b) / 2) or "(no span)", length / 1e3]
            for length, a, b in gaps]


def span_report(snap: dict, prefix: str, units: int) -> dict:
    """The host time of ``snap``'s (``utils.profiler.snapshot()``) spans
    whose names start with ``prefix``, in ms per unit (room or step):
    count, total and self time."""
    return {name: {"count": v["count"], "total_ms": 1e3 * v["total_s"] / units,
                   "self_ms": 1e3 * v["self_s"] / units}
            for name, v in sorted(snap["spans"].items()) if name.startswith(prefix)}


def _print(title: str, res: dict) -> None:
    print(f"== {title}: wall {res['wall_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms "
          f"(busy share {res['device_busy_share']:.3f}; kernels, copies and sets "
          f"{res['device_ms']:.3f} ms)", flush=True)
    for g, v in res["groups"].items():
        print(f"   {g:26s} {v['ms']:10.3f} ms  {v['count']:6d} launches  "
              f"{100 * v['share']:5.1f} % of device time", flush=True)
    print("   top kernels by device time:")
    for k in res["top_kernels"]:
        print(f"     {k['ms']:9.3f} ms {100 * k['share']:5.1f} %  {k['name']}", flush=True)
    if res.get("kernel_ms_by_span"):
        print("   kernel time by program span: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in res["kernel_ms_by_span"].items()), flush=True)
    if res.get("idle_gaps"):
        print("   longest idle gaps: " + ", ".join(
            f"{label} {ms:.3f} ms" for label, ms in res["idle_gaps"]), flush=True)


def _window(prof, wall_s: float) -> dict:
    res = device_breakdown(prof, wall_s)
    res.update(kernel_ms_by_span=kernel_ms_by_span(prof), idle_gaps=idle_gaps(prof))
    return res


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

    with profiler.profile_all_threads() as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            seg_predict_step(model, pts, feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fwd = _window(prof, wall)
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
    with profiler.profile_all_threads() as prof:
        t0 = time.perf_counter()
        chunks = scene_chunks(scene, NPOINTS, seed=0)
        t1 = time.perf_counter()
        labels = predict_scene_chunks(predict, chunks, use_feats, use_feats, BATCH)
        t2 = time.perf_counter()
    stages = {"chunk_ms": (t1 - t0) * 1e3, "predict_and_stitch_ms": (t2 - t1) * 1e3}
    srv = _window(prof, t2 - t0)
    srv.update(stages, chunks=len(chunks["points"]), points=len(labels))
    prof.export_chrome_trace(os.path.join(OUT, f"trace_serve{suffix}.json"))
    _print(f"serve one scene ({len(labels)} points, {len(chunks['points'])} chunks)", srv)
    print(f"   host stages: chunk {stages['chunk_ms']:.1f} ms, predict + stitch "
          f"{stages['predict_and_stitch_ms']:.1f} ms", flush=True)

    # Resident serving: a warm-up room, then three pipelined under the server's spans.
    rooms = [dict(make_synthetic_scene(SCENE_POINTS, seed=SEED + 10 + s), scene_name=str(s))
             for s in range(4)]
    server = rs.ResidentSceneServer(model, NPOINTS, batch_size=BATCH, layout="q16",
                                    pipeline_depth=2, use_colors=use_feats,
                                    use_normals=use_feats, device=dev)
    server.predict_scene(rooms[0])
    profiler.reset()
    with profiler.profile_all_threads() as prof:
        t0 = time.perf_counter()
        served = list(server.predict_scenes(iter(rooms[1:])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    snap = profiler.snapshot()
    res = _window(prof, wall)
    n_res = sum(len(labels) for _, labels in served)
    counters = snap["counters"]
    res.update(rooms=len(served), points=n_res, per_room_ms=wall * 1e3 / len(served),
               points_per_s=n_res / wall, counters=counters,
               spans_per_room=span_report(snap, "", len(served)),
               slot_use=counters["serve.chunks"] / counters["serve.slots"])
    prof.export_chrome_trace(os.path.join(OUT, f"trace_serve_resident{suffix}.json"))
    _print(f"serve resident, {len(served)} rooms ({n_res} points, q16, pipelined)", res)
    print("   the server's spans, ms a room (total / self): " + ", ".join(
        f"{k} {v['total_ms']:.2f} / {v['self_ms']:.2f}"
        for k, v in res["spans_per_room"].items())
          + f"; slots used {100 * res['slot_use']:.1f} % ({counters})", flush=True)

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
    profiler.reset()
    with profiler.profile_all_threads() as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            seg_train_step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trn = _window(prof, wall)
    trn["per_step_ms"] = wall * 1e3 / STEPS
    trn["spans_per_step"] = span_report(profiler.snapshot(), "train.", STEPS)
    prof.export_chrome_trace(os.path.join(OUT, f"trace_train{suffix}.json"))
    _print(f"{name} train x{STEPS} (B{BATCH} x {NPOINTS})", trn)
    print("   the step's spans, ms a step (total / self): " + ", ".join(
        f"{k} {v['total_ms']:.2f} / {v['self_ms']:.2f}"
        for k, v in trn["spans_per_step"].items()), flush=True)

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
