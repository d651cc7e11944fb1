"""Device time of every launch plan of the ball-query and three-NN kernels
at the main path's levels, to choose the constants of their ``plan()``s.

    python -m pointcloud_segmentation_attention_tpu_torch.utils.plan_sweep

Builds the geometry of one B16 x 8192 forward (points uniform in a serving
chunk's extent, FPS centres at SA1-4, the FP1-4 pairs of levels), then at
each level launches ``csrc/ball_query.cu`` (SA1-4) and ``csrc/three_nn.cu``
(FP1-4) under every plan of the grid below, straight through
``ops/cuda/__init__.py:launch``.  Every result must be bit-identical to the
plain version; each plan's device-only time is the profiler's kernel time
over ``CALLS`` back-to-back launches.  Prints one line per level with the
plans ordered by time, the one ``plan()`` picks marked with ``*``, and
writes the table to ``plan_sweep.json`` in ``trace_breakdown.OUT``, the
directory the other measurement scripts write to.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloud_segmentation_attention_tpu_torch import ops
from pointcloud_segmentation_attention_tpu_torch.models import sem_seg
from pointcloud_segmentation_attention_tpu_torch.ops import cuda as kernels
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as plain
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import ball_query as bq
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_nn as tn
from pointcloud_segmentation_attention_tpu_torch.ops.geometry import radius_threshold
from pointcloud_segmentation_attention_tpu_torch.utils.trace_breakdown import (
    OUT,
    device_breakdown,
)

EXTENT = np.array([1.9, 1.9, 2.6], np.float32)
BATCH, NPOINTS, CALLS = 16, 8192, 20
THREADS = (32, 64, 128, 256)


def device_us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return device_breakdown(prof, 1.0)["device_busy_ms"] * 1e3 / CALLS


def _tiles(n: int, whole_max: int):
    """The whole cloud in one tile where it may be, else rings of 256-1024."""
    whole = -(-n // 32) * 32
    if whole <= whole_max:
        return [(whole, 1)] + ([(256, 2)] if n > 256 else [])
    return [(t, 2) for t in (256, 512, 1024)]


def sweep_ball_query(xyz, centres, radius, ns) -> list:
    b, n, _ = xyz.shape
    m = centres.shape[1]
    want = plain.ball_query(xyz, centres, radius, ns)
    chosen = bq.plan(b, n, m)
    idx = torch.empty((b, m, ns), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    rows = []
    for r in bq.PER_WARP:
        for threads in THREADS:
            for tile, stages in _tiles(n, bq.TILE):
                args = (xyz.data_ptr(), centres.data_ptr(), idx.data_ptr(), cnt.data_ptr(), b,
                        n, m, radius_threshold(radius), ns, r, threads, tile, stages,
                        kernels.ring_bytes(tile, stages), -(-m // (threads // 32 * r)))

                def fn(args=args):
                    kernels.launch("psa_ball_query", xyz.device, *args)

                idx.fill_(-1)
                fn()
                if not (torch.equal(idx, want[0]) and torch.equal(cnt, want[1])):
                    raise AssertionError(f"ball_query R{r} T{threads} tile{tile} differs")
                pick = (r, threads, tile, stages) == (chosen.per_warp, chosen.threads,
                                                      chosen.tile, chosen.stages)
                rows.append(dict(per=r, threads=threads, tile=tile, stages=stages,
                                 us=device_us(fn), chosen=pick))
    return rows


def sweep_three_nn(xyz1, xyz2) -> list:
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    want = plain.three_nn(xyz1, xyz2)
    chosen = tn.plan(b, n, m)
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=xyz1.device)
    rows = []
    tiles = _tiles(m, tn.WHOLE_MAX_POINTS)
    for q in tn.PER_THREAD:
        for threads in THREADS:
            for tile, stages in tiles:
                args = (xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(), idx.data_ptr(), b,
                        n, m, q, threads, tile, stages, kernels.ring_bytes(tile, stages),
                        -(-n // (threads * q)))

                def fn(args=args):
                    kernels.launch("psa_three_nn", xyz1.device, *args)

                idx.fill_(-1)
                fn()
                if not (torch.equal(idx, want[1]) and torch.equal(dist, want[0])):
                    raise AssertionError(f"three_nn Q{q} T{threads} tile{tile} differs")
                pick = (q, threads, tile, stages) == (chosen.per_thread, chosen.threads,
                                                      chosen.tile, chosen.stages)
                rows.append(dict(per=q, threads=threads, tile=tile, stages=stages,
                                 us=device_us(fn), chosen=pick))
    return rows


def _print(kind: str, label: str, shape: str, rows: list) -> None:
    rows = sorted(rows, key=lambda r: r["us"])
    best = rows[0]["us"]
    chosen = next(r for r in rows if r["chosen"])
    cells = " ".join(f"{'*' if r['chosen'] else ''}{r['per']}/{r['threads']}/{r['tile']}x"
                     f"{r['stages']}={r['us']:.2f}" for r in rows[:8])
    print(f"[sweep] {kind} {label} {shape}: plan() {chosen['us']:.2f} us, best {best:.2f} us; "
          f"fastest (per/threads/tile x stages = us): {cells}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep measures the card; CUDA is not available")
    dev = torch.device("cuda")
    kernels.build()
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy((rng.rand(BATCH, NPOINTS, 3) * EXTENT).astype(np.float32)).to(dev)
    levels = [xyz]
    out = {"ball_query": {}, "three_nn": {}}
    for i, npoint in enumerate(sem_seg.SA_NPOINTS):
        centres = plain.gather_point(xyz, ops.farthest_point_sample(xyz, npoint))
        label = f"SA{i + 1}"
        rows = sweep_ball_query(xyz, centres, sem_seg.SA_RADII[i], sem_seg.SA_NSAMPLE)
        _print("ball_query", label, f"N{xyz.shape[1]} M{npoint}", rows)
        out["ball_query"][label] = rows
        xyz = centres
        levels.append(xyz)
    for i in range(4):
        label = f"FP{i + 1}"
        xyz1, xyz2 = levels[3 - i], levels[4 - i]
        rows = sweep_three_nn(xyz1, xyz2)
        _print("three_nn", label, f"N{xyz1.shape[1]} M{xyz2.shape[1]}", rows)
        out["three_nn"][label] = rows
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out["card"] = smi
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "plan_sweep.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"[sweep] card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
