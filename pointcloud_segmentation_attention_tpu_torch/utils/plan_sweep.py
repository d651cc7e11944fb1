"""Device time of every launch plan of the ball-query, three-NN,
interpolation and gather-backward kernels at the main path's levels, to
choose the constants of their ``plan()``s.

    python -m pointcloud_segmentation_attention_tpu_torch.utils.plan_sweep [--only KERNEL ...]

Builds the geometry of one B16 x 8192 forward (points uniform in a serving
chunk's extent, FPS centres and ball-query idx at SA1-4, the FP1-4 pairs of
levels), then at each level launches ``csrc/ball_query.cu`` (SA1-4),
``csrc/group_gather_bwd.cu`` (SA2-4, whose inputs carry a gradient, and the
large N of ``chip_smoke.py``: 2 x 4096 x 32 random idx into 33,024 rows,
C 64), ``csrc/three_nn.cu``, ``csrc/three_interpolate.cu`` and
``csrc/three_interpolate_bwd.cu`` (FP1-4, the backward with and without dw)
under every plan of the grids below, straight through
``ops/cuda/__init__.py:launch``.  Every result must be bit-identical to the
plain version (both backwards' dP to the plain version run on the CPU; the
interpolation's dw, whose sum order depends on the plan, within 1e-5).
Each plan's device-only time is the profiler's kernel time over ``CALLS``
back-to-back launches.  Prints one line per level with the plans ordered
by time, the one ``plan()`` picks marked with ``*``, and writes the table
to ``plan_sweep.json`` in ``trace_breakdown.OUT``, the directory the other
measurement scripts write to.  ``--only`` names the kernels to sweep
(``KINDS``; default all).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
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
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import csr
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import group_gather as gg
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_interpolate as ti
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import three_nn as tn
from pointcloud_segmentation_attention_tpu_torch.ops.geometry import radius_threshold
from pointcloud_segmentation_attention_tpu_torch.utils.trace_breakdown import (
    OUT,
    device_breakdown,
)

EXTENT = np.array([1.9, 1.9, 2.6], np.float32)
BATCH, NPOINTS, CALLS = 16, 8192, 20
THREADS = (32, 64, 128, 256)
FP_CHANNELS = (512, 256, 256, 128)  # interpolated channels at FP1-4
SA_CHANNELS = (9, 67, 131, 259)     # grouped channels at SA1-4 (3 + the features)


def device_us(fn, repeats: int = 3) -> float:
    """The median over ``repeats`` profiles of the device time of one call;
    a profile that lost its events counts as missing."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        times.append(device_breakdown(prof, 1.0)["device_ms"] * 1e3 / CALLS)
    found = [t for t in times if t > 0]
    return float(np.median(found)) if found else float("nan")


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


def sweep_interpolate(points, idx, weight) -> list:
    """The forward: every (lanes, threads) with lanes from 4 up to the row's
    width in float4s."""
    b, m, c = points.shape
    n = idx.shape[1]
    want = plain.three_interpolate(points, idx, weight)
    chosen = ti.plan(b, n, m, c, True)
    out = torch.empty((b, n, c), dtype=torch.float32, device=points.device)
    rows = []
    for lanes in (4, 8, 16, 32):
        if lanes > c // 4:
            continue
        for threads in (128, 256, 512):
            args = (points.data_ptr(), idx.data_ptr(), weight.data_ptr(), out.data_ptr(), b, m,
                    n, c, 1, lanes, threads, -(-n // (threads // lanes)))

            def fn(args=args):
                kernels.launch("psa_three_interpolate", points.device, *args)

            out.fill_(float("nan"))
            fn()
            if not torch.equal(out, want):
                raise AssertionError(f"three_interpolate L{lanes} T{threads} differs")
            pick = (lanes, threads) == (chosen.lanes, chosen.threads)
            rows.append(dict(plan=f"L{lanes}/T{threads}", us=device_us(fn), chosen=pick))
    return rows


def _bwd_csr_plans(b: int, n: int, m: int) -> list:
    """The CSR layouts the sweep tries: the plan's, the fused one where it
    fits, and chunks of 8-32 steps, 1-8 a block."""
    plans = {ti.csr_plan(b, n, m)}
    most = min(csr.FUSED_WARPS, csr.SMEM_LIMIT // (4 * m))
    for steps in (1, 2, 4, 8, 16, 32, 128):
        warps = -(-3 * n // (32 * steps))
        if warps <= most:
            plans.add(csr.CsrPlan("fused", steps, warps, warps, 4 * m * warps, 0))
    for steps in (8, 16, 32):
        chunks = -(-3 * n // (32 * steps))
        for warps in csr.WARPS:
            if warps <= chunks and 4 * m * warps <= csr.SMEM_LIMIT:
                plans.add(csr.CsrPlan("chunked", steps, chunks, warps, 4 * m * warps,
                                     b * chunks * (m + -(-m // csr.SCAN_TILE))))
    return sorted(plans)


def sweep_interpolate_bwd(points, idx, weight, need_dw: bool) -> list:
    """The backward: every CSR layout of ``_bwd_csr_plans`` under the plan's
    consuming pass, then every consuming pass (entries ahead, threads) under
    the plan's CSR."""
    b, m, c = points.shape
    n = idx.shape[1]
    dev = points.device
    g = torch.randn(b, n, c, device=dev, generator=torch.Generator(dev).manual_seed(3))
    want_dp, want_dw = plain.three_interpolate_backward(g.cpu(), idx.cpu(), weight.cpu(),
                                                        points.cpu())
    chosen = ti.backward_plan(b, n, m, c, True)
    dp = torch.empty_like(points)
    dw = torch.empty((b, n, 3), dtype=torch.float32, device=dev) if need_dw else None
    parts = torch.empty(chosen.col_blocks * 3 * b * n, dtype=torch.float32, device=dev)
    mine = (chosen.ahead, chosen.threads)
    tried = [(csr, mine) for csr in _bwd_csr_plans(b, n, m)]
    tried += [(chosen.csr, (ahead, threads)) for ahead in (2, 4, 8) for threads in (128, 256)
              if (ahead, threads) != mine]
    rows = []
    for csr, (ahead, threads) in tried:
        scratch, pairs, offsets, hist, _ = ti.backward_scratch(
            b, n, m, chosen._replace(csr=csr), False, dev)
        args = (g.data_ptr(), idx.data_ptr(), weight.data_ptr(),
                points.data_ptr() if need_dw else None, dp.data_ptr(),
                dw.data_ptr() if need_dw else None, parts.data_ptr(), offsets, pairs, hist, b, m,
                n, c, int(csr.variant != "chunked"), csr.steps, csr.warps, csr.smem_bytes, 1,
                chosen.lanes, ahead, chosen.col_blocks, threads)

        def fn(args=args):
            kernels.launch("psa_three_interpolate_bwd", dev, *args)

        label = f"{csr.variant}/S{csr.steps}/W{csr.warps} U{ahead}/T{threads}"
        dp.fill_(float("nan"))
        fn()
        if not torch.equal(dp.cpu(), want_dp):
            raise AssertionError(f"three_interpolate_bwd {label}: dP differs from the CPU")
        if need_dw:
            torch.testing.assert_close(dw.cpu(), want_dw, rtol=1e-5, atol=1e-5)
        pick = csr == chosen.csr and (ahead, threads) == mine
        rows.append(dict(plan=label, us=device_us(fn), chosen=pick))
        del scratch
    return rows


def _gather_csr_plans(b: int, n: int, m: int, k: int) -> list:
    """The CSR layouts the gather sweep tries: the plan's; fused with 1-16
    steps a chunk where a block's counters fit ``csr.SMEM_MAX``; chunked with
    8-64 steps, 1-8 chunks a block, where a warp's counters fit
    ``csr.SMEM_LIMIT``; tiled with 8-32 warps, the tile filling
    ``csr.SMEM_LIMIT`` or ``csr.SMEM_MAX``, where N is beyond the chunked."""
    e = m * k
    plans = {gg.csr_plan(b, n, m, k)}
    for steps in (1, 2, 4, 8, 16):
        warps = -(-e // (32 * steps))
        if warps <= csr.FUSED_WARPS and 4 * n * warps <= csr.SMEM_MAX:
            plans.add(csr.CsrPlan("fused", steps, warps, warps, 4 * n * warps, 0))
    for steps in (8, 16, 32, 64):
        chunks = -(-e // (32 * steps))
        for warps in csr.WARPS:
            if warps <= chunks and 4 * n * warps <= csr.SMEM_LIMIT:
                plans.add(csr.CsrPlan("chunked", steps, chunks, warps, 4 * n * warps,
                                      b * chunks * (n + -(-n // csr.SCAN_TILE))))
    if 4 * n > csr.SMEM_LIMIT:
        for most in (8, 16, 32):
            steps = -(-e // (32 * most))
            warps = -(-e // (32 * steps))
            for smem in (csr.SMEM_LIMIT, csr.SMEM_MAX):
                tile = min(n, smem // (4 * warps))
                plans.add(csr.CsrPlan("tiled", steps, warps, warps, 4 * tile * warps, 0))
    return sorted(plans)


def _gather_consumes(chosen: gg.BackwardPlan, b: int, n: int, m: int, k: int, c: int) -> list:
    """The consuming passes the gather sweep tries under the plan's CSR:
    every number of elements a lane (with ``AHEAD``'s rows a round), its
    column blocks following, with windows of 8-32 places, 256 threads."""
    width = c // 4 if chosen.vector else c
    out = []
    for per_lane, ahead in gg.AHEAD[chosen.vector].items():
        col_blocks = -(-width // (chosen.lanes * per_lane))
        if -(-width // (chosen.lanes * col_blocks)) != per_lane:
            continue  # another number's split
        for window in (8, 16, 32):
            out.append(chosen._replace(
                per_lane=per_lane, ahead=ahead, col_blocks=col_blocks, window=window,
                blocks=gg.consume_blocks(b, n, m, k, window, chosen.lanes, chosen.threads)))
    return out


def sweep_gather_bwd(idx, n: int, c: int) -> list:
    """The gather backward: every CSR layout of ``_gather_csr_plans`` under
    the plan's consuming pass (also the CSR alone, ``csr_us``), then every
    consuming pass of ``_gather_consumes`` under the plan's CSR."""
    b, m, k = idx.shape
    dev = idx.device
    g = torch.randn(b, m, k, c, device=dev, generator=torch.Generator(dev).manual_seed(5))
    want = plain.group_point_backward(g.cpu(), idx.cpu(), n)
    chosen = gg.backward_plan(b, n, m, k, c, True)
    dp = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    tried = [chosen._replace(csr=sort) for sort in _gather_csr_plans(b, n, m, k)]
    tried += [p for p in _gather_consumes(chosen, b, n, m, k, c) if p != chosen]
    rows = []
    for p in tried:
        sort = p.csr
        scratch, entries, offsets, hist, first_key = gg.backward_scratch(b, n, m, k, p, dev)
        fused = int(sort.variant != "chunked")
        args = (g.data_ptr(), idx.data_ptr(), dp.data_ptr(), offsets, entries, hist, first_key,
                b, n, c, m, k, fused, sort.steps, sort.warps, sort.smem_bytes, int(p.vector),
                p.lanes, p.per_lane, p.ahead, p.col_blocks, p.threads, p.window)

        def fn(args=args):
            kernels.launch("psa_group_gather_bwd", dev, *args)

        label = (f"{sort.variant}/S{sort.steps}/W{sort.warps}/{sort.smem_bytes // 1024}K "
                 f"P{p.per_lane}x{p.col_blocks}/U{p.ahead}/S{p.window}/T{p.threads}")
        dp.fill_(float("nan"))
        fn()
        if not torch.equal(dp.cpu(), want):
            raise AssertionError(f"group_gather_bwd {label}: dP differs from the CPU")
        row = dict(plan=label, us=device_us(fn), chosen=p == chosen)
        if p.csr != chosen.csr or p == chosen:
            csr_args = (idx.data_ptr(), offsets, entries, hist, b, n, m, k, fused, sort.steps,
                        sort.warps, sort.smem_bytes)
            row["csr_us"] = device_us(
                lambda: kernels.launch("psa_group_gather_csr", dev, *csr_args))
        rows.append(row)
        del scratch
    return rows


def _print(kind: str, label: str, shape: str, rows: list) -> None:
    rows = sorted(rows, key=lambda r: r["us"])
    best = rows[0]["us"]
    chosen = next(r for r in rows if r["chosen"])

    def name(r):
        return r.get("plan") or f"{r['per']}/{r['threads']}/{r['tile']}x{r['stages']}"

    cells = " ".join(f"{'*' if r['chosen'] else ''}{name(r)}={r['us']:.2f}" for r in rows[:8])
    print(f"[sweep] {kind} {label} {shape}: plan() {chosen['us']:.2f} us, best {best:.2f} us; "
          f"fastest (plan = us): {cells}", flush=True)


KINDS = ("ball_query", "group_gather_bwd", "three_nn", "three_interpolate",
         "three_interpolate_bwd")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=KINDS, default=list(KINDS))
    kinds = ap.parse_args().only
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep measures the card; CUDA is not available")
    dev = torch.device("cuda")
    kernels.build()
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy((rng.rand(BATCH, NPOINTS, 3) * EXTENT).astype(np.float32)).to(dev)
    levels = [xyz]
    out = {k: {} for k in kinds}
    for i, npoint in enumerate(sem_seg.SA_NPOINTS):
        centres = plain.gather_point(xyz, ops.farthest_point_sample(xyz, npoint))
        label = f"SA{i + 1}"
        if "ball_query" in kinds:
            rows = sweep_ball_query(xyz, centres, sem_seg.SA_RADII[i], sem_seg.SA_NSAMPLE)
            _print("ball_query", label, f"N{xyz.shape[1]} M{npoint}", rows)
            out["ball_query"][label] = rows
        if "group_gather_bwd" in kinds and i > 0:  # SA1's input carries no gradient
            idx, _ = ops.ball_query(xyz, centres, sem_seg.SA_RADII[i], sem_seg.SA_NSAMPLE)
            rows = sweep_gather_bwd(idx, xyz.shape[1], SA_CHANNELS[i])
            _print("group_gather_bwd", label, f"N{xyz.shape[1]} M{npoint} C{SA_CHANNELS[i]}", rows)
            out["group_gather_bwd"][label] = rows
        xyz = centres
        levels.append(xyz)
    if "group_gather_bwd" in kinds:
        n_big = (1 << 15) + 256
        big_idx = torch.from_numpy(rng.randint(0, n_big, (2, 4096, 32)).astype(np.int32)).to(dev)
        rows = sweep_gather_bwd(big_idx, n_big, 64)
        _print("group_gather_bwd", "large N", f"N{n_big} M4096 C64", rows)
        out["group_gather_bwd"]["large N"] = rows
    for i in range(4):
        label = f"FP{i + 1}"
        xyz1, xyz2 = levels[3 - i], levels[4 - i]
        shape = f"N{xyz1.shape[1]} M{xyz2.shape[1]}"
        if "three_nn" in kinds:
            rows = sweep_three_nn(xyz1, xyz2)
            _print("three_nn", label, shape, rows)
            out["three_nn"][label] = rows
        dist, idx = ops.three_nn(xyz1, xyz2)
        weight = plain.interpolation_weights(dist)
        points = torch.randn(BATCH, xyz2.shape[1], FP_CHANNELS[i], device=dev,
                             generator=torch.Generator(dev).manual_seed(i))
        shape += f" C{FP_CHANNELS[i]}"
        if "three_interpolate" in kinds:
            rows = sweep_interpolate(points, idx, weight)
            _print("three_interpolate", label, shape, rows)
            out["three_interpolate"][label] = rows
        if "three_interpolate_bwd" in kinds:
            for need_dw in (True, False):
                rows = sweep_interpolate_bwd(points, idx, weight, need_dw)
                tag = "dP+dw" if need_dw else "dP"
                _print(f"three_interpolate_bwd {tag}", label, shape, rows)
                out["three_interpolate_bwd"][f"{label} {tag}"] = rows
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
