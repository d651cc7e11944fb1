#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. build        -- compile the seven CUDA kernels from ``csrc/`` with nvcc
                   (sm_90a), one nvcc per source, all started together.
2. model        -- full-width ``sem_seg_features`` with seeded weights and BN
                   statistics: B2 x 8192 eval forward on the card and on the
                   CPU, TF32 off; indices equal at every level, logits within
                   rtol=atol=1e-3.
3. serve        -- synthetic rooms of 150k points chunked to 8192-point
                   chunks, predicted in batches of 16 and stitched; launch
                   counters are zeroed just before and read just after: every
                   forward kernel launched, no backward kernel did.
4. forward      -- B16 x 8192 eval forward time.
5. train-parity -- one ``seg_train_step`` at full width, B2 x 8192, TF32 and
                   dropout off, from the same seeded weights and batch on the
                   card, on the card through the plain ops, on the CPU, and a
                   float64 CPU reference of the gradients.  See
                   ``phase_train_parity`` for what is compared.
6. train        -- B16 x 8192 batches of random chunks (``sample_random_chunk``
                   then ``make_batch``) from synthetic 150k-point rooms; launch
                   counters zeroed just before the timed steps and read just
                   after: all seven kernels launched; every loss finite; five
                   steps on one batch bring its loss below the first.
   trainer      -- the port's workflow through its entry points
                   (``phase_trainer``): a synthetic store of 32 + 2 rooms of
                   150k points, ``precompute_cli`` (2 train epochs, val) and
                   the q16 pack store, timed; ``trainer.train`` at B16 x 8192
                   for 3 epochs of 2 steps with validation every epoch, once
                   with ``input='npz'`` and once with ``input='packed'``
                   (``packed_q16``): launch counters zeroed just before and
                   read just after each run, all seven kernels launched,
                   every logged loss finite, the step count as configured,
                   the best checkpoint restoring bit for bit; then
                   ``generate_predictions`` over the val rooms from that
                   checkpoint as f32, packed f32 (equal to the f32 path on
                   the values the record carries) and packed q16 rows,
                   ``benchmark.evaluate`` equal to the in-memory mIoU, and a
                   crop of one room on the card and the CPU (>= 99.9 %).
   The attention slice (``ATTENTION_MODELS``, fed xyz only, as the
   reference's attention ablation ran them):
   attention-model -- ``sem_seg_attention``, ``sem_seg_attention_single_layer``
                   (attention at SA1) and ``sem_seg_attention_and_pooling``
                   checked as in phase 2.
   attention-forward -- B16 x 8192 eval forward time of ``sem_seg_attention``.
   attention-train-parity -- phase 5 for ``sem_seg_attention``, same limits.
   attention-train -- phase 6 for ``sem_seg_attention`` on the flagship's
                   batches (10 timed steps): all seven kernels launched in its
                   own window, every loss finite.
7. kernels      -- every forward kernel against its plain PyTorch version on
                   the card at the B16 shapes (SA1-4, FP1-4) and at a large N;
                   all outputs equal bit for bit.  FPS, ball query,
                   three-NN and the interpolation also at edge shapes that
                   together run every variant of their plans
                   (``ops/cuda/{fps,ball_query,three_nn,
                   three_interpolate}.py``): B1, B17, ragged N and M, empty and
                   full balls, a point on the sphere, nsample 1 to 64 and
                   above N, M < 3, duplicate and all-equal points, clouds
                   beyond one tile and beyond 48 KB, C 1 to 512, misaligned
                   rows, M 33,024 (the interpolation's backward is held there
                   as in phase 8); the gather also on random idx at odd
                   (nsample, C).  Ball query's, three-NN's and the
                   interpolation's bounds at every level.  Times
                   each kernel, its plain version and, where one exists, the
                   single PyTorch call computing the same function: wall
                   time of bursts of calls (``time_ms``, which includes the
                   host launch cost).
8. kernels-bwd  -- the two backward kernels at SA2-4 / FP1-4 and a large N.
                   The gather scatter-add's dP equal to the plain version run
                   on CPU copies and from call to call, its CSR equal to
                   ``plain.transpose_csr``, there and at edge shapes that
                   together run every variant of its plan (B1, B17, N 1, K 1
                   and 64, C 1 to 1024, misaligned rows, random and
                   ball-query idx); timed beside ``zeros().index_add_`` and
                   its bound at every level.  The interpolation backward's dP
                   equal to the plain version run on CPU copies and from
                   call to call, dw within 1e-5 and equal from call to call,
                   its CSR equal to ``plain.interpolation_csr``; timed with
                   and without dw, with its bound at every level; timed like
                   phase 7.
9. device-times -- device-only time of every timed kernel level and library
                   call, and of both B16 forwards, from the profiler's kernel
                   events (``device_ms``); then the B16 forward is timed
                   again.  Last of the timed
                   phases: train steps timed after the profiler had run
                   read up to 30 % slower (PERF.md, Findings).  The kernel
                   phases come after the end-to-end ones so that their
                   inputs, which phase 9 reuses, do not count in the serve
                   and train windows' peak memory.
10. report      -- one line per kernel (with its launches in each trainer
                   run), a ``{"kernels": [...]}`` JSON line, the
                   card's name and power limit, and the final
                   ``{"ok": true, "device": {...}}`` line.

Exits non-zero without printing a result when CUDA is not available.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from pointcloud_segmentation_attention_tpu_torch import models, ops  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.data.pipeline import make_batch  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import (  # noqa: E402
    sample_random_chunk,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (  # noqa: E402
    load_scene_mapped,
    make_synthetic_scene,
    write_synthetic_dataset,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet import (  # noqa: E402
    packstore,
    precompute,
    precompute_cli,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import (  # noqa: E402
    map_to_nyu40,
)
from pointcloud_segmentation_attention_tpu_torch.data.wire import WireSpec  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.eval import benchmark  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.eval.full_scene import (  # noqa: E402
    generate_predictions,
    make_predict_fn,
    predict_scene_chunks,
    scene_chunks,
)
from pointcloud_segmentation_attention_tpu_torch.models import sem_seg  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.ops import cuda as kernels  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as plain  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (  # noqa: E402
    ball_query as bq_kernel,
    fps as fps_kernel,
    three_nn as nn_kernel,
)
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (  # noqa: E402
    group_gather as gather_kernels,
)
from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (  # noqa: E402
    three_interpolate as interp_kernels,
)
from pointcloud_segmentation_attention_tpu_torch.train import (  # noqa: E402
    TrainState,
    best_checkpoint,
    export_jax_state,
    losses,
    restore_checkpoint,
    schedules,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train import steps as train_steps  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.train import trainer  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.nn import PointConv  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.utils.trace_breakdown import (  # noqa: E402
    device_breakdown,
)

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)  # one serving chunk's extent
# The interpolation's dw sums each dot product in another order than the
# plain version; both backwards' dP are held bit for bit.
BWD_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
SA_FEATURES = (6, 64, 128, 256)   # feature channels entering SA1-4
FP_CHANNELS = (512, 256, 256, 128)  # interpolated channels at FP1-4
PALLAS = "pointcloud_segmentation_attention_tpu/ops/pallas/"
CSRC = "pointcloud_segmentation_attention_tpu_torch/csrc/"
KERNEL_INFO = {
    "fps": ("fps.cu", "fps_kernel.py:94"),
    "ball_query": ("ball_query.cu", "ball_query_kernel.py:180"),
    "group_gather": ("group_gather.cu", "group_gather_kernel.py:120"),
    "three_nn": ("three_nn.cu", "three_nn_kernel.py:80"),
    "three_interpolate": ("three_interpolate.cu", "interpolate_kernel.py:109"),
    "group_gather_bwd": ("group_gather_bwd.cu", "group_gather_kernel.py:195"),
    "three_interpolate_bwd": ("three_interpolate_bwd.cu", "interpolate_kernel.py:149"),
}
FORWARD_KERNELS = ("fps", "ball_query", "group_gather", "three_nn", "three_interpolate")
# The attention slice's registry models (name, seeded_model arguments), xyz only.
ATTENTION_MODELS = (("sem_seg_attention", {}),
                    ("sem_seg_attention_single_layer", {"layer_idx": 0}),
                    ("sem_seg_attention_and_pooling", {}))
BACKWARD_KERNELS = ("group_gather_bwd", "three_interpolate_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2, burst: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``burst``
    back-to-back calls, divided by ``burst``; the median of ``reps`` bursts.
    A call whose kernel is shorter than its host-side launch cost measures
    that cost instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return float(np.median(times))


def device_ms(fn, calls: int = 10, warmup: int = 2) -> float:
    """Device-only time of one call of ``fn`` in ms: the durations of the
    kernels, copies and sets that ``torch.profiler`` records over ``calls``
    back-to-back calls, summed and divided by ``calls``.  Host launch cost
    and the gaps between kernels are not in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = device_breakdown(prof, 1.0)["device_busy_ms"]
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return busy / calls


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not torch.equal(got.cpu(), want.cpu()):
        bad = int((got.cpu() != want.cpu()).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: kernel differs from plain version ({bad} entries)")
    return 0.0


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    torch.testing.assert_close(got.cpu(), want.cpu(), msg=lambda m: f"{name}: {m}", **tol)
    return float((got.cpu() - want.cpu()).abs().max())


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    log(f"[build] {len(kernels.SOURCES)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"-> {os.path.relpath(kernels.library_path(), ROOT)}")
    for line in kernels.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_kernels(dev, batch: int, n: int, reps: int):
    """Each forward kernel against its plain version at every level; returns
    the per-kernel report (errors, times, bounds) and each level's geometry
    for the backward kernels."""
    rng = np.random.RandomState(0)
    rep = {k: {"max_abs_err": 0.0, "levels": {}, "device_fns": {}} for k in FORWARD_KERNELS}
    geom = {"sa": [], "fp": []}

    def err(name, e):
        rep[name]["max_abs_err"] = max(rep[name]["max_abs_err"], e)

    def level_time(name, label, fn):
        rep[name]["levels"][label] = time_ms(fn, reps)
        rep[name]["device_fns"][label] = fn

    def level_bound(name, label, nbytes, flops):
        rep[name].setdefault("level_bound", {})[label] = bound(nbytes, flops)

    xyz = torch.from_numpy((rng.rand(batch, n, 3) * EXTENT).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.rand(batch, n, SA_FEATURES[0]).astype(np.float32)).to(dev)
    levels = [xyz]
    for i, npoint in enumerate(sem_seg.SA_NPOINTS):
        radius, ns = sem_seg.SA_RADII[i], sem_seg.SA_NSAMPLE
        label = f"SA{i + 1}"
        fps_k = ops.farthest_point_sample(xyz, npoint)
        err("fps", check_equal(f"fps {label}", fps_k, plain.farthest_point_sample(xyz, npoint)))
        new_xyz = plain.gather_point(xyz, fps_k)
        idx, cnt = ops.ball_query(xyz, new_xyz, radius, ns)
        pidx, pcnt = plain.ball_query(xyz, new_xyz, radius, ns)
        err("ball_query", check_equal(f"ball_query idx {label}", idx, pidx))
        err("ball_query", check_equal(f"ball_query cnt {label}", cnt, pcnt))
        pts = torch.cat([xyz, feats], dim=-1).contiguous()
        err("group_gather", check_equal(f"group_gather {label}",
                                        ops.group_point_with_counts(pts, idx, cnt),
                                        plain.group_point(pts, idx)))
        torch.cuda.synchronize()
        level_time("fps", label, functools.partial(ops.farthest_point_sample, xyz, npoint))
        level_time("ball_query", label,
                   functools.partial(ops.ball_query, xyz, new_xyz, radius, ns))
        level_time("group_gather", label,
                   functools.partial(ops.group_point_with_counts, pts, idx, cnt))
        level_bound("ball_query", label, *ball_query_work(xyz, new_xyz, idx, cnt, ns))
        if i == 0:
            sa1 = dict(xyz=xyz, new_xyz=new_xyz, idx=idx, cnt=cnt, pts=pts, npoint=npoint,
                       radius=radius, ns=ns)
        geom["sa"].append((label, idx, xyz.shape[1], pts.shape[-1]))
        log(f"[kernels] {label}: N={xyz.shape[1]} npoint={npoint} r={radius} ns={ns} "
            f"C={pts.shape[-1]} ball hits mean={cnt.float().mean().item():.2f} "
            f"fps/ball_query/group_gather equal")
        xyz = new_xyz
        feats = torch.rand(batch, npoint, SA_FEATURES[i + 1] if i < 3 else 1, device=dev)
        levels.append(xyz)

    for i in range(4):
        label = f"FP{i + 1}"
        xyz1, xyz2 = levels[3 - i], levels[4 - i]
        dist, nidx = ops.three_nn(xyz1, xyz2)
        pdist, pnidx = plain.three_nn(xyz1, xyz2)
        err("three_nn", check_equal(f"three_nn idx {label}", nidx, pnidx))
        err("three_nn", check_equal(f"three_nn dist {label}", dist, pdist))
        w = plain.interpolation_weights(pdist)
        p2 = torch.randn(batch, xyz2.shape[1], FP_CHANNELS[i], device=dev)
        err("three_interpolate", check_equal(
            f"three_interpolate {label}", ops.three_interpolate(p2, nidx, w),
            plain.three_interpolate(p2, pnidx, w)))
        torch.cuda.synchronize()
        level_time("three_nn", label, functools.partial(ops.three_nn, xyz1, xyz2))
        level_bound("three_nn", label, *three_nn_work(xyz1, xyz2))
        level_time("three_interpolate", label, functools.partial(ops.three_interpolate, p2, nidx, w))
        level_bound("three_interpolate", label, *interpolate_work(p2, nidx))
        if i == 3:
            fp4 = dict(xyz1=xyz1, xyz2=xyz2, idx=nidx, w=w, p2=p2)
        geom["fp"].append((label, nidx, w, p2))
        log(f"[kernels] {label}: N={xyz1.shape[1]} M={xyz2.shape[1]} C={FP_CHANNELS[i]} "
            f"three_nn idx and dist equal, interpolate equal")

    # Large clouds: FPS beyond shared memory, ball query over 2^15+ points.
    big = torch.from_numpy(rng.rand(2, (1 << 15) + 256, 3).astype(np.float32)).to(dev)
    err("fps", check_equal("fps large N",
                           ops.farthest_point_sample(big, 64),
                           plain.farthest_point_sample(big, 64)))
    dense = (big * 0.2).contiguous()
    centres = dense[:, :64].contiguous()
    bi, bc = ops.ball_query(dense, centres, 0.5, 8)
    pbi, pbc = plain.ball_query(dense, centres, 0.5, 8)
    err("ball_query", check_equal("ball_query large N idx", bi, pbi))
    err("ball_query", check_equal("ball_query large N cnt", bc, pbc))
    torch.cuda.synchronize()
    log(f"[kernels] large N={big.shape[1]}: fps and ball_query equal")
    fps_cases = check_fps_edges(dev, rng)
    log(f"[kernels] fps equal at {len(fps_cases)} edge shapes covering every plan variant: "
        + "; ".join(fps_cases))
    bq_cases = check_ball_query_edges(dev, rng)
    log(f"[kernels] ball_query idx and cnt equal at {len(bq_cases)} edge shapes covering every "
        "plan variant: " + "; ".join(bq_cases))
    nn_cases = check_three_nn_edges(dev, rng)
    log(f"[kernels] three_nn idx and dist equal at {len(nn_cases)} edge shapes covering every "
        "plan variant: " + "; ".join(nn_cases))
    gather_cases = check_gather_edges(dev, rng)
    log(f"[kernels] group_gather equal on random idx at (nsample, C) = {gather_cases}")
    interp_cases = check_interpolate_edges(dev, rng)
    log(f"[kernels] three_interpolate equal, its backward's dP equal to the CPU and "
        f"reproducible, dw within {BWD_TOL} and reproducible, the CSR equal, at "
        f"{len(interp_cases)} edge shapes covering every plan variant: " + "; ".join(interp_cases))

    # Headline shapes: SA1 for the SA kernels, FP4 for the FP kernels.
    b = batch
    x, nx, idx, cnt, pts = sa1["xyz"], sa1["new_xyz"], sa1["idx"], sa1["cnt"], sa1["pts"]
    npt, r, ns = sa1["npoint"], sa1["radius"], sa1["ns"]
    m, c = npt, pts.shape[-1]
    rep["fps"].update(
        ms=rep["fps"]["levels"]["SA1"], headline="SA1",
        plain_ms=time_ms(lambda: plain.farthest_point_sample(x, npt), max(2, reps // 4), 1, 1),
        library_ms=None, library_fn=None, shape=f"B{b} N{n} -> {npt}",
        plan=fps_kernel.plan(b, n)._asdict())
    rep["fps"]["bound_ms"], rep["fps"]["bound_by"] = bound(
        b * n * 12 + b * npt * 4, 9.0 * b * (npt - 1) * n)
    rep["ball_query"].update(
        ms=rep["ball_query"]["levels"]["SA1"], headline="SA1",
        plain_ms=time_ms(lambda: plain.ball_query(x, nx, r, ns), max(2, reps // 4), 1, 1),
        library_ms=None, library_fn=None, shape=f"B{b} N{n} M{m} ns{ns}")
    rep["ball_query"]["bound_ms"], rep["ball_query"]["bound_by"] = \
        rep["ball_query"]["level_bound"]["SA1"]
    bidx = torch.arange(b, device=dev)[:, None, None]
    lidx = idx.long()
    check_equal("group_gather library", pts[bidx, lidx], plain.group_point(pts, idx))
    rep["group_gather"].update(
        ms=rep["group_gather"]["levels"]["SA1"],
        headline="SA1",
        plain_ms=time_ms(lambda: plain.group_point(pts, idx), reps),
        library_ms=time_ms(lambda: pts[bidx, lidx], reps),
        library_fn=lambda: pts[bidx, lidx],
        library_call="points[b_idx, idx]", shape=f"B{b} N{n} M{m} ns{ns} C{c}")
    rep["group_gather"]["bound_ms"], rep["group_gather"]["bound_by"] = bound(
        b * n * c * 4 + b * m * ns * 4 + b * m * ns * c * 4, 0.0)

    x1, x2, nidx, w, p2 = fp4["xyz1"], fp4["xyz2"], fp4["idx"], fp4["w"], fp4["p2"]
    fn_, fm, fc = x1.shape[1], x2.shape[1], p2.shape[-1]
    rep["three_nn"].update(
        ms=rep["three_nn"]["levels"]["FP4"], headline="FP4",
        plain_ms=time_ms(lambda: plain.three_nn(x1, x2), max(2, reps // 4), 1, 1),
        library_ms=None, library_fn=None, shape=f"B{b} N{fn_} M{fm}")
    rep["three_nn"]["bound_ms"], rep["three_nn"]["bound_by"] = rep["three_nn"]["level_bound"]["FP4"]
    gidx = (nidx.long() + torch.arange(b, device=dev)[:, None, None] * fm).reshape(-1, 3)
    table, bw = p2.reshape(-1, fc), w.reshape(-1, 3)

    def embedding_bag():
        return torch.nn.functional.embedding_bag(gidx, table, mode="sum", per_sample_weights=bw)

    check_close("three_interpolate library", embedding_bag().reshape(b, fn_, fc),
                plain.three_interpolate(p2, nidx, w), dict(rtol=1e-5, atol=1e-5))
    rep["three_interpolate"].update(
        ms=rep["three_interpolate"]["levels"]["FP4"],
        headline="FP4",
        plain_ms=time_ms(lambda: plain.three_interpolate(p2, nidx, w), reps),
        library_ms=time_ms(embedding_bag, reps), library_fn=embedding_bag,
        library_call="embedding_bag(mode='sum', per_sample_weights)",
        shape=f"B{b} N{fn_} M{fm} C{fc}")
    rep["three_interpolate"]["bound_ms"], rep["three_interpolate"]["bound_by"] = \
        rep["three_interpolate"]["level_bound"]["FP4"]
    geom["large"] = big
    torch.cuda.synchronize()
    return rep, geom


def ball_query_work(xyz, centres, idx, cnt, ns):
    """(bytes, f32 operations) a ball query needs: the cloud and centres read,
    idx and cnt written; 8 operations per (centre, point) pair up to each
    centre's nsample-th hit, or over all N points when the ball is not full."""
    b, n, _ = xyz.shape
    m = centres.shape[1]
    visited = torch.where(cnt == ns, idx[..., -1].long() + 1, torch.full_like(cnt, n).long())
    return (b * n * 12 + b * m * 12 + b * m * ns * 4 + b * m * 4, 8.0 * float(visited.sum()))


def interpolate_work(points, idx):
    """(bytes, f32 operations) of the interpolation: P, idx and w read once,
    the output written; 5 operations per output element."""
    b, m, c = points.shape
    n = idx.shape[1]
    return b * m * c * 4 + b * n * 3 * 8 + b * n * c * 4, 5.0 * b * n * c


def interpolate_bwd_work(points, idx, need_dw: bool):
    """(bytes, f32 operations) of the interpolation backward: g, idx and w
    read once, dP written, and with dw P read and dw written; 2 operations
    per element of g and key for dP, 2 more per element and key for dw.  The
    CSR the kernel builds is scratch and does not count."""
    b, m, c = points.shape
    n = idx.shape[1]
    nbytes = b * n * c * 4 + b * n * 3 * 8 + b * m * c * 4
    if need_dw:
        nbytes += b * m * c * 4 + b * n * 3 * 4
    return nbytes, (12.0 if need_dw else 6.0) * b * n * c


def three_nn_work(xyz1, xyz2):
    """(bytes, f32 operations) of three-NN: both clouds read, dist and idx
    written; 8 operations per (unknown, known) pair."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    return b * n * 12 + b * m * 12 + b * n * 3 * 8, 8.0 * b * n * m


def _duplicated(rng: np.random.RandomState, b: int, n: int, distinct: int, dev):
    """B clouds of n points, each of ``distinct`` points repeated at shuffled
    indices: every distance is tied with its copies'."""
    base = rng.rand(b, distinct, 3) * EXTENT
    order = np.stack([rng.permutation(np.arange(n) % distinct) for _ in range(b)])
    return torch.from_numpy(np.take_along_axis(base, order[..., None], 1)
                            .astype(np.float32)).to(dev)


def check_ball_query_edges(dev, rng: np.random.RandomState) -> list:
    """Ball query bit-identical (idx and cnt) to its plain version at edge
    shapes that together run every variant of ``ball_query.plan``; returns
    the cases' labels."""
    def cloud(b, n, scale=1.0):
        return torch.from_numpy((rng.rand(b, n, 3) * EXTENT * scale).astype(np.float32)).to(dev)

    def centres_of(xyz, m):
        b, n, _ = xyz.shape
        pick = np.stack([rng.randint(0, n, m) for _ in range(b)])
        return plain.gather_point(xyz, torch.from_numpy(pick.astype(np.int32)).to(dev))

    # The plain version's threshold test on the sphere: d2 == r2 is no hit.
    sphere = torch.tensor([[[0.5, 0, 0], [0, 0, 0], [0.25, 0, 0], [0, 0.5, 0], [0.4999, 0, 0],
                            [0, 0, -0.5], [0.5, 0, 0]]], dtype=torch.float32, device=dev)
    dense = cloud(16, 8192, 0.2)
    cases = [
        # (label, xyz, centres, radius, nsample)
        ("B1, N 8192", cloud(1, 8192), 1024, 0.1, 32),
        ("B17, N 8192", cloud(17, 8192), 1024, 0.1, 32),
        ("N 1, nsample 4 > N", cloud(2, 1), None, 0.5, 4),
        ("N 31, nsample 13", cloud(3, 31), None, 0.5, 13),
        ("N 33, nsample 64 > N", cloud(2, 33), None, 1.0, 64),
        ("N 8193", cloud(3, 8193), 1000, 0.2, 32),
        ("N 33,024", cloud(2, 33_024), 512, 0.1, 32),
        ("M 1", cloud(4, 2048), 1, 0.3, 32),
        ("M 1000 of 16 a block", cloud(6, 1024), 1000, 0.2, 32),
        ("B5, N 4096, M 1000", cloud(5, 4096), 1000, 0.2, 32),
        ("B16, N 1024, M 1024", cloud(16, 1024), 1024, 0.2, 32),
        ("nsample 1", cloud(2, 4096), 300, 0.3, 1),
        ("nsample 64", cloud(16, 8192), 1024, 0.2, 64),
        ("empty balls, r 1e-4", cloud(2, 4096), 256, 1e-4, 16),
        ("full in the first tile (dense, r 2)", dense, dense[:, ::8].contiguous(), 2.0, 32),
        ("full in the first tile, nsample 64", dense, dense[:, ::8].contiguous(), 2.0, 64),
        ("point on the sphere", sphere, sphere[:, 1:2].contiguous(), 0.5, 4),
        ("duplicates, N 8192 of 300", _duplicated(rng, 2, 8192, 300, dev), 512, 0.2, 32),
    ]
    labels, seen = [], set()
    for label, xyz, centres, radius, ns in cases:
        if not isinstance(centres, torch.Tensor):
            centres = centres_of(xyz, min(xyz.shape[1], 128) if centres is None else centres)
        b, n, _ = xyz.shape
        m = centres.shape[1]
        p = bq_kernel.plan(b, n, m)
        seen.add((p.variant, p.per_warp))
        label = f"{label} (B{b} N{n} M{m} ns{ns}: {p.variant}, R {p.per_warp}, {p.threads} threads)"
        idx, cnt = ops.ball_query(xyz, centres, radius, ns)
        pidx, pcnt = plain.ball_query(xyz, centres, radius, ns)
        check_equal(f"ball_query idx {label}", idx, pidx)
        check_equal(f"ball_query cnt {label}", cnt, pcnt)
        labels.append(label)
    torch.cuda.synchronize()
    # Hits at d2 < r2 only: indices 1, 2, 4; (0.5, 0, 0) at d2 == r2 is out.
    idx, cnt = ops.ball_query(sphere, sphere[:, 1:2].contiguous(), 0.5, 4)
    if cnt.tolist() != [[3]] or idx.tolist() != [[[1, 2, 4, 1]]]:
        raise AssertionError(f"ball_query on the sphere: cnt {cnt.tolist()} idx {idx.tolist()}")
    want = {(v, r) for v in ("whole", "ring") for r in bq_kernel.PER_WARP}
    if want != seen:
        raise AssertionError(f"ball_query edge shapes missed plan variants {want - seen}")
    return labels


def check_three_nn_edges(dev, rng: np.random.RandomState) -> list:
    """Three-NN bit-identical (idx and dist) to its plain version at edge
    shapes that together run every variant of ``three_nn.plan``, the shared
    memory opt-in above 48 KB included; returns the cases' labels."""
    def cloud(b, n):
        return torch.from_numpy((rng.rand(b, n, 3) * EXTENT).astype(np.float32)).to(dev)

    same = torch.full((2, 1024, 3), 0.7, dtype=torch.float32, device=dev)
    cases = [
        # (label, unknown, known)
        ("M 1", cloud(2, 1000), cloud(2, 1)),
        ("M 2", cloud(3, 500), cloud(3, 2)),
        ("M 3", cloud(2, 777), cloud(2, 3)),
        ("M 1000", cloud(4, 5000), cloud(4, 1000)),
        ("M 6000, whole above 48 KB", cloud(2, 2000), cloud(2, 6000)),
        ("M 10,000 in the ring", cloud(2, 3000), cloud(2, 10_000)),
        ("N 8191 of 512 a block", cloud(16, 8191), cloud(16, 1024)),
        ("all-equal known points", cloud(2, 4096), same),
        ("duplicates, M 1024 of 50", cloud(2, 4096), _duplicated(rng, 2, 1024, 50, dev)),
        ("B1", cloud(1, 8192), cloud(1, 1024)),
        ("B17", cloud(17, 8192), cloud(17, 1024)),
        ("B16, M 8300 in the ring", cloud(16, 8192), cloud(16, 8300)),
    ]
    labels, seen, opt_in = [], set(), False
    for label, xyz1, xyz2 in cases:
        b, n, _ = xyz1.shape
        m = xyz2.shape[1]
        p = nn_kernel.plan(b, n, m)
        seen.add((p.variant, p.per_thread))
        opt_in = opt_in or p.smem_bytes > kernels.DEFAULT_SMEM_BYTES
        label = (f"{label} (B{b} N{n} M{m}: {p.variant}, Q {p.per_thread}, {p.threads} threads, "
                 f"{p.smem_bytes} B)")
        dist, idx = ops.three_nn(xyz1, xyz2)
        pdist, pidx = plain.three_nn(xyz1, xyz2)
        check_equal(f"three_nn idx {label}", idx, pidx)
        check_equal(f"three_nn dist {label}", dist, pdist)
        labels.append(label)
    torch.cuda.synchronize()
    want = {(v, q) for v in ("whole", "ring") for q in nn_kernel.PER_THREAD}
    if want != seen or not opt_in:
        raise AssertionError(f"three_nn edge shapes missed plan variants {want - seen} "
                             f"(a whole cloud above 48 KB: {opt_in})")
    return labels


def check_fps_edges(dev, rng: np.random.RandomState) -> list:
    """FPS bit-identical to its plain version at edge shapes that together
    run every variant of ``fps.plan``; returns the cases' labels."""
    def cloud(b, n):
        return torch.from_numpy((rng.rand(b, n, 3) * EXTENT).astype(np.float32)).to(dev)

    def duplicated(b, n, distinct):
        # Every pick is a tie between copies, and once all are picked, between all.
        return _duplicated(rng, b, n, distinct, dev)

    cases = [
        ("B1", cloud(1, 8192), 1024),
        ("B17", cloud(17, 8192), 1024),  # 136 blocks: more than one per SM somewhere
        ("npoint 1, N 8192", cloud(4, 8192), 1),
        ("npoint 1, N 1024", cloud(4, 1024), 1),
        ("npoint N, N 4096", cloud(2, 4096), 4096),
        ("npoint N, N 100", cloud(3, 100), 100),
        ("N 8193", cloud(3, 8193), 512),
        ("N 5000", cloud(2, 5000), 700),
        ("N 1000", cloud(3, 1000), 300),
        ("N 1, npoint 4", cloud(2, 1), 4),
        ("duplicates, N 8192 of 300", duplicated(2, 8192, 300), 1024),
        ("duplicates, N 1024 of 50", duplicated(3, 1024, 50), 256),
        ("N 70,000", cloud(2, 70_000), 64),
        ("N 120,000", cloud(2, 120_000), 64),
    ]
    labels, seen = [], set()
    for label, xyz, npoint in cases:
        b, n, _ = xyz.shape
        p = fps_kernel.plan(b, n)
        seen.add((p.variant, p.cluster, p.per_thread))
        label = (f"{label} ({p.variant}, cluster {p.cluster}, {p.threads} threads x "
                 f"{p.per_thread} points)")
        check_equal(f"fps {label}", ops.farthest_point_sample(xyz, npoint),
                    plain.farthest_point_sample(xyz, npoint))
        labels.append(label)
    torch.cuda.synchronize()
    want = {(("block" if c == 1 else "cluster"), c, k) for c, (k, _) in fps_kernel.REGISTERS.items()}
    want |= {("cluster-smem", fps_kernel.CLUSTER, 0), ("cluster-global", fps_kernel.CLUSTER, 0)}
    if want != seen:
        raise AssertionError(f"fps edge shapes missed plan variants {want - seen}")
    return labels


def check_gather_edges(dev, rng: np.random.RandomState) -> list:
    """The gather bit-identical to its plain version on random idx (no
    ball-query padding) at SA1-4's channel counts, at runs of nsample x C
    floats that are not a multiple of 4, with C < 4, and nsample > 32."""
    cases = [(32, 9), (32, 67), (32, 131), (32, 259), (13, 7), (40, 5), (1, 1), (3, 2),
             (33, 3), (64, 131)]
    for ns, c in cases:
        pts = torch.from_numpy(rng.randn(2, 1000, c).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, 1000, (2, 101, ns)).astype(np.int32)).to(dev)
        check_equal(f"group_gather random idx ns{ns} C{c}",
                    ops.group_point_with_counts(pts, idx), plain.group_point(pts, idx))
    torch.cuda.synchronize()
    return cases


def check_gather_bwd(label: str, g, idx, n: int) -> None:
    """The gather backward on the card: dP equal to the plain version run on
    CPU copies (the order of its sums is the CPU's) and the same bits from
    call to call; the CSR it builds equal to ``plain.transpose_csr``."""
    dp = gather_kernels.group_point_backward(g, idx, n)
    dp2 = gather_kernels.group_point_backward(g, idx, n)
    check_equal(f"group_gather_bwd {label} (against the CPU)", dp,
                plain.group_point_backward(g.cpu(), idx.cpu(), n))
    check_equal(f"group_gather_bwd {label} (second call)", dp2, dp)
    offsets, entries = gather_kernels.group_gather_csr(idx, n)
    poffsets, pentries = plain.transpose_csr(idx.cpu(), n)
    check_equal(f"gather CSR offsets {label}", offsets, poffsets)
    check_equal(f"gather CSR entries {label}", entries, pentries)


def check_gather_bwd_edges(dev, rng: np.random.RandomState) -> list:
    """The gather backward held as ``check_gather_bwd`` holds it at edge
    shapes that together run every variant of ``group_gather.backward_plan``
    (a fused, a chunked and a key-tiled CSR; float4 or float
    accesses, each with one or several column blocks; 1 to 5 elements a
    lane): B1, B17, N 1 (one key holds every slot), rows no slot names (a
    window of only empty rows), K 1 and 64, C 1 to 1024, misaligned rows (a
    contiguous slice ``x[1:]``), N 33,024, on ball-query idx (slot 0's row
    collects the padding) and random idx.  Returns the cases' labels."""
    def ball_idx(b, n, m, k, radius):
        xyz = torch.from_numpy((rng.rand(b, n, 3) * EXTENT).astype(np.float32)).to(dev)
        centres = plain.gather_point(xyz, ops.farthest_point_sample(xyz, m))
        return ops.ball_query(xyz, centres, radius, k)[0]

    def random_idx(b, n, m, k):
        return torch.from_numpy(rng.randint(0, n, (b, m, k)).astype(np.int32)).to(dev)

    def floats(shape, misaligned):
        flat = torch.from_numpy(rng.randn(int(np.prod(shape)) + 1).astype(np.float32)).to(dev)
        return flat[1:].view(*shape) if misaligned else flat[:-1].view(*shape)

    cases = [
        # (label, idx, N, C, misaligned)
        ("B1, SA2", ball_idx(1, 1024, 256, 32, 0.2), 1024, 67, False),
        ("B17, SA3", ball_idx(17, 256, 64, 32, 0.4), 256, 131, False),
        ("N 1", random_idx(2, 1, 50, 32), 1, 5, False),
        # one row takes every slot; the others, and the last window, are empty
        ("empty rows", torch.zeros(2, 50, 32, dtype=torch.int32, device=dev), 3, 5, False),
        ("K 1, C 3", ball_idx(3, 500, 200, 1, 0.2), 500, 3, False),
        ("K 64, C 259", ball_idx(2, 2048, 256, 64, 0.3), 2048, 259, False),
        ("C 1", random_idx(2, 300, 40, 16), 300, 1, False),
        ("C 4", random_idx(2, 300, 40, 16), 300, 4, False),
        ("C 512", ball_idx(2, 1000, 128, 32, 0.3), 1000, 512, False),
        ("C 1024", random_idx(2, 300, 32, 16), 300, 1024, False),
        ("misaligned, C 64", ball_idx(2, 500, 64, 32, 0.3), 500, 64, True),
        ("misaligned, C 67", random_idx(2, 500, 64, 32), 500, 67, True),
        ("N 33,024", random_idx(2, 33_024, 4096, 32), 33_024, 64, False),
    ]
    labels, seen = [], set()
    for label, idx, n, c, misaligned in cases:
        b, m, k = idx.shape
        p = gather_kernels.backward_plan(b, n, m, k, c, not misaligned)
        csr = p.csr.variant
        seen |= {("csr", csr), ("bwd", p.vector, p.col_blocks > 1), ("per_lane", p.per_lane)}
        label = (f"{label} (B{b} N{n} M{m} K{k} C{c}: {csr} CSR, "
                 f"{'float4' if p.vector else 'float'} L{p.lanes} x{p.per_lane} "
                 f"x{p.col_blocks} blocks, {p.ahead} ahead)")
        check_gather_bwd(label, floats((b, m, k, c), misaligned), idx, n)
        labels.append(label)
    torch.cuda.synchronize()
    want = {("csr", v) for v in ("fused", "chunked", "tiled")}
    want |= {("bwd", v, y) for v in (True, False) for y in (True, False)}
    want |= {("per_lane", q) for q in range(1, gather_kernels.MAX_PER_LANE + 1)}
    if want != seen:
        raise AssertionError(f"gather backward edge shapes missed plan variants {want - seen}")
    return labels


def check_interpolate_bwd(label: str, g, idx, w, p2) -> float:
    """The interpolation backward on the card: dP equal to the plain version
    run on CPU copies (the order of its sums is the CPU's), dP and dw the
    same bits from call to call, dP without dw the same again, dw within
    BWD_TOL; the CSR the backward builds equal to ``plain.interpolation_csr``.
    Returns dw's largest error."""
    dp, dw = interp_kernels.three_interpolate_backward(g, idx, w, p2)
    dp2, dw2 = interp_kernels.three_interpolate_backward(g, idx, w, p2)
    dp_only, none = interp_kernels.three_interpolate_backward(g, idx, w, p2, need_dw=False)
    if none is not None:
        raise AssertionError("three_interpolate_bwd returned dw when not asked")
    pdp, pdw = plain.three_interpolate_backward(g.cpu(), idx.cpu(), w.cpu(), p2.cpu())
    check_equal(f"three_interpolate_bwd dP {label} (against the CPU)", dp, pdp)
    check_equal(f"three_interpolate_bwd dP {label} (second call)", dp2, dp)
    check_equal(f"three_interpolate_bwd dP only {label}", dp_only, dp)
    check_equal(f"three_interpolate_bwd dw {label} (second call)", dw2, dw)
    offsets, entries = interp_kernels.interpolation_csr(idx, p2.shape[1])
    poffsets, pentries = plain.interpolation_csr(idx.cpu(), p2.shape[1])
    check_equal(f"interpolation CSR offsets {label}", offsets, poffsets)
    check_equal(f"interpolation CSR entries {label}", entries, pentries)
    return check_close(f"three_interpolate_bwd dw {label}", dw, pdw, BWD_TOL)


def check_interpolate_edges(dev, rng: np.random.RandomState) -> list:
    """The interpolation forward bit-identical to its plain version, and its
    backward held as ``check_interpolate_bwd`` holds it, at edge shapes that
    together run every variant of ``three_interpolate.plan`` (float4 or
    float accesses, indices shared by shuffle or loaded by each lane) and of
    ``backward_plan`` (a fused, a chunked and a key-tiled CSR;
    float4 or float; one or several column blocks; 4 or 8 entries ahead):
    B1, B17, N 1 and ragged, M 1 to 3 (repeated indices in a row), C 1 to
    512, misaligned pointers (a contiguous slice ``x[1:]``), M 33,024.
    Returns the cases' labels."""
    def cloud(b, n):
        return torch.from_numpy((rng.rand(b, n, 3) * EXTENT).astype(np.float32)).to(dev)

    def floats(shape, misaligned):
        if not misaligned:
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        flat = torch.from_numpy(rng.randn(int(np.prod(shape)) + 1).astype(np.float32)).to(dev)
        return flat[1:].view(*shape)  # contiguous, 4 bytes past a 16-byte boundary

    cases = [
        # (label, B, N, M, C, misaligned)
        ("B1", 1, 8192, 1024, 128, False),
        ("B17", 17, 8192, 1024, 128, False),
        ("N 1", 2, 1, 5, 7, False),
        ("ragged N, C 5", 3, 301, 17, 5, False),
        ("M 1, C 3", 2, 300, 1, 3, False),
        ("M 2, C 1", 2, 300, 2, 1, False),
        ("M 3, C 130", 2, 777, 3, 130, False),
        ("C 512", 2, 1000, 64, 512, False),
        ("C 4", 2, 500, 40, 4, False),
        ("misaligned, C 5", 2, 500, 40, 5, True),
        ("misaligned, C 128", 2, 500, 40, 128, True),
        ("M 33,024", 2, 2000, 33_024, 64, False),
    ]
    labels, seen = [], set()
    for label, b, n, m, c, misaligned in cases:
        xyz1, xyz2 = cloud(b, n), cloud(b, m)
        dist, idx = ops.three_nn(xyz1, xyz2)
        w = plain.interpolation_weights(dist)
        p2, g = floats((b, m, c), misaligned), floats((b, n, c), misaligned)
        fp = interp_kernels.plan(b, n, m, c, not misaligned)
        bp = interp_kernels.backward_plan(b, n, m, c, not misaligned)
        csr = bp.csr.variant
        seen |= {("fwd", fp.vector, fp.lanes >= 4), ("csr", csr),
                 ("bwd", bp.vector, bp.col_blocks > 1), ("ahead", bp.ahead)}
        label = (f"{label} (B{b} N{n} M{m} C{c}: fwd {'float4' if fp.vector else 'float'} "
                 f"L{fp.lanes}; bwd {csr} CSR, {'float4' if bp.vector else 'float'} L{bp.lanes} "
                 f"x{bp.col_blocks} blocks, {bp.ahead} ahead)")
        check_equal(f"three_interpolate {label}", interp_kernels.three_interpolate(p2, idx, w),
                    plain.three_interpolate(p2, idx, w))
        check_interpolate_bwd(label, g, idx, w, p2)
        labels.append(label)
    torch.cuda.synchronize()
    want = {("fwd", v, s) for v in (True, False) for s in (True, False)}
    want |= {("csr", k) for k in ("fused", "chunked", "tiled")}
    want |= {("bwd", v, y) for v in (True, False) for y in (True, False)}
    want |= {("ahead", a) for a in (interp_kernels.CONSUME_SMALL[0],
                                    interp_kernels.CONSUME_LARGE[0])}
    if want != seen:
        raise AssertionError(f"interpolation edge shapes missed plan variants {want - seen}")
    return labels


def gather_bwd_work(g, n: int):
    """(bytes, f32 operations) of the gather backward: g and idx read once,
    dP written; one add per element of g.  The CSR the kernel builds is
    scratch and does not count."""
    b, m, k, c = g.shape
    return b * m * k * c * 4 + b * m * k * 4 + b * n * c * 4, float(b * m * k * c)


def index_add_call(g, idx, n: int):
    """The single PyTorch call computing the gather backward:
    ``zeros().index_add_`` over the flattened rows."""
    b, m, k, c = g.shape
    rows = (idx.long().reshape(b, m * k)
            + torch.arange(b, device=g.device)[:, None] * n).reshape(-1)
    flat_g = g.reshape(-1, c)
    return lambda: torch.zeros(b * n, c, device=g.device).index_add_(0, rows, flat_g)


def phase_kernels_bwd(dev, geom: dict, reps: int) -> dict:
    """The two backward kernels against their plain versions at SA2-4 /
    FP1-4 and a large N, and the gather backward at edge shapes; times at
    every level, headline SA2 and FP4."""
    rng = torch.Generator(device=dev).manual_seed(7)
    rep = {k: {"max_abs_err": 0.0, "levels": {}, "device_fns": {}} for k in BACKWARD_KERNELS}

    def err(name, e):
        rep[name]["max_abs_err"] = max(rep[name]["max_abs_err"], e)

    def gather_case(label, idx, n, c):
        """Bit for bit against the CPU and call to call; timed beside its
        bound and ``index_add_``."""
        b, m, k = idx.shape
        g = torch.randn(b, m, k, c, device=dev, generator=rng)
        check_gather_bwd(label, g, idx, n)
        r = rep["group_gather_bwd"]
        fn = lambda: gather_kernels.group_point_backward(g, idx, n)  # noqa: E731
        lib = index_add_call(g, idx, n)
        check_close(f"group_gather_bwd library {label}", lib().reshape(b, n, c),
                    plain.group_point_backward(g, idx, n), BWD_TOL)
        r["levels"][label] = time_ms(fn, reps)
        r["device_fns"][label] = fn
        r.setdefault("level_bound", {})[label] = bound(*gather_bwd_work(g, n))
        r.setdefault("library_levels", {})[label] = time_ms(lib, reps)
        r.setdefault("library_fns", {})[label] = lib
        return g

    def interp_case(label, idx, w, p2, timed):
        g = torch.randn(idx.shape[0], idx.shape[1], p2.shape[-1], device=dev, generator=rng)
        err("three_interpolate_bwd", check_interpolate_bwd(label, g, idx, w, p2))
        if timed:
            r = rep["three_interpolate_bwd"]
            fn = lambda: interp_kernels.three_interpolate_backward(g, idx, w, p2)  # noqa: E731
            dp_fn = lambda: interp_kernels.three_interpolate_backward(  # noqa: E731
                g, idx, w, p2, need_dw=False)
            r["levels"][label] = time_ms(fn, reps)
            r["device_fns"][label] = fn
            r.setdefault("level_bound", {})[label] = bound(*interpolate_bwd_work(p2, idx, True))
            r.setdefault("dp_levels", {})[label] = time_ms(dp_fn, reps)
            r.setdefault("dp_fns", {})[label] = dp_fn
            r.setdefault("dp_level_bound", {})[label] = bound(
                *interpolate_bwd_work(p2, idx, False))
        return g

    heads = {}
    for label, idx, n, c in geom["sa"][1:]:  # SA1's input carries no gradient
        g = gather_case(label, idx, n, c)
        if label == "SA2":
            heads["gather"] = (g, idx, n)
    for label, idx, w, p2 in geom["fp"]:
        g = interp_case(label, idx, w, p2, True)
        if label == "FP4":
            heads["interp"] = (g, idx, w, p2)
    log("[kernels-bwd] SA2-4 gather backward: dP equal to the plain version on CPU copies and "
        "from call to call, the CSR equal to plain.transpose_csr; FP1-4 interpolation "
        "backward: dP equal to the plain version on CPU copies and from call to call (also "
        f"without dw), dw within {BWD_TOL} and equal from call to call, the CSR equal to "
        "plain.interpolation_csr")

    # Large N: 33,024 rows scattered into, and interpolated from.
    big = geom["large"]
    n_big = big.shape[1]
    big_idx = torch.randint(0, n_big, (2, 4096, 32), device=dev, dtype=torch.int32,
                            generator=rng)
    gather_case("large N", big_idx, n_big, 64)
    known = big[:, :1024].contiguous()
    dist, nidx = ops.three_nn(big, known)
    big_w = plain.interpolation_weights(dist)
    big_p = torch.randn(2, 1024, 128, device=dev, generator=rng)
    check_equal("three_interpolate large N", ops.three_interpolate(big_p, nidx, big_w),
                plain.three_interpolate(big_p, nidx, big_w))
    interp_case("large N", nidx, big_w, big_p, False)
    torch.cuda.synchronize()
    log(f"[kernels-bwd] large N={n_big}: gather backward (2 x 4096 x 32 rows, C64) equal to "
        f"the CPU and reproducible; interpolation (M1024, C128) equal, its backward's dP equal "
        f"to the CPU, dw within {BWD_TOL}")
    edges = check_gather_bwd_edges(dev, np.random.RandomState(8))
    log(f"[kernels-bwd] gather backward equal to the CPU, reproducible and its CSR equal at "
        f"{len(edges)} edge shapes covering every plan variant: " + "; ".join(edges))

    # Gather backward at SA2: bytes of g, idx and dP; one add per g element.
    g, idx, n = heads["gather"]
    b, m, k, c = g.shape
    r = rep["group_gather_bwd"]
    r.update(ms=r["levels"]["SA2"], headline="SA2",
             plain_ms=time_ms(lambda: plain.group_point_backward(g, idx, n), reps),
             library_ms=r["library_levels"]["SA2"], library_fn=r["library_fns"]["SA2"],
             library_call="zeros().index_add_(rows)", shape=f"B{b} N{n} M{m} ns{k} C{c}")
    r["bound_ms"], r["bound_by"] = r["level_bound"]["SA2"]

    # Interpolation backward at FP4: g, idx, w and P read, dP and dw written.
    g, idx, w, p2 = heads["interp"]
    b, fn_, fc = g.shape
    fm = p2.shape[1]
    gidx = (idx.long() + torch.arange(b, device=dev)[:, None, None] * fm).reshape(-1, 3)
    table = p2.reshape(-1, fc).detach().requires_grad_()
    bw = w.reshape(-1, 3).detach().requires_grad_()
    out = torch.nn.functional.embedding_bag(gidx, table, mode="sum", per_sample_weights=bw)
    flat_out_g = g.reshape(-1, fc)

    def embedding_bag_backward():
        return torch.autograd.grad(out, (table, bw), flat_out_g, retain_graph=True)

    ldp, ldw = embedding_bag_backward()
    pdp, pdw = plain.three_interpolate_backward(g, idx, w, p2)
    check_close("three_interpolate_bwd library dP", ldp.reshape(b, fm, fc), pdp, BWD_TOL)
    check_close("three_interpolate_bwd library dw", ldw.reshape(b, fn_, 3), pdw, BWD_TOL)
    rep["three_interpolate_bwd"].update(
        ms=rep["three_interpolate_bwd"]["levels"]["FP4"],
        headline="FP4",
        plain_ms=time_ms(lambda: plain.three_interpolate_backward(g, idx, w, p2), reps),
        library_ms=time_ms(embedding_bag_backward, reps),
        library_fn=embedding_bag_backward,
        library_call="embedding_bag(mode='sum', per_sample_weights) backward",
        shape=f"B{b} N{fn_} M{fm} C{fc} (dP and dw)")
    rep["three_interpolate_bwd"]["bound_ms"], rep["three_interpolate_bwd"]["bound_by"] = \
        rep["three_interpolate_bwd"]["level_bound"]["FP4"]
    torch.cuda.synchronize()
    return rep


def phase_device_times(rep: dict) -> None:
    """Device-only time of every kernel at every timed level, and of each
    library call, from the profiler (``device_ms``).  Run after the timed
    phases: a process that has run the profiler may launch more slowly
    afterwards (PERF.md, Findings), and no wall time may carry that."""
    for r in rep.values():
        r["level_device"] = {label: device_ms(fn) for label, fn in r.pop("device_fns").items()}
        if "dp_fns" in r:  # the interpolation backward without dw
            r["dp_level_device"] = {label: device_ms(fn) for label, fn in r.pop("dp_fns").items()}
        if "library_fns" in r:  # the gather backward's index_add_ at every level
            r["library_level_device"] = {label: device_ms(fn)
                                         for label, fn in r.pop("library_fns").items()}
        r["device_ms"] = r["level_device"][r.pop("headline")]
        lib = r.pop("library_fn")
        r["library_device_ms"] = None if lib is None else device_ms(lib)
    torch.cuda.synchronize()
    log("[device-times] device-only times of all kernels and library calls from the profiler")


def _capture_levels(model):
    levels = {}
    hooks = []
    for i in range(4):
        def hook(mod, args, out, i=i):
            levels[i] = (out[0].detach().cpu(), out[2].detach().cpu())
        hooks.append(getattr(model, f"sa{i + 1}").register_forward_hook(hook))
    return levels, hooks


def phase_model(dev, n: int, name: str = "sem_seg_features", tag: str = "model",
                **kwargs) -> torch.nn.Module:
    """Full-width registry model ``name`` (``kwargs`` to ``seeded_model``),
    B2 x n eval forward on the card and on the CPU: indices equal at every
    level, logits within LOGIT_TOL.  Fed colors and normals where the model
    takes them, else xyz only.  Returns the card's model."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = models.seeded_model(name, seed=0, device="cpu", **kwargs)
    dev_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.RandomState(1)
    pts = torch.from_numpy((rng.rand(2, n, 3) * EXTENT).astype(np.float32))
    feats = (torch.from_numpy(rng.rand(2, n, 6).astype(np.float32))
             if cpu_model.in_features else None)
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    dev_levels, h1 = _capture_levels(dev_model)
    cpu_levels, h2 = _capture_levels(cpu_model)
    t0 = time.perf_counter()
    got = seg_predict_step(dev_model, pts.to(dev), None if feats is None else feats.to(dev)).cpu()
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = seg_predict_step(cpu_model, pts, feats)
    t_cpu = time.perf_counter() - t0
    for h in h1 + h2:
        h.remove()
    for i in range(4):
        check_equal(f"{tag} SA{i + 1} centres", dev_levels[i][0], cpu_levels[i][0])
        check_equal(f"{tag} SA{i + 1} ball_query", dev_levels[i][1], cpu_levels[i][1])
    xyzs = [pts] + [cpu_levels[i][0] for i in range(4)]
    for i in range(4):
        lvl = 3 - i
        _, di = ops.three_nn(xyzs[lvl].to(dev), xyzs[lvl + 1].to(dev))
        check_equal(f"{tag} FP{i + 1} three_nn", di, plain.three_nn(xyzs[lvl], xyzs[lvl + 1])[1])
    if got.shape != (2, n, 21) or not torch.isfinite(got).all():
        raise AssertionError(f"{tag} logits bad: shape {tuple(got.shape)}")
    e = check_close(f"{tag} logits", got, want, LOGIT_TOL)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[{tag}] {name}{kwargs or ''} full width, B2 x {n}, "
        f"{'colors and normals' if feats is not None else 'xyz only'}: indices equal at "
        f"SA1-4/FP1-4; logits max |card - cpu| = {e:.3e} (tol {LOGIT_TOL}); argmax agreement "
        f"{agree:.6f}; first forward card {t_dev:.2f} s (incl. warm-up), cpu {t_cpu:.2f} s")
    return dev_model


def phase_serve(model, dev, scene_points: int, n_scenes: int, npoints: int,
                batch: int) -> dict:
    predict = make_predict_fn(model, device=dev)
    scenes = [make_synthetic_scene(scene_points, seed=100 + s) for s in range(n_scenes + 1)]
    # Warm-up scene: first launches, allocator growth.
    predict_scene_chunks(predict, scene_chunks(scenes[0], npoints, seed=0), True, True, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    n_chunks = n_points = 0
    served = []
    for scene in scenes[1:]:
        chunks = scene_chunks(scene, npoints, seed=0)
        labels = predict_scene_chunks(predict, chunks, True, True, batch)
        n_chunks += len(chunks["points"])
        n_points += len(labels)
        served.append((scene, chunks, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve phase never launched {missing}")
    if any(launches[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"serving launched backward kernels: {launches}")
    for scene, _, labels in served:
        if labels.shape != (len(scene["points"]),) or labels.min() < 0 or labels.max() >= 21:
            raise AssertionError("served labels have the wrong shape or range")
    # The first two chunks of the first served scene, against the plain CPU path.
    _, chunks, _ = served[0]
    feats = np.concatenate([chunks["colors"][:2] / np.float32(255.0), chunks["normals"][:2]],
                           -1).astype(np.float32)
    got = predict(chunks["points"][:2], feats)
    cpu_model = copy.deepcopy(model).cpu()
    want = make_predict_fn(cpu_model, device="cpu")(chunks["points"][:2], feats)
    agree = float((got == want).mean())
    if agree < 0.999:
        raise AssertionError(f"served chunk labels agree with the CPU path on only {agree:.4%}")
    res = dict(scenes=len(served), chunks=n_chunks, points=n_points, wall_s=wall,
               points_per_s=n_points / wall, chunks_per_s=n_chunks / wall,
               peak_bytes=peak, launches=launches, cpu_agreement=agree)
    log(f"[serve] {res['scenes']} scenes, {n_chunks} chunks of {npoints}, {n_points} points "
        f"served in {wall:.3f} s after one warm-up scene: {res['points_per_s']:.0f} points/s, "
        f"{res['chunks_per_s']:.1f} chunks/s; max_memory_allocated {peak / 2**20:.1f} MiB; "
        f"labels of 2 chunks agree with the CPU path on {agree:.4%}")
    log(f"[serve] launches in the serve window: {json.dumps(launches)}")
    return res


def _forward_inputs(model, dev, batch: int, n: int):
    """Seeded points (and colors and normals, where the model takes them)."""
    rng = np.random.RandomState(2)
    pts = torch.from_numpy((rng.rand(batch, n, 3) * EXTENT).astype(np.float32)).to(dev)
    feats = (torch.from_numpy(rng.rand(batch, n, 6).astype(np.float32)).to(dev)
             if model.in_features else None)
    return pts, feats


def phase_forward_time(model, dev, batch: int, n: int, reps: int, tag: str = "forward") -> dict:
    """Wall time (``time_ms``) of the B x n eval forward, and the peak memory
    it allocates."""
    pts, feats = _forward_inputs(model, dev, batch, n)
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = time_ms(lambda: seg_predict_step(model, pts, feats), reps)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] B{batch} x {n} eval forward: {ms:.3f} ms median of {reps}; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above "
        f"the weights and inputs)")
    return dict(ms=ms, peak_bytes=peak, peak_above_inputs_bytes=peak - base)


def phase_forward_device(model, dev, batch: int, n: int) -> float:
    """Device-only time of one B16 x 8192 eval forward (``device_ms``)."""
    pts, feats = _forward_inputs(model, dev, batch, n)
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    ms = device_ms(lambda: seg_predict_step(model, pts, feats), calls=5)
    log(f"[device-times] B{batch} x {n} eval forward: {ms:.3f} ms of device time")
    return ms


@contextlib.contextmanager
def plain_ops():
    """Route the model's geometry ops to the plain PyTorch versions, on any
    device, for as long as the context lasts.  Used only to hold the
    kernels' autograd path against the plain one on the card."""
    swap = {
        "farthest_point_sample": plain.farthest_point_sample,
        "ball_query": plain.ball_query,
        "group_point_with_counts": lambda points, idx, cnt=None: plain.group_point(points, idx),
        "three_nn": plain.three_nn,
        "three_interpolate": plain.three_interpolate,
    }
    saved = {name: getattr(ops, name) for name in swap}
    for name, fn in swap.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _for_model(batch: dict, model) -> dict:
    """The batch as ``model`` takes it: without its colors and normals where
    the model is fed xyz only."""
    return batch if model.in_features else {k: v for k, v in batch.items() if k != "features"}


def _train_batch(scenes, rng: np.random.RandomState, batch: int, npoints: int) -> dict:
    """One training batch: random chunks of random rooms, stacked by
    ``make_batch`` (f32 wire, colors and normals)."""
    chunks = []
    for _ in range(batch):
        sc = scenes[rng.randint(len(scenes))]
        p, lab, col, nrm, w = sample_random_chunk(sc["points"], sc["labels"], sc["colors"],
                                                  sc["normals"], npoints, rng)
        chunks.append({"points": p, "labels": lab, "colors": col, "normals": nrm, "weights": w})
    return make_batch(chunks, True, True, "f32")


def _noise_biases(model) -> set:
    """Biases whose exact gradient is 0, so that what either device computes
    for them is rounding noise: those of convolutions feeding a train-mode
    BN, and the affine bias of an attention pooling's BN (a constant shift
    of a channel that reaches the loss only through convolutions followed
    by a train-mode BN)."""
    return {name + ".bias" for name, mod in model.named_modules()
            if (isinstance(mod, PointConv) and mod.bn is not None)
            or name.endswith("attention_bn")}


def _one_step(model, batch: dict):
    """(loss, gradients, BN statistics) of one ``seg_train_step``, on the CPU."""
    _, m = seg_train_step(TrainState(model), batch)
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in model.named_buffers()}
    return float(m["loss"]), grads, stats


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase_train_parity(dev, scenes, n: int, name: str = "sem_seg_features",
                       tag: str = "train-parity") -> dict:
    """One full-width training step of registry model ``name``, B2 x n (xyz
    only where the model takes no features), TF32 and dropout off, from the
    same seeded weights and batch:

    - card (kernels) vs CPU (plain ops): FPS, ball-query and three-NN indices
      equal at every level; loss within rtol 1e-4; BN running statistics
      within rtol 1e-4 (atol 1e-5, for means near 0), or, for a tensor with an
      element outside that (a mean of terms that cancel to near 0: one at
      SA4's attention BN, 1.35e-5 from the CPU, on an H100), no farther from
      the float64 run in relative L2 than twice the CPU's distance, as the
      gradients below; such tensors are logged.  Gradients: a ReLU and
      max-pool network's gradient is discontinuous in its forward values, so
      two float32 forwards that differ by rounding route some of it
      differently (measured on the CPU at B1 x 2048: the float32 gradients
      are up to 2.8e-3 from float64 in relative L2, while reordering the
      backward's sums alone moves them by 2e-6).  So every gradient tensor is
      held to: its relative L2 distance from a float64 CPU run is at most
      twice the largest such distance of the float32 CPU run (+1e-6).
    - card (kernels) vs card (plain ops): the forwards are the same
      computation bit for bit, so only the backward kernels' summation order
      differs: every gradient within rtol 1e-3, atol 1e-5 x max|g| of its
      tensor; the biases with an exact gradient of 0 below 1e-5 x the
      largest gradient on both sides.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = models.seeded_model(name, seed=0, device="cpu", dropout_rate=0.0)
    batch = _for_model(_train_batch(scenes, np.random.RandomState(3), 2, n), base)
    card, on_plain, ref64 = (copy.deepcopy(base).to(dev), copy.deepcopy(base).to(dev),
                             copy.deepcopy(base).double())
    card_levels, h1 = _capture_levels(card)
    cpu_levels, h2 = _capture_levels(base)
    t0 = time.perf_counter()
    loss_card, g_card, bn_card = _one_step(card, batch)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu, g_cpu, bn_cpu = _one_step(base, batch)
    t_cpu = time.perf_counter() - t0
    for h in h1 + h2:
        h.remove()
    with plain_ops():
        loss_plain, g_plain, _ = _one_step(on_plain, batch)
    t0 = time.perf_counter()
    ref64.train()
    logits = ref64(torch.from_numpy(batch["points"]).double(),
                   torch.from_numpy(batch["features"]).double() if "features" in batch else None,
                   bn_momentum=schedules.scannet_bn_momentum(0))  # the first step's, as above
    bn64 = {k: v.detach() for k, v in ref64.named_buffers()}
    w = torch.from_numpy(batch["weights"]).double()
    ce = losses.softmax_cross_entropy(logits, torch.from_numpy(batch["labels"]))
    ((ce * w).sum() / (w != 0).sum().clamp_min(1)).backward()
    g64 = {k: p.grad.detach() for k, p in ref64.named_parameters()}
    t_64 = time.perf_counter() - t0

    pts = torch.from_numpy(batch["points"])
    xyzs = [pts] + [cpu_levels[i][0] for i in range(4)]
    for i in range(4):
        check_equal(f"{tag} SA{i + 1} centres", card_levels[i][0], cpu_levels[i][0])
        check_equal(f"{tag} SA{i + 1} ball_query", card_levels[i][1], cpu_levels[i][1])
        lvl = 3 - i
        _, di = ops.three_nn(xyzs[lvl].to(dev), xyzs[lvl + 1].to(dev))
        check_equal(f"{tag} FP{i + 1} three_nn", di, plain.three_nn(xyzs[lvl], xyzs[lvl + 1])[1])
    if not np.isfinite(loss_card):
        raise AssertionError(f"{tag} loss not finite: {loss_card}")
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-4, err_msg=f"{tag} loss")
    np.testing.assert_allclose(loss_card, loss_plain, rtol=1e-6, err_msg=f"{tag} card plain loss")
    bn_by_f64 = {}
    for k in bn_cpu:
        if torch.isclose(bn_card[k], bn_cpu[k], rtol=1e-4, atol=1e-5).all():
            continue
        d_card = _rel_l2(bn_card[k].double(), bn64[k])
        d_cpu = _rel_l2(bn_cpu[k].double(), bn64[k])
        if d_card > 2.0 * d_cpu + 1e-6:
            check_close(f"{tag} BN {k}", bn_card[k], bn_cpu[k], dict(rtol=1e-4, atol=1e-5))
            raise AssertionError(f"{tag} BN {k}: rel L2 from float64 {d_card:.3e} > 2 x the "
                                 f"CPU's {d_cpu:.3e}")
        bn_by_f64[k] = dict(card_rel_l2=d_card, cpu_rel_l2=d_cpu,
                            max_abs_card_cpu=float((bn_card[k] - bn_cpu[k]).abs().max()))
    if bn_by_f64:
        log(f"[{tag}] BN statistics held to float64 (rel L2, card <= 2 x cpu + 1e-6): "
            f"{json.dumps(bn_by_f64)}")

    noise = _noise_biases(base)
    real = [k for k in g_cpu if k not in noise]
    g_max = max(float(g_cpu[k].abs().max()) for k in real)
    cpu_err = {k: _rel_l2(g_cpu[k], g64[k]) for k in real}
    card_err = {k: _rel_l2(g_card[k], g64[k]) for k in real}
    limit = 2.0 * max(cpu_err.values()) + 1e-6
    bad = {k: v for k, v in card_err.items() if v > limit}
    if bad:
        raise AssertionError(f"{tag}: card gradients farther from float64 than {limit:.3e}: {bad}")
    kernel_err = 0.0
    for k, g in g_card.items():
        if k in noise:
            if max(float(g.abs().max()), float(g_plain[k].abs().max())) >= 1e-5 * g_max:
                raise AssertionError(f"{tag}: gradient of {k} (exactly 0) is not noise-sized")
            continue
        scale = float(g_plain[k].abs().max())
        check_close(f"{tag} card kernels vs card plain grad {k}", g, g_plain[k],
                    dict(rtol=1e-3, atol=1e-5 * scale))
        kernel_err = max(kernel_err, float((g - g_plain[k]).abs().max()) / max(scale, 1e-30))
    res = dict(loss_card=loss_card, loss_cpu=loss_cpu, loss_card_plain=loss_plain,
               grad_rel_l2_card_vs_f64_max=max(card_err.values()),
               grad_rel_l2_cpu_vs_f64_max=max(cpu_err.values()),
               grad_rel_l2_card_vs_cpu_max=max(_rel_l2(g_card[k], g_cpu[k]) for k in real),
               grad_max_err_kernels_vs_plain_on_card=kernel_err, bn_held_to_f64=bn_by_f64,
               first_step_card_s=t_card, step_cpu_s=t_cpu, f64_cpu_s=t_64)
    log(f"[{tag}] {name} full width B2 x {n}, "
        f"{'colors and normals' if 'features' in batch else 'xyz only'}, TF32 and dropout off: "
        f"indices equal at "
        f"SA1-4/FP1-4; loss card {loss_card:.7f} cpu {loss_cpu:.7f} card-plain {loss_plain:.7f}; "
        f"BN statistics within rtol 1e-4 ({len(bn_by_f64)} held to float64 instead); "
        f"gradients rel-L2 from float64: card max "
        f"{res['grad_rel_l2_card_vs_f64_max']:.3e}, cpu max {res['grad_rel_l2_cpu_vs_f64_max']:.3e}"
        f" (card vs cpu max {res['grad_rel_l2_card_vs_cpu_max']:.3e}); card kernels vs card "
        f"plain max |dg|/max|g| {kernel_err:.3e}; first step card {t_card:.2f} s, cpu "
        f"{t_cpu:.2f} s, f64 {t_64:.2f} s")
    return res


def train_batches(scenes, batch: int, npoints: int, count: int):
    """``count`` training batches of random chunks, made on the host, and
    the seconds that took."""
    rng = np.random.RandomState(11)
    t0 = time.perf_counter()
    batches = [_train_batch(scenes, rng, batch, npoints) for _ in range(count)]
    return batches, time.perf_counter() - t0


def phase_train(dev, batches, steps: int, warmup: int, name: str = "sem_seg_features",
                tag: str = "train") -> dict:
    """``steps`` timed training steps of registry model ``name`` on fresh
    batches (xyz only where the model takes no features), after ``warmup``
    steps, then five steps on one batch.  Launch counters cover the timed
    steps only: all seven kernels must launch there."""
    model = models.seeded_model(name, seed=0, device=dev)
    batches = [_for_model(b, model) for b in batches[:warmup + steps]]
    state = TrainState(model)
    for b in batches[:warmup]:
        seg_train_step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    events, step_losses = [], []
    t0 = time.perf_counter()
    for b in batches[warmup:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = seg_train_step(state, b)
        end.record()
        events.append((start, end))
        step_losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in KERNEL_INFO if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag} phase never launched {missing}")
    step_ms = [s.elapsed_time(e) for s, e in events]
    step_losses = [float(v) for v in step_losses]
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"{tag}: non-finite training loss: {step_losses}")
    fixed = batches[warmup]
    repeat = [float(seg_train_step(state, fixed)[1]["loss"]) for _ in range(5)]
    if not min(repeat[1:]) < repeat[0]:
        raise AssertionError(f"{tag}: five steps on one batch did not lower its loss: {repeat}")
    med = float(np.median(step_ms))
    batch, npoints = fixed["points"].shape[:2]
    res = dict(model=name, batch=batch, npoints=npoints, steps=steps, step_ms_median=med,
               step_ms=step_ms, points_per_s=batch * npoints / (med / 1e3),
               wall_s=wall, peak_bytes=peak, launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()},
               losses=step_losses, repeat_losses=repeat)
    log(f"[{tag}] {name} B{batch} x {npoints}, "
        f"{'colors and normals' if 'features' in fixed else 'xyz only'}, {steps} steps after "
        f"{warmup} warm-up: median step {med:.3f} ms ({res['points_per_s']:.0f} points/s), wall "
        f"{wall:.3f} s; max_memory_allocated {peak / 2**20:.1f} MiB; losses "
        f"{step_losses[0]:.3f} .. {step_losses[-1]:.3f}, all finite; one batch x5: "
        f"{' '.join(f'{v:.3f}' for v in repeat)}")
    log(f"[{tag}] launches in the {tag} window: {json.dumps(launches)}")
    return res

# ---- the trainer entry point, end to end -------------------------------------------

TRAINER_RUNS = (("npz", dict(input="npz")),
                ("packed_q16", dict(input="packed", wire_format="packed_q16")))


@contextlib.contextmanager
def timed_train_steps(events: list, host_ms: list):
    """CUDA events around every ``seg_train_step`` that ``trainer.train``
    calls, appended to ``events``, and the host milliseconds each call took
    to queue its work, appended to ``host_ms`` (no host sync is added)."""
    inner = train_steps.seg_train_step

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        return out

    train_steps.seg_train_step = timed
    try:
        yield
    finally:
        train_steps.seg_train_step = inner


def nyu40_miou(preds, gts) -> float:
    """The benchmark's mean IoU computed from in-memory [0, 20] labels in
    NYU40 space: predictions mapped as the txt export maps them, ground
    truth with unannotated points left out."""
    valid = benchmark.VALID_CLASS_IDS
    conf = np.zeros((41, 41), np.int64)
    for pred, gt in zip(preds, gts):
        g = map_to_nyu40(gt)
        p = benchmark.map_to_nyu40_for_benchmark(pred)
        keep = np.isin(g, valid)
        np.add.at(conf, (g[keep], p[keep]), 1)
    ious = []
    for c in valid:
        tp = conf[c, c]
        denom = conf[c].sum() + conf[valid, c].sum() - tp
        if denom:
            ious.append(tp / denom)
    return float(np.mean(ious))


def _check_restores(dev, cfg: TrainConfig, tag: str, best) -> None:
    """The best checkpoint exists and restores bit for bit into a fresh
    ``make_eval_state``."""
    if best is None:
        raise AssertionError(f"trainer {tag}: no best_* checkpoint in {cfg.ckpt_dir}")
    fresh = trainer.make_eval_state(cfg, device=dev)
    restore_checkpoint(best, fresh)
    with np.load(best) as z:
        saved = {k: z[k] for k in z.files}
    again = export_jax_state(fresh)
    if sorted(again) != sorted(saved) or any(
            again[k].dtype != saved[k].dtype or again[k].tobytes() != saved[k].tobytes()
            for k in saved):
        raise AssertionError(f"trainer {tag}: {best} does not restore bit for bit")


def _train_run(dev, cfg: TrainConfig, tag: str, expect_steps: int) -> dict:
    """One ``trainer.train`` run on the card, its launch counters zeroed just
    before and read just after; every kernel must launch, every logged loss
    be finite, the step count be ``expect_steps``, and, where it validated,
    the best checkpoint restore bit for bit into a fresh ``make_eval_state``."""
    events: list = []
    host_ms: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with timed_train_steps(events, host_ms):
        summary = trainer.train(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in KERNEL_INFO if launches[k] == 0]
    if missing:
        raise AssertionError(f"trainer {tag}: never launched {missing}")
    if summary["final_step"] != expect_steps:
        raise AssertionError(f"trainer {tag}: final_step {summary['final_step']} != "
                             f"{expect_steps}")
    records = read_metrics(os.path.join(cfg.log_dir, "train_metrics.jsonl"))
    epochs = [r for r in records if "train_loss" in r]
    vals = [r for r in records if "val_miou" in r]
    losses_ = [r["train_loss"] for r in epochs] + [r["val_loss"] for r in vals]
    if (len(epochs) != cfg.epochs or len(vals) != cfg.epochs // cfg.n_epochs_to_val
            or not np.all(np.isfinite(losses_))):
        raise AssertionError(f"trainer {tag}: logged {len(epochs)} epochs, {len(vals)} "
                             f"validations, losses {losses_}")
    best = best_checkpoint(cfg.ckpt_dir, "best")
    if vals:
        _check_restores(dev, cfg, tag, best)
    step_ms = [a.elapsed_time(b) for a, b in events]
    res = dict(
        input=tag, wall_s=wall, summary=summary, launches=launches,
        launches_per_step={k: v / expect_steps for k, v in launches.items()},
        step_ms=step_ms, step_ms_median=float(np.median(step_ms)),
        step_host_ms=host_ms, step_host_ms_median=float(np.median(host_ms)), peak_bytes=peak,
        points_per_s=[r["points_per_sec"] for r in epochs],
        epoch_s=[r["epoch_s"] for r in epochs],
        input_wait_share=[r["input_wait_s"] / r["epoch_s"] for r in epochs],
        train_loss=[r["train_loss"] for r in epochs],
        val_miou=[r["val_miou"] for r in vals], val_loss=[r["val_loss"] for r in vals],
        best_checkpoint=best and os.path.basename(best))
    log(f"[trainer] {tag}: {summary['final_step']} steps, {cfg.epochs} epochs, "
        f"{len(vals)} validations, "
        f"{wall:.2f} s wall; points/s per epoch (the trainer's, host pipeline included) "
        f"{' '.join(f'{v:.0f}' for v in res['points_per_s'])}; median step "
        f"{res['step_ms_median']:.3f} ms (CUDA events), its host call "
        f"{res['step_host_ms_median']:.3f} ms; waiting on the next batch "
        f"{' '.join(f'{v:.3f}' for v in res['input_wait_share'])} of each epoch; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB; train loss "
        f"{' '.join(f'{v:.3f}' for v in res['train_loss'])}, val mIoU "
        f"{' '.join(f'{v:.4f}' for v in res['val_miou'])}"
        + (f"; {os.path.basename(best)} restores bit for bit" if vals else ""))
    log(f"[trainer] {tag}: launches in the trainer window: {json.dumps(launches)}")
    return res


def host_batch_ms(pre: str, names, batch: int, npoints: int, count: int = 8) -> dict:
    """Host milliseconds a batch of the two replays, run alone on the main
    thread: loading ``batch`` npz chunks, ``make_batch`` of them (f32), and
    one batch of the q16 pack store (its copy out of the memory map)."""
    replay = precompute.replay_train_chunks(pre, 2, names, shuffle_seed=0)
    t_load = t_make = 0.0
    for _ in range(count):
        t0 = time.perf_counter()
        chunks = [next(replay) for _ in range(batch)]
        t1 = time.perf_counter()
        make_batch(chunks, True, True, "f32")
        t_load, t_make = t_load + t1 - t0, t_make + time.perf_counter() - t1
    reader = packstore.PackReader(os.path.join(pre, f"pack_q16_c1n1_p{npoints}"))
    rows = reader.replay_batches(batch, shuffle_seed=0)
    t0 = time.perf_counter()
    for _ in range(count):
        next(rows)
    t_pack = time.perf_counter() - t0
    return dict(npz_load=t_load * 1e3 / count, npz_make_batch=t_make * 1e3 / count,
                pack_q16=t_pack * 1e3 / count)


def _serve(model, dev, root, names, out_dir, npoints: int, batch: int, spec=None):
    """``generate_predictions`` over ``names``: per-scene labels, ground
    truth, the txt files and points/s."""
    predict = make_predict_fn(model, device=dev, wire_spec=spec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(generate_predictions(predict, root, names, out_dir, npoints=npoints,
                                        batch_size=batch, wire_spec=spec))
    wall = time.perf_counter() - t0
    n = sum(len(r["predictions"]) for r in results)
    return results, dict(points=n, wall_s=wall, points_per_s=n / wall)


def phase_trainer(dev, n_train: int = 32, n_val: int = 2, scene_points: int = 150_000,
                  epochs: int = 3, batch: int = 16, npoints: int = 8192,
                  cpu_crop: float = 2.0, steady_epochs: int = 10) -> dict:
    """The port's workflow through its entry points, at full width:

    - a synthetic store (``write_synthetic_dataset``: ``n_train`` + ``n_val``
      rooms of ``scene_points``), ``precompute_cli`` for two train epochs
      and the val set, and the q16 pack store, all timed;
    - ``trainer.train`` (``sem_seg_features``, B16 x 8192, f32, TF32 off,
      validation every epoch) twice, ``input='npz'`` and
      ``input='packed'`` with ``wire_format='packed_q16'`` (``_train_run``);
      then both again for ``steady_epochs`` epochs without validation, the
      rate once the prefetch queue has drained;
    - from the npz run's best checkpoint, ``generate_predictions`` over the
      val rooms as f32 arrays, packed f32 and packed q16 rows.  Packed-f32
      labels must equal the f32 path fed the values the record carries
      (normals through f16) vertex for vertex; their agreement with the
      plain f32 path and q16's are reported.  The ground truth exported with
      ``export_ids`` and ``benchmark.evaluate`` over the f32 txt files:
      ``mean_iou`` equal to ``nyu40_miou`` of the in-memory labels;
    - the part of one val room with x < ``cpu_crop`` m predicted on the card
      and on the CPU from the same checkpoint: >= 99.9 % of labels agree."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix=".trainer_smoke_", dir=ROOT)
    try:
        root, pre = os.path.join(work, "scannet"), os.path.join(work, "chunks")
        secs = {}
        t0 = time.perf_counter()
        splits = write_synthetic_dataset(root, n_train=n_train, n_val=n_val,
                                         n_points=scene_points, seed=300)
        secs["write_dataset"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        precompute_cli.main(["--data_root", root, "--out_dir", pre, "--epochs", "2",
                             "--npoints", str(npoints)])
        secs["precompute_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        precompute_cli.main(["--data_root", root, "--out_dir", pre, "--split", "val",
                             "--npoints", str(npoints)])
        secs["precompute_val"] = time.perf_counter() - t0
        q16 = WireSpec(npoints, "q16")
        t0 = time.perf_counter()
        rows = packstore.write_pack_from_npz(pre, os.path.join(pre, f"pack_q16_c1n1_p{npoints}"),
                                             2, splits["train"], q16)
        secs["pack_q16"] = time.perf_counter() - t0
        log(f"[trainer] store of {n_train} + {n_val} rooms of {scene_points} points written in "
            f"{secs['write_dataset']:.2f} s; precompute_cli: 2 train epochs "
            f"{secs['precompute_train']:.2f} s, val {secs['precompute_val']:.2f} s; q16 pack "
            f"store ({rows} rows) {secs['pack_q16']:.2f} s")

        host_ms = host_batch_ms(pre, splits["train"], batch, npoints)
        log(f"[trainer] host work a batch, alone on the main thread: npz replay "
            f"{host_ms['npz_load']:.2f} ms (16 np.load) + make_batch "
            f"{host_ms['npz_make_batch']:.2f} ms; q16 pack replay "
            f"{host_ms['pack_q16']:.2f} ms")

        base = dict(data_root=root, precompute_dir=pre, batch_size=batch, n_points=npoints,
                    epochs=epochs, n_epochs_to_val=1, save_every_epochs=1, n_devices=1)
        steps = epochs * (n_train // batch)
        runs, cfgs = {}, {}
        for tag, over in TRAINER_RUNS:
            cfgs[tag] = TrainConfig(**base, **over, log_dir=os.path.join(work, "logs_" + tag))
            runs[tag] = _train_run(dev, cfgs[tag], tag, steps)
        # The same replays past the prefetch queue's depth (4 batches, which
        # validation refills between the short epochs above): no validation,
        # no checkpoints, steady_epochs epochs.
        steady = {}
        for tag, over in TRAINER_RUNS:
            cfg = TrainConfig(**{**base, "epochs": steady_epochs, "n_epochs_to_val": 10**6,
                                 "save_every_epochs": 0}, **over,
                              log_dir=os.path.join(work, "steady_" + tag))
            steady[tag] = _train_run(dev, cfg, tag + " steady",
                                     steady_epochs * (n_train // batch))

        state = trainer.make_eval_state(cfgs["npz"], device=dev)
        restore_checkpoint(best_checkpoint(cfgs["npz"].ckpt_dir, "best"), state)
        model = state.model
        names = splits["val"]
        out = os.path.join(work, "predictions")
        f32, serve = _serve(model, dev, root, names, os.path.join(out, "f32"), npoints, batch)
        packed, serve_packed = _serve(model, dev, root, names, os.path.join(out, "packed"),
                                      npoints, batch, WireSpec(npoints, "f32"))
        quant, serve_q16 = _serve(model, dev, root, names, os.path.join(out, "q16"), npoints,
                                  batch, q16)
        predict = make_predict_fn(model, device=dev)
        agree_packed, agree_q16 = [], []
        for scene, a, b, c in zip(precompute.eval_scene_stream(root, names, npoints=npoints),
                                  f32, packed, quant):
            scene["normals"] = scene["normals"].astype(np.float16).astype(np.float32)
            same_values = predict_scene_chunks(predict, scene, True, True, batch)
            if not np.array_equal(b["predictions"], same_values):
                bad = int((b["predictions"] != same_values).sum())
                raise AssertionError(f"trainer serve: packed-f32 labels differ from the f32 "
                                     f"path on the same values at {bad} vertices")
            agree_packed.append(float((b["predictions"] == a["predictions"]).mean()))
            agree_q16.append(float((c["predictions"] == a["predictions"]).mean()))

        gt_files = []
        for r in f32:
            gt_files.append(os.path.join(out, f"{r['scene_name']}_gt.txt"))
            benchmark.export_ids(gt_files[-1], map_to_nyu40(r["labels"]))
        scores = benchmark.evaluate([os.path.join(out, "f32", f"{n}.txt") for n in names],
                                    gt_files, os.path.join(out, "results.txt"))
        direct = nyu40_miou([r["predictions"] for r in f32], [r["labels"] for r in f32])
        if not abs(scores["mean_iou"] - direct) <= 1e-12 * max(1.0, abs(direct)):
            raise AssertionError(f"evaluate mean_iou {scores['mean_iou']} != in-memory {direct}")

        room = load_scene_mapped(root, names[0])
        keep = room["points"][:, 0] < cpu_crop
        crop = scene_chunks({k: v[keep] for k, v in room.items()}, npoints)
        on_card = predict_scene_chunks(predict, crop, True, True, batch)
        cpu_model = copy.deepcopy(model).cpu()
        t0 = time.perf_counter()
        on_cpu = predict_scene_chunks(make_predict_fn(cpu_model, device="cpu"), crop, True,
                                      True, batch)
        t_cpu = time.perf_counter() - t0
        agree_cpu = float((on_card == on_cpu).mean())
        if agree_cpu < 0.999:
            raise AssertionError(f"card and CPU labels agree on only {agree_cpu:.4%}")
        serving = dict(f32=serve, packed_f32=serve_packed, packed_q16=serve_q16)
        for tag, sv in serving.items():
            log(f"[trainer] serve {tag}: {sv['points']} val points in {sv['wall_s']:.3f} s, "
                f"{sv['points_per_s']:.0f} points/s")
        log(f"[trainer] packed-f32 labels equal the f32 path on the same values; agreement "
            f"with plain f32: packed f32 {' '.join(f'{v:.6f}' for v in agree_packed)}, "
            f"packed q16 {' '.join(f'{v:.6f}' for v in agree_q16)}; benchmark.evaluate "
            f"mean_iou {scores['mean_iou']:.6f} = in-memory {direct:.6f}; card vs CPU on "
            f"{int(keep.sum())} points of {names[0]}: {agree_cpu:.6f} (CPU {t_cpu:.1f} s)")
        return dict(seconds=secs, rooms=dict(train=n_train, val=n_val, points=scene_points),
                    host_batch_ms=host_ms, runs=runs, steady_runs=steady, serving=serving, agreement_packed_f32=agree_packed,
                    agreement_packed_q16=agree_q16, mean_iou=scores["mean_iou"],
                    mean_iou_direct=direct, cpu_points=int(keep.sum()),
                    cpu_agreement=agree_cpu)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the GPU port",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_s = {}

    def phase(label, fn, /, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[label] = time.perf_counter() - t0
        log(f"[phase] {label}: {phase_s[label]:.1f} s")
        return out

    phase("build", phase_build)
    model = phase("model", phase_model, dev, n=8192)
    serve = phase("serve", phase_serve, model, dev, scene_points=150_000, n_scenes=3,
                  npoints=8192, batch=16)
    fwd = phase("forward", phase_forward_time, model, dev, batch=16, n=8192, reps=10)
    rooms = [make_synthetic_scene(150_000, seed=200 + s) for s in range(4)]
    parity = phase("train-parity", phase_train_parity, dev, rooms, n=8192)
    batches, t_data = train_batches(rooms, batch=16, npoints=8192, count=23)
    log(f"[train] {len(batches)} batches of B16 x 8192 made on the host in {t_data:.1f} s")
    train = phase("train", phase_train, dev, batches, steps=20, warmup=3)
    trained = phase("trainer", phase_trainer, dev)

    # The attention slice: the three registry models at full width, then the
    # first one's train step against the CPU, its training and its forward.
    attn_models = {}
    for name, kw in ATTENTION_MODELS:
        attn_models[name] = phase(f"attention-model {name}", phase_model, dev, n=8192,
                                  name=name, tag="attention-model", **kw)
    attn_model = attn_models["sem_seg_attention"]
    del attn_models
    attn_fwd = phase("attention-forward", phase_forward_time, attn_model, dev, batch=16,
                     n=8192, reps=10, tag="attention-forward")
    attn_parity = phase("attention-train-parity", phase_train_parity, dev, rooms, n=8192,
                        name="sem_seg_attention", tag="attention-train-parity")
    attn_train = phase("attention-train", phase_train, dev, batches, steps=10, warmup=3,
                       name="sem_seg_attention", tag="attention-train")
    del rooms, batches
    rep, geom = phase("kernels", phase_kernels, dev, batch=16, n=8192, reps=20)
    rep.update(phase("kernels-bwd", phase_kernels_bwd, dev, geom, reps=20))
    del geom
    phase("device-times", phase_device_times, rep)
    fwd_device_ms = phase_forward_device(model, dev, batch=16, n=8192)
    attn_fwd_device_ms = phase_forward_device(attn_model, dev, batch=16, n=8192)
    fwd_after = phase_forward_time(model, dev, batch=16, n=8192, reps=10,
                                   tag="forward after the profiler")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    line = []
    for name, (src, pallas) in KERNEL_INFO.items():
        r = rep[name]
        launches = (serve if name in FORWARD_KERNELS else train)["launches"][name]
        levels = " ".join(f"{k}={v:.4f}/{r['level_device'][k]:.4f}"
                          + (f"/bound {r['level_bound'][k][0]:.4f}" if "level_bound" in r else "")
                          for k, v in r["levels"].items())
        lib = ("-" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f}")
        trainer_launches = " ".join(f"{tag}={run['launches'][name]}"
                                    for tag, run in trained["runs"].items())
        log(f"[report] {name:21s} launches={launches:4d} (trainer window: {trainer_launches}) "
            f"{r['shape']}: "
            f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}); per level "
            f"ms wall/device{'/bound' if 'level_bound' in r else ''}: {levels}; "
            f"max_abs_err {r['max_abs_err']}")
        line.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": PALLAS + pallas, "launches": launches,
            "launch_window": "serve" if name in FORWARD_KERNELS else "train",
            "attention_train_launches": attn_train["launches"][name],
            "trainer_launches": {tag: run["launches"][name]
                                 for tag, run in trained["runs"].items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
            "parity": "pass", "shape": r["shape"], "level_ms": r["levels"],
            "level_device_ms": r["level_device"],
        })
        if "level_bound" in r:  # all kernels but FPS and the gather: the bound per level
            line[-1]["level_bound_ms"] = {k: v[0] for k, v in r["level_bound"].items()}
        if "library_levels" in r:  # the gather backward: index_add_ per level
            line[-1].update(library_level_ms=r["library_levels"],
                            library_level_device_ms=r["library_level_device"])
            log(f"[report] {name:21s} zeros().index_add_ per level ms wall/device: " + " ".join(
                f"{k}={v:.4f}/{r['library_level_device'][k]:.4f}"
                for k, v in r["library_levels"].items()))
        if "dp_levels" in r:  # the interpolation backward without dw, as the train step runs it
            line[-1].update(dp_only_level_ms=r["dp_levels"],
                            dp_only_level_device_ms=r["dp_level_device"],
                            dp_only_level_bound_ms={k: v[0] for k, v in
                                                    r["dp_level_bound"].items()})
            log(f"[report] {name:21s} without dw, per level ms wall/device/bound: " + " ".join(
                f"{k}={v:.4f}/{r['dp_level_device'][k]:.4f}/{r['dp_level_bound'][k][0]:.4f}"
                for k, v in r["dp_levels"].items()))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": line, "serve": serve, "forward_b16_ms": fwd["ms"],
                   "forward_b16_peak_bytes": fwd["peak_bytes"],
                   "forward_b16_ms_after_profiler": fwd_after["ms"],
                   "forward_b16_device_ms": fwd_device_ms,
                   "train_parity": parity, "train": train, "train_data_s": t_data,
                   "attention": {"model": "sem_seg_attention", "forward_b16_ms": attn_fwd["ms"],
                                 "forward_b16_peak_bytes": attn_fwd["peak_bytes"],
                                 "forward_b16_device_ms": attn_fwd_device_ms,
                                 "train_parity": attn_parity, "train": attn_train},
                   "trainer": trained, "phase_seconds": phase_s,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
