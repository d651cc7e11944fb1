#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. build        -- compile the host grid assignment (``native/``) with g++,
                   then the seven CUDA kernels from ``csrc/`` with nvcc
                   (sm_90a), one nvcc per source, all started together.
2. model        -- full-width ``sem_seg_features`` with seeded weights and BN
                   statistics: B2 x 8192 eval forward on the card and on the
                   CPU, TF32 off; indices equal at every level, logits within
                   rtol=atol=1e-3.
3. serve        -- synthetic rooms of 150k points chunked to 8192-point
                   chunks (the compiled grid assignment, timed beside its
                   numpy version), predicted in batches of 16 and stitched; launch
                   counters are zeroed just before and read just after: every
                   forward kernel launched, no backward kernel did.
   serve-resident -- the same rooms through ``ResidentSceneServer`` (q16, one
                   upload and one u8 fetch a room, the chunker, forwards and
                   stitch on the card, two rooms in flight): launch counters
                   as in phase 3; points/s, ms a room, peak memory, chunks
                   against scheduled slots, ``_stage`` timed in the pipeline
                   and alone.  On one room: the card's chunker bit for bit
                   equal to the numpy twin (f32 layout, ``GEOMETRIES``), the
                   f32 server's labels equal to ``predict_scene_chunks`` fed
                   the twin's chunks, q16 labels >= 98 % of f32's,
                   ``group_size=3`` equal to ungrouped, a BN-folded copy
                   (``train/bn_fold.py``) >= 99.9 % of the unfolded labels.
4. forward      -- B16 x 8192 eval forward time, unfolded and BN-folded.
5. train-parity -- one ``seg_train_step`` at full width, B2 x 8192, TF32 and
                   dropout off, from the same seeded weights and batch on the
                   card, on the card through the plain ops, on the CPU, and a
                   float64 CPU reference of the gradients.  See
                   ``phase_train_parity`` for what is compared.
   sampler      -- ``ResidentScenes`` of four 150k-point rooms on the card
                   and on the CPU; ``sample_chunk_batch`` at B16 x 8192 with
                   the same draws on both, occupancy 'fast' and 'exact',
                   with the kept box: equal bit for bit; timed beside its
                   byte bound (its device-only time after device-times).
6. train        -- B16 x 8192 batches of random chunks (``sample_random_chunk``
                   then ``make_batch``) from synthetic 150k-point rooms; launch
                   counters zeroed just before the timed steps and read just
                   after: all seven kernels launched; every loss finite; five
                   steps on one batch bring its loss below the first.
   remat        -- one B16 x 8192 ``seg_train_step`` from the same weights
                   and batch, dropout on, with ``remat`` 'none', 'dots' and
                   'full': loss, gradients, new parameters and BN statistics
                   within ``phase_train_parity``'s card limits of 'none''s
                   (bit-identical is reported); step time and peak memory.
   trainer      -- the port's workflow through its entry points
                   (``phase_trainer``): a synthetic store of 32 + 2 rooms of
                   150k points, ``precompute_cli`` (2 train epochs, val) and
                   the q16 pack store, timed; ``trainer.train`` at B16 x 8192
                   for 3 epochs of 2 steps with validation every epoch, once
                   with ``input='npz'`` and once with ``input='packed'``
                   (``packed_q16``), and once with ``input='resident'`` (the
                   q16 store on the card, each step's rows equal to the
                   packed run's byte for byte), and once with
                   ``input='sampler'`` (raw rooms on the card, no
                   precompute directory may appear; CUDA events around
                   ``sample_chunk_batch`` give its share of the step), and
                   once more with the sampler and ``compute_dtype=
                   'bfloat16'``:
                   launch counters zeroed just
                   before and read just after each run, all seven kernels
                   launched,
                   every logged loss finite, the step count as configured,
                   the best checkpoint restoring bit for bit; then
                   ``generate_predictions`` over the val rooms from that
                   checkpoint as f32, packed f32 (equal to the f32 path on
                   the values the record carries) and packed q16 rows, and
                   through ``generate_predictions_resident``;
                   ``benchmark.evaluate`` equal to the in-memory mIoU (f32
                   and resident), and a
                   crop of one room on the card and the CPU (>= 99.9 %).
   recipe       -- ``run_zero_precompute`` at the JAX results' size (8 + 2
                   rooms of 16k points, B4 x 2048, 100 epochs): offline mIoU
                   beside JAX's 0.795 (reported; fails on a non-finite loss).
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
   The PointNet++ classification and part-segmentation families
   (``FAMILY_N``: ModelNet40's B16 x 1024 xyz only, ShapeNet-part's B16 x
   2048 with normals):
   family-model -- ``cls_ssg``, ``cls_msg``, ``part_seg`` and
                   ``part_seg_msg_one_hot`` with seeded weights, B16 eval
                   forward on the card and on CPU copies: SA1-2 centres
                   equal, logits within rtol=atol=1e-3; launches a forward.
   family-train-parity -- one ``cls_train_step`` of ``cls_msg`` and one
                   ``partseg_train_step`` of ``part_seg_msg_one_hot``, B2,
                   held as in phase 5 (``hold_step``); all seven kernels
                   launch in the part-seg step.
   family-train -- 10 timed B16 steps of each of the four: median step,
                   points/s, peak memory, launches a step.
   family-recipe -- ``run_cls_convergence`` (cls_ssg, cls_msg with normals)
                   and ``run_partseg_convergence`` (part_seg,
                   part_seg_msg_one_hot) at the sizes of the JAX package's
                   RESULTS_family_convergence.json, reported beside it; the
                   trained ``part_seg``'s test shapes dumped with
                   ``evaluate_part_segmentation(ply_dir=)``, one PLY a shape
                   read back equal to its points and restricted argmax.
   The full attention nets (``ATTENTION_NETS``, B16 x 8192 with colors and
   normals, 6 feature channels) and the PointNet v1 family:
   attention-net-model -- each of the three with seeded weights, checked as
                   in phase 2 at B16 (the CPU on the first 4 clouds); peak
                   memory.
   attention-net-train-parity -- phase 5 for ``attention_net`` from the
                   trainer's initial weights (``phase_attention_net_train_parity``);
                   all seven kernels launch in the card's step.
   attention-net-train -- phase 6 for ``attention_net`` and
                   ``pooling_attention_net`` (10 timed steps each): median
                   step, points/s, peak memory, launches a step.
   attention-net-serve -- ``ResidentSceneServer`` with ``attention_net`` over
                   150k-point rooms: launches in its window, ms a room; f32
                   labels >= 99.9 % equal to the host path's.
   Mixed precision (``compute_dtype=torch.bfloat16``: bf16 products with
   float32 results, float32 parameters):
   mixed-precision-model -- the bf16 flagship's B16 x 8192 forward on the
                   card against the CPU's bf16 forward of its first cloud:
                   indices equal, logits within ``BF16_LOGIT_TOL``, argmax
                   agreement >= ``BF16_ARGMAX``; then its forward time.
   bf16-train-parity -- one bf16 B2 x 8192 step on the card (kernels and
                   plain ops) and the CPU, held to the CPU's float32 step
                   (``phase_bf16_train_parity``); all seven kernels launch.
   mixed-precision-train -- 10 timed bf16 B16 x 8192 steps of the flagship
                   and of ``pooling_attention_net`` beside their float32
                   steps of phase 6 and attention-net-train: median step,
                   peak memory, launches a step (device time after
                   device-times).
   pointnet1    -- the five v1 models' B16 forward at the reference's sizes
                   against the CPU, and one ``pointnet1_cls`` step with the
                   orthogonality loss held by ``hold_step``.
   attention-net-recipe -- ``run_attention_net_convergence``, the
                   ``pointnet1_cls`` and ``pointnet1_seg`` arms and
                   ``run_s3dis_convergence`` at the JAX results' sizes,
                   reported beside them.
   v1-scannet   -- the PointNet++ v1 ScanNet pipeline (``phase_v1_scannet``):
                   FPS and ball query of 1024 centres from 256 points against
                   their plain versions; ``train_scannet_v1`` (``sem_seg``,
                   B16 x 8192) for 3 steps of each ``dataset_kind`` with the
                   whole-scene evaluation of two 150k-point rooms, launch
                   counters zeroed just before and read just after each run
                   (all seven kernels) and each step's launches; then
                   ``run_v1_scannet_convergence`` at its defaults and at the
                   vendored result's 40 epochs, beside it.
   The raw-scan path (``data/scannet/preprocessing.py``, ``recipes/
   realdata_drill.py``, ``viz/``):
   realdata-drill -- ``realdata_drill.main --device cuda`` at JAX's CLI
                   defaults, then ``run_drill`` on a ScanNet-sized room
                   (138,778 vertices, 274,900 faces, B16 x 8192): every stage
                   timed on its own line (fabricate, ``read_ply_mesh``,
                   ``compute_vertex_normals``, ``collect_scannet_scene``,
                   precompute train and val, train, predict and stitch,
                   ground-truth export, evaluate) with its launches; launch
                   counters zeroed just before and read just after each run,
                   all seven kernels launched; the resolved labels and the
                   exported ground truth equal to the fabricated ones, one
                   stitched label per vertex, the perfect predictor's mIoU
                   1.0; the room's labels rendered by ``rotation_animation``,
                   ``render_ball`` (C++) equal to ``render_ball_numpy`` byte
                   for byte on a frame's points and to the frame's PNG.
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
                   (nsample, C); ball query at radius 0.1 at SA2-4, the
                   gather at the attention nets' widths (C 131 to 4099) and
                   the interpolation at FP1 with C 1024 and 8192, each
                   timed beside its bound (their backwards in phase 8).  Ball query's, three-NN's and the
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
                   call, of the B16 forwards (flagship unfolded, folded and
                   bf16, attention) and of one float32 and one bf16 B16
                   step of each mixed-precision model, from the profiler's kernel
                   events (``device_ms``); then the B16 forward is timed
                   again.  Last of the timed
                   phases: train steps timed after the profiler had run
                   read up to 30 % slower (PERF.md, Findings).  The kernel
                   phases come after the end-to-end ones so that their
                   inputs, which phase 9 reuses, do not count in the serve
                   and train windows' peak memory.
10. report      -- one line per kernel (with its launches in the
                   serve-resident window, in each trainer run, in a bf16
                   step, in a v1 ScanNet trainer step and in the drill's
                   two runs), a
                   ``{"kernels": [...]}`` JSON line, the
                   card's name and power limit, and the final
                   ``{"ok": true, "device": {...}}`` line.

Exits non-zero without printing a result when CUDA is not available.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import glob
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Optional

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
from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving  # noqa: E402
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
from pointcloud_segmentation_attention_tpu_torch.train import device_replay  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.recipes import (  # noqa: E402
    run_cls_convergence,
    run_partseg_convergence,
    run_zero_precompute,
)
from pointcloud_segmentation_attention_tpu_torch.recipes.family_convergence import (  # noqa: E402
    run_attention_net_convergence,
    run_s3dis_convergence,
)
from pointcloud_segmentation_attention_tpu_torch.data import modelnet, s3dis  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.models import pointnet1  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch import native  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.train import cls_steps  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.train.bn_fold import (  # noqa: E402
    fold_batchnorm_for_inference,
)
from pointcloud_segmentation_attention_tpu_torch.train import trainer  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.nn import PointConv  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.utils.trace_breakdown import (  # noqa: E402
    device_breakdown,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet import preprocessing  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.data.shapenet_part import (  # noqa: E402
    PartNormalDataset,
)
from pointcloud_segmentation_attention_tpu_torch.eval import full_scene  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.eval.part_iou import (  # noqa: E402
    restrict_logits_to_category,
)
from pointcloud_segmentation_attention_tpu_torch.eval.voting import (  # noqa: E402
    evaluate_part_segmentation,
)
from pointcloud_segmentation_attention_tpu_torch.recipes import realdata_drill  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.viz import (  # noqa: E402
    animations,
    colorize_labels,
    read_ply,
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
# The full attention nets (``models/attention_nets.py``), fed colors and
# normals (TrainConfig's default, 6 feature channels); the gather widths of
# ``attention_net`` and ``pooling_attention_net`` at SA2-4 (3 + 16 x out_dim
# of the level below) and their FP1 interpolation widths (16 x out_dim of SA4).
ATTENTION_NETS = ("attention_net", "attention_net_mlp", "pooling_attention_net")
ATTNET_FEATURES = 6
ATTNET_GATHER_C = ((131, 1027), (259, 2051), (515, 4099))
ATTNET_FP1_C = (1024, 8192)
# Chunk geometries (cell, margin) the card's chunker is held to the numpy twin at:
# the default and the context-margin ablation's two (JAX tests/test_resident_serving.py).
GEOMETRIES = ((1.5, 0.2), (1.5, 0.0), (1.0, 0.3))


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
    native.build()
    log(f"[build] host grid assignment built with g++ in {time.perf_counter() - t0:.1f} s "
        f"-> {os.path.relpath(native.library_path(), ROOT)}")
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
        level_bound("group_gather", label, *gather_work(pts, idx))
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

    # The full attention nets' new shapes: ball query at radius 0.1 at SA2-4
    # (sparse balls), the gather at their group widths (3 + the level's
    # input channels) and its backward there (phase 8), and the
    # interpolation and its backward at FP1 (M 16 -> N 64) at their widest
    # interpolated features.
    for i, widths in enumerate(ATTNET_GATHER_C, start=1):
        xyz, centres = levels[i], levels[i + 1]
        label = f"SA{i + 1} r.1"
        idx, cnt = ops.ball_query(xyz, centres, 0.1, 32)
        pidx, pcnt = plain.ball_query(xyz, centres, 0.1, 32)
        err("ball_query", check_equal(f"ball_query idx attention nets {label}", idx, pidx))
        err("ball_query", check_equal(f"ball_query cnt attention nets {label}", cnt, pcnt))
        level_time("ball_query", f"attention nets {label}",
                   functools.partial(ops.ball_query, xyz, centres, 0.1, 32))
        level_bound("ball_query", f"attention nets {label}",
                    *ball_query_work(xyz, centres, idx, cnt, 32))
        for net, c in zip(ATTENTION_NETS[::2], widths):
            pts = torch.rand(batch, xyz.shape[1], c, device=dev)
            lab = f"{net} {label} C{c}"
            err("group_gather", check_equal(f"group_gather {lab}",
                                            ops.group_point_with_counts(pts, idx, cnt),
                                            plain.group_point(pts, idx)))
            level_time("group_gather", lab,
                       functools.partial(ops.group_point_with_counts, pts, idx, cnt))
            level_bound("group_gather", lab, *gather_work(pts, idx))
            geom["sa"].append((lab, idx, xyz.shape[1], c))
        log(f"[kernels] attention nets {label}: N={xyz.shape[1]} M={centres.shape[1]} ns=32 "
            f"ball hits mean={cnt.float().mean().item():.2f}; ball_query equal, group_gather "
            f"equal at C {widths}")
    dist, nidx = ops.three_nn(levels[3], levels[4])
    w = plain.interpolation_weights(dist)
    geom["fp_wide"] = []
    for net, c in zip(ATTENTION_NETS[::2], ATTNET_FP1_C):
        p2 = torch.randn(batch, levels[4].shape[1], c, device=dev)
        lab = f"{net} FP1 C{c}"
        err("three_interpolate", check_equal(f"three_interpolate {lab}",
                                             ops.three_interpolate(p2, nidx, w),
                                             plain.three_interpolate(p2, nidx, w)))
        level_time("three_interpolate", lab,
                   functools.partial(ops.three_interpolate, p2, nidx, w))
        level_bound("three_interpolate", lab, *interpolate_work(p2, nidx))
        geom["fp_wide"].append((lab, nidx, w, p2))
    log(f"[kernels] attention nets FP1: N={levels[3].shape[1]} M={levels[4].shape[1]} "
        f"three_interpolate equal at C {ATTNET_FP1_C}")

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
    rep["group_gather"]["bound_ms"], rep["group_gather"]["bound_by"] = \
        rep["group_gather"]["level_bound"]["SA1"]

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


def gather_work(points, idx):
    """(bytes, f32 operations) of the gather: P and idx read once, the
    groups written; no arithmetic."""
    b, n, c = points.shape
    m, k = idx.shape[1:]
    return b * n * c * 4 + b * m * k * 4 + b * m * k * c * 4, 0.0


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


def family_level(name: str, n: int, m: int, b: int = 16):
    """(cloud (B,n,3), its FPS centres (B,m,3)) on the card: unit-sphere
    shapes of ``family_batch(name)``, thinned by FPS to ``n`` points where
    ``n`` is below the model's input size (SA2's input)."""
    xyz = torch.from_numpy(family_batch(name, b, seed=5)["points"][..., :3].copy()).cuda()
    if n < xyz.shape[1]:
        xyz = plain.gather_point(xyz, ops.farthest_point_sample(xyz, n))
    return xyz, plain.gather_point(xyz, ops.farthest_point_sample(xyz, m))


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
        # The families' levels on unit-sphere shapes, FPS centres.
        ("cls MSG SA1 r .1 ns16", *family_level("cls_ssg", 1024, 512), 0.1, 16),
        ("cls MSG SA1 r .4 ns128", *family_level("cls_ssg", 1024, 512), 0.4, 128),
        ("cls SSG SA2 r .4 ns64", *family_level("cls_ssg", 512, 128), 0.4, 64),
        ("cls MSG SA2 r .8 ns128", *family_level("cls_ssg", 512, 128), 0.8, 128),
        ("part-seg MSG SA1 r .4 ns128", *family_level("part_seg", 2048, 512), 0.4, 128),
        ("part-seg SSG SA1 r .2 ns64", *family_level("part_seg", 2048, 512), 0.2, 64),
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
        ("part-seg FP1, M 1", cloud(16, 128), torch.zeros(16, 1, 3, device=dev)),
        ("M 2, B16 N 128", cloud(16, 128), cloud(16, 2)),
        ("part-seg FP3, N 2048 M 512", *family_level("part_seg", 2048, 512)),
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
             (33, 3), (64, 131), (16, 6), (128, 6), (128, 323), (64, 323)]
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


def check_interpolate_bwd(label: str, g, idx, w, p2, dw_tol: dict = BWD_TOL) -> float:
    """The interpolation backward on the card: dP equal to the plain version
    run on CPU copies (the order of its sums is the CPU's), dP and dw the
    same bits from call to call, dP without dw the same again, dw within
    ``dw_tol`` (``BWD_TOL`` unless a caller states another); the CSR the
    backward builds equal to ``plain.interpolation_csr``.  Returns dw's
    largest error."""
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
    return check_close(f"three_interpolate_bwd dw {label}", dw, pdw, dw_tol)


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

    def gather_case(label, idx, n, c, lib_tol=BWD_TOL):
        """Bit for bit against the CPU and call to call; timed beside its
        bound and ``index_add_`` (held to the plain version within
        ``lib_tol``: on the card it adds in no fixed order)."""
        b, m, k = idx.shape
        g = torch.randn(b, m, k, c, device=dev, generator=rng)
        check_gather_bwd(label, g, idx, n)
        r = rep["group_gather_bwd"]
        fn = lambda: gather_kernels.group_point_backward(g, idx, n)  # noqa: E731
        lib = index_add_call(g, idx, n)
        check_close(f"group_gather_bwd library {label}", lib().reshape(b, n, c),
                    plain.group_point_backward(g, idx, n), lib_tol)
        r["levels"][label] = time_ms(fn, reps)
        r["device_fns"][label] = fn
        r.setdefault("level_bound", {})[label] = bound(*gather_bwd_work(g, n))
        r.setdefault("library_levels", {})[label] = time_ms(lib, reps)
        r.setdefault("library_fns", {})[label] = lib
        return g

    def interp_case(label, idx, w, p2, timed, dw_tol=BWD_TOL):
        g = torch.randn(idx.shape[0], idx.shape[1], p2.shape[-1], device=dev, generator=rng)
        err("three_interpolate_bwd", check_interpolate_bwd(label, g, idx, w, p2, dw_tol))
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
    for label, idx, w, p2 in geom.pop("fp_wide"):
        # dw sums C products of unit-scale normals in another order than the
        # plain version: its tolerance grows with C over BWD_TOL's 512, as
        # at the part-seg FP1 below.
        c = p2.shape[-1]
        interp_case(label, idx, w, p2, True, dw_tol=dict(rtol=1e-5, atol=1e-5 * c / 512))
    log("[kernels-bwd] SA2-4 gather backward: dP equal to the plain version on CPU copies and "
        "from call to call, the CSR equal to plain.transpose_csr; FP1-4 interpolation "
        "backward: dP equal to the plain version on CPU copies and from call to call (also "
        f"without dw), dw within {BWD_TOL} and equal from call to call, the CSR equal to "
        "plain.interpolation_csr")

    # The families' new shapes: the gather backward at K 128, C 323 (cls MSG
    # SA2: 320 features + xyz), and the interpolation from M 1 (part-seg FP1,
    # N 128, C 1024; and N 2048): one CSR key holds every entry of a cloud.
    xyz, centres = family_level("cls_ssg", 512, 128)
    # A row there sums up to ~4,000 g rows, in no fixed order in index_add_
    # (2.1e-5 apart from the ordered sum on an H100).
    gather_case("cls MSG SA2 K128 C323", ops.ball_query(xyz, centres, 0.8, 128)[0], 512, 323,
                lib_tol=dict(rtol=1e-4, atol=1e-4))
    for n_m1 in (128, 2048):
        unknown, _ = family_level("part_seg", n_m1, 1)
        dist, m1_idx = ops.three_nn(unknown, torch.zeros(16, 1, 3, device=dev))
        m1_w = plain.interpolation_weights(dist)
        m1_p = torch.randn(16, 1, 1024, device=dev, generator=rng)
        label = f"M1 N{n_m1} C1024" + (" (part-seg FP1)" if n_m1 == 128 else "")
        check_equal(f"three_interpolate {label}", ops.three_interpolate(m1_p, m1_idx, m1_w),
                    plain.three_interpolate(m1_p, m1_idx, m1_w))
        # dw is a dot product of C 1024 products of unit-scale normals, summed
        # in another order than the plain version's: 1.05e-5 apart on an
        # H100, so its tolerance doubles with C over BWD_TOL's 512.
        interp_case(label, m1_idx, m1_w, m1_p, True, dw_tol=dict(rtol=1e-5, atol=2e-5))
    log("[kernels-bwd] family shapes: gather backward at cls MSG SA2 (B16 N512 M128 K128 "
        "C323) and the interpolation forward and backward from M 1 (B16, N 128 and 2048, "
        "C1024: one CSR key a cloud) equal to the plain versions on CPU copies")

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


def _sa_level(model, i: int):
    """SA level ``i`` (1-4): ``sa{i}``, or ``l{i}`` in the attention nets."""
    return getattr(model, f"sa{i}") if hasattr(model, f"sa{i}") else getattr(model, f"l{i}")


def _capture_levels(model):
    levels = {}
    hooks = []
    for i in range(4):
        def hook(mod, args, out, i=i):
            levels[i] = (out[0].detach().cpu(), out[2].detach().cpu())
        hooks.append(_sa_level(model, i + 1).register_forward_hook(hook))
    return levels, hooks


def phase_model(dev, n: int, name: str = "sem_seg_features", tag: str = "model",
                batch: int = 2, cpu_batch: Optional[int] = None, tol: dict = LOGIT_TOL,
                min_argmax: float = 0.0, **kwargs) -> torch.nn.Module:
    """Full-width registry model ``name`` (``kwargs`` to ``seeded_model``),
    B``batch`` x n eval forward on the card and on the CPU (on the first
    ``cpu_batch`` clouds, where given: an eval forward treats each cloud
    alone): indices equal at every level, logits within ``tol`` and at
    least ``min_argmax`` of the argmax equal; the card's peak memory.  Fed
    colors and normals where the model takes them, else xyz only.  Returns
    the card's model."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = models.seeded_model(name, seed=0, device="cpu", **kwargs)
    dev_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.RandomState(1)
    pts = torch.from_numpy((rng.rand(batch, n, 3) * EXTENT).astype(np.float32))
    feats = (torch.from_numpy(rng.rand(batch, n, 6).astype(np.float32))
             if cpu_model.in_features else None)
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    dev_levels, h1 = _capture_levels(dev_model)
    cpu_levels, h2 = _capture_levels(cpu_model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = seg_predict_step(dev_model, pts.to(dev), None if feats is None else feats.to(dev)).cpu()
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cb = cpu_batch or batch
    t0 = time.perf_counter()
    want = seg_predict_step(cpu_model, pts[:cb], None if feats is None else feats[:cb])
    t_cpu = time.perf_counter() - t0
    for h in h1 + h2:
        h.remove()
    for i in range(4):
        check_equal(f"{tag} SA{i + 1} centres", dev_levels[i][0][:cb], cpu_levels[i][0])
        check_equal(f"{tag} SA{i + 1} ball_query", dev_levels[i][1][:cb], cpu_levels[i][1])
    xyzs = [pts[:cb]] + [cpu_levels[i][0] for i in range(4)]
    for i in range(4):
        lvl = 3 - i
        _, di = ops.three_nn(xyzs[lvl].to(dev), xyzs[lvl + 1].to(dev))
        check_equal(f"{tag} FP{i + 1} three_nn", di, plain.three_nn(xyzs[lvl], xyzs[lvl + 1])[1])
    if got.shape != (batch, n, 21) or not torch.isfinite(got).all():
        raise AssertionError(f"{tag} logits bad: shape {tuple(got.shape)}")
    e = check_close(f"{tag} logits", got[:cb], want, tol)
    agree = float((got[:cb].argmax(-1) == want.argmax(-1)).float().mean())
    if agree < min_argmax:
        raise AssertionError(f"{tag}: argmax agreement {agree:.6f} < {min_argmax}")
    log(f"[{tag}] {name}{kwargs or ''} full width, B{batch} x {n}, "
        f"{'colors and normals' if feats is not None else 'xyz only'}"
        + (f" (the CPU on the first {cb} clouds)" if cb != batch else "")
        + f": indices equal at SA1-4/FP1-4; logits max |card - cpu| = {e:.3e} (tol {tol}); argmax agreement "
        f"{agree:.6f}; first forward card {t_dev:.2f} s (incl. warm-up), cpu {t_cpu:.2f} s; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB")
    dev_model.smoke_report = dict(max_abs_err=e, argmax_agreement=agree, peak_bytes=peak,
                                  first_forward_s=t_dev, cpu_forward_s=t_cpu)
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
    grid = grid_assign_times(scenes[1]["points"])
    res = dict(scenes=len(served), chunks=n_chunks, points=n_points, wall_s=wall,
               points_per_s=n_points / wall, chunks_per_s=n_chunks / wall,
               peak_bytes=peak, launches=launches, cpu_agreement=agree, grid_assign=grid)
    log(f"[serve] {res['scenes']} scenes, {n_chunks} chunks of {npoints}, {n_points} points "
        f"served in {wall:.3f} s after one warm-up scene: {res['points_per_s']:.0f} points/s, "
        f"{res['chunks_per_s']:.1f} chunks/s; max_memory_allocated {peak / 2**20:.1f} MiB; "
        f"labels of 2 chunks agree with the CPU path on {agree:.4%}")
    log(f"[serve] launches in the serve window: {json.dumps(launches)}")
    log(f"[serve] grid assignment of scene_chunks: the compiled one "
        f"({os.path.relpath(native.library_path(), ROOT)}), {grid['compiled_ms']:.2f} ms a "
        f"room of {len(scenes[1]['points'])} points against the numpy version's "
        f"{grid['numpy_ms']:.2f} ms, equal pair for pair")
    return res


def grid_assign_times(points: np.ndarray, reps: int = 5) -> dict:
    """Median ms of the compiled host grid assignment (what ``scene_chunks``
    runs) and of its numpy version on one room; both must give the same
    pairs."""
    times = {}
    for label, fn in (("compiled_ms", native.grid_chunk_assign),
                      ("numpy_ms", native.grid_chunk_assign_numpy)):
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(points)
            runs.append((time.perf_counter() - t0) * 1e3)
        times[label] = float(np.median(runs))
        times.setdefault("pairs", []).append(out)
    a, b = times.pop("pairs")
    for x, y in zip(a, b):
        if not np.array_equal(x, y):
            raise AssertionError("compiled and numpy grid assignments differ")
    return times


def phase_serve_resident(model, dev, scene_points: int, n_scenes: int, npoints: int,
                         batch: int):
    """``ResidentSceneServer`` (q16, pipeline depth 2) over the serve phase's
    rooms after one warm-up room: launch counters zeroed just before the
    window and read just after (all five forward kernels, no backward);
    points/s, ms a room, peak memory, each room's chunks against the slots
    scheduled for it, and ``_stage`` timed inside the pipeline and alone.
    Then, on one room: the card's chunker equal to the numpy twin bit for
    bit (f32 layout, ``GEOMETRIES``); the f32 server's labels equal to
    ``predict_scene_chunks`` on the card fed the twin's chunks; q16 against
    f32 >= 98 %; ``group_size=3`` equal to the window's labels; a BN-folded
    copy of the model >= 99.9 % of the unfolded labels.  Returns (report,
    folded model)."""
    scenes = [dict(make_synthetic_scene(scene_points, seed=100 + s), scene_name=f"room{s}")
              for s in range(n_scenes + 1)]
    server = resident_serving.ResidentSceneServer(model, npoints, batch_size=batch,
                                                  layout="q16", pipeline_depth=2, device=dev)
    stage_s, slots = [], []
    stage, fetch = server._stage, server._fetch

    def timed_stage(scene):
        t0 = time.perf_counter()
        out = stage(scene)
        stage_s.append(time.perf_counter() - t0)
        return out

    def counted_fetch(computed):
        out = fetch(computed)
        slots.append((computed[0], int(computed[3]), computed[5]))
        return out

    server._stage, server._fetch = timed_stage, counted_fetch
    server.predict_scene(scenes[0])  # warm-up: first launches, allocator growth
    torch.cuda.synchronize()
    stage_s.clear()
    slots.clear()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    served = dict(server.predict_scenes(iter(scenes[1:])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve-resident phase never launched {missing}")
    if any(launches[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"resident serving launched backward kernels: {launches}")
    rooms = scenes[1:]
    for sc in rooms:
        labels = served[sc["scene_name"]]
        if labels.shape != (len(sc["points"]),) or labels.min() < 0 or labels.max() >= 21:
            raise AssertionError("resident labels have the wrong shape or range")
    stage_alone = []
    for _ in range(3):
        t1 = time.perf_counter()
        stage(rooms[0])
        torch.cuda.synchronize()  # the upload included
        stage_alone.append(time.perf_counter() - t1)
    n_points = sum(len(sc["points"]) for sc in rooms)

    # One room in the f32 layout: the chunker and the labels, bit for bit.
    room = rooms[0]
    n = len(room["points"])
    layout = resident_serving.SceneLayout("f32", server._n_pad(n))
    dbuf = torch.from_numpy(layout.pack(room["points"], room["colors"], room["normals"])).to(dev)
    for cell, margin in GEOMETRIES:
        x = resident_serving.chunk_count(room["points"], npoints, cell, margin)
        idx, mask, nc = resident_serving.make_scene_chunker(
            layout, resident_serving._bucket(x, 4 * batch), npoints, chunk_size=cell,
            margin=margin)(dbuf, n)
        twin = resident_serving.deterministic_scene_chunks(room["points"], [], npoints,
                                                           chunk_size=cell, margin=margin)
        idx, mask = idx.cpu().numpy(), mask.cpu().numpy()
        if (int(nc) != x or x != len(twin.points) or not np.array_equal(idx[:x], twin.orig_idx)
                or not np.array_equal(mask[:x], twin.masks) or mask[x:].any()):
            raise AssertionError(f"the card's chunker differs from the numpy twin at "
                                 f"({cell}, {margin}): {int(nc)} chunks, twin {len(twin.points)}")
    f32 = resident_serving.ResidentSceneServer(model, npoints, batch_size=batch, layout="f32",
                                               device=dev).predict_scene(room)
    twin = resident_serving.deterministic_scene_chunks(
        room["points"], [room["colors"], room["normals"]], npoints)
    host_scene = dict(points=twin.points, colors=twin.features[0],
                      normals=twin.features[1].astype(np.float32), masks=twin.masks,
                      orig_idx=twin.orig_idx, num_vertices=n)
    host = predict_scene_chunks(make_predict_fn(model, device=dev), host_scene, True, True, batch)
    if not np.array_equal(f32, host):
        raise AssertionError(f"resident f32 labels differ from the host path on the same chunks "
                             f"at {int((f32 != host).sum())} of {n} vertices")
    q16_agree = float((served[room["scene_name"]] == f32).mean())
    if q16_agree < 0.98:
        raise AssertionError(f"q16 labels agree with f32 on only {q16_agree:.4%}")
    grouped = dict(resident_serving.ResidentSceneServer(
        model, npoints, batch_size=batch, layout="q16", group_size=3, device=dev
    ).predict_scenes(iter(rooms)))
    for sc in rooms:
        if not np.array_equal(grouped[sc["scene_name"]], served[sc["scene_name"]]):
            raise AssertionError(f"group_size=3 labels differ from the ungrouped server on "
                                 f"{sc['scene_name']}")
    folded, n_folded = fold_batchnorm_for_inference(model)
    folded_labels = dict(resident_serving.ResidentSceneServer(
        folded, npoints, batch_size=batch, layout="q16", device=dev).predict_scenes(iter(rooms)))
    fold_agree = [float((folded_labels[sc["scene_name"]] == served[sc["scene_name"]]).mean())
                  for sc in rooms]
    if min(fold_agree) < 0.999:
        raise AssertionError(f"BN-folded labels agree with the unfolded ones on only "
                             f"{fold_agree}")
    res = dict(scenes=len(rooms), points=n_points, wall_s=wall, points_per_s=n_points / wall,
               ms_per_room=wall * 1e3 / len(rooms), peak_bytes=peak, launches=launches,
               chunks_and_slots=[{"scene": a, "n_chunks": b, "slots": c} for a, b, c in slots],
               stage_ms_in_pipeline=[v * 1e3 for v in stage_s],
               stage_ms_alone=[v * 1e3 for v in stage_alone], q16_vs_f32=q16_agree,
               n_folded=n_folded, folded_agreement=fold_agree)
    ms = {k: " ".join(f"{v:.1f}" for v in res[k])
          for k in ("stage_ms_in_pipeline", "stage_ms_alone")}
    log(f"[serve-resident] {len(rooms)} rooms, {n_points} points in {wall:.3f} s after one "
        f"warm-up room: {res['points_per_s']:.0f} points/s, {res['ms_per_room']:.2f} ms a room; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB; chunks / slots "
        f"{' '.join(f'{b}/{c}' for _, b, c in slots)}; _stage {ms['stage_ms_in_pipeline']} ms "
        f"in the pipeline, {ms['stage_ms_alone']} ms alone")
    log(f"[serve-resident] chunker equal to the numpy twin at {list(GEOMETRIES)}; f32 labels "
        f"equal to predict_scene_chunks on the twin's chunks ({n} vertices); q16 vs f32 "
        f"{q16_agree:.6f}; group_size=3 equal; BN-folded ({n_folded} convs) vs unfolded "
        f"{' '.join(f'{v:.6f}' for v in fold_agree)}")
    log(f"[serve-resident] launches in the serve-resident window: {json.dumps(launches)}")
    return res, folded


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


def phase_forward_device(model, dev, batch: int, n: int, what: str = "eval forward") -> float:
    """Device-only time of one B16 x 8192 eval forward (``device_ms``)."""
    pts, feats = _forward_inputs(model, dev, batch, n)
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    ms = device_ms(lambda: seg_predict_step(model, pts, feats), calls=5)
    log(f"[device-times] B{batch} x {n} {what}: {ms:.3f} ms of device time")
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


def _one_step(model, batch: dict, step=seg_train_step):
    """(loss, gradients, BN statistics) of one ``step`` (``seg_train_step``
    or a family's step), on the CPU."""
    _, m = step(TrainState(model), batch)
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in model.named_buffers()}
    return float(m["loss"]), grads, stats


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def hold_step(tag: str, card, cpu, on_plain, f64, noise: set, noise_tol: float = 1e-5,
              zeros: Optional[dict] = None, f64_floor: float = 0.0,
              kernel_rel: Optional[float] = None) -> dict:
    """Hold one training step on the card to ``phase_train_parity``'s limits.
    ``card`` and ``cpu`` are (loss, gradients, BN statistics) of the step
    from the same weights and batch, ``on_plain`` (loss, gradients) of the
    card through the plain ops, ``f64`` (gradients, BN statistics) of a
    float64 CPU run; ``noise`` names the tensors whose exact gradient is 0,
    held below ``noise_tol`` x the largest gradient on both sides of the
    card, as are the elements that ``zeros`` (name -> boolean mask, from
    the float64 run) marks as exactly 0 within another tensor.  The card's
    gradients may lie ``f64_floor`` from float64 where twice the CPU's
    distance is less (a model whose max pools flip on rounding: see
    ``phase_pointnet1``).  With ``kernel_rel`` the card's kernels are held
    to the card's plain ops per tensor in relative L2 instead of element
    by element (see ``phase_attention_net_train_parity``).  Returns the
    measured distances and a one-line ``summary``."""
    (loss_card, g_card, bn_card), (loss_cpu, g_cpu, bn_cpu) = card, cpu
    (loss_plain, g_plain), (g64, bn64) = on_plain, f64
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

    real = [k for k in g_cpu if k not in noise]
    g_max = max(float(g_cpu[k].abs().max()) for k in real)
    cpu_err = {k: _rel_l2(g_cpu[k], g64[k]) for k in real}
    card_err = {k: _rel_l2(g_card[k], g64[k]) for k in real}
    limit = max(2.0 * max(cpu_err.values()) + 1e-6, f64_floor)
    bad = {k: v for k, v in card_err.items() if v > limit}
    if bad:
        raise AssertionError(f"{tag}: card gradients farther from float64 than {limit:.3e}: {bad}")
    kernel_err = 0.0
    for k, g in g_card.items():
        if k in noise:
            if max(float(g.abs().max()), float(g_plain[k].abs().max())) >= noise_tol * g_max:
                raise AssertionError(f"{tag}: gradient of {k} (exactly 0) is not noise-sized")
            continue
        scale = float(g_plain[k].abs().max())
        gp = g_plain[k]
        if zeros is not None and bool(zeros[k].any()):
            z = zeros[k]
            if max(float(g[z].abs().max()), float(gp[z].abs().max())) >= noise_tol * g_max:
                raise AssertionError(f"{tag}: gradient of {k} where it is exactly 0 is not "
                                     f"noise-sized")
            g, gp = g[~z], gp[~z]
        if kernel_rel is not None:
            rel = _rel_l2(g, gp)
            if rel > kernel_rel:
                raise AssertionError(f"{tag}: card kernels vs card plain grad {k}: rel L2 "
                                     f"{rel:.3e} > {kernel_rel}")
            kernel_err = max(kernel_err, rel)
            continue
        check_close(f"{tag} card kernels vs card plain grad {k}", g, gp,
                    dict(rtol=1e-3, atol=1e-5 * scale))
        kernel_err = max(kernel_err, float((g - gp).abs().max()) / max(scale, 1e-30))
    res = dict(loss_card=loss_card, loss_cpu=loss_cpu, loss_card_plain=loss_plain,
               grad_rel_l2_card_vs_f64_max=max(card_err.values()),
               grad_rel_l2_cpu_vs_f64_max=max(cpu_err.values()),
               grad_rel_l2_card_vs_cpu_max=max(_rel_l2(g_card[k], g_cpu[k]) for k in real),
               grad_max_err_kernels_vs_plain_on_card=kernel_err, bn_held_to_f64=bn_by_f64)
    res["summary"] = (
        f"loss card {loss_card:.7f} cpu {loss_cpu:.7f} card-plain {loss_plain:.7f}; "
        f"BN statistics within rtol 1e-4 ({len(bn_by_f64)} held to float64 instead); "
        f"gradients rel-L2 from float64: card max {res['grad_rel_l2_card_vs_f64_max']:.3e}, "
        f"cpu max {res['grad_rel_l2_cpu_vs_f64_max']:.3e} (card vs cpu max "
        f"{res['grad_rel_l2_card_vs_cpu_max']:.3e}); card kernels vs card plain max "
        + ("rel L2" if kernel_rel is not None else "|dg|/max|g|") + f" {kernel_err:.3e}")
    return res


def phase_train_parity(dev, scenes, n: int, name: str = "sem_seg_features",
                       tag: str = "train-parity", init_weights: bool = False,
                       zero_below: Optional[float] = None, kernel_rel: Optional[float] = None,
                       **kwargs) -> dict:
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
    - all seven kernels launch in the card's step.

    ``kwargs`` go to the registry.  ``init_weights`` takes the trainer's
    initial weights (zero biases, identity BN affines) instead of seeded
    ones.  With ``zero_below``, every gradient tensor (or element) whose
    float64 value is below ``zero_below`` x the largest is exactly 0 too and
    is held as noise below 1e-4 x the largest gradient (the full attention
    nets: see ``phase_attention_net_train_parity``); ``kernel_rel`` goes to
    ``hold_step``.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if init_weights:
        base = models.get_model(name, device="cpu", dropout_rate=0.0,
                                generator=torch.Generator().manual_seed(0), **kwargs)
    else:
        base = models.seeded_model(name, seed=0, device="cpu", dropout_rate=0.0, **kwargs)
    batch = _for_model(_train_batch(scenes, np.random.RandomState(3), 2, n), base)
    card, on_plain, ref64 = (copy.deepcopy(base).to(dev), copy.deepcopy(base).to(dev),
                             copy.deepcopy(base).double())
    card_levels, h1 = _capture_levels(card)
    cpu_levels, h2 = _capture_levels(base)
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss_card, g_card, bn_card = _one_step(card, batch)
    t_card = time.perf_counter() - t0
    launches = kernels.launch_counts()
    missing = [k for k in KERNEL_INFO if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: the card's step never launched {missing}")
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
    noise, zeros, noise_tol = _noise_biases(base), None, 1e-5
    if zero_below is not None:
        g64_max = max(float(g.abs().max()) for g in g64.values())
        zeros = {k: g.abs() < zero_below * g64_max for k, g in g64.items()}
        noise = noise | {k for k, z in zeros.items() if bool(z.all())}
        noise_tol = 1e-4
    held = hold_step(tag, (loss_card, g_card, bn_card), (loss_cpu, g_cpu, bn_cpu),
                     (loss_plain, g_plain), (g64, bn64), noise, noise_tol=noise_tol,
                     zeros=zeros, kernel_rel=kernel_rel)
    res = dict(held, first_step_card_s=t_card, step_cpu_s=t_cpu, f64_cpu_s=t_64,
               launches=launches, exact_zero=sorted(noise - _noise_biases(base)))
    log(f"[{tag}] {name} full width B2 x {n}, "
        f"{'colors and normals' if 'features' in batch else 'xyz only'}, TF32 and dropout off: "
        f"indices equal at "
        f"SA1-4/FP1-4; loss card {loss_card:.7f} cpu {loss_cpu:.7f} card-plain {loss_plain:.7f}; "
        f"{held['summary']}; first step card {t_card:.2f} s, cpu {t_cpu:.2f} s, "
        f"f64 {t_64:.2f} s; launches in the card's step {json.dumps(launches)}"
        + (f"; exactly-zero gradients beyond the BN-fed biases: {res['exact_zero']}"
           if zero_below is not None else ""))
    return res


def train_batches(scenes, batch: int, npoints: int, count: int):
    """``count`` training batches of random chunks, made on the host, and
    the seconds that took."""
    rng = np.random.RandomState(11)
    t0 = time.perf_counter()
    batches = [_train_batch(scenes, rng, batch, npoints) for _ in range(count)]
    return batches, time.perf_counter() - t0


def phase_train(dev, batches, steps: int, warmup: int, name: str = "sem_seg_features",
                tag: str = "train", **kwargs) -> dict:
    """``steps`` timed training steps of registry model ``name`` (``kwargs``
    to the registry) on fresh batches (xyz only where the model takes no
    features), after ``warmup`` steps, then five steps on one batch.  Launch
    counters cover the timed steps only: all seven kernels must launch
    there."""
    model = models.seeded_model(name, seed=0, device=dev, **kwargs)
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

# ---- the zero-precompute path: the sampler, remat, the recipe ------------------------


def sampler_work(scenes, batch: int, npoints: int) -> float:
    """Bytes one ``sample_chunk_batch`` call must move: every try's stripe
    (points, labels and run starts, 20 B a row), each sample's x-cell window
    once, the kept stripe's points again, and the chunk out (points, labels,
    weights, features)."""
    stripes = batch * device_sampler.MAX_TRIES * scenes.sub_len * 20
    windows = batch * scenes.max_len * 4
    chunk = batch * npoints * (12 + 4 + 4 + 4 * 6 + 3 + 12)
    return float(stripes + windows + batch * scenes.sub_len * 12 + chunk)


def phase_sampler(dev, rooms, batch: int, npoints: int, reps: int) -> dict:
    """``ResidentScenes`` of ``rooms`` on the card and on the CPU; one
    ``sample_chunk_batch`` at B x npoints with the same ``draws`` (made on
    the CPU) on both, for ``occupancy`` 'fast' and 'exact', ``with_box``:
    points, labels, weights, features (colors divided correctly rounded on
    both) and the kept box bit-identical.  Times the card's call (CUDA
    events) and the CPU's, beside the call's byte bound."""
    t0 = time.perf_counter()
    card = device_sampler.ResidentScenes(rooms, device=dev)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    cpu = device_sampler.ResidentScenes(rooms, device="cpu")
    ids = (torch.arange(batch) % len(rooms)).to(torch.int32)
    draws = device_sampler.make_draws(cpu, ids, npoints, torch.Generator().manual_seed(5))
    ids_dev, draws_dev = ids.to(dev), tuple(d.to(dev) for d in draws)
    nbytes = sampler_work(card, batch, npoints)
    res = dict(rooms=len(rooms), points=int(card.lengths.sum()), max_len=card.max_len,
               sub_len=card.sub_len, batch=batch, npoints=npoints, upload_s=t_upload,
               bytes=nbytes, bound_ms=bound(nbytes, 0.0)[0])
    for occ in ("fast", "exact"):
        got = device_sampler.sample_chunk_batch(card, ids_dev, draws_dev, npoints,
                                                occupancy=occ, with_box=True)
        t0 = time.perf_counter()
        want = device_sampler.sample_chunk_batch(cpu, ids, draws, npoints, occupancy=occ,
                                                 with_box=True)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        for k in want:
            check_equal(f"sampler {occ} {k}", got[k], want[k])
        res[occ] = dict(ok=int(want["chunk_ok"].sum()), cpu_ms=cpu_ms, ms=time_ms(
            functools.partial(device_sampler.sample_chunk_batch, card, ids_dev, draws_dev,
                              npoints, occupancy=occ), reps, burst=1))
    log(f"[sampler] {len(rooms)} rooms, {res['points']} points on the card in "
        f"{t_upload:.2f} s (max_len {card.max_len}, sub_len {card.sub_len}); B{batch} x "
        f"{npoints} chunks with the same draws equal the CPU's bit for bit (fast: "
        f"{res['fast']['ok']}/{batch} valid, exact: {res['exact']['ok']}/{batch}); "
        f"sample_chunk_batch fast {res['fast']['ms']:.3f} ms, exact {res['exact']['ms']:.3f} "
        f"ms on the card (CUDA events; CPU {res['fast']['cpu_ms']:.1f} / "
        f"{res['exact']['cpu_ms']:.1f} ms); bound {res['bound_ms']:.4f} ms "
        f"({nbytes / 1e6:.1f} MB)")
    # For the device-times phase: the fast call's device-only time.
    res["call"] = functools.partial(device_sampler.sample_chunk_batch, card, ids_dev, draws_dev,
                                    npoints)
    return res


def _step_state(model, dev, batch: dict, remat: str, seed: int):
    """One ``seg_train_step`` of a copy of ``model`` on ``dev``: (the state,
    loss, gradients, parameters and BN statistics on the CPU)."""
    state = TrainState(copy.deepcopy(model).to(dev))
    _, m = seg_train_step(state, batch, seed, remat=remat)
    grads = {k: p.grad.detach().cpu().clone() for k, p in state.model.named_parameters()}
    params = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
    stats = {k: v.detach().cpu().clone() for k, v in state.model.named_buffers()}
    return state, float(m["loss"]), grads, params, stats


def phase_remat(dev, batches, reps: int) -> dict:
    """One B16 x 8192 ``seg_train_step`` of the flagship from the same
    seeded weights and batch, dropout on with one seed, with ``remat``
    'none', 'dots' and 'full': loss, gradients, new parameters and BN
    statistics of 'dots' and 'full' against 'none' within
    ``phase_train_parity``'s card limits (gradients and parameters rtol
    1e-3, atol 1e-5 x max|g|; BN rtol 1e-4, atol 1e-5), and whether they
    are bit-identical.  Then ``reps`` timed steps each on fresh batches
    (CUDA events, after one warm-up step): median step and peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = models.seeded_model("sem_seg_features", seed=0, device="cpu")
    if model.dp1.rate != 0.5:
        raise AssertionError("remat phase: dropout is not on")
    res = {}
    for remat in ("none", "dots", "full"):
        state, loss, g, p, bn = _step_state(model, dev, batches[0], remat, 7)
        if remat == "none":
            loss0, g0, p0, bn0 = loss, g, p, bn
        same = (loss == loss0 and all(torch.equal(g[k], g0[k]) for k in g0)
                and all(torch.equal(p[k], p0[k]) for k in p0)
                and all(torch.equal(bn[k], bn0[k]) for k in bn0))
        if not same:
            np.testing.assert_allclose(loss, loss0, rtol=1e-6, err_msg=f"remat {remat} loss")
            for k in g0:
                scale = float(g0[k].abs().max())
                check_close(f"remat {remat} grad {k}", g[k], g0[k],
                            dict(rtol=1e-3, atol=1e-5 * scale))
                check_close(f"remat {remat} param {k}", p[k], p0[k],
                            dict(rtol=1e-3, atol=1e-5 * max(scale, 1e-30)))
            for k in bn0:
                check_close(f"remat {remat} BN {k}", bn[k], bn0[k], dict(rtol=1e-4, atol=1e-5))
        seg_train_step(state, batches[1], 7, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = []
        for b in batches[2:2 + reps]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            seg_train_step(state, b, 7, remat=remat)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in events]
        res[remat] = dict(loss=loss, bit_identical_to_none=same, step_ms=step_ms,
                          step_ms_median=float(np.median(step_ms)),
                          peak_bytes=torch.cuda.max_memory_allocated())
        del state
        log(f"[remat] {remat}: B16 x 8192 step, dropout on: loss {loss:.7f}, "
            f"{'bit-identical to' if same else 'within the limits of'} 'none' (loss, gradients, "
            f"new parameters, BN statistics); median step {res[remat]['step_ms_median']:.3f} "
            f"ms over {reps} (CUDA events), max_memory_allocated "
            f"{res[remat]['peak_bytes'] / 2**20:.1f} MiB")
    return res


def phase_recipe(dev, epochs: int = 100) -> dict:
    """``run_zero_precompute`` on the card at the size of the JAX package's
    ``RESULTS_zero_precompute.json`` (8 train + 2 val rooms of 16k points,
    B4 x 2048, ``epochs`` epochs): the offline mIoU beside JAX's 0.795 and
    the trainer's median points/s.  The random streams differ from JAX's, so
    the mIoU is reported, not held; every logged loss must be finite."""
    work = tempfile.mkdtemp(prefix=".recipe_smoke_", dir=ROOT)
    try:
        t0 = time.perf_counter()
        out = run_zero_precompute(work, epochs=epochs, device=dev)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    curve = [r["loss"] for r in out["loss_curve"]]
    if not np.all(np.isfinite(curve + [out["final_loss"]])) or not np.isfinite(
            out["offline_mean_iou"]):
        raise AssertionError(f"recipe zero_precompute: non-finite result {out}")
    out["wall_s"] = wall
    log(f"[recipe] zero_precompute, {epochs} epochs of 2 steps (B4 x 2048, 8 + 2 rooms of "
        f"16k points) in {wall:.1f} s: offline mIoU {out['offline_mean_iou']:.4f} (JAX "
        f"RESULTS_zero_precompute.json: 0.795), best val mIoU {out['best_val_miou']:.4f}, "
        f"final loss {out['final_loss']:.4f}, median {out['median_points_per_sec']:.0f} "
        f"points/s")
    return out

# ---- the trainer entry point, end to end -------------------------------------------

# The resident run reads the q16 store's rows on the card; with the same
# wire_format as the packed run its validation reads the same batches too.
# The sampler run reads the raw rooms of the store, no precomputed chunk.
TRAINER_RUNS = (("npz", dict(input="npz")),
                ("packed_q16", dict(input="packed", wire_format="packed_q16")),
                ("resident", dict(input="resident", wire_format="packed_q16")),
                ("sampler", dict(input="sampler")))


@contextlib.contextmanager
def timed_train_steps(events: list, host_ms: list, rows: list, sampled: list):
    """CUDA events around every ``seg_train_step`` that ``trainer.train``
    calls, appended to ``events``, and the host milliseconds each call took
    to queue its work, appended to ``host_ms`` (no host sync is added).
    ``rows`` gets each step's packed rows: a packed batch's own, or for the
    resident corpus the (corpus, index) pair its rows are gathered by.
    ``sampled`` gets CUDA events around each ``sample_chunk_batch`` call of
    the sampler input."""
    inner, gather = train_steps.seg_train_step, device_replay.gather_batch
    sample = device_sampler.sample_chunk_batch

    def timed(state, batch, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        if "packed" in batch:
            rows.append(batch["packed"])
        out = inner(state, batch, *args, **kwargs)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        return out

    def gathered(corpus, idx, spec):
        rows.append((corpus, idx.clone()))
        return gather(corpus, idx, spec)

    def sampling(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sample(*args, **kwargs)
        end.record()
        sampled.append((start, end))
        return out

    train_steps.seg_train_step, device_replay.gather_batch = timed, gathered
    device_sampler.sample_chunk_batch = sampling
    try:
        yield
    finally:
        train_steps.seg_train_step, device_replay.gather_batch = inner, gather
        device_sampler.sample_chunk_batch = sample


def _host_rows(rows: list) -> list:
    """Each step's packed rows as numpy, gathering the resident ones now."""
    return [np.asarray(r) if not isinstance(r, tuple)
            else r[0][r[1].to(r[0].device).long()].cpu().numpy() for r in rows]


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
    rows: list = []
    sampled: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with timed_train_steps(events, host_ms, rows, sampled):
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
    sample_ms = [a.elapsed_time(b) for a, b in sampled]
    if cfg.input == "sampler" and len(sample_ms) != expect_steps:
        raise AssertionError(f"trainer {tag}: {len(sample_ms)} sampler calls in "
                             f"{expect_steps} steps")
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
        best_checkpoint=best and os.path.basename(best), step_rows=rows)
    if sample_ms:
        res.update(sampler_ms=sample_ms, sampler_ms_median=float(np.median(sample_ms)),
                   sampler_share_median=float(np.median(
                       [a / (a + b) for a, b in zip(sample_ms, step_ms)])))
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
        + (f"; {os.path.basename(best)} restores bit for bit" if vals else "")
        + (f"; sample_chunk_batch median {res['sampler_ms_median']:.3f} ms (CUDA events), "
           f"{res['sampler_share_median']:.3f} of sampler + step" if sample_ms else ""))
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
      ``input='packed'`` with ``wire_format='packed_q16'`` (``_train_run``),
      and ``input='resident'`` and ``'sampler'`` (``TRAINER_RUNS``), and the
      sampler once more with ``compute_dtype='bfloat16'``; then the four
      again for ``steady_epochs`` epochs without validation, the rate once
      the prefetch queue has drained;
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
        # The sampler run points at a precompute directory that must never appear.
        no_pre = os.path.join(work, "sampler_precomputed")

        def run_config(over: dict, **kw) -> TrainConfig:
            cfg = {**base, **over, **kw}
            if over["input"] == "sampler":
                cfg["precompute_dir"] = no_pre
            return TrainConfig(**cfg)

        steps = epochs * (n_train // batch)
        runs, cfgs = {}, {}
        for tag, over in TRAINER_RUNS:
            cfgs[tag] = run_config(over, log_dir=os.path.join(work, "logs_" + tag))
            runs[tag] = _train_run(dev, cfgs[tag], tag, steps)
        # Mixed precision through the entry point: bf16 products, float32
        # parameters; its best checkpoint restores into a bf16 template.
        runs["sampler_bf16"] = _train_run(
            dev, run_config(dict(input="sampler"), compute_dtype="bfloat16",
                            log_dir=os.path.join(work, "logs_sampler_bf16")),
            "sampler_bf16", steps)
        runs["sampler_bf16"].pop("step_rows")
        # The resident run trains on the packed run's rows, step for step.
        packed_rows = _host_rows(runs["packed_q16"].pop("step_rows"))
        resident_rows = _host_rows(runs["resident"].pop("step_rows"))
        runs["npz"].pop("step_rows")
        runs["sampler"].pop("step_rows")
        if len(resident_rows) != steps or len(packed_rows) != steps or any(
                a.tobytes() != b.tobytes() for a, b in zip(packed_rows, resident_rows)):
            raise AssertionError("trainer resident: the gathered rows differ from the "
                                 "packed_q16 run's")
        log(f"[trainer] resident: the rows gathered on the card equal the packed_q16 run's "
            f"at each of the {steps} steps, byte for byte")
        # The same replays past the prefetch queue's depth (4 batches, which
        # validation refills between the short epochs above): no validation,
        # no checkpoints, steady_epochs epochs.
        steady = {}
        for tag, over in TRAINER_RUNS:
            cfg = run_config(over, epochs=steady_epochs, n_epochs_to_val=10**6,
                             save_every_epochs=0, log_dir=os.path.join(work, "steady_" + tag))
            steady[tag] = _train_run(dev, cfg, tag + " steady",
                                     steady_epochs * (n_train // batch))
            steady[tag].pop("step_rows")
        if os.path.exists(no_pre):
            raise AssertionError(f"trainer sampler: a precompute directory appeared: {no_pre}")
        log("[trainer] sampler: no precompute directory appeared; rate against the others, "
            "validated / steady median points/s: " + "; ".join(
                f"{tag} {np.median(runs[tag]['points_per_s']):.0f} / "
                f"{np.median(steady[tag]['points_per_s']):.0f}" for tag, _ in TRAINER_RUNS))

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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident = list(resident_serving.generate_predictions_resident(
            model, root, names, os.path.join(out, "resident"), npoints=npoints,
            batch_size=batch, device=dev))
        wall = time.perf_counter() - t0
        n_res = sum(len(r["predictions"]) for r in resident)
        serve_resident = dict(points=n_res, wall_s=wall, points_per_s=n_res / wall)
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
        if [r["scene_name"] for r in resident] != list(names):
            raise AssertionError("generate_predictions_resident served other scenes")
        scores_res = benchmark.evaluate(
            [os.path.join(out, "resident", f"{n}.txt") for n in names], gt_files,
            os.path.join(out, "results_resident.txt"))
        direct_res = nyu40_miou([r["predictions"] for r in resident],
                                [r["labels"] for r in resident])
        if not abs(scores_res["mean_iou"] - direct_res) <= 1e-12 * max(1.0, abs(direct_res)):
            raise AssertionError(f"evaluate mean_iou {scores_res['mean_iou']} of the resident "
                                 f"predictions != in-memory {direct_res}")

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
        serving = dict(f32=serve, packed_f32=serve_packed, packed_q16=serve_q16,
                       resident_q16=serve_resident)
        for tag, sv in serving.items():
            log(f"[trainer] serve {tag}: {sv['points']} val points in {sv['wall_s']:.3f} s, "
                f"{sv['points_per_s']:.0f} points/s")
        log(f"[trainer] packed-f32 labels equal the f32 path on the same values; agreement "
            f"with plain f32: packed f32 {' '.join(f'{v:.6f}' for v in agree_packed)}, "
            f"packed q16 {' '.join(f'{v:.6f}' for v in agree_q16)}; benchmark.evaluate "
            f"mean_iou {scores['mean_iou']:.6f} = in-memory {direct:.6f} (resident "
            f"{scores_res['mean_iou']:.6f} = {direct_res:.6f}); card vs CPU on "
            f"{int(keep.sum())} points of {names[0]}: {agree_cpu:.6f} (CPU {t_cpu:.1f} s)")
        return dict(seconds=secs, rooms=dict(train=n_train, val=n_val, points=scene_points),
                    host_batch_ms=host_ms, runs=runs, steady_runs=steady, serving=serving, agreement_packed_f32=agree_packed,
                    agreement_packed_q16=agree_q16, mean_iou=scores["mean_iou"],
                    mean_iou_direct=direct, mean_iou_resident=scores_res["mean_iou"],
                    cpu_points=int(keep.sum()),
                    cpu_agreement=agree_cpu)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- the PointNet++ classification and part-segmentation families ----------------

# Registry name -> points a cloud: ModelNet40 (40 classes, xyz only) and
# ShapeNet-part (50 parts of 16 categories, xyz + normals), at full width.
FAMILY_N = {"cls_ssg": 1024, "cls_msg": 1024, "part_seg": 2048, "part_seg_msg_one_hot": 2048}
# The JAX package's RESULTS_family_convergence.json: (metric, value, epochs,
# run_*_convergence arguments); cls_msg ran with normals (its extended arm).
FAMILY_RECIPES = {
    "cls_ssg": ("best_accuracy", 0.75, 60, {}),
    "cls_msg": ("best_accuracy", 1.0, 40, {"normal_channel": True}),
    "part_seg": ("best_class_avg_iou", 0.8050232456467462, 40, {}),
    "part_seg_msg_one_hot": ("best_class_avg_iou", 0.8890057979367574, 40, {}),
}


# run_partseg_convergence's points a shape at its defaults.
FAMILY_RECIPE_PARTSEG_N = inspect.signature(run_partseg_convergence).parameters[
    "n_points"].default


def family_batch(name: str, b: int, seed: int) -> dict:
    """A batch as the family's trainer feeds it: unit-sphere-normalised
    synthetic ModelNet shapes (``data/modelnet.py``), xyz only with a
    class label for the classifiers, xyz + normals with per-point part
    labels (and a category for the one-hot model) for the part segmenters."""
    rng = np.random.RandomState(seed)
    n = FAMILY_N[name]
    clouds = np.stack([modelnet._synthetic_shape(int(rng.randint(40)), seed * 100 + i, n)
                       for i in range(b)])
    clouds[..., :3] = np.stack([modelnet.pc_normalize(c[:, :3]) for c in clouds])
    if name.startswith("cls"):
        return {"points": np.ascontiguousarray(clouds[..., :3]),
                "labels": rng.randint(0, 40, b).astype(np.int32)}
    batch = {"points": clouds.astype(np.float32),
             "labels": rng.randint(0, 50, (b, n)).astype(np.int32)}
    if name == "part_seg_msg_one_hot":
        batch["cls"] = rng.randint(0, 16, b).astype(np.int32)
    return batch


def _family_step(name: str):
    return cls_steps.cls_train_step if name.startswith("cls") else cls_steps.partseg_train_step


def _family_args(name: str, batch: dict, dev, dtype=torch.float32) -> tuple:
    """The model's positional inputs for ``batch`` on ``dev``."""
    pts = torch.from_numpy(batch["points"]).to(dev, dtype)
    if name.startswith("cls"):
        return (pts,)
    if "cls" in batch:
        return pts, torch.from_numpy(batch["cls"]).to(dev)
    return (pts,)


def _family_levels(model):
    """Hooks capturing the centres of SA1 and SA2 (FPS)."""
    levels, hooks = {}, []
    for i in (1, 2):
        def hook(mod, args, out, i=i):
            levels[i] = out[0].detach().cpu()
        hooks.append(getattr(model, f"sa{i}").register_forward_hook(hook))
    return levels, hooks


def phase_family_model(dev, batch: int) -> dict:
    """The four family models with seeded weights and BN statistics, B16 at
    full width (cls 1024 xyz only, part-seg 2048 with normals), eval forward
    on the card and on CPU copies, TF32 off: SA1 and SA2 centres equal,
    logits within LOGIT_TOL.  Launches of each kernel in one forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in FAMILY_N:
        cpu_model = models.seeded_model(name, seed=0, device="cpu").eval()
        dev_model = copy.deepcopy(cpu_model).to(dev)
        data = family_batch(name, batch, seed=1)
        dev_levels, h1 = _family_levels(dev_model)
        cpu_levels, h2 = _family_levels(cpu_model)
        kernels.reset_launches()
        with torch.no_grad():
            got = dev_model(*_family_args(name, data, dev)).cpu()
        launches = kernels.launch_counts()
        with torch.no_grad():
            want = cpu_model(*_family_args(name, data, "cpu"))
        for h in h1 + h2:
            h.remove()
        for i in (1, 2):
            check_equal(f"family-model {name} SA{i} centres", dev_levels[i], cpu_levels[i])
        shape = (batch, 40) if name.startswith("cls") else (batch, FAMILY_N[name], 50)
        if tuple(got.shape) != shape or not torch.isfinite(got).all():
            raise AssertionError(f"family-model {name} logits bad: shape {tuple(got.shape)}")
        e = check_close(f"family-model {name} logits", got, want, LOGIT_TOL)
        want_kernels = FORWARD_KERNELS if name.startswith("part") else (
            "fps", "ball_query", "group_gather")
        missing = [k for k in want_kernels if launches[k] == 0]
        if missing or any(launches[k] for k in BACKWARD_KERNELS):
            raise AssertionError(f"family-model {name} forward launches {launches}")
        out[name] = dict(max_abs_err=e, launches=launches)
        log(f"[family-model] {name} B{batch} x {FAMILY_N[name]}: SA1-2 centres equal; logits "
            f"max |card - cpu| = {e:.3e} (tol {LOGIT_TOL}); launches a forward "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
    return out


def phase_family_train_parity(dev, batch: int = 2) -> dict:
    """One ``cls_train_step`` of ``cls_msg`` (B2 x 1024, xyz only) and one
    ``partseg_train_step`` of ``part_seg_msg_one_hot`` (B2 x 2048, normals
    and categories), dropout and TF32 off, from the same seeded weights and
    batch: on the card, on the card through the plain ops, on the CPU and
    in float64 on the CPU, held by ``hold_step`` to ``phase_train_parity``'s
    limits, SA1-2 centres equal.  The exactly-zero gradients are the biases
    feeding a train-mode BN and every element whose float64 gradient is
    below 1e-9 of the largest (the last BN bias of the group-all SA and of
    the MSG branches, on the channels whose max-pooled values are positive
    everywhere: a shift uniform over every point of every cloud, which the
    next train-mode BN removes); their float32 noise is held below 1e-4 of
    the largest gradient (a sum over B x npoint x nsample terms; the CPU
    tests measured up to 1.5e-5).  All seven kernels must launch in the
    part-seg step on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for name in ("cls_msg", "part_seg_msg_one_hot"):
        tag = f"family-train-parity {name}"
        step = _family_step(name)
        base = models.seeded_model(name, seed=0, device="cpu", dropout_rate=0.0)
        data = family_batch(name, batch, seed=2)
        card, on_plain, ref64 = (copy.deepcopy(base).to(dev), copy.deepcopy(base).to(dev),
                                 copy.deepcopy(base).double())
        card_levels, h1 = _family_levels(card)
        cpu_levels, h2 = _family_levels(base)
        kernels.reset_launches()
        on_card = _one_step(card, data, step)
        launches = kernels.launch_counts()
        on_cpu = _one_step(base, data, step)
        for h in h1 + h2:
            h.remove()
        for i in (1, 2):
            check_equal(f"{tag} SA{i} centres", card_levels[i], cpu_levels[i])
        with plain_ops():
            loss_plain, g_plain, _ = _one_step(on_plain, data, step)
        ref64.train()
        logits = ref64(*_family_args(name, data, "cpu", torch.float64),
                       bn_momentum=schedules.upstream_bn_momentum(0))
        losses.softmax_cross_entropy(logits, torch.from_numpy(data["labels"])).mean().backward()
        g64 = {k: p.grad.detach() for k, p in ref64.named_parameters()}
        bn64 = {k: v.detach() for k, v in ref64.named_buffers()}
        g64_max = max(float(g.abs().max()) for g in g64.values())
        zeros = {k: g.abs() < 1e-9 * g64_max for k, g in g64.items()}
        noise = _noise_biases(base) | {k for k, z in zeros.items() if bool(z.all())}
        held = hold_step(tag, on_card, on_cpu, (loss_plain, g_plain), (g64, bn64), noise,
                         noise_tol=1e-4, zeros=zeros)
        if name.startswith("part"):
            missing = [k for k in KERNEL_INFO if launches[k] == 0]
            if missing:
                raise AssertionError(f"{tag}: the step never launched {missing}")
        partial = {k: int(z.sum()) for k, z in zeros.items() if k not in noise and bool(z.any())}
        res[name] = dict(held, launches=launches, exact_zero=sorted(noise - _noise_biases(base)),
                         exact_zero_elements=partial)
        log(f"[{tag}] B{batch} x {FAMILY_N[name]}, dropout and TF32 off: SA1-2 centres equal; "
            f"{held['summary']}; exactly-zero gradients beyond the BN-fed biases: "
            f"{res[name]['exact_zero']}, and elements of {json.dumps(partial)}; launches "
            f"{json.dumps(launches)}")
    return res


def phase_family_train(dev, batch: int, steps: int, warmup: int) -> dict:
    """``steps`` timed B16 training steps of each family model at full width,
    after ``warmup``, on fresh host-made batches: median step (CUDA events),
    points/s, peak memory, each kernel's launches a step; every loss
    finite."""
    out = {}
    for name in FAMILY_N:
        model = models.seeded_model(name, seed=0, device=dev)
        state = TrainState(model, schedules.upstream_learning_rate)
        step = _family_step(name)
        data = [family_batch(name, batch, seed=10 + i) for i in range(warmup + steps)]
        for d in data[:warmup]:
            step(state, d)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        events, step_losses = [], []
        for d in data[warmup:]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _, m = step(state, d)
            end.record()
            events.append((start, end))
            step_losses.append(m["loss"])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        step_losses = [float(v) for v in step_losses]
        if not all(np.isfinite(step_losses)):
            raise AssertionError(f"family-train {name}: non-finite loss {step_losses}")
        want = KERNEL_INFO if name.startswith("part") else (
            "fps", "ball_query", "group_gather", "group_gather_bwd")
        missing = [k for k in want if launches[k] == 0]
        if missing:
            raise AssertionError(f"family-train {name} never launched {missing}")
        step_ms = [s.elapsed_time(e) for s, e in events]
        med = float(np.median(step_ms))
        n = FAMILY_N[name]
        out[name] = dict(batch=batch, npoints=n, steps=steps, step_ms_median=med,
                         step_ms=step_ms, points_per_s=batch * n / (med / 1e3),
                         peak_bytes=peak, launches_per_step={k: v / steps
                                                             for k, v in launches.items()},
                         losses=step_losses)
        log(f"[family-train] {name} B{batch} x {n}: median step {med:.3f} ms "
            f"({out[name]['points_per_s']:.0f} points/s) over {steps} steps after {warmup}; "
            f"max_memory_allocated {peak / 2**20:.1f} MiB; losses {step_losses[0]:.3f} .. "
            f"{step_losses[-1]:.3f}; launches a step "
            f"{json.dumps({k: v for k, v in out[name]['launches_per_step'].items() if v})}")
        del model, state
    return out


def phase_family_recipe(dev) -> dict:
    """``run_cls_convergence`` (cls_ssg, cls_msg with normals) and
    ``run_partseg_convergence`` (part_seg, part_seg_msg_one_hot) on the card
    at the sizes of the JAX package's ``RESULTS_family_convergence.json``
    (their defaults; 60 epochs for cls_ssg, 40 for the others): the best
    accuracy / class-average IoU beside JAX's.  The random streams differ,
    so they are reported, not held; the step count must be JAX's."""
    jax_steps = {"cls_ssg": 300, "cls_msg": 200, "part_seg": 160, "part_seg_msg_one_hot": 160}
    work = tempfile.mkdtemp(prefix=".recipe_smoke_", dir=ROOT)
    out = {}
    try:
        for name, (metric, jax_value, epochs, kw) in FAMILY_RECIPES.items():
            run = run_cls_convergence if name.startswith("cls") else run_partseg_convergence
            t0 = time.perf_counter()
            summary = run(work, name, epochs=epochs, device=dev, **kw)
            wall = time.perf_counter() - t0
            if summary["steps"] != jax_steps[name] or not np.isfinite(summary[metric]):
                raise AssertionError(f"family-recipe {name}: {summary}")
            out[name] = dict(summary, wall_s=wall, jax=jax_value)
            log(f"[family-recipe] {name}: {metric} {summary[metric]:.4f} (JAX "
                f"RESULTS_family_convergence.json: {jax_value:.4f}) after {summary['steps']} "
                f"steps, {epochs} epochs, in {wall:.1f} s")
        out["part_seg_ply_dump"] = check_partseg_ply_dump(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def check_partseg_ply_dump(dev, work: str, batch: int = 4) -> dict:
    """``evaluate_part_segmentation(..., ply_dir=)`` with the trained
    ``part_seg`` of the family recipe (its best checkpoint, on the card) over
    the recipe's test shapes, one vote: one PLY a shape, named
    ``shape{index:05d}_{category}.ply``, whose points and colors, read back
    by ``viz.read_ply``, are each shape's points and ``colorize_labels`` of
    the category-restricted argmax of the logits the card returned."""
    roots = glob.glob(os.path.join(work, "shapenet_synth_*"))
    if len(roots) != 1:
        raise AssertionError(f"family-recipe: expected one ShapeNet-part store, found {roots}")
    ckpt = best_checkpoint(os.path.join(work, "partseg_part_seg", "checkpoints"), prefix="best")
    state = TrainState(models.get_model("part_seg", device=dev,
                                        generator=torch.Generator().manual_seed(0)))
    restore_checkpoint(ckpt, state)
    calls = []

    def predict_fn(pts):
        logits = cls_steps.partseg_eval_step(state, {"points": pts})["logits"].cpu().numpy()
        calls.append((pts, logits))
        return logits

    ds = PartNormalDataset(roots[0], npoints=FAMILY_RECIPE_PARTSEG_N, split="test", seed=0)
    ply_dir = os.path.join(work, "part_seg_ply")
    t0 = time.perf_counter()
    result = evaluate_part_segmentation(predict_fn, ds, batch_size=batch, num_votes=1,
                                        ply_dir=ply_dir)
    wall = time.perf_counter() - t0
    files = sorted(os.listdir(ply_dir))
    if len(files) != len(ds) or not np.isfinite(result["class_avg_iou"]):
        raise AssertionError(f"part-seg PLY dump: {len(files)} files for {len(ds)} shapes, "
                             f"{result}")
    # One vote feeds each batch once, permuted by RandomState(0): undo it.
    inv = np.argsort(np.random.RandomState(0).permutation(FAMILY_RECIPE_PARTSEG_N))
    for k, name in enumerate(files):
        cat = name[len(f"shape{k:05d}_"):-len(".ply")]
        if not name.startswith(f"shape{k:05d}_") or cat not in ds.classes:
            raise AssertionError(f"part-seg PLY dump: file {k} is {name}")
        pts, logits = calls[k // batch]
        xyz, rgb = read_ply(os.path.join(ply_dir, name))
        want = colorize_labels(restrict_logits_to_category(logits[k % batch][inv], cat))
        if not (np.array_equal(xyz, pts[k % batch][inv, :3]) and np.array_equal(rgb, want)):
            raise AssertionError(f"part-seg PLY dump: {name} differs from its shape's "
                                 "points or restricted argmax")
    log(f"[family-recipe] evaluate_part_segmentation(ply_dir=) with the trained part_seg on "
        f"the card: {len(files)} PLYs, one a test shape, each read back equal to its points "
        f"and restricted-argmax colors; class-average IoU {result['class_avg_iou']:.4f}, "
        f"{wall:.2f} s")
    return {"files": len(files), "class_avg_iou": result["class_avg_iou"], "wall_s": wall}


# ---- the full attention nets and the PointNet v1 family ------------------------------

# The JAX package's RESULTS_family_convergence.json for the arms this slice
# ports: (metric, value, its step count).
ATTNET_RECIPES = {
    "attention_net": ("best_val_miou", 0.6568825085572408, 200),
    "pointnet1_cls": ("best_accuracy", 0.875, 300),
    "pointnet1_seg": ("best_class_avg_iou", 0.8084881168514733, 160),
    "pointnet1_sem_seg": ("best_miou", 0.2546187646522981, 300),
}
# A float32 PointNet v1 step's gradients against float64: the CPU tests
# measured up to 1.4e-2 (JAX and the port alike, the joint model); on an H100
# the card's pointnet1_cls step lay 8.8e-3 away where the CPU's lay 3.3e-3
# (PERF.md, Findings).  No port kernel runs in these models.
V1_F64_FLOOR = 2e-2
# The PointNet v1 models at the reference's sizes: points a cloud, channels.
V1_SIZES = {"pointnet1_cls_basic": (1024, 3), "pointnet1_cls": (1024, 3),
            "pointnet1_seg": (2048, 3), "pointnet1_part_seg": (2048, 3),
            "pointnet1_sem_seg": (4096, 9)}


def phase_attention_net_train_parity(dev, scenes, n: int) -> dict:
    """Phase 5 for ``attention_net`` with colors and normals, from the
    trainer's initial weights: at random weights each attention level
    shrinks its features ~100x (to ~4e-8 at SA4) and the FP head's
    train-mode BNs scale them back up, so seeded BN biases would put a
    constant under those signals whose float32 rounding the BNs magnify
    (``tests/test_torch_attention_net_train.py``).  Exactly-zero gradients
    beyond the BN-fed biases (a shift that a train-mode BN removes, the
    attention pool's key bias that the softmax cancels, and the deep levels'
    query and key projections at these weights) are those below 1e-6 of the
    largest in the float64 run, whose own rounding the BNs magnify to ~1e-7;
    they are held below 1e-4 of the largest gradient.  The card's kernels
    are held to the card's plain ops per tensor in relative L2 within 1e-2:
    the two backwards sum in another order (the plain gather's scatter in no
    fixed order), and some gradients are sums over 10^4-10^5 rows that
    cancel to ~1e-3 of their terms, so single elements move by up to 2.9e-3
    (``l3.inner0.feed_forward.layer_4.bias`` on an H100; PERF.md) where
    the flagship's move by 2e-6."""
    return phase_train_parity(dev, scenes, n, name="attention_net",
                              tag="attention-net-train-parity", init_weights=True,
                              zero_below=1e-6, kernel_rel=1e-2,
                              in_features=ATTNET_FEATURES)


def phase_attention_net_serve(model, dev, scene_points: int, n_scenes: int, npoints: int,
                              batch: int) -> dict:
    """``ResidentSceneServer`` (q16, pipeline depth 2) with ``attention_net``
    over synthetic rooms after one warm-up room: launch counters zeroed just
    before the window and read just after (all five forward kernels, no
    backward), points/s and ms a room.  On one room, the f32 server's labels
    against the host path (``predict_scene_chunks`` fed the same chunks):
    >= 99.9 % equal; the q16 window's labels against them, reported."""
    scenes = [dict(make_synthetic_scene(scene_points, seed=100 + s), scene_name=f"room{s}")
              for s in range(n_scenes + 1)]
    server = resident_serving.ResidentSceneServer(model, npoints, batch_size=batch,
                                                  layout="q16", pipeline_depth=2, device=dev)
    server.predict_scene(scenes[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    served = dict(server.predict_scenes(iter(scenes[1:])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing or any(launches[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"attention-net-serve launches {launches}")
    room = scenes[1]
    n = len(room["points"])
    f32 = resident_serving.ResidentSceneServer(model, npoints, batch_size=batch, layout="f32",
                                               device=dev).predict_scene(room)
    twin = resident_serving.deterministic_scene_chunks(
        room["points"], [room["colors"], room["normals"]], npoints)
    host_scene = dict(points=twin.points, colors=twin.features[0],
                      normals=twin.features[1].astype(np.float32), masks=twin.masks,
                      orig_idx=twin.orig_idx, num_vertices=n)
    host = predict_scene_chunks(make_predict_fn(model, device=dev), host_scene, True, True, batch)
    agree = float((f32 == host).mean())
    if agree < 0.999:
        raise AssertionError(f"attention-net-serve: f32 labels agree with the host path on "
                             f"only {agree:.4%}")
    q16_agree = float((served[room["scene_name"]] == host).mean())
    n_points = sum(len(sc["points"]) for sc in scenes[1:])
    res = dict(model="attention_net", scenes=n_scenes, points=n_points, wall_s=wall,
               points_per_s=n_points / wall, ms_per_room=wall * 1e3 / n_scenes,
               peak_bytes=peak, launches=launches, f32_vs_host=agree, q16_vs_host=q16_agree)
    log(f"[attention-net-serve] attention_net, {n_scenes} rooms of {scene_points} points "
        f"through ResidentSceneServer q16 B{batch}: {res['points_per_s']:.0f} points/s, "
        f"{res['ms_per_room']:.2f} ms a room; max_memory_allocated {peak / 2**20:.1f} MiB; f32 "
        f"labels vs the host path on the same chunks {agree:.6f} (>= 0.999), q16 vs host "
        f"{q16_agree:.6f}; launches {json.dumps(launches)}")
    return res


def _v1_inputs(name: str, b: int, dev, seed: int, dtype=torch.float32) -> tuple:
    """The v1 model's positional inputs: a synthetic ModelNet shape batch
    (unit sphere), S3DIS's nine channels for the sem-seg model, and the
    object class one-hot for the joint part segmenter."""
    rng = np.random.RandomState(seed)
    n, c = V1_SIZES[name]
    if c == 9:
        room = s3dis.make_synthetic_room(6 * n, seed=seed)
        pts = s3dis.room_to_blocks_normalized(room, n, rng=rng)[0][:b]
        pts = np.concatenate([pts] * -(-b // len(pts)))[:b]
    else:
        pts = np.stack([modelnet.pc_normalize(modelnet._synthetic_shape(
            int(rng.randint(40)), seed * 100 + i, n)[:, :3]) for i in range(b)])
    args = (torch.from_numpy(pts.astype(np.float32)).to(dev, dtype),)
    if name == "pointnet1_part_seg":
        args += (torch.eye(16, dtype=dtype)[rng.randint(0, 16, b)].to(dev),)
    return args


def phase_pointnet1(dev, batch: int) -> dict:
    """The five PointNet v1 models (no kernel runs in them) with seeded
    weights, B16 eval forward at the reference's sizes on the card and on CPU
    copies, TF32 off: every output and the T-Net transform within
    LOGIT_TOL, no kernel launched.  Then one ``cls_train_step`` of
    ``pointnet1_cls`` at B16 x 1024 with the orthogonality loss (reg_weight
    0.001) from seeded T-Net transforms, dropout off, held by ``hold_step``
    to ``phase_train_parity``'s limits (the second card run stands for the
    plain-ops one: no kernel runs), with the exactly-zero gradients from a
    float64 run as in ``phase_family_train_parity``.  Its global max pools
    over 1024 points switch on rounding, so how far a float32 run's
    gradients lie from float64 is a matter of how many switch: the card's
    may lie up to ``V1_F64_FLOOR`` from it where twice the CPU's distance
    is less."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in V1_SIZES:
        cpu_model = models.seeded_model(name, seed=0, device="cpu").eval()
        dev_model = copy.deepcopy(cpu_model).to(dev)
        kernels.reset_launches()
        with torch.no_grad():
            got = dev_model(*_v1_inputs(name, batch, dev, seed=1))
        launches = kernels.launch_counts()
        with torch.no_grad():
            want = cpu_model(*_v1_inputs(name, batch, "cpu", seed=1))
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        errs = []
        for i, (g, w) in enumerate(zip(got, want)):
            for k, gv in (g.items() if isinstance(g, dict) else [("out", g)]):
                wv = w[k] if isinstance(w, dict) else w
                if not torch.isfinite(gv).all():
                    raise AssertionError(f"pointnet1 {name} output {i} {k} not finite")
                errs.append(check_close(f"pointnet1 {name} output {i} {k}", gv.cpu(), wv,
                                        LOGIT_TOL))
        if any(launches.values()):
            raise AssertionError(f"pointnet1 {name} launched kernels: {launches}")
        out[name] = dict(max_abs_err=max(errs), shapes=[
            list(t.shape) for t in got if torch.is_tensor(t)])
        log(f"[pointnet1] {name} B{batch} x {V1_SIZES[name][0]} x {V1_SIZES[name][1]}: outputs "
            f"{out[name]['shapes']} and the transform max |card - cpu| = {max(errs):.3e} "
            f"(tol {LOGIT_TOL}); no kernel launched")

    tag = "pointnet1-train-parity"
    step = functools.partial(cls_steps.cls_train_step, reg_weight=0.001)
    base = models.seeded_model("pointnet1_cls", seed=0, device="cpu", dropout_rate=0.0)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # the T-Nets start at the identity: give them a gradient path
        for t in (base.transform_net1, base.transform_net2):
            t.transform_w.copy_(torch.randn(t.transform_w.shape, generator=g) * 0.01)
            t.transform_b.copy_(torch.randn(t.transform_b.shape, generator=g) * 0.01)
    pts = _v1_inputs("pointnet1_cls", batch, "cpu", seed=2)[0].numpy()
    data = {"points": pts, "labels": np.random.RandomState(2).randint(0, 40, batch)
            .astype(np.int32)}
    card, again, ref64 = (copy.deepcopy(base).to(dev), copy.deepcopy(base).to(dev),
                          copy.deepcopy(base).double())
    on_card = _one_step(card, data, step)
    on_cpu = _one_step(base, data, step)
    loss_again, g_again, _ = _one_step(again, data, step)
    ref64.train()
    logits, ends = ref64(torch.from_numpy(pts).double(),
                         bn_momentum=schedules.upstream_bn_momentum(0))
    loss64 = losses.softmax_cross_entropy(logits, torch.from_numpy(data["labels"])).mean()
    (loss64 + 0.001 * pointnet1.orthogonality_loss(ends["transform"])).backward()
    g64 = {k: p.grad.detach() for k, p in ref64.named_parameters()}
    bn64 = {k: v.detach() for k, v in ref64.named_buffers()}
    g64_max = max(float(g.abs().max()) for g in g64.values())
    zeros = {k: g.abs() < 1e-9 * g64_max for k, g in g64.items()}
    noise = _noise_biases(base) | {k for k, z in zeros.items() if bool(z.all())}
    held = hold_step(tag, on_card, on_cpu, (loss_again, g_again), (g64, bn64), noise,
                     noise_tol=1e-4, zeros=zeros, f64_floor=V1_F64_FLOOR)
    out["train_parity"] = dict(held, exact_zero=sorted(noise - _noise_biases(base)))
    log(f"[{tag}] pointnet1_cls B{batch} x 1024, reg_weight 0.001, dropout and TF32 off: "
        f"{held['summary']}; exactly-zero gradients beyond the BN-fed biases: "
        f"{out['train_parity']['exact_zero']}")
    return out


def phase_attention_net_recipes(dev) -> dict:
    """``run_attention_net_convergence`` (the sampler trainer, 200 steps of
    B4 x 2048 on 8 + 2 rooms of 16k points), ``run_cls_convergence``
    (``pointnet1_cls``, 60 epochs), ``run_partseg_convergence``
    (``pointnet1_seg``, 40 epochs) and ``run_s3dis_convergence`` (30 epochs)
    at the sizes of the JAX package's RESULTS_family_convergence.json: each
    score beside JAX's.  The random streams differ, so they are reported,
    not held; the step counts must be JAX's and the scores finite."""
    work = tempfile.mkdtemp(prefix=".recipe_smoke_", dir=ROOT)
    runs = {"attention_net": lambda: run_attention_net_convergence(work, device=dev),
            "pointnet1_cls": lambda: run_cls_convergence(work, "pointnet1_cls", epochs=60,
                                                         device=dev),
            "pointnet1_seg": lambda: run_partseg_convergence(work, "pointnet1_seg", epochs=40,
                                                             device=dev),
            "pointnet1_sem_seg": lambda: run_s3dis_convergence(work, epochs=30, device=dev)}
    out = {}
    try:
        for name, run in runs.items():
            metric, jax_value, jax_steps = ATTNET_RECIPES[name]
            t0 = time.perf_counter()
            summary = run()
            wall = time.perf_counter() - t0
            steps = summary.get("final_step", summary.get("steps"))
            if steps != jax_steps or not np.isfinite(summary[metric]):
                raise AssertionError(f"attention-net-recipe {name}: {summary}")
            out[name] = dict(summary, wall_s=wall, jax=jax_value)
            ortho = (f", last_ortho_loss {summary['last_ortho_loss']:.3f}"
                     if "last_ortho_loss" in summary else "")
            log(f"[attention-net-recipe] {name}: {metric} {summary[metric]:.4f} (JAX "
                f"RESULTS_family_convergence.json: {jax_value:.4f}) after {steps} steps"
                f"{ortho}, in {wall:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---- mixed precision (compute_dtype bfloat16) --------------------------------------

BF16 = torch.bfloat16
# A bf16 forward on the card against the same bf16 forward on the CPU: cuBLAS
# sums the exact bf16 products in another order than the CPU's widened
# float32 product, and where that moves a value across a bf16 rounding
# boundary before a later product, the value changes by 2^-8 of itself; such
# flips compound through the levels (the CPU tests measured 5.9e-4 between
# JAX and the port through pointnet1_cls_basic's 1024-wide layers).
BF16_LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)
BF16_ARGMAX = 0.99
# The bf16 step is held as phase 5 holds the float32 one to float64: every
# gradient tensor and BN statistic of the card's bf16 step (kernels, and plain
# ops) at most twice as far (relative L2) from the CPU's float32 step as the
# CPU's bf16 step is, or BF16_REL where that is larger.  The cotangents are
# rounded to bf16 at every product (JAX's semantics), so a gradient that is a
# sum cancelling to a small share of its terms (a BN scale or bias) is mostly
# rounding noise: at B2 x 8192 the CPU's bf16 BN-scale gradients lie up to
# 0.77 from its float32 ones, and the card's bf16 ones ~0.3 from the CPU's
# (its forward differs by summation order, which moves the roundings).
BF16_REL = 3e-2
BF16_FACTOR = 2.0
# The models timed in f32 and bf16 (registry arguments): the flagship, and
# the pooling attention net, whose key and value projections are ~280 GFLOP
# of products a B16 x 8192 forward.
MIXED_MODELS = (("sem_seg_features", {}),
                ("pooling_attention_net", {"in_features": ATTNET_FEATURES}))


def phase_bf16_train_parity(dev, scenes, n: int, tag: str = "bf16-train-parity") -> dict:
    """One full-width bf16 ``seg_train_step`` of ``sem_seg_features``, B2 x
    n, dropout off, from the same seeded weights and batch on the card, on
    the card through the plain ops and on the CPU, and the CPU's float32
    step as the reference: indices equal at SA1-4 (the geometry stays
    float32); loss within rtol 1e-3 of the CPU's and 1e-5 of the card's plain
    ops; every BN statistic and every gradient tensor but the exactly-zero
    biases, of the card with its kernels and with the plain ops, no farther
    from the float32 step than ``BF16_FACTOR`` x the CPU's bf16 step is (or
    ``BF16_REL``); the exactly-zero biases below 1e-3 x the largest
    gradient.  All seven kernels launch in the card's step; parameters stay
    float32."""
    base = models.seeded_model("sem_seg_features", seed=0, device="cpu", dropout_rate=0.0,
                               compute_dtype=BF16)
    batch = _train_batch(scenes, np.random.RandomState(3), 2, n)
    card, on_plain = copy.deepcopy(base).to(dev), copy.deepcopy(base).to(dev)
    card_levels, h1 = _capture_levels(card)
    cpu_levels, h2 = _capture_levels(base)
    kernels.reset_launches()
    loss_card, g_card, bn_card = _one_step(card, batch)
    launches = kernels.launch_counts()
    missing = [k for k in KERNEL_INFO if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: the card's step never launched {missing}")
    t0 = time.perf_counter()
    loss_cpu, g_cpu, bn_cpu = _one_step(base, batch)
    t_cpu = time.perf_counter() - t0
    for h in h1 + h2:
        h.remove()
    with plain_ops():
        loss_plain, g_plain, bn_plain = _one_step(on_plain, batch)
    f32 = models.seeded_model("sem_seg_features", seed=0, device="cpu", dropout_rate=0.0)
    _, g_f32, bn_f32 = _one_step(f32, batch)
    for i in range(4):
        check_equal(f"{tag} SA{i + 1} centres", card_levels[i][0], cpu_levels[i][0])
        check_equal(f"{tag} SA{i + 1} ball_query", card_levels[i][1], cpu_levels[i][1])
    if not np.isfinite(loss_card):
        raise AssertionError(f"{tag} loss not finite: {loss_card}")
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-3, err_msg=f"{tag} loss")
    np.testing.assert_allclose(loss_card, loss_plain, rtol=1e-5, err_msg=f"{tag} plain loss")
    noise = _noise_biases(base)
    held = {}
    for what, cpu, ref, sides in (
            ("gradient", g_cpu, g_f32, {"card": g_card, "card plain ops": g_plain}),
            ("BN statistic", bn_cpu, bn_f32, {"card": bn_card, "card plain ops": bn_plain})):
        for k in (k for k in cpu if k not in noise):
            d_cpu = _rel_l2(cpu[k].double(), ref[k].double())
            limit = max(BF16_FACTOR * d_cpu, BF16_REL)
            for side, got in sides.items():
                d = _rel_l2(got[k].double(), ref[k].double())
                if d > limit:
                    raise AssertionError(f"{tag}: {side} {what} {k} lies {d:.3e} from the "
                                         f"float32 step (rel L2), the CPU's bf16 {d_cpu:.3e}")
                held[(what, side, k)] = (d, d_cpu, d / limit)
    g_max = max(float(g_cpu[k].abs().max()) for k in g_cpu if k not in noise)
    noise_max = max(max(float(g_card[k].abs().max()), float(g_cpu[k].abs().max()))
                    for k in noise) / g_max
    if noise_max >= 1e-3:
        raise AssertionError(f"{tag}: an exactly-zero gradient is {noise_max:.3e} of the "
                             f"largest")
    if any(p.dtype != torch.float32 for p in card.parameters()):
        raise AssertionError(f"{tag}: a parameter is not float32")
    grads = [v for (what, side, _), v in held.items() if what == "gradient" and side == "card"]
    res = dict(loss_card=loss_card, loss_cpu=loss_cpu, loss_card_plain=loss_plain,
               grad_rel_l2_card_vs_f32_max=max(v[0] for v in grads),
               grad_rel_l2_cpu_bf16_vs_f32_max=max(v[1] for v in grads),
               grad_rel_l2_card_vs_cpu_max=max(_rel_l2(g_card[k], g_cpu[k])
                                               for k in g_cpu if k not in noise),
               grad_rel_l2_kernels_vs_plain_max=max(_rel_l2(g_card[k], g_plain[k])
                                                    for k in g_cpu if k not in noise),
               worst_share_of_limit=max(v[2] for v in held.values()),
               exact_zero_max_share=noise_max, step_cpu_s=t_cpu, launches=launches)
    log(f"[{tag}] sem_seg_features bf16 full width B2 x {n}, colors and normals, dropout "
        f"off: indices equal at SA1-4; loss card {loss_card:.7f} cpu {loss_cpu:.7f} "
        f"card-plain {loss_plain:.7f}; gradients rel L2 from the CPU's float32 step: card max "
        f"{res['grad_rel_l2_card_vs_f32_max']:.3e}, the CPU's bf16 max "
        f"{res['grad_rel_l2_cpu_bf16_vs_f32_max']:.3e}; card vs cpu max "
        f"{res['grad_rel_l2_card_vs_cpu_max']:.3e}, kernels vs plain ops max "
        f"{res['grad_rel_l2_kernels_vs_plain_max']:.3e}; gradients and BN statistics at most "
        f"{res['worst_share_of_limit']:.3f} of their limits ({BF16_FACTOR} x the CPU's bf16 "
        f"distance, or {BF16_REL}); exactly-zero biases <= {noise_max:.3e} of the largest "
        f"gradient; cpu step {t_cpu:.2f} s; launches in the card's step "
        f"{json.dumps(launches)}")
    return res


def train_step_device_ms(dev, batch: dict, name: str, **kwargs) -> float:
    """Device-only time of one B16 training step of registry model ``name``
    (``device_ms`` over 3 steps on one batch, after 2)."""
    model = models.seeded_model(name, seed=0, device=dev, **kwargs)
    state = TrainState(model)
    batch = _for_model(batch, model)
    ms = device_ms(lambda: seg_train_step(state, batch), calls=3)
    del state, model
    torch.cuda.empty_cache()
    return ms


# ---- the PointNet++ v1 ScanNet pipeline ---------------------------------------------

V1_KINDS = ("chunk", "whole", "virtual")
# RESULTS_family_convergence.json["v1_scannet_whole"] of the JAX package: a
# run of 40 epochs (docs/artifacts/tpu_batch_r5b.py, run_extended(epochs=40)
# when it passed its epochs on), 1480 steps.  At its defaults (8 epochs) the
# JAX package's run_v1_scannet_convergence makes 296 steps (151 whole-scene
# chunks of the six rooms, B4), as the port's does.
V1_SCANNET_JAX = dict(eval_miou=0.14839952136124135, eval_calibrated_vox_accuracy=0.8333814229935232,
                      eval_accuracy=0.5618842979088144, steps=1480, epochs=40)
V1_DEFAULT_STEPS = 296


@contextlib.contextmanager
def counted_steps(module, counts: dict):
    """Count the kernel launches of every ``seg_train_step`` that ``module``
    calls into ``counts`` (with the number of steps under ``'steps'``);
    evaluation launches in between are not counted."""
    real = module.seg_train_step

    def step(*args, **kwargs):
        before = kernels.launch_counts()
        out = real(*args, **kwargs)
        for k, v in kernels.launch_counts().items():
            counts[k] = counts.get(k, 0) + v - before[k]
        counts["steps"] = counts.get("steps", 0) + 1
        return out

    module.seg_train_step = step
    try:
        yield
    finally:
        module.seg_train_step = real


def phase_v1_scannet(dev, n_train: int = 16, scene_points: int = 150_000, batch: int = 16,
                     npoints: int = 8192, steps: int = 3) -> dict:
    """The v1 ScanNet pipeline on the card.  First ``sem_seg``'s smallest
    input of the JAX tests (FPS of 1024 centres from 256 points, ball query
    around them): indices equal to the plain versions.  Then
    ``train_scannet_v1`` at full size (``sem_seg``, B16 x 8192) for
    ``steps`` steps of each ``dataset_kind`` on ``n_train`` geometry-coded
    rooms of ``scene_points``, each run evaluating two such val rooms whole:
    launch counters zeroed just before each run and read just after (all
    seven kernels), and each step's own launches; finite metrics.  Then
    ``run_v1_scannet_convergence`` at its defaults and at the vendored
    result's 40 epochs, beside the JAX package's vendored result (reported,
    not held: the random streams differ; the step counts must be JAX's)."""
    from pointcloud_segmentation_attention_tpu_torch.recipes.family_convergence import (
        run_v1_scannet_convergence,
    )
    from pointcloud_segmentation_attention_tpu_torch.train import v1_scannet_trainer

    rng = np.random.RandomState(12)
    small = torch.from_numpy(rng.rand(2, 256, 3).astype(np.float32))
    idx = ops.farthest_point_sample(small.to(dev), 1024)
    check_equal("v1 fps 1024 of 256", idx, plain.farthest_point_sample(small, 1024))
    centres = plain.gather_point(small, idx.cpu())
    for got, want in zip(ops.ball_query(small.to(dev), centres.to(dev), 0.1, 32),
                         plain.ball_query(small, centres, 0.1, 32)):
        check_equal("v1 ball_query around 1024 of 256", got, want)
    work = tempfile.mkdtemp(prefix=".recipe_smoke_", dir=ROOT)
    out = {"runs": {}}
    try:
        root = os.path.join(work, "scannet")
        t0 = time.perf_counter()
        splits = write_synthetic_dataset(root, n_train=n_train, n_val=2, n_points=scene_points,
                                         seed=300, color_coded=True, geometry_coded=True)
        t_store = time.perf_counter() - t0
        for kind in V1_KINDS:
            counts: dict = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with counted_steps(v1_scannet_trainer, counts):
                summary = v1_scannet_trainer.train_scannet_v1(
                    root, splits["train"], splits["val"], npoints=npoints, batch_size=batch,
                    epochs=steps, log_dir=os.path.join(work, "v1_" + kind), max_steps=steps,
                    dataset_kind=kind, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            missing = [k for k in KERNEL_INFO if launches[k] == 0]
            if missing:
                raise AssertionError(f"v1-scannet {kind}: never launched {missing}")
            metrics = [summary[k] for k in ("train_loss", "eval_accuracy", "eval_miou",
                                            "eval_calibrated_vox_accuracy")]
            if summary["steps"] != steps or not np.all(np.isfinite(metrics)):
                raise AssertionError(f"v1-scannet {kind}: {summary}")
            per_step = {k: counts[k] / counts["steps"] for k in KERNEL_INFO}
            out["runs"][kind] = dict(summary, wall_s=wall, launches=launches,
                                     launches_per_step=per_step,
                                     peak_bytes=torch.cuda.max_memory_allocated())
            log(f"[v1-scannet] {kind}: {steps} steps of sem_seg B{batch} x {npoints}, each "
                f"epoch's whole-scene evaluation of 2 rooms of {scene_points} points, in "
                f"{wall:.2f} s; train loss "
                f"{summary['train_loss']:.4f}, point accuracy {summary['eval_accuracy']:.4f}, "
                f"mIoU {summary['eval_miou']:.4f}, calibrated voxel accuracy "
                f"{summary['eval_calibrated_vox_accuracy']:.4f}; launches a step "
                f"{json.dumps(per_step)}; in the window {json.dumps(launches)}")
        out["store_s"] = t_store
        for tag, epochs, want in (("recipe", None, V1_DEFAULT_STEPS),
                                  ("recipe_40_epochs", V1_SCANNET_JAX["epochs"],
                                   V1_SCANNET_JAX["steps"])):
            kw = {} if epochs is None else {"epochs": epochs}
            t0 = time.perf_counter()
            recipe = run_v1_scannet_convergence(os.path.join(work, tag), device=dev, **kw)
            wall = time.perf_counter() - t0
            if recipe["steps"] != want or not np.isfinite(recipe["eval_miou"]):
                raise AssertionError(f"v1-scannet {tag}: {recipe}")
            out[tag] = dict(recipe, wall_s=wall, jax=V1_SCANNET_JAX)
            log(f"[v1-scannet] run_v1_scannet_convergence, 6 + 2 rooms of 20k points, "
                f"whole-scene chunks, B4 x 2048, {epochs or 'its default 8'} epochs, in "
                f"{wall:.1f} s: "
                + ", ".join(f"{k} {recipe[k]:.4f} (JAX vendored {V1_SCANNET_JAX[k]:.4f})"
                            for k in ("eval_miou", "eval_calibrated_vox_accuracy",
                                      "eval_accuracy"))
                + f", {recipe['steps']} steps (JAX vendored {V1_SCANNET_JAX['steps']}), final "
                f"train loss {recipe['train_loss']:.4f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---- raw ScanNet scans in, pictures out: preprocessing, the drill, viz --------------

# A ScanNet-sized room (a real _vh_clean_2.ply holds ~10^5 vertices and twice
# as many faces): n_grid 250 gives 138,778 vertices and 274,900 faces.
DRILL_ROOM = dict(n_grid=250, npoints=8192, batch_size=16)
DRILL_ROOM_VERTICES = 138_778
DRILL_CLI_VERTICES = 5_120  # the CLI's defaults, n_grid 48
DRILL_FRAMES = dict(n_frames=4, size=480)
DRILL_SCENE = "scene9999_00"


def _drill_stages():
    """(module, function, stage) for every stage of ``run_drill`` timed on its
    own; ``read_ply_mesh`` and ``compute_vertex_normals`` run inside
    ``collect_scannet_scene``, ``precompute_cli.main`` runs for train then
    val, ``benchmark.evaluate`` for the model then the perfect predictor."""
    return ((realdata_drill, "fabricate_raw_scan", "fabricate"),
            (preprocessing, "read_ply_mesh", "read_ply_mesh"),
            (preprocessing, "compute_vertex_normals", "compute_vertex_normals"),
            (preprocessing, "collect_scannet_scene", "collect_scannet_scene"),
            (precompute_cli, "main", "precompute"),
            (trainer, "train", "train"),
            (full_scene, "generate_predictions", "predict_and_stitch"),
            (benchmark, "export_groundtruth_from_json", "groundtruth_export"),
            (benchmark, "evaluate", "evaluate"))


@contextlib.contextmanager
def timed_stages(stages, record: dict):
    """Replace each stage's function by one that appends its seconds (after a
    synchronise) and its kernel launches to ``record[stage]``; a generator's
    time runs until it is exhausted."""
    real = {}

    def wrap(fn, stage):
        def note(t0, before):
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            record.setdefault(stage, []).append(
                {"s": time.perf_counter() - t0,
                 "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}})

        if inspect.isgeneratorfunction(fn):
            def timed_gen(*args, **kwargs):
                t0, before = time.perf_counter(), kernels.launch_counts()
                yield from fn(*args, **kwargs)
                note(t0, before)
            return timed_gen

        def timed(*args, **kwargs):
            t0, before = time.perf_counter(), kernels.launch_counts()
            out = fn(*args, **kwargs)
            note(t0, before)
            return out
        return timed

    for module, name, stage in stages:
        real[(module, name)] = getattr(module, name)
        setattr(module, name, wrap(real[(module, name)], stage))
    try:
        yield record
    finally:
        for (module, name), fn in real.items():
            setattr(module, name, fn)


def _png_pixels(path: str) -> np.ndarray:
    """The (H, W, 3) pixels of an unfiltered 8-bit RGB PNG (``write_png``'s)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"), int.from_bytes(body[:4], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(size[0], -1)
    if (rows[:, 0] != 0).any():
        raise AssertionError(f"{path}: a PNG row is filtered")
    return rows[:, 1:].reshape(size[0], size[1], 3)


def phase_realdata_drill(dev) -> dict:
    """The raw-scan path on the card.  (a) ``realdata_drill.main`` at JAX's CLI
    defaults (n_grid 48, npoints 2048).  (b) ``run_drill`` on a ScanNet-sized
    room (``DRILL_ROOM``: 138,778 vertices, 274,900 faces, B16 x 8192): each
    stage timed on its own line, with its kernel launches; launch counters
    zeroed just before and read just after, all seven kernels launched;
    the drill's own checks (resolved labels and exported ground truth equal
    to the fabricated NYU40 labels, one stitched label per vertex) and
    ``perfect_miou == 1.0``.  (c) The room's stitched labels rendered by
    ``rotation_animation`` (``DRILL_FRAMES``); on the first frame's projected
    points ``render_ball`` (C++) equal to ``render_ball_numpy`` byte for byte,
    and the first frame's PNG pixels equal to that render."""
    work = tempfile.mkdtemp(prefix=".recipe_smoke_", dir=ROOT)
    out = {}
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        cli = realdata_drill.main(["--device", str(dev), "--workdir",
                                   os.path.join(work, "cli")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        missing = [k for k in KERNEL_INFO if launches[k] == 0]
        if missing or cli["perfect_miou"] != 1.0 or cli["n_vertices"] != DRILL_CLI_VERTICES:
            raise AssertionError(f"realdata-drill main: {cli}, never launched {missing}")
        out["cli"] = dict(cli, wall_s=cli_s, launches=launches)
        log(f"[realdata-drill] main --device {dev} (n_grid 48, npoints 2048): "
            f"{cli['n_vertices']} vertices, perfect mIoU {cli['perfect_miou']}, model mIoU "
            f"{cli['model_miou']:.4f}, {cli_s:.2f} s; launches {json.dumps(launches)}")

        room = os.path.join(work, "room")
        stages: dict = {}
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with timed_stages(_drill_stages(), stages):
            res = realdata_drill.run_drill(room, device=dev, **DRILL_ROOM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        missing = [k for k in KERNEL_INFO if launches[k] == 0]
        pred_dir = os.path.join(room, "pred")
        points = np.load(os.path.join(pred_dir, f"{DRILL_SCENE}_points.npy"))
        labels = np.load(os.path.join(pred_dir, f"{DRILL_SCENE}_labels.npy"))
        if (missing or res["perfect_miou"] != 1.0 or res["n_vertices"] != DRILL_ROOM_VERTICES
                or labels.shape != (DRILL_ROOM_VERTICES,)
                or points.shape != (DRILL_ROOM_VERTICES, 3)):
            raise AssertionError(f"realdata-drill room: {res}, labels {labels.shape}, "
                                 f"never launched {missing}")
        faces = len(preprocessing.read_ply_mesh(os.path.join(
            room, "scans", DRILL_SCENE, f"{DRILL_SCENE}_vh_clean_2.ply"))["faces"])
        log(f"[realdata-drill] run_drill on a ScanNet-sized room ({res['n_vertices']} "
            f"vertices, {faces} faces; B{DRILL_ROOM['batch_size']} x "
            f"{DRILL_ROOM['npoints']}) in {wall:.2f} s: perfect mIoU "
            f"{res['perfect_miou']}, model mIoU {res['model_miou']:.4f} (one training step); "
            f"launches {json.dumps(launches)}")
        for stage, calls in stages.items():
            for i, call in enumerate(calls):
                tag = {"precompute": (" train", " val"),
                       "evaluate": (" model", " perfect predictor")}.get(stage, ("", ""))[i]
                log(f"[realdata-drill]   {stage}{tag}: {call['s']:.3f} s"
                    + (f", launches {json.dumps(call['launches'])}" if call["launches"] else ""))
        out["room"] = dict(res, wall_s=wall, faces=faces, launches=launches, stages=stages)

        frames_dir = os.path.join(work, "frames")
        t0 = time.perf_counter()
        frames = animations.rotation_animation(points, labels, frames_dir, **DRILL_FRAMES)
        frames_s = time.perf_counter() - t0
        sel = np.random.RandomState(0).choice(len(points), 100000, False)
        size = DRILL_FRAMES["size"]
        screen = animations._project(points[sel].astype(np.float32), 0.0, size)
        colors = colorize_labels(labels[sel])
        t0 = time.perf_counter()
        compiled = native.render_ball(screen, colors, h=size, w=size, radius=2)
        compiled_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain_img = native.render_ball_numpy(screen, colors, h=size, w=size, radius=2)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if len(frames) != DRILL_FRAMES["n_frames"] or compiled.tobytes() != plain_img.tobytes():
            raise AssertionError(f"realdata-drill render: {len(frames)} frames, C++ and plain "
                                 "renders differ")
        if not np.array_equal(_png_pixels(frames[0]), compiled):
            raise AssertionError(f"realdata-drill render: {frames[0]} is not the C++ render")
        drawn = float((compiled != 255).any(axis=2).mean())
        out["render"] = dict(frames=len(frames), frames_s=frames_s, compiled_ms=compiled_ms,
                             plain_ms=plain_ms, drawn_share=drawn,
                             png_bytes=[os.path.getsize(f) for f in frames])
        log(f"[realdata-drill] rotation_animation of the room's stitched labels: "
            f"{len(frames)} frames of {size} px (100,000 of its points) in {frames_s:.3f} s; "
            f"one frame: render_ball (C++) {compiled_ms:.2f} ms, render_ball_numpy "
            f"{plain_ms:.2f} ms, equal byte for byte and to the frame's PNG; "
            f"{drawn:.3f} of the pixels drawn")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


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
    resident, folded = phase("serve-resident", phase_serve_resident, model, dev,
                             scene_points=150_000, n_scenes=3, npoints=8192, batch=16)
    fwd = phase("forward", phase_forward_time, model, dev, batch=16, n=8192, reps=10)
    fwd_folded = phase("forward-folded", phase_forward_time, folded, dev, batch=16, n=8192,
                       reps=10, tag="forward-folded")
    rooms = [make_synthetic_scene(150_000, seed=200 + s) for s in range(4)]
    parity = phase("train-parity", phase_train_parity, dev, rooms, n=8192)
    sampler = phase("sampler", phase_sampler, dev, rooms, batch=16, npoints=8192, reps=10)
    batches, t_data = train_batches(rooms, batch=16, npoints=8192, count=23)
    log(f"[train] {len(batches)} batches of B16 x 8192 made on the host in {t_data:.1f} s")
    train = phase("train", phase_train, dev, batches, steps=20, warmup=3)
    remat = phase("remat", phase_remat, dev, batches, reps=5)
    trained = phase("trainer", phase_trainer, dev)
    recipe = phase("recipe", phase_recipe, dev)

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

    # The full attention nets at B16 x 8192 with colors and normals: the
    # three against the CPU, attention_net's step against the CPU, 10 timed
    # steps of attention_net and pooling_attention_net, attention_net served.
    attnet_model = {}
    for name in ATTENTION_NETS:
        net = phase(f"attention-net-model {name}", phase_model, dev, n=8192, name=name,
                    tag="attention-net-model", batch=16, cpu_batch=4,
                    in_features=ATTNET_FEATURES)
        attnet_model[name] = net.smoke_report
        if name == "attention_net":
            attnet = net
        del net
    attnet_parity = phase("attention-net-train-parity", phase_attention_net_train_parity, dev,
                          rooms, n=8192)
    attnet_train = {name: phase(f"attention-net-train {name}", phase_train, dev, batches,
                                steps=10, warmup=3, name=name,
                                tag=f"attention-net-train {name}",
                                in_features=ATTNET_FEATURES)
                    for name in ATTENTION_NETS[::2]}
    attnet_serve = phase("attention-net-serve", phase_attention_net_serve, attnet, dev,
                         scene_points=150_000, n_scenes=3, npoints=8192, batch=16)

    # Mixed precision (bf16 products, float32 parameters): the flagship's
    # B16 forward against the CPU, its step against the CPU, and 10 timed
    # steps of the flagship and the pooling attention net beside their f32
    # steps above.
    bf16_model = phase("mixed-precision-model", phase_model, dev, n=8192,
                       tag="mixed-precision-model", batch=16, cpu_batch=1, tol=BF16_LOGIT_TOL,
                       min_argmax=BF16_ARGMAX, compute_dtype=BF16)
    bf16_fwd = phase("mixed-precision-forward", phase_forward_time, bf16_model, dev, batch=16,
                     n=8192, reps=10, tag="mixed-precision-forward")
    bf16_parity = phase("bf16-train-parity", phase_bf16_train_parity, dev, rooms, n=8192)
    bf16_train = {name: phase(f"mixed-precision-train {name}", phase_train, dev, batches,
                              steps=10, warmup=3, name=name,
                              tag=f"mixed-precision-train {name}", compute_dtype=BF16, **kw)
                  for name, kw in MIXED_MODELS}
    f32_train = {"sem_seg_features": train,
                 "pooling_attention_net": attnet_train["pooling_attention_net"]}
    step_batch = batches[0]
    del rooms, batches, attnet

    # The PointNet++ classification and part-segmentation families at full width.
    fam_model = phase("family-model", phase_family_model, dev, batch=16)
    fam_parity = phase("family-train-parity", phase_family_train_parity, dev)
    fam_train = phase("family-train", phase_family_train, dev, batch=16, steps=10, warmup=3)
    fam_recipe = phase("family-recipe", phase_family_recipe, dev)
    v1 = phase("pointnet1", phase_pointnet1, dev, batch=16)
    attnet_recipe = phase("attention-net-recipe", phase_attention_net_recipes, dev)
    v1_scannet = phase("v1-scannet", phase_v1_scannet, dev)
    drill = phase("realdata-drill", phase_realdata_drill, dev)
    rep, geom = phase("kernels", phase_kernels, dev, batch=16, n=8192, reps=20)
    rep.update(phase("kernels-bwd", phase_kernels_bwd, dev, geom, reps=20))
    del geom
    phase("device-times", phase_device_times, rep)
    sampler["fast"]["device_ms"] = device_ms(sampler.pop("call"))
    log(f"[sampler] sample_chunk_batch fast, B16 x 8192: {sampler['fast']['device_ms']:.4f} ms "
        f"device-only (profiler), bound {sampler['bound_ms']:.4f} ms")
    r = rep["three_interpolate_bwd"]
    for label in (k for k in r["level_device"] if k.startswith("M1")):
        log(f"[family] interpolation backward {label}: {r['level_device'][label]:.4f} ms "
            f"device with dw, {r['dp_level_device'][label]:.4f} without (the train step's); "
            f"bound {r['level_bound'][label][0]:.4f} / {r['dp_level_bound'][label][0]:.4f} ms "
            f"by {r['level_bound'][label][1]}")
    fwd_device_ms = phase_forward_device(model, dev, batch=16, n=8192)
    folded_device_ms = phase_forward_device(folded, dev, batch=16, n=8192,
                                            what="eval forward, BN folded")
    attn_fwd_device_ms = phase_forward_device(attn_model, dev, batch=16, n=8192)
    bf16_fwd_device_ms = phase_forward_device(bf16_model, dev, batch=16, n=8192,
                                              what="eval forward, bf16")
    mixed = {}
    for name, kw in MIXED_MODELS:
        for dtype, timed in (("float32", f32_train[name]), ("bfloat16", bf16_train[name])):
            extra = {"compute_dtype": BF16} if dtype == "bfloat16" else {}
            mixed[f"{name} {dtype}"] = dict(
                step_ms_median=timed["step_ms_median"], peak_bytes=timed["peak_bytes"],
                points_per_s=timed["points_per_s"], steps=timed["steps"],
                step_device_ms=train_step_device_ms(dev, step_batch, name, **kw, **extra),
                launches_per_step=timed["launches_per_step"])
            r = mixed[f"{name} {dtype}"]
            log(f"[mixed-precision] {name} {dtype} B16 x 8192 train step: median "
                f"{r['step_ms_median']:.3f} ms of {r['steps']} (CUDA events), "
                f"{r['step_device_ms']:.3f} ms device (profiler), max_memory_allocated "
                f"{r['peak_bytes'] / 2**20:.1f} MiB")
    log(f"[mixed-precision] B16 x 8192 eval forward sem_seg_features: f32 {fwd['ms']:.3f} ms "
        f"wall / {fwd_device_ms:.3f} ms device, bf16 {bf16_fwd['ms']:.3f} / "
        f"{bf16_fwd_device_ms:.3f}")
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
        trainer_launches += "; family train step: " + " ".join(
            f"{m}={v['launches_per_step'][name]:g}" for m, v in fam_train.items())
        trainer_launches += "; attention-net train step: " + " ".join(
            f"{m}={v['launches_per_step'][name]:g}" for m, v in attnet_train.items())
        trainer_launches += "; bf16 train step: " + " ".join(
            f"{m}={v['launches_per_step'][name]:g}" for m, v in bf16_train.items())
        trainer_launches += "; v1 ScanNet train step: " + " ".join(
            f"{k}={v['launches_per_step'][name]:g}" for k, v in v1_scannet["runs"].items())
        trainer_launches += (f"; realdata drill: CLI {drill['cli']['launches'][name]}, "
                             f"room {drill['room']['launches'][name]}")
        log(f"[report] {name:21s} launches={launches:4d} (serve-resident window: "
            f"{resident['launches'][name]}; trainer window: {trainer_launches}) "
            f"{r['shape']}: "
            f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}); per level "
            f"ms wall/device{'/bound' if 'level_bound' in r else ''}: {levels}; "
            f"max_abs_err {r['max_abs_err']}")
        line.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": PALLAS + pallas, "launches": launches,
            "launch_window": "serve" if name in FORWARD_KERNELS else "train",
            "serve_resident_launches": resident["launches"][name],
            "attention_train_launches": attn_train["launches"][name],
            "trainer_launches": {tag: run["launches"][name]
                                 for tag, run in trained["runs"].items()},
            "family_forward_launches": {m: v["launches"][name] for m, v in fam_model.items()},
            "family_train_launches_per_step": {m: v["launches_per_step"][name]
                                               for m, v in fam_train.items()},
            "attention_net_train_launches_per_step": {m: v["launches_per_step"][name]
                                                      for m, v in attnet_train.items()},
            "attention_net_serve_launches": attnet_serve["launches"][name],
            "bf16_train_launches_per_step": {m: v["launches_per_step"][name]
                                             for m, v in bf16_train.items()},
            "bf16_train_parity_launches": bf16_parity["launches"][name],
            "v1_scannet_train_launches_per_step": {k: v["launches_per_step"][name]
                                                   for k, v in v1_scannet["runs"].items()},
            "v1_scannet_launches": {k: v["launches"][name]
                                    for k, v in v1_scannet["runs"].items()},
            "realdata_drill_launches": {"cli": drill["cli"]["launches"][name],
                                        "room": drill["room"]["launches"][name]},
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
        json.dump({"card": smi, "kernels": line, "serve": serve, "serve_resident": resident,
                   "forward_b16_ms": fwd["ms"],
                   "forward_b16_peak_bytes": fwd["peak_bytes"],
                   "forward_b16_ms_after_profiler": fwd_after["ms"],
                   "forward_b16_device_ms": fwd_device_ms,
                   "forward_b16_folded_ms": fwd_folded["ms"],
                   "forward_b16_folded_device_ms": folded_device_ms,
                   "train_parity": parity, "train": train, "train_data_s": t_data,
                   "attention": {"model": "sem_seg_attention", "forward_b16_ms": attn_fwd["ms"],
                                 "forward_b16_peak_bytes": attn_fwd["peak_bytes"],
                                 "forward_b16_device_ms": attn_fwd_device_ms,
                                 "train_parity": attn_parity, "train": attn_train},
                   "trainer": trained, "sampler": sampler, "remat": remat,
                   "recipe_zero_precompute": recipe,
                   "family": {"model": fam_model, "train_parity": fam_parity,
                              "train": fam_train, "recipe": fam_recipe},
                   "attention_nets": {"model": attnet_model, "train_parity": attnet_parity,
                                      "train": attnet_train, "serve": attnet_serve,
                                      "recipe": attnet_recipe},
                   "pointnet1": v1,
                   "mixed_precision": {"model": bf16_model.smoke_report,
                                       "forward_b16_ms": bf16_fwd["ms"],
                                       "forward_b16_peak_bytes": bf16_fwd["peak_bytes"],
                                       "forward_b16_device_ms": bf16_fwd_device_ms,
                                       "train_parity": bf16_parity, "train_steps": mixed,
                                       "train": bf16_train},
                   "v1_scannet": v1_scannet,
                   "realdata_drill": drill,
                   "phase_seconds": phase_s,
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
