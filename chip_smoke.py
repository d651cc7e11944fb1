#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. build   -- compile the five CUDA kernels from ``csrc/`` with nvcc (sm_90a).
2. kernels -- every kernel against its plain PyTorch version on the card at
              the slice's B16 shapes (SA1-4, FP1-4) and at a large N; index
              outputs must be equal, floats within rtol=atol=1e-6.  Times
              each kernel, its plain version and, where one exists, the
              single PyTorch call computing the same function.
3. model   -- full-width ``sem_seg_features`` with seeded weights and BN
              statistics: B2 x 8192 forward on the card (kernels) and on the
              CPU (plain ops), TF32 off; indices equal at every level, logits
              within rtol=atol=1e-3.
4. serve   -- synthetic rooms of 150k points chunked to 8192-point chunks,
              predicted in batches of 16 through ``make_predict_fn`` and
              stitched; launch counters are zeroed just before and read just
              after, and every kernel must have launched.
5. report  -- one line per kernel, a ``{"kernels": [...]}`` JSON line, the
              card's name and power limit, and the final
              ``{"ok": true, "device": {...}}`` line.

Exits non-zero without printing a result when CUDA is not available.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from pointcloud_segmentation_attention_tpu_torch import models, ops  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (  # noqa: E402
    make_synthetic_scene,
)
from pointcloud_segmentation_attention_tpu_torch.eval.full_scene import (  # noqa: E402
    make_predict_fn,
    predict_scene_chunks,
    scene_chunks,
)
from pointcloud_segmentation_attention_tpu_torch.models import sem_seg  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.ops import cuda as kernels  # noqa: E402
from pointcloud_segmentation_attention_tpu_torch.ops import geometry as plain  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
EXTENT = np.array([1.9, 1.9, 2.6], np.float32)  # one serving chunk's extent
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
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
}


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


def phase_kernels(dev, batch: int, n: int, reps: int) -> dict:
    """Each kernel against its plain version at every level; returns the
    per-kernel report (errors, times, bounds)."""
    rng = np.random.RandomState(0)
    rep = {k: {"max_abs_err": 0.0, "levels": {}} for k in KERNEL_INFO}

    def err(name, e):
        rep[name]["max_abs_err"] = max(rep[name]["max_abs_err"], e)

    def level_time(name, label, fn):
        rep[name]["levels"][label] = time_ms(fn, reps)

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
        level_time("fps", label, lambda: ops.farthest_point_sample(xyz, npoint))
        level_time("ball_query", label, lambda: ops.ball_query(xyz, new_xyz, radius, ns))
        level_time("group_gather", label, lambda: ops.group_point_with_counts(pts, idx, cnt))
        if i == 0:
            sa1 = dict(xyz=xyz, new_xyz=new_xyz, idx=idx, cnt=cnt, pts=pts, npoint=npoint,
                       radius=radius, ns=ns)
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
        err("three_nn", check_close(f"three_nn dist {label}", dist, pdist, FLOAT_TOL))
        w = plain.interpolation_weights(pdist)
        p2 = torch.randn(batch, xyz2.shape[1], FP_CHANNELS[i], device=dev)
        err("three_interpolate", check_close(
            f"three_interpolate {label}", ops.three_interpolate(p2, nidx, w),
            plain.three_interpolate(p2, pnidx, w), FLOAT_TOL))
        torch.cuda.synchronize()
        level_time("three_nn", label, lambda: ops.three_nn(xyz1, xyz2))
        level_time("three_interpolate", label, lambda: ops.three_interpolate(p2, nidx, w))
        if i == 3:
            fp4 = dict(xyz1=xyz1, xyz2=xyz2, idx=nidx, w=w, p2=p2)
        log(f"[kernels] {label}: N={xyz1.shape[1]} M={xyz2.shape[1]} C={FP_CHANNELS[i]} "
            f"three_nn idx equal, interpolate within {FLOAT_TOL}")

    # Large clouds: FPS beyond shared memory, ball query over 2^15+ points.
    big = torch.from_numpy(rng.rand(2, (1 << 15) + 256, 3).astype(np.float32)).to(dev)
    err("fps", check_equal("fps large N", ops.farthest_point_sample(big, 64),
                           plain.farthest_point_sample(big, 64)))
    dense = (big * 0.2).contiguous()
    centres = dense[:, :64].contiguous()
    bi, bc = ops.ball_query(dense, centres, 0.5, 8)
    pbi, pbc = plain.ball_query(dense, centres, 0.5, 8)
    err("ball_query", check_equal("ball_query large N idx", bi, pbi))
    err("ball_query", check_equal("ball_query large N cnt", bc, pbc))
    torch.cuda.synchronize()
    log(f"[kernels] large N={big.shape[1]}: fps and ball_query equal")

    # Headline shapes: SA1 for the SA kernels, FP4 for the FP kernels.
    b = batch
    x, nx, idx, cnt, pts = sa1["xyz"], sa1["new_xyz"], sa1["idx"], sa1["cnt"], sa1["pts"]
    npt, r, ns = sa1["npoint"], sa1["radius"], sa1["ns"]
    m, c = npt, pts.shape[-1]
    rep["fps"].update(
        ms=rep["fps"]["levels"]["SA1"],
        plain_ms=time_ms(lambda: plain.farthest_point_sample(x, npt), max(2, reps // 4), 1, 1),
        library_ms=None, shape=f"B{b} N{n} -> {npt}")
    rep["fps"]["bound_ms"], rep["fps"]["bound_by"] = bound(
        b * n * 12 + b * npt * 4, 9.0 * b * (npt - 1) * n)
    # Ball query visits points up to its nsample-th hit (or all of them).
    full = cnt == ns
    visited = torch.where(full, idx[..., -1].long() + 1, torch.full_like(cnt, n).long())
    rep["ball_query"].update(
        ms=rep["ball_query"]["levels"]["SA1"],
        plain_ms=time_ms(lambda: plain.ball_query(x, nx, r, ns), max(2, reps // 4), 1, 1),
        library_ms=None, shape=f"B{b} N{n} M{m} ns{ns}")
    rep["ball_query"]["bound_ms"], rep["ball_query"]["bound_by"] = bound(
        b * n * 12 + b * m * 12 + b * m * ns * 4 + b * m * 4,
        8.0 * float(visited.sum()))
    bidx = torch.arange(b, device=dev)[:, None, None]
    lidx = idx.long()
    check_equal("group_gather library", pts[bidx, lidx], plain.group_point(pts, idx))
    rep["group_gather"].update(
        ms=rep["group_gather"]["levels"]["SA1"],
        plain_ms=time_ms(lambda: plain.group_point(pts, idx), reps),
        library_ms=time_ms(lambda: pts[bidx, lidx], reps),
        library_call="points[b_idx, idx]", shape=f"B{b} N{n} M{m} ns{ns} C{c}")
    rep["group_gather"]["bound_ms"], rep["group_gather"]["bound_by"] = bound(
        b * n * c * 4 + b * m * ns * 4 + b * m * ns * c * 4, 0.0)

    x1, x2, nidx, w, p2 = fp4["xyz1"], fp4["xyz2"], fp4["idx"], fp4["w"], fp4["p2"]
    fn_, fm, fc = x1.shape[1], x2.shape[1], p2.shape[-1]
    rep["three_nn"].update(
        ms=rep["three_nn"]["levels"]["FP4"],
        plain_ms=time_ms(lambda: plain.three_nn(x1, x2), max(2, reps // 4), 1, 1),
        library_ms=None, shape=f"B{b} N{fn_} M{fm}")
    rep["three_nn"]["bound_ms"], rep["three_nn"]["bound_by"] = bound(
        b * fn_ * 12 + b * fm * 12 + b * fn_ * 3 * 8, 8.0 * b * fn_ * fm)
    gidx = (nidx.long() + torch.arange(b, device=dev)[:, None, None] * fm).reshape(-1, 3)
    table, bw = p2.reshape(-1, fc), w.reshape(-1, 3)

    def embedding_bag():
        return torch.nn.functional.embedding_bag(gidx, table, mode="sum", per_sample_weights=bw)

    check_close("three_interpolate library", embedding_bag().reshape(b, fn_, fc),
                plain.three_interpolate(p2, nidx, w), dict(rtol=1e-5, atol=1e-5))
    rep["three_interpolate"].update(
        ms=rep["three_interpolate"]["levels"]["FP4"],
        plain_ms=time_ms(lambda: plain.three_interpolate(p2, nidx, w), reps),
        library_ms=time_ms(embedding_bag, reps),
        library_call="embedding_bag(mode='sum', per_sample_weights)",
        shape=f"B{b} N{fn_} M{fm} C{fc}")
    rep["three_interpolate"]["bound_ms"], rep["three_interpolate"]["bound_by"] = bound(
        b * fm * fc * 4 + b * fn_ * 3 * 8 + b * fn_ * fc * 4, 5.0 * b * fn_ * fc)
    torch.cuda.synchronize()
    return rep


def _capture_levels(model):
    levels = {}
    hooks = []
    for i in range(4):
        def hook(mod, args, out, i=i):
            levels[i] = (out[0].detach().cpu(), out[2].detach().cpu())
        hooks.append(getattr(model, f"sa{i + 1}").register_forward_hook(hook))
    return levels, hooks


def phase_model(dev, n: int) -> torch.nn.Module:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = models.seeded_model("sem_seg_features", seed=0, device="cpu")
    dev_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.RandomState(1)
    pts = (rng.rand(2, n, 3) * EXTENT).astype(np.float32)
    feats = rng.rand(2, n, 6).astype(np.float32)
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    dev_levels, h1 = _capture_levels(dev_model)
    cpu_levels, h2 = _capture_levels(cpu_model)
    t0 = time.perf_counter()
    got = seg_predict_step(dev_model, torch.from_numpy(pts).to(dev),
                           torch.from_numpy(feats).to(dev)).cpu()
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = seg_predict_step(cpu_model, torch.from_numpy(pts), torch.from_numpy(feats))
    t_cpu = time.perf_counter() - t0
    for h in h1 + h2:
        h.remove()
    for i in range(4):
        check_equal(f"model SA{i + 1} centres", dev_levels[i][0], cpu_levels[i][0])
        check_equal(f"model SA{i + 1} ball_query", dev_levels[i][1], cpu_levels[i][1])
    xyzs = [torch.from_numpy(pts)] + [cpu_levels[i][0] for i in range(4)]
    for i in range(4):
        lvl = 3 - i
        _, di = ops.three_nn(xyzs[lvl].to(dev), xyzs[lvl + 1].to(dev))
        check_equal(f"model FP{i + 1} three_nn", di, plain.three_nn(xyzs[lvl], xyzs[lvl + 1])[1])
    if got.shape != (2, n, 21) or not torch.isfinite(got).all():
        raise AssertionError(f"model logits bad: shape {tuple(got.shape)}")
    e = check_close("model logits", got, want, LOGIT_TOL)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[model] sem_seg_features full width, B2 x {n}: indices equal at SA1-4/FP1-4; "
        f"logits max |card - cpu| = {e:.3e} (tol {LOGIT_TOL}); argmax agreement {agree:.6f}; "
        f"first forward card {t_dev:.2f} s (incl. warm-up), cpu {t_cpu:.2f} s")
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"serve phase never launched {missing}")
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


def phase_forward_time(model, dev, batch: int, n: int, reps: int) -> float:
    rng = np.random.RandomState(2)
    pts = torch.from_numpy((rng.rand(batch, n, 3) * EXTENT).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.rand(batch, n, 6).astype(np.float32)).to(dev)
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    ms = time_ms(lambda: seg_predict_step(model, pts, feats), reps)
    log(f"[forward] B{batch} x {n} eval forward: {ms:.3f} ms median of {reps}")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the GPU port",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()
    rep = phase_kernels(dev, batch=16, n=8192, reps=20)
    model = phase_model(dev, n=8192)
    serve = phase_serve(model, dev, scene_points=150_000, n_scenes=3, npoints=8192, batch=16)
    fwd_ms = phase_forward_time(model, dev, batch=16, n=8192, reps=10)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    line = []
    for name, (src, pallas) in KERNEL_INFO.items():
        r = rep[name]
        levels = " ".join(f"{k}={v:.4f}" for k, v in r["levels"].items())
        log(f"[report] {name:17s} launches={serve['launches'][name]:4d} {r['shape']}: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}); per level ms: {levels}; "
            f"max_abs_err {r['max_abs_err']}")
        line.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": PALLAS + pallas, "launches": serve["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "parity": "pass", "shape": r["shape"],
            "level_ms": r["levels"],
        })
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": line, "serve": serve, "forward_b16_ms": fwd_ms,
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
