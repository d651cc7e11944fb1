"""Per-op times at the flagship model's shapes; the counterpart of the JAX
package's ``utils/bench_ops.py``.

``op_rows`` times each geometry op at every SA/FP level of the ScanNet
semantic-segmentation hierarchy (npoint 1024/256/64/16, radius
0.1/0.2/0.4/0.8, nsample 32, 64 feature channels, clouds uniform in one
training chunk's extent 1.9 x 1.9 x 2.6 m) under the JAX package's row
names, in its order; ``step_rows`` times the flagship's train step and eval
forward (``sem_seg_features`` with colors and normals) in float32 and
bfloat16.  The ops go through ``ops`` (``ops/dispatch.py``), so a CUDA
tensor reaches the hand-written kernel:

- ``fps``, ``ballq``, ``three_nn``: ``csrc/fps.cu``, ``ball_query.cu``,
  ``three_nn.cu``;
- ``group`` and ``grp_cnt``: both ``ops.group_point_with_counts``, so both
  run ``csrc/group_gather.cu``.  The port's gather copies every slot and
  ignores ``cnt`` (``ops/dispatch.py``), so the two rows time the same
  kernel; the JAX package's ``group`` row timed its plain XLA gather,
  which in the port is ``ops.group_point`` and not a kernel on any device.
  The ``gather_point`` of the centres between levels is the plain gather,
  outside the timed calls, as in the JAX package.

Every row carries the kernel launches its calls made (``ops.cuda``'s
counters, read before and after), so a row that reached a plain version
on the card shows it, and the device it ran on.

Timing (``_time``): on a card, CUDA events around windows of ``iters``
calls, the median of 3 windows, after ``warmup`` calls; on the CPU the
host clock the same way (a CPU time, labelled ``cpu``).  Run on the card::

    python -m pointcloud_segmentation_attention_tpu_torch.utils.bench_ops \\
        [--batch 16] [--n 8192]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch.device import resolve

EXTENT = np.array([1.9, 1.9, 2.6], np.float32)  # one training chunk with its margin
NSAMPLE = 32
CHANNELS = 64
FORWARD_KERNELS = ("fps", "ball_query", "group_gather", "three_nn", "three_interpolate")
ALL_KERNELS = FORWARD_KERNELS + ("group_gather_bwd", "three_interpolate_bwd")
_ROW_KERNELS = {"fps": ("fps",), "ballq": ("ball_query",), "group": ("group_gather",),
                "grp_cnt": ("group_gather",), "three_nn": ("three_nn",),
                "train_step": ALL_KERNELS, "forward": FORWARD_KERNELS}


def levels(n: int) -> List[Tuple[int, int, float]]:
    """(points in, centres, radius) of SA1-4 from an ``n``-point cloud."""
    return [(n, 1024, 0.1), (1024, 256, 0.2), (256, 64, 0.4), (64, 16, 0.8)]


def row_kernels(op: str) -> Tuple[str, ...]:
    """The kernels a row's call launches on a card."""
    return _ROW_KERNELS[op.split("[")[0].split()[0]]


def _launches() -> Dict[str, int]:
    from pointcloud_segmentation_attention_tpu_torch.ops import cuda as kernels

    return kernels.launch_counts()


def _time(fn: Callable, dev: torch.device, iters: int, warmup: int) -> float:
    """Median over 3 windows of the ms per call of ``iters`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
    else:
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return sorted(times)[1]


def _row(op: str, fn: Callable, dev: torch.device, iters: int, warmup: int) -> Dict:
    before = _launches()
    ms = _time(fn, dev, iters, warmup)
    after = _launches()
    label = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"op": op, "ms": ms, "calls": warmup + 3 * iters, "device": label,
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def op_rows(b: int = 16, n: int = 8192, device="cuda", iters: int = 50,
            warmup: int = 5, seed: int = 0) -> List[Dict]:
    """Rows ``fps``, ``ballq``, ``group``, ``grp_cnt`` and ``three_nn`` at
    each level, named as the JAX package names them."""
    from pointcloud_segmentation_attention_tpu_torch import ops

    dev = resolve(device)
    rng = np.random.RandomState(seed)
    rows = []
    for n_in, npoint, radius in levels(n):
        xyz = _tensor((rng.rand(b, n_in, 3) * EXTENT).astype(np.float32), dev)
        rows.append(_row(f"fps      {n_in:5d}->{npoint:4d}",
                         lambda: ops.farthest_point_sample(xyz, npoint), dev, iters, warmup))
        new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(xyz, npoint))
        rows.append(_row(f"ballq    {n_in:5d}@{npoint:4d}",
                         lambda: ops.ball_query(xyz, new_xyz, radius, NSAMPLE), dev, iters,
                         warmup))
        gidx, gcnt = ops.ball_query(xyz, new_xyz, radius, NSAMPLE)
        feats = _tensor(rng.rand(b, n_in, CHANNELS).astype(np.float32), dev)
        rows.append(_row(f"group    {n_in:5d}@{npoint:4d}x{NSAMPLE}",
                         lambda: ops.group_point_with_counts(feats, gidx), dev, iters, warmup))
        rows.append(_row(f"grp_cnt  {n_in:5d}@{npoint:4d}x{NSAMPLE}",
                         lambda: ops.group_point_with_counts(feats, gidx, gcnt), dev, iters,
                         warmup))
        rows.append(_row(f"three_nn {n_in:5d}<-{npoint:4d}",
                         lambda: ops.three_nn(xyz, new_xyz), dev, iters, warmup))
    return rows


def step_batch(b: int, n: int, dev: torch.device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A B x n batch of uniform points in the chunk extent, labels 0-20,
    six feature channels and the ScanNet class weights, on ``dev``."""
    from pointcloud_segmentation_attention_tpu_torch.train.steps import make_sample_weights

    rng = np.random.RandomState(seed)
    batch = {"points": _tensor((rng.rand(b, n, 3) * EXTENT).astype(np.float32), dev),
             "labels": _tensor(rng.randint(0, 21, (b, n)).astype(np.int32), dev),
             "features": _tensor(rng.rand(b, n, 6).astype(np.float32), dev)}
    batch["weights"] = make_sample_weights(batch["labels"],
                                           torch.ones((b, n), dtype=torch.float32, device=dev))
    return batch


def step_rows(b: int = 16, n: int = 8192, device="cuda",
              dtypes: Sequence[str] = ("float32", "bfloat16"), iters: int = 10,
              warmup: int = 3, forward: bool = True) -> List[Dict]:
    """``train_step[dtype]`` (``seg_train_step``, Adam included) and, with
    ``forward``, ``forward[dtype]`` (``seg_predict_step``) of
    ``sem_seg_features`` with seeded weights (``models.seeded_model``) for
    each compute dtype."""
    from pointcloud_segmentation_attention_tpu_torch import models
    from pointcloud_segmentation_attention_tpu_torch.train import TrainState, seg_train_step
    from pointcloud_segmentation_attention_tpu_torch.train.steps import seg_predict_step

    dev = resolve(device)
    batch = step_batch(b, n, dev)
    rows = []
    for dtype in dtypes:
        model = models.seeded_model("sem_seg_features", seed=0, device=dev,
                                    compute_dtype=getattr(torch, dtype))
        state = TrainState(model)
        rows.append(_row(f"train_step[{dtype}]", lambda: seg_train_step(state, batch), dev,
                         iters, warmup))
        if forward:
            rows.append(_row(f"forward[{dtype}]",
                             lambda: seg_predict_step(model, batch["points"],
                                                      batch["features"]),
                             dev, iters, warmup))
        del state, model
    return rows


def format_rows(rows: List[Dict]) -> str:
    lines = [f"{'op':28s} {'ms':>9s}  launches"]
    for r in rows:
        launches = " ".join(f"{k}={v}" for k, v in r["launches"].items()) or "-"
        lines.append(f"{r['op']:28s} {r['ms']:9.3f}  {launches}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve(args.device)
    rows = op_rows(args.batch, args.n, dev) + step_rows(args.batch, args.n, dev)
    print(f"device={rows[0]['device']} batch={args.batch} n={args.n}")
    print(format_rows(rows))


if __name__ == "__main__":
    main()
