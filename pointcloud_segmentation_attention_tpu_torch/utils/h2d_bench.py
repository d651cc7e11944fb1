"""The host-to-device link: per-transfer latency, bandwidth, and overlap with
compute; the counterpart of the JAX package's ``utils/h2d_bench.py``.

- ``sweep``: wall time of one copy against payload size, for the two routes
  the port takes.  Pageable: ``torch.from_numpy(x).to(dev)``, what
  ``train/steps.py:_to_device`` does for every npz and packed batch.
  Pinned (``pinned=True``): a ``non_blocking`` copy from a ``pin_memory()``
  buffer, what the resident and sampler inputs (``train/trainer.py``) and
  resident serving (``eval/resident_serving.py:_upload``) do; the buffer is
  pinned once, before the timing, so the time is the link's and not the
  staging copy's.  Each copy is followed by a synchronise on the device
  and timed on the host clock, so a row's time holds the per-call cost.
- ``fit_latency_bandwidth``: least squares ``time = latency + bytes / bw``
  over a sweep: latency (the intercept) and bandwidth (the slope).
- ``overlap``: can a copy make progress while the card computes?  Times a
  compute loop alone, a copy loop alone, and the compute loop while a
  feeder thread copies on a stream of its own (the trainer's prefetch
  structure).  ``overlap_efficiency`` 1.0 means copies are free behind
  compute; 0.0 means they serialize.
- ``implied_flagship_floors``: the copy time of one B16 x 8192 batch in
  each wire format (bytes and ``.to()`` calls from the port's own
  ``data/pipeline.py:make_batch`` and ``data/wire.py``), and the points/s
  it allows beside a measured step, serialized and overlapped.

Every result names the device it ran on.  On ``device="cpu"`` a copy is a
host copy, which says nothing of a link: the CPU runs only exercise the
code.  Run on the card::

    python -m pointcloud_segmentation_attention_tpu_torch.utils.h2d_bench \\
        [--step_ms MS] [--iters 8]

(prints one JSON object; without ``--step_ms`` the flagship's float32
step is measured in the same run by ``bench_ops.step_rows``).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch.device import resolve

SIZES_MB = (0.0625, 0.25, 1.0, 4.0, 8.0, 16.0)
# The JAX package's names of the four wire formats, and the port's.
WIRE_FORMATS = {"f32_dict": "f32", "compact": "compact", "packed": "packed",
                "packed_q16": "packed_q16"}


def device_label(dev: torch.device) -> str:
    """The card's name, or ``'cpu'``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device, stream=None) -> None:
    if dev.type == "cuda":
        (stream or torch.cuda.current_stream(dev)).synchronize()


def _copier(nbytes: int, dev: torch.device, pinned: bool, seed: int = 0):
    """A function that copies ``nbytes`` seeded host bytes to ``dev`` once."""
    x = np.random.RandomState(seed).randint(0, 255, nbytes).astype(np.uint8)
    if not pinned:
        return lambda: torch.from_numpy(x).to(dev, copy=True)
    if dev.type != "cuda":
        raise ValueError("pinned copies need a card: pin_memory() is CUDA's")
    host = torch.from_numpy(x).pin_memory()
    return lambda: host.to(dev, non_blocking=True)


def sweep(sizes_mb=SIZES_MB, iters: int = 8, device="cuda", pinned: bool = False) -> List[Dict]:
    """One row per size: ``mb``, ``ms`` (mean wall time of one synchronised
    copy over ``iters``, after one warm-up copy), ``mb_per_s``, and the
    ``device`` and ``pinned`` it was taken with."""
    dev = resolve(device)
    out = []
    for mb in sizes_mb:
        copy = _copier(int(mb * 2**20), dev, pinned)
        copy()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            copy()
            _sync(dev)
        dt = (time.perf_counter() - t0) / iters
        out.append({"mb": mb, "ms": dt * 1e3, "mb_per_s": mb / dt,
                    "device": device_label(dev), "pinned": pinned})
    return out


def fit_latency_bandwidth(rows: List[Dict]) -> Dict:
    """Least-squares time = latency + bytes/bw over the sweep.

    Noise can flip the slope of a short sweep (one stalled window on a
    small payload makes bigger transfers look faster per byte), which
    would read as infinite bandwidth and a latency equal to the mean sample
    — and anything derived from the fit becomes nonsense.  A non-positive
    slope therefore falls back to per-row BOUNDS (latency = fastest observed
    transfer, bandwidth = best achieved rate) and flags the fit
    ``degenerate`` so callers can re-sweep."""
    x = np.array([r["mb"] for r in rows])
    y = np.array([r["ms"] for r in rows]) / 1e3
    a = np.vstack([np.ones_like(x), x * 2**20]).T
    (lat, inv_bw), *_ = np.linalg.lstsq(a, y, rcond=None)
    if inv_bw <= 0:
        return {"latency_ms": round(min(r["ms"] for r in rows), 3),
                "bandwidth_mb_per_s": round(
                    max(r["mb_per_s"] for r in rows), 1),
                "degenerate": True}
    # A slightly negative intercept (noise around a real slope) clamps to 0
    # rather than predicting negative transfer times.
    lat = max(float(lat), 0.0)
    return {"latency_ms": round(lat * 1e3, 3),
            "bandwidth_mb_per_s": round(1.0 / float(inv_bw) / 2**20, 1)}


@contextlib.contextmanager
def _tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def overlap(payload_mb: float = 4.0, compute_ms_target: float = 20.0, iters: int = 20,
            device="cuda", pinned: bool = False) -> Dict:
    """Compute loop vs copy loop vs both (a feeder thread).

    The compute is a chain of 2048 x 2048 float32 ``torch.matmul``s (TF32
    off), sized to about ``compute_ms_target`` a burn.  On a card a burn is
    one CUDA graph, as the JAX package's burn is one jitted program: the
    compute loop needs the interpreter lock once a burn, so a feeder that
    holds the lock through a pageable copy (``.to()`` from pageable memory
    returns only when the copy is done) cannot starve the card of
    launches.  The feeder copies on its own stream and waits for each copy
    on that stream alone: on the compute's stream its copies would queue
    behind the matmuls by construction.  ``compute_again_ms`` is the
    compute loop timed once more after the feeder stopped, the spread to
    read the interleaved time against; ``feeder_copies`` counts the copies
    made while the interleaved loop ran."""
    dev = resolve(device)
    n = 2048
    a = torch.from_numpy(np.random.RandomState(1).rand(n, n).astype(np.float32)).to(dev)

    def chain(k):
        x = a
        for _ in range(k):
            x = torch.matmul(x, a) * (1.0 / n)
        return x

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) / iters

    with _tf32_off():
        k = 4
        chain(k)
        _sync(dev)
        t0 = time.perf_counter()
        chain(k)
        _sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        # Scale k so one burn ~ compute_ms_target.
        k = max(1, int(k * compute_ms_target / max(step_ms, 1e-3)))
        burn = functools.partial(chain, k)
        if dev.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                chain(k)
            burn = graph.replay
        burn()
        _sync(dev)

        def compute_only():
            for _ in range(iters):
                burn()
            _sync(dev)

        copy = _copier(int(payload_mb * 2**20), dev, pinned, seed=2)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def copy_on_stream():
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                copy()
            _sync(dev, stream)

        def transfer_only():
            for _ in range(iters):
                copy_on_stream()

        stop = threading.Event()
        copies = [0]

        def feeder():
            while not stop.is_set():
                copy_on_stream()
                copies[0] += 1

        t_compute = timed(compute_only)
        t_transfer = timed(transfer_only)
        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        try:
            t_both = timed(compute_only)
        finally:
            stop.set()
            th.join(timeout=10)
        if th.is_alive():
            raise RuntimeError("the feeder thread did not stop within 10 s")
        feeder_copies = copies[0]
        t_again = timed(compute_only)

    serial = t_compute + t_transfer
    denom = max(serial - t_compute, 1e-9)
    eff = float(np.clip((serial - t_both) / denom, 0.0, 1.0))
    return {
        "compute_ms": t_compute * 1e3,
        "transfer_ms": t_transfer * 1e3,
        "interleaved_compute_ms": t_both * 1e3,
        "overlap_efficiency": eff,
        "compute_again_ms": t_again * 1e3,
        "feeder_copies": feeder_copies,
        "matmuls_per_burn": k,
        "payload_mb": payload_mb,
        "device": device_label(dev),
        "pinned": pinned,
    }


def wire_transfers(batch: int = 16, n: int = 8192) -> Dict[str, Dict[str, int]]:
    """Bytes and ``.to()`` calls of one training batch in each wire format:
    the arrays ``data.pipeline.make_batch`` gives for chunks with colors and
    normals, each of which ``train/steps.py:_to_device`` copies with one
    ``.to()``."""
    from pointcloud_segmentation_attention_tpu_torch.data.pipeline import make_batch

    chunk = {"points": np.zeros((n, 3), np.float32), "labels": np.zeros(n, np.int32),
             "colors": np.zeros((n, 3), np.float32), "normals": np.zeros((n, 3), np.float32),
             "weights": np.ones(n, np.float32)}
    out = {}
    for name, wire in WIRE_FORMATS.items():
        arrays = make_batch([chunk] * batch, True, True, wire=wire)
        out[name] = {"bytes": sum(np.ascontiguousarray(v).nbytes for v in arrays.values()),
                     "calls": len(arrays)}
    return out


def implied_flagship_floors(fit: Dict, step_ms: float, batch: int = 16,
                            n: int = 8192) -> Dict[str, Dict]:
    """For each wire format: the copy time of one batch from ``fit``
    (``calls`` x latency + bytes / bandwidth), and the points/s a step of
    ``step_ms`` allows when the copy is serialized with it or hidden
    behind it."""
    step_s = step_ms / 1e3
    floors = {}
    for name, w in wire_transfers(batch, n).items():
        t = w["calls"] * fit["latency_ms"] / 1e3 + w["bytes"] / (
            fit["bandwidth_mb_per_s"] * 2**20)
        floors[name] = {
            "bytes": w["bytes"], "calls": w["calls"],
            "transfer_ms": t * 1e3,
            "pts_per_s_if_serialized": batch * n / (t + step_s),
            "pts_per_s_if_overlapped": batch * n / max(t, step_s),
        }
    return floors


def measure(device="cuda", iters: int = 8, step_ms: Optional[float] = None,
            batch: int = 16, n: int = 8192) -> Dict:
    """``main``'s object: sweep, fit and overlap for pageable and pinned
    copies, the step the floors are set against (``step_ms``, or the
    flagship's float32 ``train_step`` row of ``bench_ops.step_rows`` at
    ``batch`` x ``n`` measured now) and the implied floors of each wire
    format for each route."""
    dev = resolve(device)
    routes = (False, True) if dev.type == "cuda" else (False,)
    out = {"device": device_label(dev)}
    for pinned in routes:
        rows = sweep(iters=iters, device=dev, pinned=pinned)
        out["pinned" if pinned else "pageable"] = {
            "sweep": rows, "fit": fit_latency_bandwidth(rows),
            "overlap": overlap(device=dev, pinned=pinned)}
    if step_ms is None:
        from pointcloud_segmentation_attention_tpu_torch.utils import bench_ops

        row, = bench_ops.step_rows(batch, n, device=dev, dtypes=("float32",), forward=False)
        step_ms, source = row["ms"], f"bench_ops {row['op']} B{batch} x {n}, measured now"
    else:
        source = "--step_ms"
    out["step_ms"], out["step_source"] = step_ms, source
    out["implied_flagship_floors"] = {
        route: implied_flagship_floors(out[route]["fit"], step_ms, batch, n)
        for route in ("pageable", "pinned") if route in out}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--step_ms", type=float, default=None,
                   help="the step the floors are set against (default: measured now)")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.device, args.iters, args.step_ms)))


if __name__ == "__main__":
    main()
