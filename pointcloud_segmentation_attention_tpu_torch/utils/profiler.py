"""Profiling: ``torch.profiler`` traces and a simple step timer; the
counterpart of the JAX package's ``utils/profiler.py``.

``trace`` wraps ``torch.profiler.profile`` and writes a Chrome trace
(``*.pt.trace.json``, read by Perfetto, ``chrome://tracing`` and
TensorBoard's profiler plugin) into its directory; ``StepTimer`` gives
EMA'd step times and points/sec for a training loop.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace context: host activity, and the card's kernels and copies where
    CUDA is available, written to ``log_dir`` as a Chrome trace when the
    context exits; yields the profiler.  A no-op (yielding None) when
    ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt

    def points_per_sec(self, points_per_step: int) -> float:
        return points_per_step / self.avg if self.avg else 0.0
