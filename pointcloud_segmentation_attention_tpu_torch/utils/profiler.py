"""Profiling: ``torch.profiler`` traces, and the program's own spans and
counters; the counterpart of the JAX package's ``utils/profiler.py``.

``trace`` wraps ``torch.profiler.profile`` and writes a Chrome trace
(``*.pt.trace.json``, read by Perfetto, ``chrome://tracing`` and
TensorBoard's profiler plugin) into its directory.

``span(name, request=None)`` and ``count(name, n=1)`` mark the program's
layers where the work happens (the server's stages, the prefetch queue,
the training step's phases).  They record exactly while a
``torch.profiler`` session records, and cost one flag check otherwise.
The check reads ``torch.autograd.profiler._is_profiler_enabled``, the
profiler's process-wide flag: the C flag (``_profiler_enabled()``) is
per thread and reads False on a thread the session did not start, such
as the server's staging thread.  While on, a span enters
``record_function(name)``, so that it sits on the profiler's timeline
beside the kernels it launches (a thread started before the session, or
any thread under a session without ``profile_all_threads``, gets no
timeline event, but is recorded here all the same), and keeps in memory,
from any thread: per name the count, total and self seconds, and a
capped list of records (name, thread, start and end in
``time.perf_counter_ns``, the innermost span open on the same thread,
request).  A span without a request takes its parent's.  ``snapshot()``
reads it all; ``reset()`` clears it.  Nothing is written to disk.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# The program's span names start with these; ``trace_breakdown`` tells
# them from the profiler's own events by them.
SPAN_PREFIXES = ("serve.", "train.", "prefetch.", "nn.")
MAX_RECORDS = 100_000


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace context: host activity of every thread started inside it, and
    the card's kernels and copies where CUDA is available, written to
    ``log_dir`` as a Chrome trace when the context exits; yields the
    profiler.  A no-op (yielding None) when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import tensorboard_trace_handler

    with profile_all_threads(on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def profile_all_threads(**kwargs):
    """``torch.profiler.profile`` over CPU (and CUDA where available) that
    also records the host events of threads started inside it, such as
    the server's staging thread."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True), **kwargs)


class _Registry:
    """What the spans and counters recorded, shared by every thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.stats: Dict[str, List[int]] = {}     # name -> [count, total ns, self ns]
            self.counters: Dict[str, int] = {}
            self.records: List[Tuple] = []
            self.dropped = 0

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_REGISTRY = _Registry()


class _Span:
    __slots__ = ("name", "request", "parent", "start", "child_ns", "annotation")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = _REGISTRY.stack()
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.child_ns = 0
        self.annotation = _autograd_profiler.record_function(self.name)
        self.annotation.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _REGISTRY.stack().pop()
        self.annotation.__exit__(*exc)
        took = end - self.start
        if self.parent is not None:
            self.parent.child_ns += took
        record = (self.name, threading.get_ident(), self.start, end,
                  self.parent.name if self.parent is not None else None, self.request)
        with _REGISTRY.lock:
            agg = _REGISTRY.stats.setdefault(self.name, [0, 0, 0])
            agg[0] += 1
            agg[1] += took
            agg[2] += took - self.child_ns
            if len(_REGISTRY.records) < MAX_RECORDS:
                _REGISTRY.records.append(record)
            else:
                _REGISTRY.dropped += 1
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def span(name: str, request=None):
    """Context manager: a span of the program's work named ``name``, under
    request ``request`` (a room's sequence number, a step's number; by
    default the enclosing span's).  Records only while a profiler session
    records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, only while a profiler session
    records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _REGISTRY.lock:
        _REGISTRY.counters[name] = _REGISTRY.counters.get(name, 0) + int(n)


def snapshot() -> Dict:
    """What was recorded since the last ``reset()``: ``spans`` (per name
    ``count``, ``total_s``, ``self_s``: the total less the time its
    children on the same thread took), ``counters``, ``records`` (dicts of
    name, thread, start_ns, end_ns, parent, request; at most
    ``MAX_RECORDS``) and ``dropped`` (records past the cap)."""
    with _REGISTRY.lock:
        spans = {k: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                 for k, (c, t, s) in _REGISTRY.stats.items()}
        keys = ("name", "thread", "start_ns", "end_ns", "parent", "request")
        return {"spans": spans, "counters": dict(_REGISTRY.counters),
                "records": [dict(zip(keys, r)) for r in _REGISTRY.records],
                "dropped": _REGISTRY.dropped}


def reset() -> None:
    """Clear every span, counter and record."""
    _REGISTRY.reset()
