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

A CUDA graph's capture (``train/step_graph.py``) runs Python once for many
replays: inside ``tally()`` the counts go to a dict that each replay adds
back, and inside ``split_at_spans(mark)`` each span calls ``mark`` at its
ends, where the capture starts a new graph, so that a replay launches each
stretch under the spans that enclosed it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

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
# While ``tally()`` runs: the dict that ``count`` adds to instead of the registry.
_TALLY: Optional[Dict[str, int]] = None
# While ``split_at_spans(mark)`` runs: (its thread's ident, ``mark``).
_SPLIT: Optional[Tuple[int, Callable[[str, str], None]]] = None


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


class _Split:
    """A span opened inside ``split_at_spans``: ``mark`` at both its ends,
    outside the span itself (``_Span`` or ``_OFF``)."""
    __slots__ = ("name", "inner", "mark")

    def __init__(self, name: str, inner, mark: Callable[[str, str], None]):
        self.name, self.inner, self.mark = name, inner, mark

    def __enter__(self):
        self.mark("enter", self.name)
        return self.inner.__enter__()

    def __exit__(self, exc_type, exc, tb):
        out = self.inner.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self.mark("exit", self.name)
        return out


def span(name: str, request=None):
    """Context manager: a span of the program's work named ``name``, under
    request ``request`` (a room's sequence number, a step's number; by
    default the enclosing span's).  Records only while a profiler session
    records; inside ``split_at_spans`` it also marks its ends."""
    inner = _Span(name, request) if _autograd_profiler._is_profiler_enabled else _OFF
    split = _SPLIT
    if split is not None and split[0] == threading.get_ident():
        return _Split(name, inner, split[1])
    return inner


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, only while a profiler session
    records; inside ``tally()``, to the tally, always."""
    tally_ = _TALLY
    if tally_ is not None:
        with _REGISTRY.lock:
            tally_[name] = tally_.get(name, 0) + int(n)
        return
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _REGISTRY.lock:
        _REGISTRY.counters[name] = _REGISTRY.counters.get(name, 0) + int(n)


@contextlib.contextmanager
def tally():
    """Context: every ``count`` made inside, from any thread, goes to the
    dict yielded (name -> total), whether or not a profiler records, and
    not to the registry."""
    global _TALLY
    counts: Dict[str, int] = {}
    previous, _TALLY = _TALLY, counts
    try:
        yield counts
    finally:
        _TALLY = previous


@contextlib.contextmanager
def split_at_spans(mark: Callable[[str, str], None]):
    """Context: every span opened inside on this thread calls
    ``mark('enter', name)`` before it opens and ``mark('exit', name)`` after
    it closes (not when it closes on an exception), whether or not a
    profiler records; spans of other threads do not.  A CUDA graph's
    capture cuts itself there (``train/step_graph.py``)."""
    global _SPLIT
    previous, _SPLIT = _SPLIT, (threading.get_ident(), mark)
    try:
        yield
    finally:
        _SPLIT = previous


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
