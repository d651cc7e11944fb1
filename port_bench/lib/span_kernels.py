"""Kernel time of a ``torch.profiler`` trace by the program span around each
kernel's launch, and by kernel name: the attribution of the program's
``utils/trace_breakdown.kernel_ms_by_span``, copied here so that no change
to the program can move the yardstick.

A kernel's launch is the CUDA API event sharing its correlation id; its
span is the first program span among the launch's CPU parents, else the
innermost one open on its thread at the launch, and on a thread with no
program span (autograd's backward threads) the innermost ones open on the
other threads, joined by '+'.  Copies and sets are left out."""
from __future__ import annotations

import bisect
import itertools
from collections import defaultdict
from typing import Dict, Optional

import torch

# The program's span names start with these (``utils/profiler.SPAN_PREFIXES``).
SPAN_PREFIXES = ("serve.", "train.", "prefetch.", "nn.")
NO_SPAN = "(no program span)"


def _is_span(name: str) -> bool:
    return name.startswith(SPAN_PREFIXES)


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def _kernels(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not _is_copy(e.name)]


def _span_index(events) -> dict:
    by_thread = defaultdict(list)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and _is_span(e.name):
            by_thread[e.thread].append((e.time_range.start, e.time_range.end, e.name))
    index = {}
    for thread, spans in by_thread.items():
        spans.sort(key=lambda x: (x[0], -x[1]))
        index[thread] = ([x[0] for x in spans],
                         list(itertools.accumulate((x[1] for x in spans), max)), spans)
    return index


def _innermost(entry, t) -> Optional[str]:
    starts, reach, spans = entry
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and reach[i] > t:
        if spans[i][1] > t:
            return spans[i][2]
        i -= 1
    return None


def _open_at(index: dict, t) -> str:
    return "+".join(sorted(n for n in (_innermost(e, t) for e in index.values()) if n))


def seconds_by_span(prof) -> Dict[str, float]:
    """Kernel seconds by the program span around each kernel's launch."""
    events = prof.events()
    index = _span_index(events)
    launches = {e.id: e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cu") and "Launch" in e.name}
    out: Dict[str, float] = defaultdict(float)
    for k in _kernels(prof):
        launch, label = launches.get(k.id), None
        if launch is not None:
            owner = launch.cpu_parent
            while owner is not None and not _is_span(owner.name):
                owner = owner.cpu_parent
            if owner is not None:
                label = owner.name
            elif launch.thread in index:
                label = _innermost(index[launch.thread], launch.time_range.start)
            else:
                label = _open_at(index, launch.time_range.start)
        out[label or NO_SPAN] += k.time_range.elapsed_us() / 1e6
    return dict(out)


def seconds_named(prof, part: str) -> float:
    """Seconds of the kernels whose name holds ``part``."""
    return sum(k.time_range.elapsed_us() / 1e6 for k in _kernels(prof) if part in k.name)
