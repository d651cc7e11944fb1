"""Reduction of a ``torch.profiler`` trace of the traced stretch to device
numbers: the busy time as the union of kernel intervals (overlapping
streams counted once, copies not counted as busy), the kernel time by
group and by the program's own kernels, the kernel count, and the
longest idle gaps labelled by the benchmark's own spans.

Kernel groups: the substrings of the program's ``csrc/`` kernels each
name a group of their own (both backwards' CSR passes are told apart by
``csr.cuh``'s last template argument), then GEMMs, reductions and
elementwise kernels: the grouping of the program's
``utils/trace_breakdown.py``, copied, with softmax kernels apart.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

OWN_KERNELS = ("fps_regs_kernel", "fps_mem_kernel", "ball_query_kernel", "group_gather_kernel",
               "group_gather_bwd_kernel", "three_nn_kernel", "three_interpolate_kernel",
               "three_interpolate_bwd_kernel", "dw_combine_kernel")
CSR_GROUPS = {True: "interpolation CSR (csr.cuh)", False: "gather CSR (csr.cuh)"}
# Which of the seven kernels each own group belongs to (a backward's CSR
# passes are part of its work).
KERNEL_OF = {"fps_regs_kernel": "fps", "fps_mem_kernel": "fps",
             "ball_query_kernel": "ball_query", "group_gather_kernel": "group_gather",
             "group_gather_bwd_kernel": "group_gather_bwd",
             CSR_GROUPS[False]: "group_gather_bwd", "three_nn_kernel": "three_nn",
             "three_interpolate_kernel": "three_interpolate",
             "three_interpolate_bwd_kernel": "three_interpolate_bwd",
             "dw_combine_kernel": "three_interpolate_bwd",
             CSR_GROUPS[True]: "three_interpolate_bwd"}
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.traced_window"
TOP = 10


def group_of(name: str) -> str:
    if "csr::csr_" in name:
        return CSR_GROUPS[name.split(">(")[0].endswith("true")]
    for k in OWN_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "reduce_kernel" in low:
        return "reductions"
    if "softmax" in low:
        return "softmax"
    if "elementwise_kernel" in low:
        return "elementwise"
    return "other kernels"


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: float
    kernels: int
    group_s: Dict[str, float]
    own_s: Dict[str, float]
    gaps: List[Tuple[str, float]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(prof) -> Summary:
    """The traced stretch's device numbers; times in seconds.  The stretch
    is the span ``WINDOW_SPAN``; kernels outside it are left out."""
    spans, kernels = [], []
    for evt in prof.events():
        start, end = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False) or _is_copy(evt.name):
                continue
            kernels.append((start, end, evt.name))
        elif evt.name.startswith(SPAN_PREFIX):
            spans.append((start, end, evt.name))
    windows = [(s, e) for s, e, n in spans if n == WINDOW_SPAN]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = windows[0]
    kernels = [(max(s, w0), min(e, w1), n) for s, e, n in kernels if e > w0 and s < w1]
    group_s: Dict[str, float] = defaultdict(float)
    own_s: Dict[str, float] = defaultdict(float)
    for s, e, n in kernels:
        g = group_of(n)
        group_s[g] += e - s
        if g in KERNEL_OF:
            own_s[KERNEL_OF[g]] += e - s
    merged = _union([(s, e) for s, e, _ in kernels])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    idle = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)[:TOP]
    inner = [sp for sp in spans if sp[2] != WINDOW_SPAN]
    gaps = []
    for length, a, b in idle:
        mid = (a + b) / 2
        active = {name for s, e, name in inner if s <= mid < e}
        gaps.append(("+".join(sorted(active)) or "no bench span", length))
    return Summary(window_s=w1 - w0, busy_s=busy, kernel_s=sum(e - s for s, e, _ in kernels),
                   kernels=len(kernels), group_s=dict(group_s), own_s=dict(own_s),
                   gaps=gaps)


def breakdown(summary: Summary) -> Dict[str, list]:
    ops = sorted(summary.group_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary.gaps]}
