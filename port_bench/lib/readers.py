"""What the per-layer metrics' readers (``metrics/<name>.py``) share.  A
reader gets the run's context (the cell, the driver, the window's record,
the traced stretch's record and its ``trace.Summary``) and returns its
number, or None where it finds nothing to read."""
from __future__ import annotations

import math
from typing import Dict, Optional

from port_bench.cost import kernels, model
from port_bench.reference import serve as ref_serve

SEVEN = ("fps", "ball_query", "group_gather", "three_nn", "three_interpolate",
         "group_gather_bwd", "three_interpolate_bwd")


def idle_share(ctx) -> float:
    """The share of the window's wall time in which no kernel ran: the traced
    stretch's busy time (the union of kernel intervals) a step, or a chunk
    served, over the unprofiled window's wall time a step or chunk.  The
    profiler slows the host, so the traced stretch's own idle share reads
    high; and the window's rooms are not the traced pass's, so serving
    counts chunks, which set a room's device work, not rooms."""
    w, tr = ctx["window"], ctx["traced"]
    if "steps" in w:
        units, traced_units = w["steps"], tr["steps"]
    else:
        units, traced_units = served_chunks(ctx, w), served_chunks(ctx, tr)
    return 100.0 * (1.0 - (ctx["trace"].busy_s / traced_units) / (w["wall_s"] / units))


def _chunks(ctx):
    """Chunks each pool room needs (the reference chunker's count, on the
    coordinates the wire format carries)."""
    d = ctx["driver"]
    if "_chunks" not in ctx:
        ctx["_chunks"] = [ref_serve.chunk_count(ref_serve.wire_q16(r, False, False)["points"],
                                                d.npoints) for r in d.pool]
    return ctx["_chunks"]


def mfu_train(ctx) -> float:
    t, w = ctx["driver"].traffic, ctx["window"]
    flops = model.train_step_flops(ctx["driver"].cfg, t["batch_size"], t["npoints"]) * w["steps"]
    return 100.0 * flops / w["wall_s"] / kernels.peak_flops()


def served_chunks(ctx, record) -> int:
    """Chunks the rooms of a window's or traced stretch's ``record`` need."""
    return sum(c * x for c, x in zip(record["pool_counts"], _chunks(ctx)))


def mfu_serve(ctx) -> float:
    t, w = ctx["driver"].traffic, ctx["window"]
    chunks = served_chunks(ctx, w)
    flops = chunks * model.forward_flops(ctx["driver"].cfg, 1, t["npoints"])
    return 100.0 * flops / w["wall_s"] / kernels.peak_flops()


def per_unit(ctx, value: float) -> float:
    """``value`` per step (training) or per room (serving: the pool's rooms,
    each once) of the traced stretch."""
    tr = ctx["traced"]
    return value / (tr["steps"] if "steps" in tr else tr["rooms"])


def bounds(ctx) -> Dict[str, float]:
    """Seconds of bound of the seven kernels over the traced stretch."""
    d, tr = ctx["driver"], ctx["traced"]
    cfg, t = d.cfg, d.traffic
    b, n = t["batch_size"], t["npoints"]
    if d.kind == "train":
        per = kernels.forward_bounds(cfg, b, n, True, d.extras.get("visits"))
        return {k: v * tr["steps"] for k, v in per.items()}
    visits = None
    if d.extras.get("visit_chunks"):
        visits = {k: v * b / d.extras["visit_chunks"] for k, v in d.extras["visit_sum"].items()}
    per = kernels.forward_bounds(cfg, b, n, False, visits)
    batches = sum(c * math.ceil((x + b) / b) for c, x in zip(tr["pool_counts"], _chunks(ctx)))
    return {k: v * batches for k, v in per.items()}


def roofline(ctx, kernel: Optional[str]) -> Optional[float]:
    """Bound time over kernel time, in percent: of one kernel, or with None
    of the seven pooled."""
    own = ctx["trace"].own_s
    names = SEVEN if kernel is None else (kernel,)
    spent = sum(own.get(k, 0.0) for k in names)
    if spent <= 0:
        return None
    b = bounds(ctx)
    return 100.0 * sum(b[k] for k in names) / spent
