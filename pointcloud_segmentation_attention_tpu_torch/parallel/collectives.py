"""Every collective of the port, counted.

The port's training path moves data between ranks only through this module:
``all_reduce`` (a sum, in place) and ``broadcast``, the two collectives that
NCCL and gloo both run on CUDA tensors (gloo stages them through the host),
and ``barrier`` outside the step.
Each call adds one to its kind's call count and the tensor's bytes to its
byte count; ``collective_stats()`` reads them.  This is the port's
counterpart of the JAX package's ``parallel/hlo_analysis.py:collective_stats``,
read from the calls the program makes rather than from compiled HLO.

Inside ``timed()`` each call also adds its seconds: the host clock around
the call, with the tensor's CUDA device synchronised before and after, so
an asynchronous collective (NCCL) is timed to its end and none of the work
queued before it is.  The synchronisations change the step's overlap, so a
step's own time is read outside ``timed()``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

_STATS: Dict[str, Dict[str, float]] = {}
_TIMED = False


@contextlib.contextmanager
def _counted(kind: str, t: Optional[torch.Tensor]):
    s = _STATS.setdefault(kind, {"count": 0, "bytes": 0})
    s["count"] += 1
    if t is not None:
        s["bytes"] += t.numel() * t.element_size()
    if not _TIMED:
        yield
        return
    cuda = t is not None and t.is_cuda
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(t.device)
    s["seconds"] = s.get("seconds", 0.0) + time.perf_counter() - t0


def all_reduce(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place; returns ``t``."""
    with _counted("all-reduce", t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0,
              group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Overwrite ``t`` on every rank of ``group`` with rank ``src``'s value."""
    with _counted("broadcast", t):
        dist.broadcast(t, src=src, group=group)
    return t


def barrier(group: Optional[dist.ProcessGroup] = None) -> None:
    """Wait for every rank of ``group`` (no data; counted with 0 bytes)."""
    with _counted("barrier", None):
        dist.barrier(group=group)


@contextlib.contextmanager
def timed():
    """Time every collective while the block runs (the stats of each kind
    then carry 'seconds')."""
    global _TIMED
    was, _TIMED = _TIMED, True
    try:
        yield
    finally:
        _TIMED = was


def collective_stats() -> Dict[str, Dict[str, float]]:
    """``{kind: {'count': calls, 'bytes': bytes moved per rank}}`` since the
    last ``reset_collective_stats``, with 'seconds' for calls made inside
    ``timed()``."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()
