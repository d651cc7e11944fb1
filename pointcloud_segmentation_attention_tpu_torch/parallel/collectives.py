"""Every collective of the port, counted.

The port's training path moves data between ranks only through this module:
``all_reduce`` (a sum, in place) and ``broadcast``; for tensor parallelism
``all_gather`` and ``reduce_scatter`` on the last axis; and ``barrier``
outside the step.
Each call adds one to its kind's call count and its result's bytes to its
byte count, as the JAX package's audit counts an instruction's result, and
its result's shape to the kind's distinct shapes (an audit tells activations
from weights by them); ``collective_stats()`` reads them.  This is the
port's counterpart of the JAX package's
``parallel/hlo_analysis.py:collective_stats``, read from the calls the
program makes rather than from compiled HLO.

Inside ``timed()`` each call also adds its seconds: the host clock around
the call, with the tensor's CUDA device synchronised before and after, so
an asynchronous collective (NCCL) is timed to its end and none of the work
queued before it is.  The synchronisations change the step's overlap, so a
step's own time is read outside ``timed()``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_STATS: Dict[str, dict] = {}
_TIMED = False
# The name of the reduce-scatter of one tensor in this torch (newer versions
# renamed it).
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@contextlib.contextmanager
def _counted(kind: str, t: Optional[torch.Tensor], shape: Optional[Sequence[int]] = None):
    """Count a call of ``kind`` on ``t`` whose result has ``shape`` (default
    ``t``'s)."""
    s = _STATS.setdefault(kind, {"count": 0, "bytes": 0, "shapes": []})
    s["count"] += 1
    if t is not None:
        shape = tuple(t.shape if shape is None else shape)
        s["bytes"] += int(np.prod(shape, dtype=np.int64)) * t.element_size()
        if shape not in s["shapes"]:
            s["shapes"].append(shape)
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


def all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The (..., C) tensors of every rank of ``group`` joined on the last
    axis in rank order: a new contiguous (..., C * ranks) tensor."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    with _counted("all-gather", t, (*t.shape[:-1], t.shape[-1] * n)):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=-1)


def reduce_scatter(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``t`` (..., C * ranks) summed over the ranks of ``group``, and this
    rank's block of the last axis: a new contiguous (..., C) tensor."""
    n = dist.get_world_size(group)
    c = t.shape[-1] // n
    shape = (*t.shape[:-1], c)
    with _counted("reduce-scatter", t, shape):
        out = t.new_empty((1, *shape))
        _REDUCE_SCATTER(out, t.reshape(*shape[:-1], n, c).movedim(-2, 0).contiguous(),
                        group=group)
    return out[0]


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


def collective_stats() -> Dict[str, dict]:
    """``{kind: {'count': calls, 'bytes': result bytes on this rank,
    'shapes': the distinct result shapes in the order first seen}}`` since
    the last ``reset_collective_stats``, with 'seconds' for calls made
    inside ``timed()``."""
    return {k: dict(v, shapes=list(v["shapes"])) for k, v in _STATS.items()}


def full_kernel_allgathers(stats: Dict[str, dict],
                           kernel_shapes: Sequence[Sequence[int]]) -> List[Tuple[int, ...]]:
    """The all-gather result shapes in ``stats`` (``collective_stats()``)
    that equal a full weight kernel's shape: the evidence that a sharded
    kernel was rebuilt whole, the counterpart of the JAX package's
    ``hlo_analysis.full_kernel_allgathers``."""
    wanted = {tuple(s) for s in kernel_shapes}
    return [tuple(s) for s in stats.get("all-gather", {}).get("shapes", [])
            if tuple(s) in wanted]


def reset_collective_stats() -> None:
    _STATS.clear()
