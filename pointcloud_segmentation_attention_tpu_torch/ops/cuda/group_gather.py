"""Wrappers of ``csrc/group_gather.cu`` and ``csrc/group_gather_bwd.cu``:
neighbourhood row gather on the card, its scatter-add backward (through a
CSR of idx's transpose), and the autograd function joining them."""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
    check_input,
    csr,
    launch,
    refuse_grad,
)
from pointcloud_segmentation_attention_tpu_torch.ops.cuda.csr import CsrPlan

THREADS_BWD = 256   # threads a block of the backward's consuming pass
MAX_PER_LANE = 5    # the most elements of a row a lane of the consuming pass takes (floats)
MAX_PER_LANE_VEC = 4  # the same in float4s
# float4 accesses? -> elements a lane takes -> rows a round of the consuming pass
# (the pairs csrc/group_gather_bwd.cu builds; a float4 is four registers).  On
# an H100 4 and 16 rows measured no faster than 8 at SA2-4 (utils/plan_sweep.py).
AHEAD = {False: {1: 8, 2: 8, 3: 8, 4: 8, 5: 8}, True: {1: 8, 2: 4, 3: 2, 4: 2}}
WINDOW = 16         # CSR places a lane group of the consuming pass takes
ZERO_KEYS = 32      # rows a zero group of the consuming pass checks (csrc: kZeroKeys)
FUSED_STEPS = 4     # 32-entry steps a fused CSR's warp takes, where the block allows


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a 16-byte boundary (float4 accesses)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,N,C) f32, (B,M,K) int32 CUDA -> (B,M,K,C): out[b,m,k] = points[b, idx[b,m,k]].
    Not differentiable itself: ``GroupPoint`` is."""
    check_input(points, "points", torch.float32, 3)
    check_input(idx, "idx", torch.int32, 3)
    refuse_grad("group_point", points)
    b, n, c = points.shape
    _, m, k = idx.shape
    if idx.shape[0] != b or idx.device != points.device:
        raise ValueError("points and idx must share batch size and device")
    out = torch.empty((b, m, k, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    launch("psa_group_gather", points.device, points.data_ptr(), idx.data_ptr(),
           out.data_ptr(), b, n, c, m, k)
    group_point.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def csr_plan(b: int, n: int, m: int, k: int) -> CsrPlan:
    """The CSR of B batches of M*K slots into N rows: ``csr.plan`` of M*K
    entries a batch and N keys, fused blocks of up to 226 KB preferring 4
    steps a warp (fused at SA2-4 at B16: 32, 16 and 4 warps; tiled beyond
    12,032 rows)."""
    if min(b, n, m, k) < 1:
        raise ValueError(f"gather CSR plan needs B, N, M, K >= 1, got {b}, {n}, {m}, {k}")
    if b * m * k >= 2 ** 31:
        raise ValueError(f"B * M * K = {b * m * k} slots do not fit int32")
    return csr.plan(b, m * k, n, fused_smem=csr.SMEM_MAX, fused_steps=FUSED_STEPS)


class BackwardPlan(NamedTuple):
    """How ``csrc/group_gather_bwd.cu`` runs one call: the CSR, then the
    consuming pass, a lane group per window of the CSR's places and column
    block."""

    csr: CsrPlan
    vector: bool      # float4 accesses of g and dP, else floats
    lanes: int        # lanes per (window, column block), a power of two <= 32
    per_lane: int     # elements of a row a lane takes in its column block (1-5)
    ahead: int        # rows a round: their loads are all issued before the first add
    col_blocks: int   # column blocks (grid.y)
    threads: int      # threads per block
    blocks: int       # blocks over the windows, then the zero groups
    window: int       # CSR places a window


def windows(b: int, m: int, k: int, window: int) -> int:
    return -(-(b * m * k) // window)


def consume_blocks(b: int, n: int, m: int, k: int, window: int, lanes: int,
                   threads: int) -> int:
    """Blocks of the consuming pass: a group per window, then a group per
    ``ZERO_KEYS`` rows, ``threads // lanes`` groups a block."""
    groups = windows(b, m, k, window) + -(-(b * n) // ZERO_KEYS)
    return -(-groups // (threads // lanes))


@functools.lru_cache(maxsize=256)
def backward_plan(b: int, n: int, m: int, k: int, c: int, is_aligned: bool) -> BackwardPlan:
    """The backward's launch for g (B,M,K,C) into dP (B,N,C).  The consuming
    pass walks a row in float4s where C % 4 == 0 and the pointers allow it,
    else in floats (C = 67, 131, 259 at SA2-4); the fewest lanes up to 32
    that give each lane one element form a group, a lane takes up to
    ``MAX_PER_LANE`` elements L apart, and a wider row is cut into the
    fewest column blocks that allows, the elements spread evenly over them
    (at SA2 one block of 3 a lane, at SA3 one of 5, at SA4 two of 5: 5 a
    lane measured 1.2 us faster than two blocks of 3 at SA3); a group takes
    ``WINDOW`` places of the CSR and loads ``AHEAD`` rows a round.
    Windows of 16 measured faster than 32 at SA3-4 on an H100 (a window
    walks its places plus the rest of a segment that starts in it, ~30 of
    ball-query padding; ``utils/plan_sweep.py``)."""
    sort = csr_plan(b, n, m, k)
    if c < 1:
        raise ValueError(f"group_gather backward plan needs C >= 1, got {c}")
    vector = is_aligned and c % 4 == 0
    width = c // 4 if vector else c
    lanes = min(32, csr.pow2_at_least(width))
    col_blocks = -(-width // (lanes * (MAX_PER_LANE_VEC if vector else MAX_PER_LANE)))
    per_lane = -(-width // (lanes * col_blocks))
    return BackwardPlan(sort, vector, lanes, per_lane, AHEAD[vector][per_lane], col_blocks,
                        THREADS_BWD, consume_blocks(b, n, m, k, WINDOW, lanes, THREADS_BWD),
                        WINDOW)


def backward_scratch(b: int, n: int, m: int, k: int, p: BackwardPlan, device):
    """One int32 tensor for all of the backward's scratch, and the addresses
    of its parts: the CSR's entries (BMK), its offsets (B*N + 1), the
    chunked CSR's histograms, and the (first key, its offset) of each window
    and of the end, which sit first in the tensor to be 8-byte aligned."""
    first = 2 * (windows(b, m, k, p.window) + 1)  # (key, offset) pairs, 8-byte aligned first
    sizes = (first, b * m * k, b * n + 1, p.csr.hist_ints)
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    at = scratch.data_ptr()
    entries = at + 4 * first
    offsets = entries + 4 * sizes[1]
    return scratch, entries, offsets, offsets + 4 * sizes[2], at


def _check_backward(g: torch.Tensor, idx: torch.Tensor) -> Tuple[int, int, int, int]:
    check_input(g, "g", torch.float32, 4)
    check_input(idx, "idx", torch.int32, 3)
    b, m, k, c = g.shape
    if tuple(idx.shape) != (b, m, k) or idx.device != g.device:
        raise ValueError("g and idx shapes or devices disagree")
    return b, m, k, c


def group_point_backward(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B,M,K,C) f32, (B,M,K) int32 CUDA -> dP (B,n,C): the sum of the g rows
    gathered from each of the n rows.  No atomics: dP equals the plain
    version run on the CPU bit for bit, and is the same from call to call."""
    b, m, k, c = _check_backward(g, idx)
    if g.numel() == 0 or n == 0:
        return torch.zeros((b, n, c), dtype=torch.float32, device=g.device)
    dp = torch.empty((b, n, c), dtype=torch.float32, device=g.device)  # every row written
    p = backward_plan(b, n, m, k, c, aligned(g, dp))
    # scratch lives until the call returns; the allocator reuses it in stream order
    scratch, entries, offsets, hist, first_key = backward_scratch(b, n, m, k, p, g.device)
    sort = p.csr
    launch("psa_group_gather_bwd", g.device, g.data_ptr(), idx.data_ptr(), dp.data_ptr(),
           offsets, entries, hist, first_key, b, n, c, m, k, int(sort.variant != "chunked"),
           sort.steps, sort.warps, sort.smem_bytes, int(p.vector), p.lanes, p.per_lane, p.ahead,
           p.col_blocks, p.threads, p.window)
    group_point_backward.launches += 1
    return dp


def group_gather_csr(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CSR the backward builds, on its own: idx (B,M,K) int32 CUDA with
    values in [0, n) -> offsets (B*n + 1) and entries (BMK) int32; the
    entries of key b*n + t are the flat slots (b*M + m)*K + k with
    idx[b, m, k] == t, ascending.  Equals ``geometry.transpose_csr``."""
    check_input(idx, "idx", torch.int32, 3)
    b, m, k = idx.shape
    if n < 1:
        raise ValueError(f"group_gather_csr needs n >= 1, got {n}")
    if b * m * k == 0:
        return (torch.zeros(b * n + 1, dtype=torch.int32, device=idx.device),
                torch.empty(0, dtype=torch.int32, device=idx.device))
    sort = csr_plan(b, n, m, k)
    offsets = torch.empty(b * n + 1, dtype=torch.int32, device=idx.device)
    entries = torch.empty(b * m * k, dtype=torch.int32, device=idx.device)
    hist = torch.empty(sort.hist_ints, dtype=torch.int32, device=idx.device)
    launch("psa_group_gather_csr", idx.device, idx.data_ptr(), offsets.data_ptr(),
           entries.data_ptr(), hist.data_ptr(), b, n, m, k, int(sort.variant != "chunked"),
           sort.steps, sort.warps, sort.smem_bytes)
    group_gather_csr.launches += 1
    return offsets, entries


class GroupPoint(torch.autograd.Function):
    """``group_point`` with the scatter-add kernel as its backward; ``idx``
    gets no gradient."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return group_point(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        dp = None
        if ctx.needs_input_grad[0]:
            dp = group_point_backward(grad.contiguous(), idx, ctx.n)
        return dp, None


group_point.launches = 0
group_point_backward.launches = 0
group_gather_csr.launches = 0
