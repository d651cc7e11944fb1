"""Wrappers of ``csrc/three_interpolate.cu`` and ``csrc/three_interpolate_bwd.cu``:
weighted 3-row gather on the card, its backward (through a CSR of idx's
transpose), and the autograd function joining them."""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import (
    check_input,
    launch,
    refuse_grad,
)

THREADS_FWD = 128        # threads a block of the forward
PER_ROW_LANE = 2         # the most elements (float4s or floats) a forward lane takes of a row
# The consuming pass: (entries whose g rows a lane has in flight, threads a
# block) for fewer than SMALL_GROUPS lane groups (FP1-2 at B16), and beyond.
SMALL_GROUPS = 4096
CONSUME_SMALL, CONSUME_LARGE = (8, 256), (4, 128)
CSR_STEPS = (8, 64)      # the least and most 32-entry steps of a chunked CSR's chunk
CSR_WARPS = (8, 4, 2, 1)  # chunks (warps) a block of the chunked CSR passes, most first
FUSED_WARPS = 32         # the most warps (chunks) of a fused CSR's block
FUSED_MAX_STEPS = 8      # the most 32-entry steps of a fused CSR's chunk
SMEM_LIMIT = 47 * 1024   # dynamic shared memory of a CSR block (csrc: kSmemLimit)
SCAN_TILE = 256          # keys a block of the chunked CSR's scan takes (csrc: kScanTile)
MIN_BLOCKS = 264         # two blocks per SM of an H100


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a 16-byte boundary (float4 accesses)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


class InterpolatePlan(NamedTuple):
    """How ``csrc/three_interpolate.cu`` runs one call."""

    vector: bool        # float4 accesses (C % 4 == 0, pointers 16-byte aligned), else floats
    lanes: int          # lanes per output row, a power of two <= 32
    rows_per_warp: int  # 32 / lanes
    threads: int        # threads per block
    blocks: int         # blocks per batch; the grid is (blocks, B)


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, m: int, c: int, is_aligned: bool) -> InterpolatePlan:
    """The forward's launch for B batches of N output rows of C channels
    from M source rows.

    A row is walked in float4s where C % 4 == 0 and the pointers allow it,
    else in floats; it goes to the fewest lanes (a power of two, at most 32)
    that give each lane at most two of its ``width`` elements: 16 lanes at
    FP4 (C 128), 32 at FP1-3.  128 threads a block.  Both from
    ``utils/plan_sweep.py`` on an H100: at FP4 16 lanes of two float4s took
    28.0 us, 32 lanes of one 35.1 us; FP1-3 were within 0.4 us of their
    best."""
    if min(b, n, m, c) < 1:
        raise ValueError(f"three_interpolate plan needs B, N, M, C >= 1, got {b}, {n}, {m}, {c}")
    vector = is_aligned and c % 4 == 0
    width = c // 4 if vector else c
    lanes = min(32, _pow2_at_least(-(-width // PER_ROW_LANE)))
    return InterpolatePlan(vector, lanes, 32 // lanes, THREADS_FWD,
                           -(-n // (THREADS_FWD // lanes)))


class CsrPlan(NamedTuple):
    """How the CSR passes of ``csrc/three_interpolate_bwd.cu`` run one call."""

    variant: str      # "fused": one kernel, a block per batch; "chunked": three kernels
    steps: int        # 32-entry steps in a chunk (a warp's share of a batch's 3N entries)
    chunks: int       # chunks per batch
    warps: int        # chunks (warps) per block
    smem_bytes: int   # the warps' key counters (M each) in shared memory; 0: in the histogram
    hist_ints: int    # the chunked layout's per-chunk counts and per-tile sums of them


@functools.lru_cache(maxsize=256)
def csr_plan(b: int, n: int, m: int) -> CsrPlan:
    """The CSR of B batches of N rows of 3 indices into M known points.

    Fused where one block of up to 32 warps, each with M counters in shared
    memory, covers a batch's 3N entries in at most ``FUSED_MAX_STEPS`` steps
    of 32 each (FP1-3 at B16).  Else chunked: a chunk holds about M / 2
    entries (16 steps at FP4: the histograms hold about twice as many ints
    as there are entries; 32 steps measured 2.6 us slower on an H100,
    ``utils/plan_sweep.py``), between ``CSR_STEPS`` steps of 32, and no more
    than a batch has; its counters sit in shared memory while a warp's M ints
    fit, else in the histogram; a block takes the most chunks (up to 8,
    within the limit) that still leave ``MIN_BLOCKS`` blocks."""
    if min(b, n, m) < 1:
        raise ValueError(f"interpolation CSR plan needs B, N, M >= 1, got {b}, {n}, {m}")
    if 3 * b * n >= 2 ** 31:
        raise ValueError(f"3 * B * N = {3 * b * n} entries do not fit int32")
    most = min(FUSED_WARPS, SMEM_LIMIT // (4 * m))
    if most >= 1 and -(-3 * n // (32 * most)) <= FUSED_MAX_STEPS:
        steps = -(-3 * n // (32 * most))
        warps = -(-3 * n // (32 * steps))
        return CsrPlan("fused", steps, warps, warps, 4 * m * warps, 0)
    lo, hi = CSR_STEPS
    steps = min(max(lo, _pow2_at_least(-(-m // 64))), hi, -(-3 * n // 32))
    chunks = -(-3 * n // (32 * steps))
    in_smem = 4 * m <= SMEM_LIMIT
    fits = [w for w in CSR_WARPS if w == 1 or (w <= chunks
                                               and (not in_smem or 4 * m * w <= SMEM_LIMIT))]
    warps = next(w for w in fits if w == 1 or b * -(-chunks // w) >= MIN_BLOCKS)
    return CsrPlan("chunked", steps, chunks, warps, 4 * m * warps if in_smem else 0,
                   b * chunks * (m + -(-m // SCAN_TILE)))


class BackwardPlan(NamedTuple):
    """How ``csrc/three_interpolate_bwd.cu`` runs one call: the CSR, then the
    consuming pass, a lane group per known point and column block."""

    csr: CsrPlan
    vector: bool      # float4 accesses of g, P and dP, else floats
    lanes: int        # lanes per (known point, column block), a power of two <= 32
    ahead: int        # entries whose g rows a lane loads before adding them (2, 4 or 8)
    col_blocks: int   # column blocks of one element a lane (grid.y)
    threads: int      # threads per block
    blocks: int       # blocks over the B * M known points


@functools.lru_cache(maxsize=256)
def backward_plan(b: int, n: int, m: int, c: int, is_aligned: bool) -> BackwardPlan:
    """The backward's launch.  The consuming pass walks a row of C in
    float4s where allowed; the fewest lanes up to 32 that give each lane one
    element form a group, and a wider row is cut into column blocks of 32
    elements, each its own group (with dw, the blocks' partial dot products
    are added in order by a last small kernel).  Few groups (FP1-2 at B16)
    keep 8 entries' g rows in flight a lane in blocks of 256 threads, more
    keep 4 in blocks of 128: from ``utils/plan_sweep.py`` on an H100 (FP1
    dP+dw 8.6 against 10.6 us, FP4 72.5 against 75.9 us)."""
    csr = csr_plan(b, n, m)
    if c < 1:
        raise ValueError(f"three_interpolate backward plan needs C >= 1, got {c}")
    vector = is_aligned and c % 4 == 0
    width = c // 4 if vector else c
    lanes = min(32, _pow2_at_least(width))
    col_blocks = -(-width // lanes)
    groups = b * m * col_blocks
    ahead, threads = CONSUME_SMALL if groups < SMALL_GROUPS else CONSUME_LARGE
    return BackwardPlan(csr, vector, lanes, ahead, col_blocks, threads,
                        -(-(b * m) // (threads // lanes)))


def _check(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> None:
    check_input(points, "points", torch.float32, 3)
    check_input(idx, "idx", torch.int32, 3, last=3)
    check_input(weight, "weight", torch.float32, 3, last=3)
    if idx.shape[0] != points.shape[0] or weight.shape != idx.shape:
        raise ValueError("points, idx and weight shapes disagree")
    if idx.device != points.device or weight.device != points.device:
        raise ValueError("points, idx and weight must share a device")


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B,M,C) f32, (B,N,3) int32, (B,N,3) f32 CUDA -> (B,N,C), bit-identical
    to the plain version.  Not differentiable itself: ``ThreeInterpolate``
    is."""
    _check(points, idx, weight)
    refuse_grad("three_interpolate", points, weight)
    b, m, c = points.shape
    n = idx.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    p = plan(b, n, m, c, aligned(points, out))
    launch("psa_three_interpolate", points.device, points.data_ptr(), idx.data_ptr(),
           weight.data_ptr(), out.data_ptr(), b, m, n, c, int(p.vector), p.lanes, p.threads,
           p.blocks)
    three_interpolate.launches += 1
    return out


def backward_scratch(b: int, n: int, m: int, p: BackwardPlan, need_dw: bool, device):
    """One int32 tensor for all of the backward's scratch, and the addresses
    of its parts: the (E, w[E]) pairs (6BN ints, first, so 8-byte aligned),
    the offsets (B*M + 1, padded to even), the chunked CSR's histograms and,
    with dw over several column blocks, their partial sums (floats) or None.
    One allocation instead of four: the wrapper's host time is most of a
    small level's call."""
    sizes = (6 * b * n, b * m + 1 + (b * m + 1) % 2, p.csr.hist_ints,
             p.col_blocks * 3 * b * n if need_dw and p.col_blocks > 1 else 0)
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    at, ptrs = scratch.data_ptr(), []
    for size in sizes:
        ptrs.append(at)
        at += 4 * size
    return scratch, ptrs[0], ptrs[1], ptrs[2], ptrs[3] if sizes[3] else None


def interpolation_csr(idx: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CSR the backward builds, on its own: idx (B,N,3) int32 CUDA ->
    offsets (B*M + 1) and entries (3BN) int32; the entries of key b*M + t are
    the flat indices b*3N + 3n + k with idx[b, n, k] == t, ascending.  Equals
    ``geometry.interpolation_csr``."""
    check_input(idx, "idx", torch.int32, 3, last=3)
    b, n, _ = idx.shape
    if m < 1:
        raise ValueError(f"interpolation_csr needs M >= 1, got {m}")
    if b * n == 0:
        return (torch.zeros(b * m + 1, dtype=torch.int32, device=idx.device),
                torch.empty(0, dtype=torch.int32, device=idx.device))
    csr = csr_plan(b, n, m)
    offsets = torch.empty(b * m + 1, dtype=torch.int32, device=idx.device)
    entries = torch.empty(3 * b * n, dtype=torch.int32, device=idx.device)
    hist = torch.empty(csr.hist_ints, dtype=torch.int32, device=idx.device)
    launch("psa_interpolation_csr", idx.device, idx.data_ptr(), offsets.data_ptr(),
           entries.data_ptr(), hist.data_ptr(), b, n, m, int(csr.variant == "fused"), csr.steps,
           csr.warps, csr.smem_bytes)
    interpolation_csr.launches += 1
    return offsets, entries


def three_interpolate_backward(
    g: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, points: torch.Tensor,
    need_dw: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """g (B,N,C) f32 CUDA -> (dP (B,M,C), dw (B,N,3) or None when not
    ``need_dw``).  No atomics: dP equals the plain version run on the CPU bit
    for bit, and dP and dw are the same from call to call."""
    _check(points, idx, weight)
    check_input(g, "g", torch.float32, 3)
    b, m, c = points.shape
    n = idx.shape[1]
    if tuple(g.shape) != (b, n, c) or g.device != points.device:
        raise ValueError("g must be (B, N, C) on the points' device")
    dw = torch.empty((b, n, 3), dtype=torch.float32, device=g.device) if need_dw else None
    if g.numel() == 0:
        if dw is not None:
            dw.zero_()
        return torch.zeros_like(points), dw
    dp = torch.empty_like(points)  # every row written by the call
    p = backward_plan(b, n, m, c, aligned(g, dp, *((points,) if need_dw else ())))
    # scratch lives until the call returns; the allocator reuses it in stream order
    scratch, pairs, offsets, hist, parts = backward_scratch(b, n, m, p, need_dw, g.device)
    csr = p.csr
    launch("psa_three_interpolate_bwd", g.device, g.data_ptr(), idx.data_ptr(),
           weight.data_ptr(), points.data_ptr() if need_dw else None, dp.data_ptr(),
           dw.data_ptr() if need_dw else None, parts, offsets, pairs, hist, b, m, n, c,
           int(csr.variant == "fused"), csr.steps, csr.warps, csr.smem_bytes, int(p.vector),
           p.lanes, p.ahead, p.col_blocks, p.threads)
    three_interpolate_backward.launches += 1
    return dp, dw


class ThreeInterpolate(torch.autograd.Function):
    """``three_interpolate`` with the backward kernel; gradients for points
    and weight (``dw`` only when it is needed), none for idx."""

    @staticmethod
    def forward(ctx, points, idx, weight):
        ctx.save_for_backward(points, idx, weight)
        return three_interpolate(points, idx, weight)

    @staticmethod
    def backward(ctx, grad):
        points, idx, weight = ctx.saved_tensors
        need_dp, _, need_dw = ctx.needs_input_grad
        if not (need_dp or need_dw):
            return None, None, None
        dp, dw = three_interpolate_backward(grad.contiguous(), idx, weight, points,
                                            need_dw=need_dw)
        return (dp if need_dp else None), None, dw


three_interpolate.launches = 0
three_interpolate_backward.launches = 0
interpolation_csr.launches = 0
