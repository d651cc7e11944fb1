"""The launch plan of ``csrc/csr.cuh``: the stable counting sort that both
backward kernels use to build the transpose of an index array as a CSR
(the interpolation's: 3N entries a batch keyed by M known points; the
gather's: M*K entries a batch keyed by N points)."""
from __future__ import annotations

import functools
from typing import NamedTuple

STEPS = (8, 64)           # the least and most 32-entry steps of a chunked CSR's chunk
WARPS = (8, 4, 2, 1)      # chunks (warps) a block of the chunked passes, most first
FUSED_WARPS = 32          # the most warps (chunks) of a fused CSR's block
FUSED_MAX_STEPS = 8       # the most 32-entry steps of a fused CSR's chunk
SMEM_LIMIT = 47 * 1024    # dynamic shared memory of a CSR block that plan() chooses
SMEM_MAX = 226 * 1024     # the most a block takes, opted into above 48 KB (csrc: kSmemLimit)
SCAN_TILE = 256           # keys a block of the chunked scan takes (csrc: kScanTile)
MIN_BLOCKS = 264          # two blocks per SM of an H100


def pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


class CsrPlan(NamedTuple):
    """How the CSR passes of ``csrc/csr.cuh`` run one call."""

    variant: str      # "fused": one kernel, a block per batch; "tiled": one kernel, a block
    #                   per (tile of keys, batch); "chunked": three kernels
    steps: int        # 32-entry steps in a chunk (a warp's share of a batch's entries)
    chunks: int       # chunks per batch
    warps: int        # chunks (warps) per block
    smem_bytes: int   # the warps' key counters in shared memory (fused, tiled: of a tile)
    hist_ints: int    # the chunked layout's per-chunk counts and per-tile sums of them

    @property
    def key_tile(self) -> int:
        """Keys a block of the fused and tiled layouts counts (C: smem / 4 warps)."""
        return self.smem_bytes // (4 * self.warps)


@functools.lru_cache(maxsize=256)
def plan(b: int, entries: int, keys: int, fused_smem: int = SMEM_LIMIT,
         fused_steps: int = 1) -> CsrPlan:
    """The CSR of B batches of ``entries`` entries each into ``keys`` keys.

    Fused where one block of up to 32 warps, each with ``keys`` counters in
    ``fused_smem`` bytes of shared memory, covers a batch's entries in at
    most ``FUSED_MAX_STEPS`` steps of 32 each, with the fewest warps that
    take at most ``fused_steps`` steps each, else the most (the
    interpolation at FP1-3, one step where it can; the gather at SA2-4,
    four: on an H100 16 warps of 4 steps measured 1.5 us faster than 32 of 2
    at SA3, and 32 warps of 8 steps with 128 KB 1.7 us faster than the
    chunked layout at SA2, ``utils/plan_sweep.py``).  Else chunked while a
    warp's ``keys`` counters fit ``SMEM_LIMIT``: a chunk holds about keys / 2
    entries (16 steps for 1024 keys: the histograms hold about twice as
    many ints as there are entries; 32 steps measured 2.6 us slower on an
    H100 at FP4), between ``STEPS`` steps of 32, and no more than a batch
    has; a block takes the most chunks (up to 8, within the limit) that
    still leave ``MIN_BLOCKS`` blocks.  Beyond that, tiled: 32 warps share
    a batch, each block counting the keys of one tile that fills
    ``SMEM_MAX``, so the keys never sit in device memory."""
    if min(b, entries, keys) < 1:
        raise ValueError(f"CSR plan needs B, entries, keys >= 1, got {b}, {entries}, {keys}")
    if b * entries >= 2 ** 31 or b * keys >= 2 ** 31:
        raise ValueError(f"B * entries = {b * entries} or B * keys = {b * keys} do not fit int32")
    most = min(FUSED_WARPS, fused_smem // (4 * keys))
    if most >= 1 and -(-entries // (32 * most)) <= FUSED_MAX_STEPS:
        warps = min(most, -(-entries // (32 * fused_steps)))
        steps = -(-entries // (32 * warps))
        warps = -(-entries // (32 * steps))
        return CsrPlan("fused", steps, warps, warps, 4 * keys * warps, 0)
    if 4 * keys > SMEM_LIMIT:
        steps = -(-entries // (32 * FUSED_WARPS))
        warps = -(-entries // (32 * steps))
        tile = min(keys, SMEM_MAX // (4 * warps))
        return CsrPlan("tiled", steps, warps, warps, 4 * tile * warps, 0)
    lo, hi = STEPS
    steps = min(max(lo, pow2_at_least(-(-keys // 64))), hi, -(-entries // 32))
    chunks = -(-entries // (32 * steps))
    fits = [w for w in WARPS if w == 1 or (w <= chunks and 4 * keys * w <= SMEM_LIMIT)]
    warps = next(w for w in fits if w == 1 or b * -(-chunks // w) >= MIN_BLOCKS)
    return CsrPlan("chunked", steps, chunks, warps, 4 * keys * warps,
                   b * chunks * (keys + -(-keys // SCAN_TILE)))
