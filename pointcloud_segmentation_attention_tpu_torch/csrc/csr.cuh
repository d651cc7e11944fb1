// The transpose of an index array as a CSR, by a stable counting sort in
// integer passes: no atomics on its result and no dependence on timing, so
// the same input gives the same bits on every run.
//
// Input: B batches of `per_batch` entries; entry e of batch b (global index
// E = b * per_batch + e) names the key keys[E] in [0, n_keys).  Output:
// offsets (B * n_keys + 1) and entries (B * per_batch): the entries of key
// b * n_keys + t are the E with keys[E] == t, ascending, at
// [offsets[b * n_keys + t], offsets[b * n_keys + t + 1]).  Each entry is
// stored as its index E alone or, with a weight array, as the pair
// (E, weight[E]) in one 8-byte store.
//
// Users: csrc/three_interpolate_bwd.cu (entries e = 3n + k of idx (B, N, 3),
// keys the M known points, pairs with the weights) and
// csrc/group_gather_bwd.cu (entries e = m * K + k of idx (B, M, K), keys the
// N points gathered from, indices alone).
//
// The passes:
// - count: the entries of a batch are cut into chunks of 32 x `steps`; a
//   warp owns one chunk and counts its entries per key, 32 at a time;
// - scan: the exclusive scan of the counts in (key, chunk) order, from
//   b * per_batch, gives offsets[b * n_keys + t] and turns each (key, chunk)
//   count into the cursor of that chunk's first entry of the key;
// - fill: each warp walks its chunk in order again; a lane's place is its
//   key's cursor plus the number of lower lanes of the same key in its step
//   (__match_any_sync peers), so within a key the entries land in ascending
//   E, whatever the key's length (one key may hold every entry of a batch).
// Two layouts (the plan, ops/cuda/csr.py:plan): "fused", blocks whose warps
// hold their counts in shared memory and run all three passes in one kernel,
// a block per batch where a batch is small, and for more keys than one
// block's shared memory holds a block per (tile of keys, batch) that walks
// the whole batch and keeps the entries of its keys, counting those of
// lower keys for its first offset ("tiled"); "chunked", three kernels over
// many blocks (the scan a block per 256 keys), the counters of a warp in
// shared memory (n_keys each), the counts between passes in a histogram in
// device memory.
// With a Windows argument the scan also cuts the entries into windows of
// `size` consecutive places and writes, for each window w, the first key
// whose segment starts at or after w * size and that segment's offset
// (first[0] = (0, 0), first[count] = (all keys, all entries)): the gather
// backward's consuming pass takes one window per lane group, so that each
// group walks about `size` entries however uneven the segments are.
// Shared memory above 48 KB is opted into per kernel (allow_smem).
//
// Everything here has internal linkage: each source that includes the
// header gets its own copy of the kernels.  Every kernel carries kPairs as
// its last template argument, so a profile tells the interpolation's CSR
// (true) from the gather's (false) by name.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace csr {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkThreads = 256;    // chunked passes: 8 warps, one chunk each, at most
constexpr int kFusedThreads = 1024;  // fused: 32 warps, one chunk each, at most
constexpr int kScanTile = 256;       // keys a block of the chunked scan takes
constexpr int kScanBatch = 32;       // chunks' counts a scan thread keeps in registers
constexpr int kPrefetch = 8;         // 32-entry steps whose keys are loaded together
constexpr int kMaxBatchBlocks = 65535;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without the opt-in
constexpr int kSmemLimit = 226 * 1024;   // with it; the scan's static words stay within 227 KB

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// Count (kFill false) or place (kFill true) the `count` entries of one chunk
// of a batch, in order, 32 a step.  keys: the chunk's keys; e0: the global
// index of its first entry; cnt: the chunk's counters (cursors when
// placing).  Counting adds with atomics that return nothing (integer sums
// do not depend on their order): for the gather, the lowest of a key's
// __match_any_sync peers adds their number, one atomic a key, since its
// ball-query padding puts most of a centre's 32 slots, one step, on one
// key; for the interpolation, whose keys are spread, each lane adds 1 (a
// match on every step slowed its CSR).  Placing finds the lanes of one key
// in a step, its
// __match_any_sync peers: each peer takes
// the key's cursor plus the popc of its lower peers as its place, and the
// lowest moves the cursor past them.  Plain loads and stores between __syncwarp()s keep the
// steps in order; a returning atomicAdd there measured ~480 cycles a step
// on the H100 against ~11 for the match, its ~30 distinct addresses
// serialised.  The keys (and weights) of kPrefetch steps are loaded
// together, and with kPipeline those of the next kPrefetch steps while these
// run.  An entry is stored as its index E alone, or (kPairs) as the pair
// (E, weight[E]) in one 8-byte store.  Only keys in [t0, t1) are counted
// and placed, as key - t0; counting returns the number of the chunk's
// entries with a key below t0 (a tile's entries start after theirs).
template <bool kFill, bool kPairs, bool kPipeline>
__device__ __forceinline__ int walk_chunk(const int32_t* __restrict__ keys, int count, int e0,
                                          int* cnt, int* __restrict__ entries,
                                          const float* __restrict__ weight, int lane, int t0,
                                          int t1) {
  constexpr int kBelow = -2;  // a key below the tile; -1: past the chunk or above the tile
  const unsigned lower = lanemask_lt();
  int below = 0;
  int key[kPrefetch], next_key[kPrefetch];
  float w[kPrefetch], next_w[kPrefetch];
  auto load = [&](int s0, int (&k)[kPrefetch], float (&v)[kPrefetch]) {
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int e = s0 + 32 * u + lane;
      const int r = e < count ? __ldg(keys + e) : -1;
      k[u] = r >= t0 && r < t1 ? r - t0 : (r >= 0 && r < t0 ? kBelow : -1);
      if (kFill && kPairs) v[u] = e < count ? __ldg(weight + e0 + e) : 0.f;
    }
  };
  load(0, key, w);
  for (int s0 = 0; s0 < count; s0 += 32 * kPrefetch) {
    if (kPipeline && s0 + 32 * kPrefetch < count) load(s0 + 32 * kPrefetch, next_key, next_w);
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (s0 + 32 * u >= count) break;  // the same for the whole warp
      const bool live = key[u] >= 0;
      if (!kFill && t0 > 0) below += __popc(__ballot_sync(kFull, key[u] == kBelow));  // tiled
      if (!kFill && kPairs) {  // the interpolation's keys are spread: an atomic a lane
        if (live) atomicAdd(cnt + key[u], 1);
        continue;
      }
      const unsigned peers = __match_any_sync(kFull, key[u]);
      const int rank = __popc(peers & lower);
      const bool leader = live && rank == 0;
      if (!kFill) {  // the gather's padding piles a step on one key: an atomic a key
        if (leader) atomicAdd(cnt + key[u], __popc(peers));
        continue;
      }
      const int base = live ? cnt[key[u]] : 0;
      __syncwarp();  // every peer has read the counter before it moves
      if (leader) cnt[key[u]] = base + __popc(peers);
      __syncwarp();
      if (live) {
        const int e = e0 + s0 + 32 * u + lane;
        if (kPairs) {
          reinterpret_cast<int2*>(entries)[base + rank] = make_int2(e, __float_as_int(w[u]));
        } else {
          entries[base + rank] = e;
        }
      }
    }
    if (s0 + 32 * kPrefetch < count) {
      if (kPipeline) {
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          key[u] = next_key[u];
          w[u] = next_w[u];
        }
      } else {
        load(s0 + 32 * kPrefetch, key, w);
      }
    }
  }
  return below;
}

// The windows of the consuming pass that reads the CSR (see above); none
// where first is null.
struct Windows {
  int2* first = nullptr;  // count + 1 pairs (first key, its offset)
  int size = 0;           // places a window
  int count = 0;          // windows: ceil(all entries / size)
};

// Key `key` (global, b * n_keys + t) has its segment at [run, run + total):
// the windows whose first place w * size lies in (run, run + total] start
// with the next key, whose segment starts at run + total.
__device__ __forceinline__ void mark_windows(const Windows& win, int key, int run, int total) {
  if (win.first == nullptr) return;
  for (long long w = run / win.size + 1; w < win.count && w * win.size <= (long long)run + total;
       ++w) {
    win.first[w] = make_int2(key + 1, run + total);
  }
}

__device__ __forceinline__ void mark_window_ends(const Windows& win, int keys, int entries) {
  if (win.first == nullptr) return;
  win.first[0] = make_int2(0, 0);
  win.first[win.count] = make_int2(keys, entries);
}

// An exclusive scan over the block (a multiple of 32 threads, at most 1024)
// of v; *total gets the block's sum.  shared: 33 words of the caller's.
__device__ __forceinline__ int block_scan(int v, int* shared, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) shared[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? shared[lane] : 0;
    int s = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += u;
    }
    if (lane < warps) shared[lane] = s - w;
    if (lane == 31) shared[32] = s;
  }
  __syncthreads();
  const int excl = shared[warp] + incl - v;
  *total = shared[32];
  __syncthreads();  // the words are free again
  return excl;
}

// The fused layout's scan, in (key, chunk) order, of the counts
// h[chunk * n_keys + t] (chunks of them, in shared memory) of one batch's
// keys key0 + t, from `carry`, by the whole block: writes offs[t], marks the
// windows and turns each count into a cursor.
__device__ void scan_counts(int* h, int chunks, int n_keys, int carry, int* __restrict__ offs,
                            int key0, const Windows& win) {
  __shared__ int words[33];
  for (int t0 = 0; t0 < n_keys; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    int total = 0;
    if (t < n_keys) {
#pragma unroll 4
      for (int c = 0; c < chunks; ++c) total += h[c * n_keys + t];
    }
    int sum;
    int run = carry + block_scan(total, words, &sum);
    if (t < n_keys) {
      offs[t] = run;
      mark_windows(win, key0 + t, run, total);
#pragma unroll 4
      for (int c = 0; c < chunks; ++c) {
        const int v = h[c * n_keys + t];
        h[c * n_keys + t] = run;
        run += v;
      }
    }
    carry += sum;
    __syncthreads();  // every cursor is written before any warp places an entry
  }
}

// The sum of v over the 32 lanes, the same in every lane.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The chunked layout's count (kFill false) and fill (kFill true) passes.
// Warp w of block x owns chunk x * warps + w of batch y, its n_keys counters
// in shared memory.  hist holds, per (batch, chunk), n_keys counts (after
// the scan: cursors), then, per (batch, chunk), the sums of the counts over
// each tile of kScanTile keys, which the count pass writes for the scan.
// Only warp-level synchronisation: a warp whose chunk lies past the end
// leaves at once.
template <bool kFill, bool kPairs>
__global__ void __launch_bounds__(kWalkThreads)
csr_walk_kernel(const int32_t* __restrict__ keys, const float* __restrict__ weight,
                int* __restrict__ hist, int* __restrict__ entries, int batches, int per_batch,
                int n_keys, int steps, int chunks) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * (blockDim.x >> 5) + warp;
  if (chunk >= chunks) return;
  const int first = chunk * 32 * steps;
  const int count = min(32 * steps, per_batch - first);
  const int tiles = (n_keys + kScanTile - 1) / kScanTile;
  int* tile_sums = hist + (long long)batches * chunks * n_keys;
  int* cnt = smem + warp * n_keys;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    int* slot = hist + ((long long)b * chunks + chunk) * n_keys;
#pragma unroll 8
    for (int t = lane; t < n_keys; t += 32) cnt[t] = kFill ? slot[t] : 0;
    __syncwarp();
    // B * per_batch < 2^31, checked by build()
    walk_chunk<kFill, kPairs, true>(keys + (long long)b * per_batch + first, count,
                                    b * per_batch + first, cnt, entries, weight, lane, 0, n_keys);
    __syncwarp();  // the counts are complete
    if (!kFill) {
      for (int j = 0; j < tiles; ++j) {
        int sum = 0;
        for (int t = j * kScanTile + lane; t < min(n_keys, (j + 1) * kScanTile); t += 32) {
          const int v = cnt[t];
          slot[t] = v;
          sum += v;
        }
        sum = warp_sum(sum);
        if (lane == 0) tile_sums[((long long)b * chunks + chunk) * tiles + j] = sum;
      }
    }
    __syncwarp();
  }
}

// The chunked layout's scan: block (j, b) takes keys [j * kScanTile,
// (j + 1) * kScanTile) of batch b.  Its first offset is b * per_batch plus
// the tile sums of the keys before it, over all chunks; then the per-key
// totals over the chunks are scanned across the block, and each (chunk, key)
// count is turned into that chunk's cursor.  kPairs only names the user.
template <bool kPairs>
__global__ void __launch_bounds__(kScanTile)
csr_scan_kernel(int* __restrict__ hist, int* __restrict__ offsets, int batches, int per_batch,
                int n_keys, int chunks, Windows win) {
  __shared__ int words[33];
  const int tiles = (n_keys + kScanTile - 1) / kScanTile;
  const int tile = blockIdx.x;
  const int* tile_sums = hist + (long long)batches * chunks * n_keys;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    const int* ts = tile_sums + (long long)b * chunks * tiles;
    int* h = hist + (long long)b * chunks * n_keys;
    const int t = tile * kScanTile + threadIdx.x;
    // The first kScanBatch chunks' counts stay in registers for the cursors;
    // they and the tile sums are loaded together.
    int kept[kScanBatch];
    int total = 0;
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      kept[u] = t < n_keys && u < chunks ? h[(long long)u * n_keys + t] : 0;
    }
    int before = 0;
    for (int i = threadIdx.x; i < chunks * tile; i += kScanTile) {
      const int c = i / tile;
      before += ts[(long long)c * tiles + (i - c * tile)];
    }
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) total += kept[u];
    if (t < n_keys) {
      for (int c = kScanBatch; c < chunks; ++c) total += h[(long long)c * n_keys + t];
    }
    int sum;
    block_scan(before, words, &sum);
    int unused;
    const int excl = block_scan(total, words, &unused);
    if (t < n_keys) {
      int run = b * per_batch + sum + excl;
      offsets[(long long)b * n_keys + t] = run;
      mark_windows(win, b * n_keys + t, run, total);
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        if (u < chunks) {
          h[(long long)u * n_keys + t] = run;
          run += kept[u];
        }
      }
      for (int c = kScanBatch; c < chunks; ++c) {
        const int v = h[(long long)c * n_keys + t];
        h[(long long)c * n_keys + t] = run;
        run += v;
      }
    }
  }
  if (blockIdx.x == tiles - 1 && blockIdx.y == 0 && threadIdx.x == 0) {
    offsets[(long long)batches * n_keys] = batches * per_batch;
    mark_window_ends(win, batches * n_keys, batches * per_batch);
  }
}

// The fused layout: block (x, y) takes keys [x * key_tile, (x + 1) *
// key_tile) of batch y (one tile where key_tile = n_keys), warp w owning
// chunk w of the batch, the warps' counts of the tile's keys in shared
// memory (warps * key_tile ints); count, scan and fill with block barriers
// between them.  The tile's first offset is b * per_batch plus the batch's
// entries with lower keys, which the count pass tallies.  The indices-only
// walks (the gather's) load the next steps' keys while these run; with the
// weights as well that would pass the 64 registers of a 1024-thread block.
template <bool kPairs>
__global__ void __launch_bounds__(kFusedThreads)
csr_fused_kernel(const int32_t* __restrict__ keys, const float* __restrict__ weight,
                 int* __restrict__ offsets, int* __restrict__ entries, int batches,
                 int per_batch, int n_keys, int key_tile, int steps, Windows win) {
  extern __shared__ int smem[];
  __shared__ int below[kFusedThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int t0 = blockIdx.x * key_tile;
  const int tile_keys = min(key_tile, n_keys - t0);
  const int first = warp * 32 * steps;
  const int count = max(0, min(32 * steps, per_batch - first));
  int* cnt = smem + warp * tile_keys;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    const int32_t* chunk_keys = keys + (long long)b * per_batch + first;
    const int e0 = b * per_batch + first;
    for (int t = lane; t < tile_keys; t += 32) cnt[t] = 0;
    __syncwarp();
    const int lower = walk_chunk<false, kPairs, !kPairs>(chunk_keys, count, e0, cnt, entries,
                                                         weight, lane, t0, t0 + tile_keys);
    if (lane == 0) below[warp] = lower;
    __syncthreads();
    int carry = b * per_batch;
    if (t0 > 0) carry += warp_sum(lane < warps ? below[lane] : 0);  // tiled: lower keys' entries
    scan_counts(smem, warps, tile_keys, carry, offsets + (long long)b * n_keys + t0,
                b * n_keys + t0, win);
    walk_chunk<true, kPairs, !kPairs>(chunk_keys, count, e0, cnt, entries, weight, lane, t0,
                                      t0 + tile_keys);
    __syncthreads();  // the counters and `below` are reused by the next batch
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    offsets[(long long)batches * n_keys] = batches * per_batch;
    mark_window_ends(win, batches * n_keys, batches * per_batch);
  }
}

// Raise a kernel's dynamic shared memory limit to kSmemLimit on the current
// device, once, before its first launch with more than kDefaultSmem.
template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  if (bytes <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && allowed[dev])) return err;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <bool kPairs>
cudaError_t launch_walks(dim3 grid, int threads, int smem_bytes, const int32_t* keys,
                         const float* weight, int* hist, int* offsets, int* entries, int b,
                         int per_batch, int n_keys, int steps, int chunks, const Windows& win,
                         cudaStream_t s) {
  cudaError_t err = allow_smem<csr_walk_kernel<false, kPairs>>(smem_bytes);
  if (err == cudaSuccess) err = allow_smem<csr_walk_kernel<true, kPairs>>(smem_bytes);
  if (err != cudaSuccess) return err;
  csr_walk_kernel<false, kPairs><<<grid, threads, smem_bytes, s>>>(
      keys, weight, hist, entries, b, per_batch, n_keys, steps, chunks);
  const dim3 scan_grid((n_keys + kScanTile - 1) / kScanTile, grid.y);
  csr_scan_kernel<kPairs><<<scan_grid, kScanTile, 0, s>>>(hist, offsets, b, per_batch, n_keys,
                                                          chunks, win);
  csr_walk_kernel<true, kPairs><<<grid, threads, smem_bytes, s>>>(
      keys, weight, hist, entries, b, per_batch, n_keys, steps, chunks);
  return cudaSuccess;
}

template <bool kPairs>
cudaError_t launch_fused(dim3 grid, int warps, int smem_bytes, const int32_t* keys,
                         const float* weight, int* offsets, int* entries, int b, int per_batch,
                         int n_keys, int key_tile, int steps, const Windows& win,
                         cudaStream_t s) {
  const cudaError_t err = allow_smem<csr_fused_kernel<kPairs>>(smem_bytes);
  if (err != cudaSuccess) return err;
  csr_fused_kernel<kPairs><<<grid, warps * 32, smem_bytes, s>>>(
      keys, weight, offsets, entries, b, per_batch, n_keys, key_tile, steps, win);
  return cudaSuccess;
}

// Queue the CSR.  The plan's fields: fused (one kernel, a block per tile of
// keys and batch) or chunked, 32-entry steps a chunk, chunks (warps) a
// block, and the block's shared memory for the counters: warps * n_keys * 4
// bytes when chunked; warps * key_tile * 4 when fused, which fixes the tile,
// up to kSmemLimit.  hist holds the chunked layout's counts and tile sums,
// B * chunks * (n_keys + ceil(n_keys / 256)) ints; offsets B * n_keys + 1
// ints.  With weight, entries holds B * per_batch (E, weight[E]) pairs (twice
// as many ints), else B * per_batch indices E.  With win.first, the windows
// of win.size places, win.count = ceil(B * per_batch / win.size).
inline cudaError_t build(const int32_t* keys, const float* weight, int* offsets, int* entries,
                         int* hist, int b, int per_batch, int n_keys, int fused, int steps,
                         int warps, int smem_bytes, cudaStream_t s, Windows win = Windows()) {
  if (b < 1 || per_batch < 1 || n_keys < 1 || steps < 1 || warps < 1 || smem_bytes < 1 ||
      smem_bytes > kSmemLimit || (long long)b * per_batch >= (1LL << 31) ||
      (long long)b * n_keys >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  if (win.first != nullptr &&
      (win.size < 1 || win.count != ((long long)b * per_batch + win.size - 1) / win.size)) {
    return cudaErrorInvalidValue;
  }
  const int chunks = (int)(((long long)per_batch + 32LL * steps - 1) / (32LL * steps));
  const int batch_blocks = b < kMaxBatchBlocks ? b : kMaxBatchBlocks;
  if (fused) {
    const int key_tile = smem_bytes / (4 * warps);
    if (warps != chunks || warps > kFusedThreads / 32 || 4LL * warps * key_tile != smem_bytes ||
        key_tile > n_keys) {
      return cudaErrorInvalidValue;
    }
    const dim3 grid((n_keys + key_tile - 1) / key_tile, batch_blocks);
    const cudaError_t err =
        weight != nullptr
            ? launch_fused<true>(grid, warps, smem_bytes, keys, weight, offsets, entries, b,
                                 per_batch, n_keys, key_tile, steps, win, s)
            : launch_fused<false>(grid, warps, smem_bytes, keys, weight, offsets, entries, b,
                                  per_batch, n_keys, key_tile, steps, win, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  if (warps > kWalkThreads / 32 || 4LL * warps * n_keys != smem_bytes) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((chunks + warps - 1) / warps, batch_blocks);
  const cudaError_t err =
      weight != nullptr
          ? launch_walks<true>(grid, warps * 32, smem_bytes, keys, weight, hist, offsets,
                               entries, b, per_batch, n_keys, steps, chunks, win, s)
          : launch_walks<false>(grid, warps * 32, smem_bytes, keys, weight, hist, offsets,
                                entries, b, per_batch, n_keys, steps, chunks, win, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace csr
}  // namespace
