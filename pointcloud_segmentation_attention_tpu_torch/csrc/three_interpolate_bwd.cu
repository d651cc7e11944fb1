// Backward of the three-point interpolation
//   out[b, n, :] = sum_k w[b, n, k] * P[b, idx[b, n, k], :]
// given g = d loss / d out (B, N, C):
//   dP[b, t, :]  = sum over (n, k) with idx[b, n, k] == t, in ascending (n, k),
//                  of w[b, n, k] * g[b, n, :]
//   dw[b, n, k]  = <g[b, n, :], P[b, idx[b, n, k], :]>
// idx gets no gradient.  dw is computed only when the caller passes P and dw.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/interpolate_kernel.py
//   three_interpolate_pallas -> _vjp_bwd (body _bwd_kernel).
//
// Bound on this card: bytes.  g (B, N, C) f32 dominates; at FP4 (B16, N 8192,
// M 1024, C 128) the call must move about 89 MB with dw, 79 MB without.  12
// f32 operations per element of g are far below the compute bound.
//
// Design: no atomics and no memset.  Every result is written once, by one
// thread, in an order fixed by the data, so dP and dw are the same bits from
// run to run.  The entries e = 3n + k of a batch (global index
// E = 3(bN + n) + k) are regrouped by their key t = idx[b, n, k] with a stable
// counting sort, the transpose of idx as a CSR (offsets per key b*M + t, the
// entries E of each key ascending, and w[E] beside each), in integer passes:
// - count: the entries of a batch are cut into chunks of 32 x `steps`; a warp
//   owns one chunk and counts its entries per key, 32 at a time;
// - scan: the exclusive scan of the counts in (t, chunk) order, from b * 3N,
//   gives offsets[b*M + t] and turns each (t, chunk) count into the cursor of
//   that chunk's first entry of key t;
// - fill: each warp walks its chunk in order again; a lane's place is its
//   key's cursor plus the number of lower lanes of the same key in its step
//   (__match_any_sync peers), so within a key the entries land in ascending
//   e, whatever the key's length (M = 1 puts all 3N in one).
// Two layouts (the plan, ops/cuda/three_interpolate.py:csr_plan): "fused",
// one block per batch whose warps hold their counts in shared memory and run
// all three passes in one kernel, where a batch is small; "chunked", three
// kernels over many blocks (the scan a block per 256 keys), the counters of a
// warp in shared memory (M each) or, for an M too large for 48 KB, in the
// chunk's slot of a histogram in device memory.
// Then one pass consumes the CSR: a group of L lanes per key (b, t) and column
// block of L float4s (or floats) walks the key's entries in order, gathers
// g[b, n] and accumulates acc = acc + w * g (__fmul_rn, __fadd_rn) from 0 in
// registers, and writes dP[b, t] once (0 for a key no entry names).  That is
// the order in which index_add_ on the CPU adds them, so dP equals the plain
// version run on the CPU bit for bit.  A lane has the g rows of U (2, 4 or
// 8) entries in flight.  With dw asked for, the same pass forms
// <g[b, n], P[b, t]> for each entry, summed over the lanes in a fixed order;
// each (n, k) lies in exactly one key's list, so each dw entry is written
// once (per column block, then added in order) and g is read once for both.
// Keys run in order over the grid, so one batch's g (4 MB at FP4) stays in L2
// across the ~3 reads of each of its rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkThreads = 256;    // chunked passes: 8 warps, one chunk each, at most
constexpr int kFusedThreads = 1024;  // fused: 32 warps, one chunk each, at most
constexpr int kScanTile = 256;      // keys a block of the chunked scan takes
constexpr int kScanBatch = 32;      // chunks' counts a scan thread keeps in registers
constexpr int kMaxThreads = 256;     // consuming pass
constexpr int kPrefetch = 8;         // 32-entry steps whose keys are loaded together
constexpr int kMaxBatchBlocks = 65535;
constexpr int kSmemLimit = 47 * 1024;  // dynamic; the scan's static words stay within 48 KB

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// Count (kFill false) or place (kFill true) the `count` entries of one chunk
// of a batch, in order, 32 a step.  keys: the chunk's idx values; e0: the
// global index of its first entry; cnt: the chunk's M counters (cursors when
// placing).  Counting adds 1 a lane with an atomic that returns nothing
// (integer sums do not depend on their order).  Placing: the lanes of one
// key in a step are its __match_any_sync peers; each takes the key's cursor
// plus the popc of its lower peers as its place, and the lowest moves the
// cursor past them.  Plain loads and stores between __syncwarp()s keep the
// steps in order; a returning atomicAdd there measured ~480 cycles a step
// on the H100 against ~11 for the match, its ~30 distinct addresses
// serialised.  The keys (and weights) of kPrefetch steps are loaded
// together, and with kPipeline those of the next kPrefetch steps while these
// run.  An
// entry is stored as its index E alone, or (kPairs) as the pair (E, w[E]) in
// one 8-byte store.
template <bool kFill, bool kPairs, bool kPipeline>
__device__ __forceinline__ void walk_chunk(const int32_t* __restrict__ keys, int count, int e0,
                                           int* cnt, int* __restrict__ entries,
                                           const float* __restrict__ weight, int lane) {
  const unsigned lower = lanemask_lt();
  int key[kPrefetch], next_key[kPrefetch];
  float w[kPrefetch], next_w[kPrefetch];
  auto load = [&](int s0, int (&k)[kPrefetch], float (&v)[kPrefetch]) {
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int e = s0 + 32 * u + lane;
      k[u] = e < count ? __ldg(keys + e) : -1;
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
      if (!kFill) {
        if (live) atomicAdd(cnt + key[u], 1);
        continue;
      }
      const unsigned peers = __match_any_sync(kFull, key[u]);
      const int rank = __popc(peers & lower);
      const bool leader = live && rank == 0;
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

// The fused layout's scan, in (t, chunk) order, of the counts h[chunk * m + t]
// (chunks of them, in shared memory) of one batch, from `carry`, by the
// whole block: writes offs[t] and turns each count into a cursor.
__device__ void scan_counts(int* h, int chunks, int m, int carry, int* __restrict__ offs) {
  __shared__ int words[33];
  for (int t0 = 0; t0 < m; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    int total = 0;
    if (t < m) {
      for (int c = 0; c < chunks; ++c) total += h[c * m + t];
    }
    int sum;
    int run = carry + block_scan(total, words, &sum);
    if (t < m) {
      offs[t] = run;
      for (int c = 0; c < chunks; ++c) {
        const int v = h[c * m + t];
        h[c * m + t] = run;
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
// Warp w of block x owns chunk x * warps + w of batch y.  hist holds, per
// (batch, chunk), M counts (after the scan: cursors), then, per (batch,
// chunk), the sums of the counts over each tile of kScanTile keys, which the
// count pass writes for the scan.  Only warp-level synchronisation: a warp
// whose chunk lies past the end leaves at once.
template <bool kSmem, bool kFill, bool kPairs>
__global__ void __launch_bounds__(kWalkThreads)
interp_csr_walk_kernel(const int32_t* __restrict__ idx, const float* __restrict__ weight,
                       int* __restrict__ hist, int* __restrict__ entries, int batches, int n,
                       int m, int steps, int chunks) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * (blockDim.x >> 5) + warp;
  if (chunk >= chunks) return;
  const int per_batch = 3 * n;
  const int first = chunk * 32 * steps;
  const int count = min(32 * steps, per_batch - first);
  const int tiles = (m + kScanTile - 1) / kScanTile;
  int* tile_sums = hist + (long long)batches * chunks * m;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    int* slot = hist + ((long long)b * chunks + chunk) * m;
    int* cnt = kSmem ? smem + warp * m : slot;
    if (!kFill) {
      for (int t = lane; t < m; t += 32) cnt[t] = 0;
    } else if (kSmem) {
      for (int t = lane; t < m; t += 32) cnt[t] = slot[t];
    }
    __syncwarp();
    // 3BN < 2^31, checked by the entry points
    walk_chunk<kFill, kPairs, true>(idx + (long long)b * per_batch + first, count,
                                         b * per_batch + first, cnt, entries, weight, lane);
    __syncwarp();  // the counts are complete
    if (!kFill) {
      for (int j = 0; j < tiles; ++j) {
        int sum = 0;
        for (int t = j * kScanTile + lane; t < min(m, (j + 1) * kScanTile); t += 32) {
          const int v = cnt[t];
          if (kSmem) slot[t] = v;
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
// (j + 1) * kScanTile) of batch b.  Its first offset is b * 3N plus the tile
// sums of the keys before it, over all chunks; then the per-key totals over
// the chunks are scanned across the block, and each (chunk, key) count is
// turned into that chunk's cursor.
__global__ void __launch_bounds__(kScanTile)
interp_csr_scan_kernel(int* __restrict__ hist, int* __restrict__ offsets, int batches, int n,
                       int m, int chunks) {
  __shared__ int words[33];
  const int tiles = (m + kScanTile - 1) / kScanTile;
  const int tile = blockIdx.x;
  const int* tile_sums = hist + (long long)batches * chunks * m;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    const int* ts = tile_sums + (long long)b * chunks * tiles;
    int* h = hist + (long long)b * chunks * m;
    const int t = tile * kScanTile + threadIdx.x;
    // The first kScanBatch chunks' counts stay in registers for the cursors;
    // they and the tile sums are loaded together.
    int kept[kScanBatch];
    int total = 0;
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      kept[u] = t < m && u < chunks ? h[(long long)u * m + t] : 0;
    }
    int before = 0;
    for (int i = threadIdx.x; i < chunks * tile; i += kScanTile) {
      const int c = i / tile;
      before += ts[(long long)c * tiles + (i - c * tile)];
    }
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) total += kept[u];
    if (t < m) {
      for (int c = kScanBatch; c < chunks; ++c) total += h[(long long)c * m + t];
    }
    int sum;
    block_scan(before, words, &sum);
    int unused;
    const int excl = block_scan(total, words, &unused);
    if (t < m) {
      int run = b * 3 * n + sum + excl;
      offsets[(long long)b * m + t] = run;
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        if (u < chunks) {
          h[(long long)u * m + t] = run;
          run += kept[u];
        }
      }
      for (int c = kScanBatch; c < chunks; ++c) {
        const int v = h[(long long)c * m + t];
        h[(long long)c * m + t] = run;
        run += v;
      }
    }
  }
  if (blockIdx.x == tiles - 1 && blockIdx.y == 0 && threadIdx.x == 0) {
    offsets[(long long)batches * m] = 3 * batches * n;
  }
}

// The fused layout: one block per batch, warp w owning chunk w of its batch,
// the warps' counts in shared memory (warps * M ints); count, scan and fill
// with block barriers between them.
template <bool kPairs>
__global__ void __launch_bounds__(kFusedThreads)
interp_csr_fused_kernel(const int32_t* __restrict__ idx, const float* __restrict__ weight,
                        int* __restrict__ offsets, int* __restrict__ entries, int batches, int n,
                        int m, int steps) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int per_batch = 3 * n;
  const int first = warp * 32 * steps;
  const int count = max(0, min(32 * steps, per_batch - first));
  int* cnt = smem + warp * m;
  for (int b = blockIdx.x; b < batches; b += gridDim.x) {
    const int32_t* keys = idx + (long long)b * per_batch + first;
    const int e0 = b * per_batch + first;
    for (int t = lane; t < m; t += 32) cnt[t] = 0;
    __syncwarp();
    walk_chunk<false, kPairs, false>(keys, count, e0, cnt, entries, weight, lane);
    __syncthreads();
    scan_counts(smem, warps, m, b * per_batch, offsets + (long long)b * m);
    walk_chunk<true, kPairs, false>(keys, count, e0, cnt, entries, weight, lane);
    __syncthreads();  // the counters are reused by the next batch
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) offsets[(long long)batches * m] = 3 * batches * n;
}

__device__ __forceinline__ float axpy(float acc, float w, float g) {
  return __fadd_rn(acc, __fmul_rn(w, g));
}

__device__ __forceinline__ float4 axpy(float4 acc, float w, float4 g) {
  return make_float4(axpy(acc.x, w, g.x), axpy(acc.y, w, g.y), axpy(acc.z, w, g.z),
                     axpy(acc.w, w, g.w));
}

__device__ __forceinline__ float dot(float a, float b) { return a * b; }

__device__ __forceinline__ float dot(float4 a, float4 b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// The consuming pass.  A group of L lanes per (key b*M + t, column block y
// of L elements); lane t holds element y * L + t.  The group loads up to L
// of its key's (entry, weight) pairs at a time and hands them round by
// shuffle; the g rows of U entries are loaded before they are added, in
// order.  dw: each lane's share of the U dot products is summed over the
// group in a fixed order, through shared memory for a whole warp (lane t
// adds U shares of entry t / (32 / U), then 32 / U lanes finish by
// butterfly), by butterfly shuffles for smaller groups.  With one column
// block the sum is dw[E]; with several, block y's sum goes to
// parts[y * 3BN + E] and dw_combine_kernel adds the blocks in order.
template <typename V, int U, bool kDw>
__global__ void __launch_bounds__(kMaxThreads)
three_interpolate_bwd_kernel(const V* __restrict__ g, const int2* __restrict__ pairs,
                             const V* __restrict__ points, const int* __restrict__ offsets,
                             V* __restrict__ dp, float* __restrict__ dw, long long dw_stride,
                             int keys, int width, int lanes_log2) {
  __shared__ float shares[kDw ? kMaxThreads / 32 : 1][U][33];
  const int lanes = 1 << lanes_log2;
  const int t = threadIdx.x & (lanes - 1);
  const int key = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2);
  if (key >= keys) return;  // the whole group: its shuffles name only its own lanes
  const unsigned gmask =
      lanes == 32 ? kFull : ((1u << lanes) - 1) << ((threadIdx.x & 31) & ~(lanes - 1));
  const int col = blockIdx.y * lanes + t;
  const bool in = col < width;
  const int begin = __ldg(offsets + key), end = __ldg(offsets + key + 1);
  if (kDw) dw += blockIdx.y * dw_stride;  // this column block's partial sums
  V acc = zero<V>(), p = zero<V>();
  if (kDw && in) p = __ldg(points + (long long)key * width + col);
  for (int base = begin; base < end; base += lanes) {
    const int cnt = min(lanes, end - base);
    int2 mine = make_int2(0, 0);
    if (t < cnt) mine = __ldg(pairs + base + t);
    for (int q = 0; q < cnt; q += U) {
      int e[U];
      float w[U];
      V gv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every lane of the group takes part
        e[u] = __shfl_sync(gmask, mine.x, q + u, lanes);
        w[u] = __int_as_float(__shfl_sync(gmask, mine.y, q + u, lanes));
        gv[u] = q + u < cnt && in ? __ldg(g + (long long)(e[u] / 3) * width + col) : zero<V>();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (q + u < cnt) acc = axpy(acc, w[u], gv[u]);
      }
      if (kDw) {
        float s[U];
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] = dot(gv[u], p);
        if (lanes == 32) {
          float(*sh)[33] = shares[threadIdx.x >> 5];
#pragma unroll
          for (int u = 0; u < U; ++u) sh[u][t] = s[u];
          __syncwarp();
          constexpr int kPer = 32 / U;  // lanes finishing each entry
          const int u = t / kPer, part = t % kPer;
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < U; ++i) sum += sh[u][part * U + i];
#pragma unroll
          for (int off = kPer / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
          __syncwarp();  // the shares are read before the next batch writes them
          int eu = e[0];
#pragma unroll
          for (int v = 1; v < U; ++v) eu = u == v ? e[v] : eu;
          if (part == 0 && q + u < cnt) dw[eu] = sum;
        } else {
          for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(gmask, s[u], off, lanes);
          }
          if (t == 0) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              if (q + u < cnt) dw[e[u]] = s[u];
            }
          }
        }
      }
    }
  }
  if (in) dp[(long long)key * width + col] = acc;
}

// dw[E] = sum over the column blocks y, in order, of parts[y * total + E].
__global__ void __launch_bounds__(256)
dw_combine_kernel(const float* __restrict__ parts, float* __restrict__ dw, long long total,
                  int blocks) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = parts[e];
    for (int y = 1; y < blocks; ++y) sum += parts[y * total + e];
    dw[e] = sum;
  }
}

template <typename V, int U>
void launch_consume(const float* g, const int2* pairs, const float* points, const int* offsets,
                    float* dp, float* dw, long long dw_stride, int keys, int width,
                    int lanes_log2, dim3 grid, int threads, cudaStream_t s) {
  const V* gv = reinterpret_cast<const V*>(g);
  const V* pv = reinterpret_cast<const V*>(points);
  V* dpv = reinterpret_cast<V*>(dp);
  if (dw != nullptr) {
    three_interpolate_bwd_kernel<V, U, true><<<grid, threads, 0, s>>>(
        gv, pairs, pv, offsets, dpv, dw, dw_stride, keys, width, lanes_log2);
  } else {
    three_interpolate_bwd_kernel<V, U, false><<<grid, threads, 0, s>>>(
        gv, pairs, pv, offsets, dpv, dw, 0, keys, width, lanes_log2);
  }
}

template <typename V>
bool launch_consume_u(int ahead, const float* g, const int2* pairs, const float* points,
                      const int* offsets, float* dp, float* dw, long long dw_stride, int keys,
                      int width, int lanes_log2, dim3 grid, int threads, cudaStream_t s) {
  switch (ahead) {
    case 2:
      launch_consume<V, 2>(g, pairs, points, offsets, dp, dw, dw_stride, keys, width, lanes_log2,
                           grid, threads, s);
      return true;
    case 4:
      launch_consume<V, 4>(g, pairs, points, offsets, dp, dw, dw_stride, keys, width, lanes_log2,
                           grid, threads, s);
      return true;
    case 8:
      launch_consume<V, 8>(g, pairs, points, offsets, dp, dw, dw_stride, keys, width, lanes_log2,
                           grid, threads, s);
      return true;
    default:
      return false;
  }
}

int log2_of(int lanes) {
  for (int l = 0; l <= 5; ++l) {
    if ((1 << l) == lanes) return l;
  }
  return -1;
}

template <bool kPairs>
void launch_walks(bool in_smem, dim3 grid, int threads, int smem_bytes, const int32_t* idx,
                  const float* weight, int* hist, int* offsets, int* entries, int b, int n, int m,
                  int steps, int chunks, cudaStream_t s) {
  if (in_smem) {
    interp_csr_walk_kernel<true, false, kPairs><<<grid, threads, smem_bytes, s>>>(
        idx, weight, hist, entries, b, n, m, steps, chunks);
  } else {
    interp_csr_walk_kernel<false, false, kPairs><<<grid, threads, 0, s>>>(
        idx, weight, hist, entries, b, n, m, steps, chunks);
  }
  const dim3 scan_grid((m + kScanTile - 1) / kScanTile, grid.y);
  interp_csr_scan_kernel<<<scan_grid, kScanTile, 0, s>>>(hist, offsets, b, n, m, chunks);
  if (in_smem) {
    interp_csr_walk_kernel<true, true, kPairs><<<grid, threads, smem_bytes, s>>>(
        idx, weight, hist, entries, b, n, m, steps, chunks);
  } else {
    interp_csr_walk_kernel<false, true, kPairs><<<grid, threads, 0, s>>>(
        idx, weight, hist, entries, b, n, m, steps, chunks);
  }
}

// The CSR plan's fields (ops/cuda/three_interpolate.py:csr_plan): fused (one
// kernel, a block per batch) or chunked, 32-entry steps a chunk, chunks
// (warps) a block, and the block's shared memory for the counters (warps * M
// * 4 bytes; 0 for counters in the histogram, chunked only).  hist holds the
// chunked layout's counts and tile sums, B * chunks * (M + ceil(M / 256))
// ints; offsets B*M + 1 ints.  With weight, entries holds 3BN (E, w[E])
// pairs (6BN ints), else 3BN indices E.
cudaError_t build_csr(const int32_t* idx, const float* weight, int* offsets, int* entries,
                      int* hist, int b, int n, int m, int fused, int steps, int warps,
                      int smem_bytes, cudaStream_t s) {
  if (b < 1 || n < 1 || m < 1 || steps < 1 || warps < 1 || 3LL * b * n >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const int chunks = (int)((3LL * n + 32LL * steps - 1) / (32LL * steps));
  const int batch_blocks = b < kMaxBatchBlocks ? b : kMaxBatchBlocks;
  if (fused) {
    if (warps != chunks || warps > kFusedThreads / 32 || 4LL * warps * m != smem_bytes ||
        smem_bytes > kSmemLimit) {
      return cudaErrorInvalidValue;
    }
    if (weight != nullptr) {
      interp_csr_fused_kernel<true><<<batch_blocks, warps * 32, smem_bytes, s>>>(
          idx, weight, offsets, entries, b, n, m, steps);
    } else {
      interp_csr_fused_kernel<false><<<batch_blocks, warps * 32, smem_bytes, s>>>(
          idx, weight, offsets, entries, b, n, m, steps);
    }
    return cudaGetLastError();
  }
  const bool in_smem = smem_bytes > 0;
  if (warps > kWalkThreads / 32 ||
      (in_smem && (4LL * warps * m != smem_bytes || smem_bytes > kSmemLimit))) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((chunks + warps - 1) / warps, batch_blocks);
  if (weight != nullptr) {
    launch_walks<true>(in_smem, grid, warps * 32, smem_bytes, idx, weight, hist, offsets, entries,
                       b, n, m, steps, chunks, s);
  } else {
    launch_walks<false>(in_smem, grid, warps * 32, smem_bytes, idx, weight, hist, offsets,
                        entries, b, n, m, steps, chunks, s);
  }
  return cudaGetLastError();
}

}  // namespace

// The CSR alone: offsets (B*M + 1) and entries (3BN, global E, ascending
// within each key), from idx (B, N, 3).
extern "C" int psa_interpolation_csr(const int32_t* idx, int* offsets, int* entries, int* hist,
                                     int b, int n, int m, int fused, int steps, int warps,
                                     int smem_bytes, void* stream) {
  return (int)build_csr(idx, nullptr, offsets, entries, hist, b, n, m, fused, steps, warps,
                        smem_bytes, (cudaStream_t)stream);
}

// The whole backward: the CSR into the caller's scratch (offsets, the
// (E, w[E]) pairs, hist), then the consuming pass.  points and dw may both be
// null: then only dP is computed.  With dw and more than one column block,
// parts (col_blocks * 3BN floats) takes the blocks' partial sums.  The
// consuming pass's plan: vector (float4 accesses), lanes per key and column
// block, entries whose g rows a lane loads at once (2, 4 or 8), column
// blocks, threads per block; its grid covers the B*M keys.
extern "C" int psa_three_interpolate_bwd(const float* g, const int32_t* idx, const float* weight,
                                         const float* points, float* dp, float* dw, float* parts,
                                         int* offsets, int* pairs, int* hist, int b, int m,
                                         int n, int c, int fused, int steps, int warps,
                                         int smem_bytes, int vector, int lanes, int ahead,
                                         int col_blocks, int threads, void* stream) {
  const int lanes_log2 = log2_of(lanes);
  const int width = vector ? c / 4 : c;
  if (c < 1 || lanes_log2 < 0 || threads < 32 || threads % 32 || threads > kMaxThreads ||
      threads < lanes || col_blocks < 1 || col_blocks > kMaxBatchBlocks ||
      (long long)col_blocks * lanes < width || (dw != nullptr && points == nullptr) ||
      (dw != nullptr && col_blocks > 1 && parts == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (vector && (c % 4 || (uintptr_t)g % 16 || (uintptr_t)dp % 16 ||
                 (dw != nullptr && (uintptr_t)points % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long keys = (long long)b * m;
  const long long groups = threads / lanes;
  const long long blocks = (keys + groups - 1) / groups;
  if (keys >= (1LL << 31) || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = build_csr(idx, weight, offsets, pairs, hist, b, n, m, fused, steps, warps,
                              smem_bytes, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, col_blocks);
  const int2* pr = reinterpret_cast<const int2*>(pairs);
  const bool split = dw != nullptr && col_blocks > 1;
  float* sums = split ? parts : dw;
  const long long stride = split ? 3LL * b * n : 0;
  const bool known =
      vector ? launch_consume_u<float4>(ahead, g, pr, points, offsets, dp, sums, stride,
                                        (int)keys, width, lanes_log2, grid, threads, s)
             : launch_consume_u<float>(ahead, g, pr, points, offsets, dp, sums, stride, (int)keys,
                                       width, lanes_log2, grid, threads, s);
  if (!known) return (int)cudaErrorInvalidValue;
  if (split) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = 3LL * b * n;
    const long long combine = (total + 255) / 256;
    dw_combine_kernel<<<(unsigned)(combine < 4096 ? combine : 4096), 256, 0, s>>>(
        parts, dw, total, col_blocks);
  }
  return (int)cudaGetLastError();
}
