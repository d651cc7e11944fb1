// Ball query: the cloud in shared-memory tiles, several centres per warp.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/ball_query_kernel.py
//   ball_query_pallas (body _ball_query_kernel).
//
// Bound on this card: the distance arithmetic.  Each (centre, point) pair
// the scan visits costs 8 f32 operations that must stay unfused
// (__fsub_rn x3, __fmul_rn x3, __fadd_rn x2, in the plain version's order)
// and a compare.  The listed bound divides the 8 operations by the
// 67 TFLOP/s f32 peak, which counts an FMA as two; unfused, the card issues
// at most half that, so the issue-rate floor is twice the listed bound
// (~0.032 ms at SA1, B16 x 8192 -> 1024, where the balls hold a few points
// and every centre scans all 8192).  The outputs are small.
//
// Design.  The plan (ops/cuda/ball_query.py:plan) picks R centres a warp,
// the warps a block, the tile and the ring depth.
// - A block serves consecutive centres of one cloud (grid (blocks, B)) and
//   stages the cloud through shared memory in tiles (point_tiles.cuh): one
//   tile holds the whole cloud ("whole"), or two buffers form a ring
//   ("ring") whose next tile is in flight while the block scans this one.
//   Device memory is read once per block, not once per centre.
// - A warp owns R centres, their coordinates in registers and the same in
//   every lane.  Each lane reads one point of the tile (word stride 3: no
//   bank conflict) and computes R distances, so one shared-memory read feeds
//   R distances.  Per centre, the lane marks in a bit of a mask whether the
//   point is inside the ball: a compare and a predicated OR a pair.  One
//   vote per 8 steps of 32 points asks whether any centre hit; hits are rare
//   (a few per ball at SA1), so the pair costs its 8 operations, the compare
//   and the OR, and little else.
// - Where the vote says so, the steps with hits are replayed in order:
//   __ballot_sync of the step's bit gives its in-radius mask and __popc of
//   the lanes below gives each hit its slot, so hits land in index order
//   with no sort.  Count and first hit are warp-uniform per centre.  Slots
//   at or beyond the count repeat the first hit (0 for an empty ball); the
//   count is clamped to nsample.
// - A warp whose R centres are all full stops computing (checked every 256
//   points) but keeps reaching the block's barriers; when every warp of the
//   block is full (__syncthreads_and), the block stops loading tiles.  On
//   the main path's clouds no ball fills, so every centre scans all N
//   points; on denser scans the exit saves the rest of the cloud.
// The threshold r2 comes from the host as float32(max(r, 1e-20)**2),
// squared in double and rounded once; with the distance summed as the
// plain version sums it, idx and cnt are bit-identical to
// ops/geometry.py:ball_query.
#include <cuda_runtime.h>
#include <stdint.h>

#include "point_tiles.cuh"

namespace {

using point_tiles::mark_if_below;
using point_tiles::Ring;
using point_tiles::sq_dist;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 256;
constexpr int kGroup = 8;  // steps of 32 points between votes

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int32_t* __restrict__ idx, int32_t* __restrict__ cnt,
                  int n, int m, float r2, int nsample, int tile, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bi = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5)) * R;

  float cx[R], cy[R], cz[R];
  int count[R], first[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = c0 + r < m ? c0 + r : m - 1;
    const float* p = centers + ((size_t)bi * m + c) * 3;
    cx[r] = p[0];
    cy[r] = p[1];
    cz[r] = p[2];
    count[r] = c0 + r < m ? 0 : nsample;  // a centre beyond M counts as full
    first[r] = 0;
  }
  bool full = true;  // warp-uniform: every centre of the warp holds nsample hits
#pragma unroll
  for (int r = 0; r < R; ++r) full = full && count[r] >= nsample;

  // A group: up to kGroup steps of 32 points.  In a step each lane takes
  // one point and marks, per centre, whether it is inside the ball: bit st
  // of bits[r], a compare and a predicated OR a pair, no vote.  One vote a
  // group decides whether any centre hit; only then are the steps with hits
  // replayed in order, a ballot each, and the hits placed.  ``check`` masks
  // the points at or beyond tn (the cloud's last, partial step).  Returns
  // whether every centre of the warp is now full.
  const float* s = nullptr;
  int base = 0;
  auto group = [&](int j0, int nsteps, int tn, bool check) -> bool {
    unsigned bits[R];
#pragma unroll
    for (int r = 0; r < R; ++r) bits[r] = 0u;
#pragma unroll
    for (int st = 0; st < kGroup; ++st) {
      if (st < nsteps) {
        const int j = j0 + 32 * st + lane;
        const float px = s[3 * j], py = s[3 * j + 1], pz = s[3 * j + 2];
        const float lim = check && j >= tn ? -1.0f : r2;  // stale words beyond tn: no hit
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mark_if_below(bits[r], sq_dist(cx[r], cy[r], cz[r], px, py, pz), lim, 1u << st);
        }
      }
    }
    unsigned any = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) any |= bits[r];
    if (!__any_sync(kFull, any != 0u)) return false;  // rare on the main path
    bool all = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      unsigned steps = __reduce_or_sync(kFull, bits[r]);  // warp-uniform
      while (steps && count[r] < nsample) {
        const int st = __ffs(steps) - 1;
        steps &= steps - 1u;
        const unsigned mask = __ballot_sync(kFull, (bits[r] >> st) & 1u);
        const int js = base + j0 + 32 * st;
        if (count[r] == 0) first[r] = js + __ffs(mask) - 1;
        const int pos = count[r] + __popc(mask & ((1u << lane) - 1u));
        if (((mask >> lane) & 1u) && pos < nsample) {
          idx[((size_t)bi * m + c0 + r) * nsample + pos] = js + lane;
        }
        count[r] += __popc(mask);
      }
      all = all && count[r] >= nsample;
    }
    return all;
  };

  const Ring ring(smem, xyz + (size_t)bi * n * 3, n, tile, stages);
  ring.start();
  int t = 0;
  for (;; ++t) {
    s = ring.wait(t);
    base = t * tile;
    if (!full) {
      const int tn = ring.count(t);
      int j0 = 0;
      for (; j0 + 32 * kGroup <= tn; j0 += 32 * kGroup) {
        if (group(j0, kGroup, tn, false)) {
          full = true;
          break;
        }
      }
      if (!full && j0 < tn) full = group(j0, (tn - j0 + 31) / 32, tn, true);
    }
    if (__syncthreads_and(full) || t + 1 == ring.ntiles) break;
    ring.advance(t);
  }
  ring.drain(t);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (c0 + r >= m) break;
    const size_t q = (size_t)bi * m + c0 + r;
    const int k = count[r] < nsample ? count[r] : nsample;
    int32_t* out = idx + q * nsample;
    for (int s = k + lane; s < nsample; s += 32) out[s] = first[r];
    if (lane == 0) cnt[q] = k;
  }
}

template <int R>
int launch(const float* xyz, const float* centers, int32_t* idx, int32_t* cnt, int b, int n,
           int m, float r2, int nsample, int threads, int tile, int stages, int smem_bytes,
           int blocks, cudaStream_t stream) {
  if ((long long)blocks * (threads / 32) * R < m) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, b);
  ball_query_kernel<R><<<grid, threads, smem_bytes, stream>>>(
      xyz, centers, idx, cnt, n, m, r2, nsample, tile, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's fields arrive as ints; a plan this file cannot run, or whose
// grid misses a query, is refused with cudaErrorInvalidValue before any
// launch.
extern "C" int psa_ball_query(const float* xyz, const float* centers, int32_t* idx,
                              int32_t* cnt, int b, int n, int m, float r2, int nsample,
                              int per_warp, int threads, int tile, int stages, int smem_bytes,
                              int blocks, void* stream) {
  const bool ok = b >= 1 && b <= 65535 && n >= 1 && m >= 1 && nsample >= 1 && blocks >= 1 &&
                  threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
                  tile >= 32 && tile % 32 == 0 && (stages == 1 || stages == 2) &&
                  (stages == 2 || tile >= n) &&
                  smem_bytes == point_tiles::ring_bytes(tile, stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (per_warp) {
    case 1: return launch<1>(xyz, centers, idx, cnt, b, n, m, r2, nsample, threads, tile,
                             stages, smem_bytes, blocks, s);
    case 2: return launch<2>(xyz, centers, idx, cnt, b, n, m, r2, nsample, threads, tile,
                             stages, smem_bytes, blocks, s);
    case 4: return launch<4>(xyz, centers, idx, cnt, b, n, m, r2, nsample, threads, tile,
                             stages, smem_bytes, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
