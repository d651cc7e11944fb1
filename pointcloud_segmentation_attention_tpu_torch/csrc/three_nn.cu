// Three nearest neighbours: for each unknown point, the 3 known points of
// least squared distance, ascending, lower index first on ties.  The known
// cloud in shared memory, one or two unknowns per thread, insertions
// deferred to a bitmask per block of 32 points.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/three_nn_kernel.py
//   three_nn_pallas (body _three_nn_kernel).
//
// Bound on this card: the distance arithmetic, 8 f32 operations for each of
// the N*M (unknown, known) pairs, which must stay unfused (__fsub_rn x3,
// __fmul_rn x3, __fadd_rn x2, in the plain version's order), and a compare.
// The listed bound divides the 8 operations by the 67 TFLOP/s f32 peak,
// which counts an FMA as two; unfused, the card issues at most half that,
// so the issue-rate floor is twice the listed bound (~0.032 ms at FP4, B16,
// 8192 unknowns x 1024 known).
//
// Design.  The plan (ops/cuda/three_nn.py:plan) picks Q unknowns a thread,
// the threads a block and the variant:
// - "whole": the known cloud fits in shared memory (up to 96 KB; at FP4 it
//   is 12 KB) and is staged once per block;
// - "ring": larger clouds pass through two tile buffers, the next tile in
//   flight while the block scans this one (point_tiles.cuh).
// A block serves consecutive unknowns of one cloud (grid (blocks, B));
// thread i of the block owns unknowns i, i + T, .., i + (Q-1) T of the
// block's run, so loads and stores stay coalesced.  Every thread scans the
// known points in index order; each read is a broadcast (all lanes read
// the same address), four points come as three float4 loads, and each
// point read feeds Q distances.  The top 3 of each unknown live in
// registers; the insertion uses strict <, so an equal distance never
// displaces a lower index.  The slots start at FLT_MAX with index 0, which
// is also the plain version's padding when M < 3, so that case needs no
// branch.  Squared distances are summed as the plain version sums them, so
// indices and distances are bit-identical to ops/geometry.py:three_nn.
//
// Deferred insertion.  A thread inserts only about 3 ln(M) times, but an
// insertion is a divergent branch: offered point by point, a warp takes it
// whenever any of its 32 unknowns inserts, which early in the scan is at
// almost every point, and pays a compare, a branch and the reconvergence
// for every pair.  So after the first 32 points (offered one by one, to
// set a threshold), the scan goes in blocks of 32 points: each pair costs
// its distance, one compare against the third-best distance as the block
// began, and one predicated OR into a 32-bit mask; then the thread offers
// the points of its mask in index order, recomputing their distances.  A
// point at or above the block's starting threshold would have been refused
// anyway, since the third-best distance only falls, so the result is the
// same.  The warp loops as often as its busiest lane has candidates.
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "point_tiles.cuh"

namespace {

using point_tiles::mark_if_below;
using point_tiles::Ring;
using point_tiles::sq_dist;

constexpr int kMaxThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

__device__ __forceinline__ void offer(Top3& t, float d, int k) {
  if (d < t.d2) {
    if (d < t.d1) {
      t.d2 = t.d1;
      t.i2 = t.i1;
      if (d < t.d0) {
        t.d1 = t.d0;
        t.i1 = t.i0;
        t.d0 = d;
        t.i0 = k;
      } else {
        t.d1 = d;
        t.i1 = k;
      }
    } else {
      t.d2 = d;
      t.i2 = k;
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                float* __restrict__ dist, int32_t* __restrict__ idx, int n, int m, int tile,
                int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bi = blockIdx.y;
  const int first = blockIdx.x * (int)blockDim.x * Q + (int)threadIdx.x;

  float ux[Q], uy[Q], uz[Q];
  Top3 top[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = first + q * (int)blockDim.x;
    const float* u = unknown + ((size_t)bi * n + (i < n ? i : n - 1)) * 3;
    ux[q] = u[0];
    uy[q] = u[1];
    uz[q] = u[2];
    top[q] = Top3{FLT_MAX, FLT_MAX, FLT_MAX, 0, 0, 0};
  }
  auto offer_point = [&](const float* s, int j, int k) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      offer(top[q], sq_dist(ux[q], uy[q], uz[q], s[3 * j], s[3 * j + 1], s[3 * j + 2]), k);
    }
  };

  const Ring ring(smem, known + (size_t)bi * m * 3, m, tile, stages);
  ring.start();
  for (int t = 0; t < ring.ntiles; ++t) {
    const float* s = ring.wait(t);
    const int tn = ring.count(t);
    const int base = t * tile;
    int j = 0;
    if (t == 0) {  // the first 32 points one by one: they set the threshold
      for (; j < 32 && j < tn; ++j) offer_point(s, j, j);
    }
    for (; j + 32 <= tn; j += 32) {
      float thr[Q];
      unsigned mask[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        thr[q] = top[q].d2;
        mask[q] = 0u;
      }
      const float4* p4 = reinterpret_cast<const float4*>(s + 3 * j);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const float4 a = p4[3 * g];
        const float4 b = p4[3 * g + 1];
        const float4 c = p4[3 * g + 2];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          mark_if_below(mask[q], sq_dist(ux[q], uy[q], uz[q], a.x, a.y, a.z), thr[q],
                        1u << (4 * g));
          mark_if_below(mask[q], sq_dist(ux[q], uy[q], uz[q], a.w, b.x, b.y), thr[q],
                        1u << (4 * g + 1));
          mark_if_below(mask[q], sq_dist(ux[q], uy[q], uz[q], b.z, b.w, c.x), thr[q],
                        1u << (4 * g + 2));
          mark_if_below(mask[q], sq_dist(ux[q], uy[q], uz[q], c.y, c.z, c.w), thr[q],
                        1u << (4 * g + 3));
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        while (mask[q]) {  // the candidates in index order
          const int k = j + __ffs(mask[q]) - 1;
          mask[q] &= mask[q] - 1u;
          offer(top[q], sq_dist(ux[q], uy[q], uz[q], s[3 * k], s[3 * k + 1], s[3 * k + 2]),
                base + k);
        }
      }
    }
    for (; j < tn; ++j) offer_point(s, j, base + j);  // the cloud's last, partial block
    if (t + 1 < ring.ntiles) {
      __syncthreads();  // every thread is done with this buffer
      ring.advance(t);
    }
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = first + q * (int)blockDim.x;
    if (i >= n) break;
    const size_t o = ((size_t)bi * n + i) * 3;
    dist[o] = top[q].d0;
    dist[o + 1] = top[q].d1;
    dist[o + 2] = top[q].d2;
    idx[o] = top[q].i0;
    idx[o + 1] = top[q].i1;
    idx[o + 2] = top[q].i2;
  }
}

template <int Q>
int launch(const float* unknown, const float* known, float* dist, int32_t* idx, int b, int n,
           int m, int threads, int tile, int stages, int smem_bytes, int blocks,
           cudaStream_t stream) {
  if ((long long)blocks * threads * Q < n) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, b);
  three_nn_kernel<Q><<<grid, threads, smem_bytes, stream>>>(unknown, known, dist, idx, n, m,
                                                            tile, stages);
  return (int)cudaGetLastError();
}

template <int Q>
int allow_smem(int bytes) {
  return (int)cudaFuncSetAttribute(three_nn_kernel<Q>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The plan's fields arrive as ints; a plan this file cannot run, or whose
// grid misses a query, is refused with cudaErrorInvalidValue before any
// launch.
extern "C" int psa_three_nn(const float* unknown, const float* known, float* dist,
                            int32_t* idx, int b, int n, int m, int per_thread, int threads,
                            int tile, int stages, int smem_bytes, int blocks, void* stream) {
  const bool ok = b >= 1 && b <= 65535 && n >= 1 && m >= 1 && blocks >= 1 &&
                  threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
                  tile >= 32 && tile % 32 == 0 && (stages == 1 || stages == 2) &&
                  (stages == 2 || tile >= m) &&
                  smem_bytes == point_tiles::ring_bytes(tile, stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (per_thread) {
    case 1: return launch<1>(unknown, known, dist, idx, b, n, m, threads, tile, stages,
                             smem_bytes, blocks, s);
    case 2: return launch<2>(unknown, known, dist, idx, b, n, m, threads, tile, stages,
                             smem_bytes, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Let both variants take ``bytes`` of dynamic shared memory on the current
// device; the wrapper calls this once per device and size above 48 KB.  The
// stream is not used: it keeps the entry point's arguments like the others'.
extern "C" int psa_three_nn_allow_smem(int bytes, void* /*stream*/) {
  if (bytes <= kDefaultSmem) return (int)cudaErrorInvalidValue;
  const int err = allow_smem<1>(bytes);
  return err != 0 ? err : allow_smem<2>(bytes);
}
