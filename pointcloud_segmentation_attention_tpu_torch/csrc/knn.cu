// k nearest neighbours: for each query point, the k points of its cloud of
// least squared distance, ascending, lower index first on ties (k <= 16).
// The cloud in shared memory, one or two queries per thread, insertions
// deferred to a bitmask per block of 32 points.
//
// Replaces: ops/geometry.py:knn_point on the card, a stable sort of every
//   query's N squared distances (the JAX package computes it in XLA).
//
// Bound on this card: the distance arithmetic, 8 f32 operations for each of
// the M*N (query, point) pairs, unfused as in three_nn.cu (__fsub_rn x3,
// __fmul_rn x3, __fadd_rn x2, in the plain version's order), and a compare.
// The listed bound divides the 8 operations by the 67 TFLOP/s f32 peak,
// which counts an FMA as two; unfused, the card issues at most half that.
//
// Design: three_nn.cu's, with a sorted list of K (8 or 16) in registers in
// place of its top 3.  The plan (ops/cuda/knn.py:plan) picks K, Q queries a
// thread, the threads a block and the variant ("whole": the cloud staged
// once per block, up to 8192 points; "ring": two tile buffers,
// point_tiles.cuh).  Every thread scans the cloud in index order; each read
// is a broadcast and feeds Q distances.  An insertion moves the list's
// tail by one slot with selects over compile-time slots, so the list never
// leaves registers; it uses strict <, so an equal distance never displaces
// a lower index, which is the stable sort's order.  After the first 32
// points the scan goes in blocks of 32: each pair costs its distance, one
// compare against the K-th best distance as the block began and a
// predicated OR into a mask; then the thread offers its mask's points in
// index order.  The K-th best only falls, so a point the mask leaves out
// would have been refused.  With k < K the first k slots are written: the
// k nearest of the K nearest.  Squared distances are summed as the plain
// version sums them, so indices and distances are bit-identical to
// ops/geometry.py:knn_point.
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

template <int K>
struct TopK {
  float d[K];
  int i[K];
};

// Insert (d, k) into the ascending list: slot s takes the old slot s - 1
// where d < old d[s - 1], d itself where old d[s - 1] <= d < old d[s], and
// keeps its own otherwise.  The slots are walked from the last, so each
// reads its neighbour's old value.
template <int K>
__device__ __forceinline__ void offer(TopK<K>& t, float d, int k) {
  if (d < t.d[K - 1]) {
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      const bool shift = d < t.d[s - 1];
      const bool here = !shift && d < t.d[s];
      t.d[s] = shift ? t.d[s - 1] : (here ? d : t.d[s]);
      t.i[s] = shift ? t.i[s - 1] : (here ? k : t.i[s]);
    }
    if (d < t.d[0]) {
      t.d[0] = d;
      t.i[0] = k;
    }
  }
}

template <int K, int Q>
__global__ void __launch_bounds__(kMaxThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ cloud,
           float* __restrict__ dist, int32_t* __restrict__ idx, int m, int n, int k, int tile,
           int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bi = blockIdx.y;
  const int first = blockIdx.x * (int)blockDim.x * Q + (int)threadIdx.x;

  float ux[Q], uy[Q], uz[Q];
  TopK<K> top[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = first + q * (int)blockDim.x;
    const float* u = query + ((size_t)bi * m + (i < m ? i : m - 1)) * 3;
    ux[q] = u[0];
    uy[q] = u[1];
    uz[q] = u[2];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      top[q].d[s] = FLT_MAX;
      top[q].i[s] = 0;
    }
  }
  auto offer_point = [&](const float* s, int j, int p) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      offer<K>(top[q], sq_dist(ux[q], uy[q], uz[q], s[3 * j], s[3 * j + 1], s[3 * j + 2]), p);
    }
  };

  const Ring ring(smem, cloud + (size_t)bi * n * 3, n, tile, stages);
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
        thr[q] = top[q].d[K - 1];
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
          const int p = j + __ffs(mask[q]) - 1;
          mask[q] &= mask[q] - 1u;
          offer<K>(top[q], sq_dist(ux[q], uy[q], uz[q], s[3 * p], s[3 * p + 1], s[3 * p + 2]),
                   base + p);
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
    if (i >= m) break;
    const size_t o = ((size_t)bi * m + i) * k;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        dist[o + s] = top[q].d[s];
        idx[o + s] = top[q].i[s];
      }
    }
  }
}

template <int K, int Q>
int launch(const float* query, const float* cloud, float* dist, int32_t* idx, int b, int m,
           int n, int k, int threads, int tile, int stages, int smem_bytes, int blocks,
           cudaStream_t stream) {
  if ((long long)blocks * threads * Q < m) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, b);
  knn_kernel<K, Q><<<grid, threads, smem_bytes, stream>>>(query, cloud, dist, idx, m, n, k,
                                                          tile, stages);
  return (int)cudaGetLastError();
}

template <int K, int Q>
int allow_smem(int bytes) {
  return (int)cudaFuncSetAttribute(knn_kernel<K, Q>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The plan's fields arrive as ints; a plan this file cannot run, or whose
// grid misses a query, is refused with cudaErrorInvalidValue before any
// launch.  k <= n: the wrapper pads k > n as the plain version does.
extern "C" int psa_knn(const float* query, const float* cloud, float* dist, int32_t* idx,
                       int b, int m, int n, int k, int kmax, int per_thread, int threads,
                       int tile, int stages, int smem_bytes, int blocks, void* stream) {
  const bool ok = b >= 1 && b <= 65535 && m >= 1 && n >= 1 && k >= 1 && k <= kmax &&
                  k <= n && blocks >= 1 && threads >= 32 && threads <= kMaxThreads &&
                  threads % 32 == 0 && tile >= 32 && tile % 32 == 0 &&
                  (stages == 1 || stages == 2) && (stages == 2 || tile >= n) &&
                  smem_bytes == point_tiles::ring_bytes(tile, stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (kmax == 8 && per_thread == 1) {
    return launch<8, 1>(query, cloud, dist, idx, b, m, n, k, threads, tile, stages, smem_bytes,
                        blocks, s);
  }
  if (kmax == 8 && per_thread == 2) {
    return launch<8, 2>(query, cloud, dist, idx, b, m, n, k, threads, tile, stages, smem_bytes,
                        blocks, s);
  }
  if (kmax == 16 && per_thread == 1) {
    return launch<16, 1>(query, cloud, dist, idx, b, m, n, k, threads, tile, stages,
                         smem_bytes, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Let every variant take ``bytes`` of dynamic shared memory on the current
// device; the wrapper calls this once per device and size above 48 KB.  The
// stream is not used: it keeps the entry point's arguments like the others'.
extern "C" int psa_knn_allow_smem(int bytes, void* /*stream*/) {
  if (bytes <= kDefaultSmem) return (int)cudaErrorInvalidValue;
  int err = allow_smem<8, 1>(bytes);
  if (err == 0) err = allow_smem<8, 2>(bytes);
  return err != 0 ? err : allow_smem<16, 1>(bytes);
}
