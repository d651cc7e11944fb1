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
// count, scan, fill; with M = 1 one key takes all 3N.
// The sort is csrc/csr.cuh's, with per_batch = 3N entries and M keys; its
// plan is ops/cuda/three_interpolate.py:csr_plan.
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

#include "csr.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;     // consuming pass
constexpr int kMaxBatchBlocks = 65535;

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

}  // namespace

// The CSR alone: offsets (B*M + 1) and entries (3BN, global E, ascending
// within each key), from idx (B, N, 3).
extern "C" int psa_interpolation_csr(const int32_t* idx, int* offsets, int* entries, int* hist,
                                     int b, int n, int m, int fused, int steps, int warps,
                                     int smem_bytes, void* stream) {
  if (3LL * b * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return (int)csr::build(idx, nullptr, offsets, entries, hist, b, 3 * n, m, fused, steps, warps,
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
  if (3LL * b * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = csr::build(idx, weight, offsets, pairs, hist, b, 3 * n, m, fused, steps,
                               warps, smem_bytes, s);
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
