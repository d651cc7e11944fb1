// Backward of the three-point interpolation
//   out[b, n, :] = sum_k w[b, n, k] * P[b, idx[b, n, k], :]
// given g = d loss / d out (B, N, C):
//   dP[b, t, :]  = sum over (n, k) with idx[b, n, k] == t of w[b, n, k] * g[b, n, :]
//   dw[b, n, k]  = <g[b, n, :], P[b, idx[b, n, k], :]>
// idx gets no gradient.  dw is computed only when the caller passes P and dw.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/interpolate_kernel.py
//   three_interpolate_pallas -> _vjp_bwd (body _bwd_kernel).
//
// Bound on this card: bytes.  g (B, N, C) f32 dominates; at FP4 (B16, N 8192,
// M 1024, C 128) the call must move about 89 MB with dw, 80 MB without.  12
// f32 operations per element of g are far below the compute bound.
//
// Design: two kernels on one stream.  dP: one thread per (n, channel),
// consecutive threads on consecutive channels, so g is read as contiguous
// rows; each thread adds w_k * g to its three target rows with atomicAdd
// (f32 atomics in L2 take the place of the TPU kernel's transposed one-hot
// matmul).  The order of those sums varies between runs, so dP is not
// bit-reproducible; it is held to rtol = atol = 1e-5.  dw: one warp per
// point n; the lanes stride over the channels, reading g's row once for all
// three neighbours, and a butterfly shuffle reduces the three dot products.
// dw has no atomics and is the same from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
three_interpolate_dp_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
                            const float* __restrict__ weight, float* __restrict__ dp,
                            long long total, int m, int n, int c) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long row = e / c;  // b * n + i
  const int ch = (int)(e - row * c);
  const long long base = (row / n) * (long long)m;
  const int32_t* ir = idx + row * 3;
  const float* wr = weight + row * 3;
  const float gv = __ldg(g + e);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    atomicAdd(dp + (base + __ldg(ir + k)) * c + ch, __ldg(wr + k) * gv);
  }
}

__global__ void __launch_bounds__(kThreads)
three_interpolate_dw_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
                            const float* __restrict__ points, float* __restrict__ dw,
                            long long rows, int m, int n, int c) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long base = (row / n) * (long long)m;
  const float* p0 = points + (base + __ldg(idx + row * 3)) * c;
  const float* p1 = points + (base + __ldg(idx + row * 3 + 1)) * c;
  const float* p2 = points + (base + __ldg(idx + row * 3 + 2)) * c;
  const float* gr = g + row * c;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int ch = lane; ch < c; ch += 32) {
    const float gv = __ldg(gr + ch);
    a0 += gv * __ldg(p0 + ch);
    a1 += gv * __ldg(p1 + ch);
    a2 += gv * __ldg(p2 + ch);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    a2 += __shfl_xor_sync(0xffffffffu, a2, off);
  }
  if (lane == 0) {
    dw[row * 3] = a0;
    dw[row * 3 + 1] = a1;
    dw[row * 3 + 2] = a2;
  }
}

}  // namespace

// points and dw may both be null: then only dP is computed.
extern "C" int psa_three_interpolate_bwd(const float* g, const int32_t* idx,
                                         const float* weight, const float* points,
                                         float* dp, float* dw, int b, int m, int n, int c,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(dp, 0, sizeof(float) * (size_t)b * m * c, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)b * n * c;
  three_interpolate_dp_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                                s>>>(g, idx, weight, dp, total, m, n, c);
  err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return (int)err;
  const long long rows = (long long)b * n;
  three_interpolate_dw_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      g, idx, points, dw, rows, m, n, c);
  return (int)cudaGetLastError();
}
