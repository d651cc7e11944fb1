// Three-point interpolation:
//   out[b, n, :] = w[b,n,0]*P[b, idx[b,n,0], :] + w[b,n,1]*P[b, idx[b,n,1], :]
//                + w[b,n,2]*P[b, idx[b,n,2], :]
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/interpolate_kernel.py
//   three_interpolate_pallas -> _fwd (body _fwd_kernel).
//
// Bound on this card: bytes.  The output (B, N, C) f32 dominates; at FP4
// (B16, N 8192, C 128) the call must move about 79 MB.  5 f32 operations
// per output element are far below the compute bound.
//
// Design: one thread per output element, consecutive threads on consecutive
// channels, so the three source rows are read and the output row written as
// contiguous runs.  It is a direct gather: the TPU kernel's one-hot indicator
// matrix existed only to feed its matrix unit.  The sum is taken in k order
// with __fmul_rn/__fadd_rn, as the plain version takes it, so the result is
// bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
three_interpolate_kernel(const float* __restrict__ points,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ weight, float* __restrict__ out,
                         long long total, int m, int n, int c) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long row = e / c;  // b * n + i
  const int ch = (int)(e - row * c);
  const long long base = (row / n) * (long long)m;
  const int32_t* ir = idx + row * 3;
  const float* wr = weight + row * 3;
  const float p0 = __ldg(points + (base + __ldg(ir)) * c + ch);
  const float p1 = __ldg(points + (base + __ldg(ir + 1)) * c + ch);
  const float p2 = __ldg(points + (base + __ldg(ir + 2)) * c + ch);
  out[e] = __fadd_rn(__fadd_rn(__fmul_rn(p0, __ldg(wr)), __fmul_rn(p1, __ldg(wr + 1))),
                     __fmul_rn(p2, __ldg(wr + 2)));
}

}  // namespace

extern "C" int psa_three_interpolate(const float* points, const int32_t* idx,
                                     const float* weight, float* out, int b, int m,
                                     int n, int c, void* stream) {
  const long long total = (long long)b * n * c;
  const long long blocks = (total + kThreads - 1) / kThreads;
  three_interpolate_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      points, idx, weight, out, total, m, n, c);
  return (int)cudaGetLastError();
}
