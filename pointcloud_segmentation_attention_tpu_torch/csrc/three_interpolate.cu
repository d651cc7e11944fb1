// Three-point interpolation:
//   out[b, n, :] = w[b,n,0]*P[b, idx[b,n,0], :] + w[b,n,1]*P[b, idx[b,n,1], :]
//                + w[b,n,2]*P[b, idx[b,n,2], :]
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/interpolate_kernel.py
//   three_interpolate_pallas -> _fwd (body _fwd_kernel).
//
// Bound on this card: bytes.  The output (B, N, C) f32 dominates; at FP4
// (B16, N 8192, C 128) the call must move about 79 MB.  5 f32 operations
// per output element are far below the compute bound.  The first version (one
// thread per element, two 64-bit divisions and six index loads each) was
// bound by instruction issue at a quarter of HBM's rate.
//
// Design (the launch plan is ops/cuda/three_interpolate.py:plan):
// - A group of L lanes (a power of two <= 32) owns one output row.  Lane t
//   walks the row's channels in float4s (the vector path: C % 4 == 0, P and
//   out 16-byte aligned) or in floats (the scalar path), taking elements
//   t, t + L, ...; the plan gives a lane about two (two float4s at FP4).
//   Groups of several rows, each lane with the loads of all of them in
//   flight, measured slower on the H100 (utils/plan_sweep.py).
// - The group reads the row's indices and weights once: lanes 0-2 load them
//   and the lanes take them by shuffle (groups of 1 or 2 lanes load them
//   directly).
// - The batch is blockIdx.y, so no division is needed; offsets are 64-bit
//   products.
// - The output is written with streaming stores (__stcs): it is not read
//   again here, and P, which neighbouring rows read again, keeps the L2.
// - The sum is taken in k order with __fmul_rn/__fadd_rn per component, as
//   the plain version takes it, so the result is bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxBatchBlocks = 65535;  // gridDim.y; more batches loop

__device__ __forceinline__ float mix(float p0, float p1, float p2, float w0, float w1,
                                     float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p0, w0), __fmul_rn(p1, w1)), __fmul_rn(p2, w2));
}

__device__ __forceinline__ float4 mix(float4 p0, float4 p1, float4 p2, float w0, float w1,
                                      float w2) {
  return make_float4(mix(p0.x, p1.x, p2.x, w0, w1, w2), mix(p0.y, p1.y, p2.y, w0, w1, w2),
                     mix(p0.z, p1.z, p2.z, w0, w1, w2), mix(p0.w, p1.w, p2.w, w0, w1, w2));
}

// V is float4 (vector path) or float (scalar path); width = C / (floats in V).
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
three_interpolate_kernel(const V* __restrict__ points, const int32_t* __restrict__ idx,
                         const float* __restrict__ weight, V* __restrict__ out, int batches,
                         int m, int n, int width, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int t = threadIdx.x & (lanes - 1);
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2);
  const bool shuffle = lanes >= 4;  // the same for the whole launch
  const bool live = row < n;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    const long long r = (long long)b * n + row;
    int my_i = 0;
    float my_w = 0.f;
    if (shuffle && t < 3 && live) {
      my_i = __ldg(idx + r * 3 + t);
      my_w = __ldg(weight + r * 3 + t);
    }
    const V* pb = points + (long long)b * m * width;
    const V* src[3];
    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int i;
      if (shuffle) {  // every lane of the warp takes part
        i = __shfl_sync(kFull, my_i, k, lanes);
        w[k] = __shfl_sync(kFull, my_w, k, lanes);
      } else {
        i = live ? __ldg(idx + r * 3 + k) : 0;
        w[k] = live ? __ldg(weight + r * 3 + k) : 0.f;
      }
      src[k] = pb + (long long)i * width;
    }
    if (!live) continue;
    V* dst = out + r * width;
    for (int j = t; j < width; j += lanes) {
      const V p0 = __ldg(src[0] + j), p1 = __ldg(src[1] + j), p2 = __ldg(src[2] + j);
      __stcs(dst + j, mix(p0, p1, p2, w[0], w[1], w[2]));
    }
  }
}

int log2_of(int lanes) {
  for (int l = 0; l <= 5; ++l) {
    if ((1 << l) == lanes) return l;
  }
  return -1;
}

}  // namespace

// The plan's fields (ops/cuda/three_interpolate.py:plan): vector (float4
// accesses), lanes per row, threads and blocks per batch.  A plan whose grid
// misses a row, or a vector plan on a C or a pointer that does not allow it,
// is refused.
extern "C" int psa_three_interpolate(const float* points, const int32_t* idx,
                                     const float* weight, float* out, int b, int m, int n,
                                     int c, int vector, int lanes, int threads, int blocks,
                                     void* stream) {
  const int lanes_log2 = log2_of(lanes);
  if (b < 1 || m < 1 || n < 1 || c < 1 || lanes_log2 < 0 || threads < 32 || threads % 32 ||
      threads > kMaxThreads || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)blocks * (threads / lanes) < n) return (int)cudaErrorInvalidValue;
  if (vector && (c % 4 || (uintptr_t)points % 16 || (uintptr_t)out % 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(blocks, b < kMaxBatchBlocks ? b : kMaxBatchBlocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (vector) {
    three_interpolate_kernel<float4><<<grid, threads, 0, s>>>(
        reinterpret_cast<const float4*>(points), idx, weight, reinterpret_cast<float4*>(out), b,
        m, n, c / 4, lanes_log2);
  } else {
    three_interpolate_kernel<float><<<grid, threads, 0, s>>>(points, idx, weight, out, b, m, n, c,
                                                             lanes_log2);
  }
  return (int)cudaGetLastError();
}
