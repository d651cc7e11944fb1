// Backward of the neighbourhood gather: the scatter-add
//   dP[b, t, :] = sum over slots (m, k) with idx[b, m, k] == t of g[b, m, k, :]
// for g (B, M, nsample, C) and idx (B, M, nsample) into dP (B, N, C).
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/group_gather_kernel.py
//   _group_gather_bwd -> _scatter_add_mxu (body _scatter_add_kernel).
//
// Bound on this card: bytes.  g (B, M, nsample, C) f32 dominates; at SA2
// (B16, M 256, nsample 32, C 67) the call must move about 40 MB.  One add
// per element of g is far below the compute bound.
//
// Design: one thread per (centre, channel), consecutive threads on
// consecutive channels, so each slot's g row is read as one contiguous run.
// The thread walks the centre's nsample slots.  Ball-query padding makes
// every slot at or beyond the hit count repeat slot 0, so at real densities
// (~4 hits of 32) most slots land on slot 0's row: those are summed in a
// register and added with one atomicAdd at the end; a slot with another row
// is added at once.  Any idx is summed correctly; the padding only makes it
// cheap.  The TPU kernel's one-hot indicator matmul existed because the TPU
// has no fast scatter; this card has f32 atomics in L2.  Atomics make the
// order of the sum vary between runs: the result is not bit-reproducible,
// and is held to rtol = atol = 1e-5 against the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
group_gather_bwd_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
                        float* __restrict__ dp, long long total, int n, int c, int m,
                        int nsample) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long centre = e / c;  // b * m + j
  const int ch = (int)(e - centre * c);
  const long long bi = centre / m;
  const int32_t* ir = idx + centre * nsample;
  const float* gr = g + centre * nsample * (long long)c + ch;
  float* dpb = dp + bi * n * (long long)c + ch;
  const int first = __ldg(ir);
  float acc = 0.f;
  for (int k = 0; k < nsample; ++k) {
    const int t = __ldg(ir + k);
    const float v = __ldg(gr + (long long)k * c);
    if (t == first) {
      acc += v;
    } else {
      atomicAdd(dpb + (long long)t * c, v);
    }
  }
  atomicAdd(dpb + (long long)first * c, acc);
}

}  // namespace

extern "C" int psa_group_gather_bwd(const float* g, const int32_t* idx, float* dp, int b,
                                    int n, int c, int m, int nsample, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(dp, 0, sizeof(float) * (size_t)b * n * c, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)b * m * c;
  const long long blocks = (total + kThreads - 1) / kThreads;
  group_gather_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(g, idx, dp, total, n, c, m,
                                                                 nsample);
  return (int)cudaGetLastError();
}
