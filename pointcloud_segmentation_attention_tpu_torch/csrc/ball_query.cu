// Ball query: one warp per query centre.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/ball_query_kernel.py
//   ball_query_pallas (body _ball_query_kernel).
//
// Bound on this card: the distance arithmetic, 8 f32 operations for each
// (centre, point) pair the scan visits; at SA1 balls hold a few points of
// 8192, so the scan visits all of them.  The outputs are small.
//
// Design: a warp scans the cloud in index order, 32 points a step.
// __ballot_sync gives the step's in-radius mask and __popc of the lanes below
// gives each hit its position, so hits land in index order with no sort, and
// the warp stops as soon as nsample hits are found, which also yields the
// clamped count.  Slots at or beyond the count repeat the first hit (0 when
// the ball is empty).  The TPU kernel's full-width prefix sums and 16-bit
// packing are not needed.  The threshold r2 comes from the host as
// float32(max(r, 1e-20)**2), squared in double and rounded once; squared
// distances are summed with __fmul_rn/__fadd_rn in the plain version's order,
// so the boundary test is bit-identical to it.  Coordinates are read from
// device memory (cached); staging them through shared memory is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int32_t* __restrict__ idx, int32_t* __restrict__ cnt,
                  int b, int n, int m, float r2, int nsample) {
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= (long long)b * m) return;  // the whole warp leaves together
  const int bi = (int)(q / m);
  const float* pts = xyz + (size_t)bi * n * 3;
  const float cx = centers[q * 3], cy = centers[q * 3 + 1], cz = centers[q * 3 + 2];
  int32_t* out = idx + q * nsample;

  int count = 0;
  int first = 0;
  for (int base = 0; base < n && count < nsample; base += 32) {
    const int k = base + lane;
    bool hit = false;
    if (k < n) {
      const float dx = __fsub_rn(cx, __ldg(pts + 3 * k));
      const float dy = __fsub_rn(cy, __ldg(pts + 3 * k + 1));
      const float dz = __fsub_rn(cz, __ldg(pts + 3 * k + 2));
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, hit);
    if (mask) {
      if (count == 0) first = base + __ffs(mask) - 1;
      const int pos = count + __popc(mask & ((1u << lane) - 1u));
      if (hit && pos < nsample) out[pos] = k;
      count += __popc(mask);
    }
  }
  count = count < nsample ? count : nsample;
  for (int s = count + lane; s < nsample; s += 32) out[s] = first;
  if (lane == 0) cnt[q] = count;
}

}  // namespace

extern "C" int psa_ball_query(const float* xyz, const float* centers, int32_t* idx,
                              int32_t* cnt, int b, int n, int m, float r2,
                              int nsample, void* stream) {
  const long long warps = (long long)b * m;
  const int blocks = (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ball_query_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      xyz, centers, idx, cnt, b, n, m, r2, nsample);
  return (int)cudaGetLastError();
}
