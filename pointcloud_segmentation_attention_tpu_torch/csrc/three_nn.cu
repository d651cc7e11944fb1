// Three nearest neighbours: for each unknown point, the 3 known points of
// least squared distance, ascending, lower index first on ties.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/three_nn_kernel.py
//   three_nn_pallas (body _three_nn_kernel).
//
// Bound on this card: the distance arithmetic, 8 f32 operations for each of
// the N*M (unknown, known) pairs; at FP4 (B16, 8192 x 1024) about 1.1 GFLOP.
//
// Design: one thread per unknown point; the block stages the known points
// through shared memory in tiles of 256 and every thread keeps its top 3 in
// registers with an insertion that uses strict <, so an equal distance never
// displaces a lower index.  The slots start at FLT_MAX with index 0, which is
// also the padding of the plain version when M < 3, so that case needs no
// branch.  Squared distances are summed with __fmul_rn/__fadd_rn in the plain
// version's order, so indices and distances are bit-identical to it.
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                float* __restrict__ dist, int32_t* __restrict__ idx, int n, int m) {
  __shared__ float tile[3 * kTile];
  const int bi = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const float* u = unknown + ((size_t)bi * n + (active ? i : 0)) * 3;
  const float ux = u[0], uy = u[1], uz = u[2];
  const float* kn = known + (size_t)bi * m * 3;

  float d0 = FLT_MAX, d1 = FLT_MAX, d2 = FLT_MAX;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tn = min(kTile, m - t0);
    for (int j = threadIdx.x; j < 3 * tn; j += kThreads) tile[j] = kn[3 * t0 + j];
    __syncthreads();
    if (active) {
      for (int j = 0; j < tn; ++j) {
        const float dx = __fsub_rn(ux, tile[3 * j]);
        const float dy = __fsub_rn(uy, tile[3 * j + 1]);
        const float dz = __fsub_rn(uz, tile[3 * j + 2]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const int k = t0 + j;
        if (d < d0) {
          d2 = d1; i2 = i1; d1 = d0; i1 = i0; d0 = d; i0 = k;
        } else if (d < d1) {
          d2 = d1; i2 = i1; d1 = d; i1 = k;
        } else if (d < d2) {
          d2 = d; i2 = k;
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const size_t o = ((size_t)bi * n + i) * 3;
  dist[o] = d0; dist[o + 1] = d1; dist[o + 2] = d2;
  idx[o] = i0; idx[o + 1] = i1; idx[o + 2] = i2;
}

}  // namespace

extern "C" int psa_three_nn(const float* unknown, const float* known, float* dist,
                            int32_t* idx, int b, int n, int m, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  three_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      unknown, known, dist, idx, n, m);
  return (int)cudaGetLastError();
}
