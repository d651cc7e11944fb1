// Farthest point sampling: one thread block per cloud, a loop over npoint
// inside the block.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/fps_kernel.py
//   farthest_point_sample_pallas (body _fps_kernel).
//
// Bound on this card: the npoint-1 selections are sequential, so the kernel
// is bound by latency (one block-wide argmax per pick), not by the ~9 f32
// operations per point per pick nor by the bytes of the cloud.  A batch of
// B clouds keeps only B of the 132 SMs busy.
//
// Design: every pick is one pass over the cloud in which each thread updates
// the running min-distance of its points and keeps the best (distance, index)
// pair packed into one 64-bit key (distance bits high, inverted index low),
// so one unsigned max gives the farthest point with lower-index ties.  A warp
// shuffle reduction and one pass over 16 warp results finish the argmax.
// When coordinates and min-distances fit in shared memory (N <= ~14k) they
// live there for the whole loop; larger clouds read coordinates from device
// memory and keep the min-distances in a scratch tensor the caller allocates.
// Squared distances are summed with __fmul_rn/__fadd_rn in the plain
// version's order ((dx*dx + dy*dy) + dz*dz), never contracted into FMAs, so
// the picks are bit-identical to the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Largest dynamic shared-memory request: 16 bytes per point (xyz + min-dist).
constexpr int kMaxSmemBytes = 200 * 1024;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, float* __restrict__ mind_scratch,
           int32_t* __restrict__ out, int n, int npoint, int use_smem) {
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* gxyz = xyz + (size_t)b * n * 3;
  const float* pts;
  float* mind;
  if (use_smem) {
    float* sx = smem;
    for (int i = tid; i < 3 * n; i += kThreads) sx[i] = gxyz[i];
    pts = sx;
    mind = smem + 3 * (size_t)n;
  } else {
    pts = gxyz;
    mind = mind_scratch + (size_t)b * n;
  }
  // Each thread owns the same indices in every pass, so no barrier is needed
  // between a thread's own min-distance writes and reads.
  for (int i = tid; i < n; i += kThreads) mind[i] = 1e38f;
  int32_t* o = out + (size_t)b * npoint;
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = pts[3 * last], ly = pts[3 * last + 1], lz = pts[3 * last + 2];
    unsigned long long best = 0ull;
    for (int i = tid; i < n; i += kThreads) {
      const float d = sq_dist(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], lx, ly, lz);
      const float m = fminf(mind[i], d);
      mind[i] = m;
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(m) << 32) |
          (unsigned long long)(0xFFFFFFFFu - (unsigned)i);
      best = key > best ? key : best;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      best = other > best ? other : best;
    }
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < kWarps ? warp_best[lane] : 0ull;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, v, off);
        v = other > v ? other : v;
      }
      if (lane == 0) {
        const int pick = (int)(0xFFFFFFFFu - (unsigned)(v & 0xFFFFFFFFull));
        s_pick = pick;
        o[j] = pick;
      }
    }
    __syncthreads();
    last = s_pick;
  }
}

}  // namespace

extern "C" int psa_fps(const float* xyz, float* mind_scratch, int32_t* out,
                       int b, int n, int npoint, void* stream) {
  const size_t smem_bytes = (size_t)n * 4 * sizeof(float);
  const int use_smem = smem_bytes <= (size_t)kMaxSmemBytes;
  if (use_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fps_kernel<<<b, kThreads, use_smem ? smem_bytes : 0, (cudaStream_t)stream>>>(
      xyz, mind_scratch, out, n, npoint, use_smem);
  return (int)cudaGetLastError();
}
