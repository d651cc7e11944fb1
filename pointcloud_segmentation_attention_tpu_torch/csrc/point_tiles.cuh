// A ring of point tiles in shared memory, shared by ball_query.cu and
// three_nn.cu.
//
// A block walks one cloud of (N, 3) f32 points in index order, a tile of
// ``tile`` points at a time (``tile`` a multiple of 32).  Tile t lands in
// buffer t % stages.  Every thread copies its share of the tile's words with
// cp.async (16 bytes a copy where the cloud's address allows, else 4), then
// makes one cp.async.mbarrier.arrive.noinc on the buffer's mbarrier, which
// was initialised for blockDim.x arrivals: the barrier's phase completes
// when every thread's copies have landed, and a thread that waits on it then
// sees the whole tile.  With two stages, tile t+1 is in flight while the
// block scans tile t; the caller refills a buffer only after a
// __syncthreads that follows the last read of it.  The layout stays AoS:
// word 3k + a is coordinate a of the tile's point k.
//
// The block's dynamic shared memory holds the ring: the mbarriers first
// (kHeaderBytes), then the buffers.  Nothing is static, so the launch's
// dynamic size is all the block takes, and the 48 KB default limit applies
// to it alone.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace point_tiles {

constexpr int kMaxStages = 2;
constexpr int kHeaderBytes = 16;  // kMaxStages mbarriers, 8 bytes each
constexpr int kBytesPerPoint = 12;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  // The plain version's order, each step rounded on its own: no FMA.
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// mask |= bit when d < thr: a compare and a predicated OR.  The compiler's
// own form of this (a select, then a merge) takes two more instructions.
__device__ __forceinline__ void mark_if_below(unsigned& mask, float d, float thr, unsigned bit) {
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, %2;\n\t@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(mask) : "f"(d), "f"(thr), "r"(bit));
}

struct Ring {
  float* buf;           // stages * tile * 3 floats, 16-byte aligned
  uint64_t* mbar;       // one mbarrier per stage
  const float* cloud;   // this block's cloud, N * 3 floats
  int n, tile, stages, ntiles;

  // ``smem`` is the block's dynamic shared memory, 16-byte aligned.
  __device__ __forceinline__ Ring(unsigned char* smem, const float* cloud_, int n_, int tile_,
                                  int stages_)
      : buf(reinterpret_cast<float*>(smem + kHeaderBytes)),
        mbar(reinterpret_cast<uint64_t*>(smem)), cloud(cloud_), n(n_), tile(tile_),
        stages(stages_),
        ntiles((n_ + tile_ - 1) / tile_) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                     :: "r"(smem_addr(mbar + s)), "r"(blockDim.x) : "memory");
      }
    }
    __syncthreads();
  }

  __device__ __forceinline__ int count(int t) const { return min(tile, n - t * tile); }

  // Start copying tile t into buffer t % stages.
  __device__ __forceinline__ void fill(int t) const {
    const int s = t % stages;
    float* dst = buf + (size_t)s * tile * 3;
    const float* src = cloud + (size_t)t * tile * 3;
    const int words = 3 * count(t);
    int w0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
      // dst is 16-byte aligned: the buffers start so and tile % 32 == 0.
      const int vecs = words >> 2;
      for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(smem_addr(dst + 4 * v)), "l"(src + 4 * v) : "memory");
      }
      w0 = vecs << 2;
    }
    for (int w = w0 + (int)threadIdx.x; w < words; w += blockDim.x) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   :: "r"(smem_addr(dst + w)), "l"(src + w) : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_addr(mbar + s)) : "memory");
  }

  // Wait until tile t has landed; returns its buffer.  Buffer s completes
  // its k-th fill (tile k * stages + s) in phase k.
  __device__ __forceinline__ const float* wait(int t) const {
    const int s = t % stages;
    const uint32_t parity = (uint32_t)(t / stages) & 1u;
    asm volatile(
        "{\n\t.reg .pred done;\n"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
        "@!done bra WAIT;\n}"
        :: "r"(smem_addr(mbar + s)), "r"(parity) : "memory");
    return buf + (size_t)s * tile * 3;
  }

  // Start the first fills: tiles 0 .. stages-1.
  __device__ __forceinline__ void start() const {
    for (int t = 0; t < stages && t < ntiles; ++t) fill(t);
  }

  // After the scan of tile t and a __syncthreads: refill its buffer.
  __device__ __forceinline__ void advance(int t) const {
    if (t + stages < ntiles) fill(t + stages);
  }

  // Before the block leaves after tile t (advance(t) not called): wait for
  // the fills still in flight, tiles t+1 .. t+stages-1, so that no copy
  // lands in shared memory the block no longer owns.
  __device__ __forceinline__ void drain(int t) const {
    for (int u = t + 1; u < ntiles && u < t + stages; ++u) wait(u);
  }
};

// The dynamic shared memory a ring takes; the host's plans compute the same.
__host__ __device__ constexpr long long ring_bytes(int tile, int stages) {
  return kHeaderBytes + (long long)stages * tile * kBytesPerPoint;
}

}  // namespace point_tiles
