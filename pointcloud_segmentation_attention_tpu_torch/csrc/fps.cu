// Farthest point sampling: a thread-block cluster per cloud, the cloud in
// registers, redux.sync reductions, winners pushed over distributed shared
// memory.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/fps_kernel.py
//   farthest_point_sample_pallas (body _fps_kernel).
//
// Bound on this card: operations, ~9 f32 per point per pick (0.018 ms at
// B16, 8192 -> 1024); the bytes of the cloud are read once.  But the
// npoint-1 picks are sequential, so what a pick costs is latency: update
// the points, argmax over the cloud, hand the winner to every thread.
//
// Design.  The plan (ops/cuda/fps.py:plan) chooses from the shapes:
// - "cluster": clouds of N >= 4096 are spread over a cluster of C = 8
//   blocks (128 of the 132 SMs at B16); block r owns the contiguous slice
//   [r*S, (r+1)*S) of the cloud, S = ceil(N/8).  Each thread keeps K = 16
//   points and their running min-distances in registers for the whole
//   loop, in as few threads as hold the slice (64 at SA1): few warps keep
//   the exchange below short.
// - "block": smaller clouds run one block per cloud, K = 4, where the
//   exchange between blocks costs more than it saves.
// Slices too large for the registers (N > 65,536) live in shared memory
// (16 bytes a point) or, beyond that, are read from device memory with the
// min-distances in a scratch tensor.
// A candidate is a 64-bit key, min-distance bits high (non-negative floats
// order as unsigned) and 0xFFFFFFFF - index low, so the largest key is the
// farthest point and, on ties, the lower index; its xyz travels with it.
// Per pick:
//   1. every thread updates its points against the last pick and keeps its
//      farthest (a float compare and two selects a point; the key and xyz
//      are formed once, after the loop);
//   2. warp argmax: __reduce_max_sync on the high words, then on the low
//      words of the lanes holding that maximum (two redux.sync); the
//      winner's lane follows from its index, and its xyz comes by
//      __shfl_sync;
//   3. one block: the warps' winners meet in shared memory, one
//      __syncthreads, and every warp reduces them itself.  Cluster: lanes
//      0..C-1 of every warp push the warp's winner (key and xyz, 20 bytes)
//      into slot [p][rank, warp] of every block of the cluster, itself
//      included, with st.async over distributed shared memory, p the pick's
//      parity.  Each st.async completes its bytes on the receiving block's
//      mbarrier [p], armed for C x warps x 20 bytes; every thread waits on
//      its own block's mbarrier, then every warp reduces the slots' keys
//      from local shared memory (16 at SA1, one per lane) and reads the
//      winner's xyz from its slot.
// No block reads device memory during the loop.
//
// No barrier in the cluster's loop: on an H100 a cluster barrier costs
// ~420-500 ns, and pulling the winners over distributed shared memory
// after it ~300 ns more, where the push and wait take ~180-240 ns
// (utils/cluster_latency.cu).  Why two slots suffice: a warp pushes pick
// j+2 only after its block has received every warp's winner of pick j+1,
// and each warp pushes pick j+1 only after it has read the slots of pick j.
// For the same reason the mbarrier [p] completes its phase of pick j before
// any byte of pick j+2 reaches it.  The mbarriers are initialised and
// fenced before one cluster barrier at the start; one more at the end keeps
// every block resident until its peers are done.
//
// Squared distances are summed with __fmul_rn/__fadd_rn in the plain
// version's order ((dx*dx + dy*dy) + dz*dz), never contracted into FMAs,
// and the min-distances start at 1e38, so the picks are bit-identical to
// ops/geometry.py:farthest_point_sample.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCluster = 8;
constexpr int kMaxWarps = 32;
constexpr int kMemThreads = 1024;
constexpr float kInitDist = 1e38f;

// A candidate: key 0 is no point (every point's key is larger).
struct Cand {
  u64 key;
  float x, y, z;
};

// A candidate in shared memory; a push writes it as one 16-byte and one
// 4-byte st.async.
struct __align__(16) Slot {
  u64 key;
  float x, y, z;
};
constexpr unsigned kSlotBytes = 20;

// The shared memory of the per-pick argmax, double-buffered by parity.
template <int C>
struct Exchange {
  Slot warp[2][kMaxWarps];                  // one block: each warp's winner
  Slot recv[2][C > 1 ? C * kMaxWarps : 1];  // cluster: each warp's winner, from every block
  u64 mbar[2];                              // cluster: all slots of one parity have landed
};

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void offer(Cand& best, float m, unsigned i,
                                      float x, float y, float z) {
  const u64 key = ((u64)__float_as_uint(m) << 32) | (u64)(0xFFFFFFFFu - i);
  if (key > best.key) best = Cand{key, x, y, z};
}

__device__ __forceinline__ unsigned key_index(u64 key) {
  return 0xFFFFFFFFu - (unsigned)key;
}

// The largest key over the warp's lanes, in every lane.
__device__ __forceinline__ u64 warp_max_key(u64 key) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(key >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
  return ((u64)hi << 32) | lo;
}

// Warp argmax of the threads' own candidates.  Point i of this block's slice
// (which starts at ``begin``) lives in lane (i - begin) % 32, since blocks
// have a multiple of 32 threads; a warp without points returns key 0.
__device__ __forceinline__ Cand warp_argmax_own(const Cand& c, unsigned begin) {
  const u64 key = warp_max_key(c.key);
  const int owner = (int)((key_index(key) - begin) & 31u);
  return Cand{key, __shfl_sync(kFull, c.x, owner), __shfl_sync(kFull, c.y, owner),
              __shfl_sync(kFull, c.z, owner)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The same shared-memory address in block ``rank`` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// Write c into a peer's slot; the bytes complete on the peer's mbarrier.
__device__ __forceinline__ void push(const Cand& c, uint32_t slot, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(slot), "r"((unsigned)c.key), "r"((unsigned)(c.key >> 32)),
         "r"(__float_as_uint(c.x)), "r"(__float_as_uint(c.y)), "r"(mbar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(slot + 16), "r"(__float_as_uint(c.z)), "r"(mbar) : "memory");
}

__device__ __forceinline__ void arm(uint32_t mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t mbar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}"
      :: "r"(mbar), "r"(parity) : "memory");
}

template <int C>
__device__ __forceinline__ int block_rank() {
  if constexpr (C == 1) {
    return 0;
  } else {
    return (int)cg::this_cluster().block_rank();
  }
}

// Where this lane pushes: lane l < C writes slot [p][rank, warp] and
// completes mbarrier [p] of block l.
struct Peers {
  uint32_t slot0, slot1, mbar0, mbar1;
};

// Cluster: both mbarriers take one local arrival (the arming) per phase;
// they are initialised and fenced before the peers may push into them.
template <int C>
__device__ __forceinline__ Peers exchange_init(Exchange<C>& ex, int rank) {
  Peers p{0u, 0u, 0u, 0u};
  if constexpr (C > 1) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2; ++k) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&ex.mbar[k]))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    const int lane = threadIdx.x & 31;
    const int slot = rank * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5);
    const int peer = lane < C ? lane : 0;
    p.slot0 = peer_addr(smem_addr(&ex.recv[0][slot]), peer);
    p.slot1 = peer_addr(smem_addr(&ex.recv[1][slot]), peer);
    p.mbar0 = peer_addr(smem_addr(&ex.mbar[0]), peer);
    p.mbar1 = peer_addr(smem_addr(&ex.mbar[1]), peer);
    cg::this_cluster().sync();
  }
  return p;
}

template <int C>
__device__ __forceinline__ void final_barrier() {
  if constexpr (C > 1) cg::this_cluster().sync();
}

// Steps 2-3 above: the winner of pick j over the whole cloud, in every
// thread.  ``phases`` holds the next phase parity of each mbarrier.
template <int C>
__device__ __forceinline__ Cand pick_winner(const Cand& mine, int j, unsigned begin,
                                            Exchange<C>& ex, const Peers& peers,
                                            unsigned& phases) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int par = j & 1;
  const Cand w = warp_argmax_own(mine, begin);
  const Slot* slots;
  int total;
  if constexpr (C == 1) {
    if (lane == 0) ex.warp[par][warp] = Slot{w.key, w.x, w.y, w.z};
    __syncthreads();
    slots = ex.warp[par];
    total = nwarps;
  } else {
    const uint32_t mbar = smem_addr(&ex.mbar[par]);
    if (threadIdx.x == 0) arm(mbar, C * nwarps * kSlotBytes);
    if (lane < C) push(w, par ? peers.slot1 : peers.slot0, par ? peers.mbar1 : peers.mbar0);
    wait_parity(mbar, (phases >> par) & 1u);
    phases ^= 1u << par;
    slots = ex.recv[par];
    total = C * nwarps;
  }
  // Each lane takes the largest key of its slots (lane, lane + 32, ...);
  // the warp's largest key names the slot the winner's xyz is read from.
  u64 best = 0;
  int at = 0;
#pragma unroll
  for (int t = 0; t < (C > 1 ? C : 1); ++t) {
    if (32 * t >= total) break;
    const int q = lane + 32 * t;
    const u64 key = q < total ? slots[q].key : 0ull;
    if (key > best) {
      best = key;
      at = q;
    }
  }
  const u64 key = warp_max_key(best);
  at = __shfl_sync(kFull, at, __ffs(__ballot_sync(kFull, best == key)) - 1);
  return Cand{key, slots[at].x, slots[at].y, slots[at].z};
}

// The slice's points and min-distances in registers, K per thread.
template <int K, int C>
__global__ void __launch_bounds__(K <= 4 ? 1024 : 512)
fps_regs_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n,
                int npoint, int slice) {
  __shared__ Exchange<C> ex;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x / C;
  const int rank = block_rank<C>();
  const float* g = xyz + (size_t)b * n * 3;
  const unsigned begin = (unsigned)(rank * slice);
  const unsigned end = (unsigned)min(n, (rank + 1) * slice);

  // Slots past the slice's end hold min-distance -1, which no update
  // raises and no point's distance ties, so the loop needs no bounds test.
  float px[K], py[K], pz[K], md[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned i = begin + (unsigned)(tid + k * nthreads);
    const bool in = i < end;
    px[k] = in ? g[3 * (size_t)i] : 0.f;
    py[k] = in ? g[3 * (size_t)i + 1] : 0.f;
    pz[k] = in ? g[3 * (size_t)i + 2] : 0.f;
    md[k] = in ? kInitDist : -1.f;
  }
  float lx = g[0], ly = g[1], lz = g[2];
  int32_t* o = out + (size_t)b * npoint;
  const bool writer = rank == 0 && tid == 0;
  if (writer) o[0] = 0;
  const Peers peers = exchange_init<C>(ex, rank);
  unsigned phases = 0;

  for (int j = 1; j < npoint; ++j) {
    // The thread's farthest point: a strictly larger distance replaces it,
    // so ties keep the lower k, the lower index.
    float bm = -1.f;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      md[k] = fminf(md[k], sq_dist(px[k], py[k], pz[k], lx, ly, lz));
      if (md[k] > bm) {
        bm = md[k];
        bk = k;
      }
    }
    Cand best{0ull, px[0], py[0], pz[0]};
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (bk == k) best = Cand{0ull, px[k], py[k], pz[k]};
    }
    if (bm >= 0.f) {
      best.key = ((u64)__float_as_uint(bm) << 32) |
                 (u64)(0xFFFFFFFFu - (begin + (unsigned)(tid + bk * nthreads)));
    }
    const Cand w = pick_winner<C>(best, j, begin, ex, peers, phases);
    lx = w.x;
    ly = w.y;
    lz = w.z;
    if (writer) o[j] = (int32_t)key_index(w.key);
  }
  final_barrier<C>();
}

// The slice in shared memory (use_smem) or read from device memory with its
// min-distances in the caller's scratch: slices too large for registers.
template <int C>
__global__ void __launch_bounds__(kMemThreads)
fps_mem_kernel(const float* __restrict__ xyz, float* __restrict__ mind_scratch,
               int32_t* __restrict__ out, int n, int npoint, int slice, int use_smem) {
  extern __shared__ float smem[];
  __shared__ Exchange<C> ex;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x / C;
  const int rank = block_rank<C>();
  const float* g = xyz + (size_t)b * n * 3;
  const int begin = rank * slice;
  const int len = max(0, min(n, begin + slice) - begin);
  const float* pts;
  float* mind;
  if (use_smem) {
    for (int i = tid; i < 3 * len; i += nthreads) smem[i] = g[3 * (size_t)begin + i];
    pts = smem;
    mind = smem + 3 * (size_t)slice;
  } else {
    pts = g + 3 * (size_t)begin;
    mind = mind_scratch + (size_t)b * n + begin;
  }
  // Each thread owns the same indices in every pick, so its own min-distance
  // writes and reads need no barrier.
  for (int i = tid; i < len; i += nthreads) mind[i] = kInitDist;
  __syncthreads();
  float lx = g[0], ly = g[1], lz = g[2];
  int32_t* o = out + (size_t)b * npoint;
  const bool writer = rank == 0 && tid == 0;
  if (writer) o[0] = 0;
  const Peers peers = exchange_init<C>(ex, rank);
  unsigned phases = 0;

  for (int j = 1; j < npoint; ++j) {
    Cand best{0ull, 0.f, 0.f, 0.f};
    for (int i = tid; i < len; i += nthreads) {
      const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
      const float m = fminf(mind[i], sq_dist(x, y, z, lx, ly, lz));
      mind[i] = m;
      offer(best, m, (unsigned)(begin + i), x, y, z);
    }
    const Cand w = pick_winner<C>(best, j, (unsigned)begin, ex, peers, phases);
    lx = w.x;
    ly = w.y;
    lz = w.z;
    if (writer) o[j] = (int32_t)key_index(w.key);
  }
  final_barrier<C>();
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int blocks, int threads, int cluster, int smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// cluster, threads, per_thread and smem_bytes come from ops/cuda/fps.py:plan;
// a combination it never makes is refused with cudaErrorInvalidValue.
// per_thread 0 selects the memory-resident slice: in shared memory when
// smem_bytes > 0, else in device memory with mind_scratch (B, N) f32.
extern "C" int psa_fps(const float* xyz, float* mind_scratch, int32_t* out, int b, int n,
                       int npoint, int cluster, int threads, int per_thread, int smem_bytes,
                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if ((cluster != 1 && cluster != kCluster) || threads < 32 || threads % 32 != 0 ||
      threads > kMemThreads || n < 1 || npoint < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int slice = (n + cluster - 1) / cluster;
  const int blocks = b * cluster;
  if (per_thread == 0) {
    if (cluster != kCluster || threads != kMemThreads) return (int)cudaErrorInvalidValue;
    const int use_smem = smem_bytes > 0;
    if (use_smem ? smem_bytes != slice * 16 : mind_scratch == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    return launch(fps_mem_kernel<kCluster>, blocks, threads, cluster, smem_bytes, s, xyz,
                  mind_scratch, out, n, npoint, slice, use_smem);
  }
  if ((long long)threads * per_thread < slice || smem_bytes != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (cluster == 1 && per_thread == 4) {
    return launch(fps_regs_kernel<4, 1>, blocks, threads, 1, 0, s, xyz, out, n, npoint, slice);
  }
  if (cluster == kCluster && per_thread == 16 && threads <= 512) {
    return launch(fps_regs_kernel<16, kCluster>, blocks, threads, cluster, 0, s, xyz, out, n,
                  npoint, slice);
  }
  return (int)cudaErrorInvalidValue;
}
