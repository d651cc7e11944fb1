// Latency of the block and cluster synchronisation steps that one pick of
// farthest point sampling (csrc/fps.cu) can be built from, on one card.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o cluster_latency cluster_latency.cu && ./cluster_latency
//
// Each line is the time of one loop iteration in ns (CUDA events around a
// launch of ITERS iterations, after one warm-up launch), for 1 and 16
// clusters of 8 blocks, at 256 and 1024 threads a block:
// - cluster.sync: one cluster barrier (barrier.cluster arrive + wait);
// - __syncthreads: one block barrier;
// - cluster.sync + DSMEM pull: each block writes a word, a cluster barrier,
//   then lanes 0-7 of every warp read the word of block `lane` over
//   distributed shared memory and reduce it with redux.sync;
// - st.async push + mbarrier wait: lanes 0-7 of warp 0 push 20 bytes into
//   a slot of every block of the cluster (st.async with complete_tx on that
//   block's mbarrier), every thread waits on its own block's mbarrier, and
//   lanes 0-7 reduce the 8 slots; two slots and mbarriers by parity;
// - warp argmax: a dependent chain of redux.max, redux.min, vote and shfl.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kIters = 20000;

enum Mode { kClusterSync, kSyncThreads, kClusterPull, kPush, kArgmax };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

template <int MODE>
__global__ void __cluster_dims__(8, 1, 1) probe(int iters, unsigned* out) {
  __shared__ unsigned word[2];
  __shared__ __align__(16) unsigned slot[2][8][8];
  __shared__ unsigned long long mbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  if (MODE == kPush) {
    if (threadIdx.x == 0) {
      for (int p = 0; p < 2; ++p) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&mbar[p]))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster.sync();
  }
  unsigned v = threadIdx.x * 2654435761u + blockIdx.x;
  unsigned phases = 0;
  for (int j = 0; j < iters; ++j) {
    const int par = j & 1;
    if (MODE == kClusterSync) cluster.sync();
    if (MODE == kSyncThreads) __syncthreads();
    if (MODE == kClusterPull) {
      if (threadIdx.x == 0) word[par] = v;
      cluster.sync();
      const unsigned r = lane < 8 ? *cluster.map_shared_rank(&word[par], lane) : 0u;
      v += __reduce_max_sync(kFull, r);
    }
    if (MODE == kPush) {
      const uint32_t mb = smem_addr(&mbar[par]);
      if (threadIdx.x < 8) {
        if (threadIdx.x == 0) {
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                       :: "r"(mb), "r"(160) : "memory");
        }
        const uint32_t dst = peer_addr(smem_addr(&slot[par][cluster.block_rank()][0]), lane);
        const uint32_t rmb = peer_addr(mb, lane);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
            :: "r"(dst), "r"(v), "r"(v), "r"(v), "r"(v), "r"(rmb) : "memory");
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                     :: "r"(dst + 16), "r"(v), "r"(rmb) : "memory");
      }
      asm volatile(
          "{\n\t.reg .pred done;\nWAIT:\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
          "@!done bra WAIT;\n}" :: "r"(mb), "r"((phases >> par) & 1u) : "memory");
      phases ^= 1u << par;
      v += __reduce_max_sync(kFull, lane < 8 ? slot[par][lane][0] : 0u);
    }
    if (MODE == kArgmax) {
      const unsigned m = __reduce_max_sync(kFull, v);
      const unsigned i = __reduce_min_sync(kFull, v == m ? threadIdx.x : kFull);
      const int owner = __ffs(__ballot_sync(kFull, v == m && threadIdx.x == i)) - 1;
      v = __shfl_sync(kFull, v ^ i, owner);
    }
  }
  cluster.sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = v;
}

template <int MODE>
void run(const char* name, int clusters, int threads, unsigned* out) {
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  probe<MODE><<<clusters * 8, threads>>>(kIters, out);
  cudaEventRecord(start);
  probe<MODE><<<clusters * 8, threads>>>(kIters, out);
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, stop);
  printf("%-32s clusters=%2d threads=%4d: %7.1f ns/iter (%s)\n", name, clusters, threads,
         ms * 1e6f / kIters, cudaGetErrorString(cudaGetLastError()));
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
}

}  // namespace

int main() {
  unsigned* out = nullptr;
  cudaMalloc(&out, 16 * 8 * 1024 * sizeof(unsigned));
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s\n", prop.name);
  for (int clusters : {1, 16}) {
    for (int threads : {256, 1024}) {
      run<kClusterSync>("cluster.sync", clusters, threads, out);
      run<kSyncThreads>("__syncthreads", clusters, threads, out);
      run<kClusterPull>("cluster.sync + DSMEM pull", clusters, threads, out);
      run<kPush>("st.async push + mbarrier wait", clusters, threads, out);
      run<kArgmax>("warp argmax (redux, vote, shfl)", clusters, threads, out);
    }
  }
  cudaFree(out);
  return 0;
}
