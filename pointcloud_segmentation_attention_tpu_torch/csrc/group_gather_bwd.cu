// Backward of the neighbourhood gather: the scatter-add
//   dP[b, t, :] = sum over slots (m, k) with idx[b, m, k] == t of g[b, m, k, :]
// for g (B, M, K, C) and idx (B, M, K) into dP (B, N, C), each row's sum
// taken from 0 in ascending flat slot E = (b*M + m)*K + k.
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/group_gather_kernel.py
//   _group_gather_bwd -> _scatter_add_mxu (body _scatter_add_kernel).
//
// Bound on this card: bytes.  g (B, M, K, C) f32 dominates; at SA2 (B16,
// N 1024, M 256, K 32, C 67) the call must move about 40 MB.  One add per
// element of g is far below the compute bound.
//
// Design: no atomics and no memset, so dP is the same bits on every run.
// The TPU kernel adds its row tiles into one output block in grid order;
// here the slots are first regrouped by the row t they gather from, a CSR of
// idx's transpose over the B*N keys built by csrc/csr.cuh's stable counting
// sort (per_batch = M*K entries, N keys, indices E alone; its plan is
// ops/cuda/group_gather.py:csr_plan).  Then one pass consumes it, and each
// row's sum is acc = acc + g (__fadd_rn) from 0 over the key's entries in
// order, in registers; dP[b, t] is written once (0 for a row no slot
// names).  That is the order in which index_add_ on the CPU adds them, so
// dP equals the plain version run on the CPU bit for bit.  Each slot lies in
// exactly one key's list, so g is read once.
//
// Ball-query padding repeats slot 0's index in every slot at or beyond the
// hit count, so slot 0's row collects most of a centre's K slots (~30 of 32
// at SA2, where a ball holds ~2 points) while other rows get a few or none:
// a lane group per key would leave most groups idle and a few walking long
// chains.  So the pass deals out the CSR's places instead: the scan cuts
// them into windows of S consecutive places and a lane group takes one
// window, the keys whose segments start in it (first_key[w] up to
// first_key[w + 1]), walked in order across key boundaries, a long segment
// to its end.  The group loads L entries and their keys at once (a lane
// each, shared by shuffle) and the g rows of U of them before adding any;
// the boundary test is one compare a row.  Rows no slot names get zeros
// from groups of their own.  The rows are C = 67, 131, 259 floats at SA2-4,
// not 16-byte aligned: a lane takes P (1-5) elements of a row, L apart, in
// floats, a column block of L*P elements per grid row; float4 accesses only
// where C % 4 == 0 and the pointers are aligned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxColBlocks = 65535;
constexpr int kZeroKeys = 32;  // keys a zero group of the consuming pass takes

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Loads through the read-only path that the compiler keeps where they are
// written, so that all of a round's loads are issued before its first add
// (conditional loads feeding the adding branch ran 1.4-1.7x slower at
// SA3-4 on an H100).
__device__ __forceinline__ float load_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 load_nc(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// The consuming pass.  Lane group w (L lanes) takes, in column block y,
// elements [y*L*P, (y+1)*L*P) of a row of `width` (floats or float4s); lane
// t holds elements y*L*P + t + j*L, j < P.  Groups below `windows` take a
// window: keys k0 up to k1 from first[w], first[w + 1] (with their offsets,
// so one load round fewer); they walk the places [offsets[k0],
// offsets[k1]) in order, L at a
// time: a lane loads one entry E and its key, b*N + idx[E] with b = E / MK
// (the CSR is sorted by key, so a change of key ends a row), and the group
// loads the g rows of U entries before adding them.  The groups after them
// write the zero rows, kZeroKeys keys each: a window may hold hundreds of
// keys no slot names (SA2's ball queries leave half the rows empty, and a
// batch's trailing empty rows join the next batch's first window), and
// zeroing them there, a load round per L keys, made those few windows the
// pass's critical path.
template <typename V, int P, int U>
__global__ void __launch_bounds__(kMaxThreads)
group_gather_bwd_kernel(const V* __restrict__ g, const int32_t* __restrict__ idx,
                        const int* __restrict__ entries, const int* __restrict__ offsets,
                        const int2* __restrict__ first, V* __restrict__ dp, int windows,
                        int keys, int width, int n, int mk, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int t = threadIdx.x & (lanes - 1);
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2;
  const int group0 = (threadIdx.x & 31) & ~(lanes - 1);
  const unsigned gmask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1) << group0;
  const int col0 = blockIdx.y * lanes * P + t;
  bool in[P];
  int col[P];  // clamped into the row, so that every lane may load
#pragma unroll
  for (int j = 0; j < P; ++j) {
    in[j] = col0 + j * lanes < width;
    col[j] = min(col0 + j * lanes, width - 1);
  }
  if (w >= windows) {  // a zero group: the rows of its keys that no slot names
    const long long first = (w - windows) * kZeroKeys;
    if (first >= keys) return;
    const int last = (int)min(first + kZeroKeys, (long long)keys);
    for (int kb = (int)first; kb < last; kb += lanes) {
      const int key = kb + t;
      const bool empty = key < last && __ldg(offsets + key) == __ldg(offsets + key + 1);
      unsigned mask = __ballot_sync(gmask, empty) >> group0;
      while (mask) {  // the same for the whole group
        V* out = dp + (long long)(kb + __ffs(mask) - 1) * width + col0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (in[j]) out[j * lanes] = zero<V>();
        }
        mask &= mask - 1;
      }
    }
    return;
  }
  const int2 lo = __ldg(first + w), hi = __ldg(first + w + 1);
  if (lo.x >= hi.x) return;  // no segment starts here: the window lies inside a longer one
  const int begin = lo.y, end = hi.y;  // offsets[k0], offsets[k1]
  V acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = zero<V>();
  int cur = -1;  // the key acc belongs to
  for (int base = begin; base < end; base += lanes) {
    const int cnt = min(lanes, end - base);
    int e = 0, key = -1;  // entries past cnt: row 0, loaded and never added
    if (t < cnt) {
      e = __ldg(entries + base + t);
      key = (e / mk) * n + __ldg(idx + e);
    }
    for (int q = 0; q < cnt; q += U) {
      V gv[U][P];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every lane of the group takes part
        const V* row = g + (long long)__shfl_sync(gmask, e, q + u, lanes) * width;
#pragma unroll
        for (int j = 0; j < P; ++j) gv[u][j] = load_nc(row + col[j]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ku = __shfl_sync(gmask, key, q + u, lanes);
        if (q + u < cnt) {
          if (ku != cur) {  // the row of key cur is complete
            if (cur >= 0) {
              V* out = dp + (long long)cur * width + col0;
#pragma unroll
              for (int j = 0; j < P; ++j) {
                if (in[j]) out[j * lanes] = acc[j];
              }
            }
#pragma unroll
            for (int j = 0; j < P; ++j) acc[j] = zero<V>();
            cur = ku;
          }
#pragma unroll
          for (int j = 0; j < P; ++j) acc[j] = add(acc[j], gv[u][j]);
        }
      }
    }
  }
  if (cur >= 0) {  // none where every key of the window is empty (the last, past all slots)
    V* out = dp + (long long)cur * width + col0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (in[j]) out[j * lanes] = acc[j];
    }
  }
}

template <typename V, int P, int U>
void launch_consume_pu(const float* g, const int32_t* idx, const int* entries, const int* offsets,
                       const int2* first, float* dp, int windows, int keys, int width, int n,
                       int mk, int lanes_log2, dim3 grid, int threads, cudaStream_t s) {
  group_gather_bwd_kernel<V, P, U><<<grid, threads, 0, s>>>(
      reinterpret_cast<const V*>(g), idx, entries, offsets, first, reinterpret_cast<V*>(dp),
      windows, keys, width, n, mk, lanes_log2);
}

// (elements a lane takes, rows a round): the pairs the plan uses
// (ops/cuda/group_gather.py:AHEAD), in floats and in float4s (fewer rows a
// round: a float4 is four registers).
#define PSA_CONSUME(V, P, U)                                                                 \
  if (per_lane == P && ahead == U) {                                                         \
    launch_consume_pu<V, P, U>(g, idx, entries, offsets, first, dp, windows, keys, width,     \
                               n, mk, lanes_log2, grid, threads, s);                         \
    return true;                                                                             \
  }

bool launch_consume(bool vector, int per_lane, int ahead, const float* g, const int32_t* idx,
                    const int* entries, const int* offsets, const int2* first, float* dp,
                    int windows, int keys, int width, int n, int mk, int lanes_log2, dim3 grid,
                    int threads, cudaStream_t s) {
  if (vector) {
    PSA_CONSUME(float4, 1, 8)
    PSA_CONSUME(float4, 2, 4)
    PSA_CONSUME(float4, 3, 2)
    PSA_CONSUME(float4, 4, 2)
  } else {
    PSA_CONSUME(float, 1, 8)
    PSA_CONSUME(float, 2, 8)
    PSA_CONSUME(float, 3, 8)
    PSA_CONSUME(float, 4, 8)
    PSA_CONSUME(float, 5, 8)
  }
  return false;
}
#undef PSA_CONSUME

int log2_of(int lanes) {
  for (int l = 0; l <= 5; ++l) {
    if ((1 << l) == lanes) return l;
  }
  return -1;
}

}  // namespace

// The CSR alone: offsets (B*N + 1) and entries (BMK, global slot E,
// ascending within each key), from idx (B, M, K) with values in [0, N).
extern "C" int psa_group_gather_csr(const int32_t* idx, int* offsets, int* entries, int* hist,
                                    int b, int n, int m, int k, int fused, int steps, int warps,
                                    int smem_bytes, void* stream) {
  if (m < 1 || k < 1 || (long long)b * m * k >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return (int)csr::build(idx, nullptr, offsets, entries, hist, b, m * k, n, fused, steps, warps,
                         smem_bytes, (cudaStream_t)stream);
}

// The whole backward: the CSR and its windows into the caller's scratch
// (offsets, entries, histograms, and first_key: (first key, its offset) of
// each window and the end, 8-byte aligned), then the consuming pass.  Its
// plan: vector (float4 accesses), lanes per group, elements a lane takes
// in a column block (1-5), entries whose g rows a lane loads at once, column
// blocks, threads per block, places per window; its grid covers the windows,
// then the zero groups.
extern "C" int psa_group_gather_bwd(const float* g, const int32_t* idx, float* dp, int* offsets,
                                    int* entries, int* hist, int* first_key, int b, int n, int c,
                                    int m, int k, int fused, int steps, int warps,
                                    int smem_bytes, int vector, int lanes, int per_lane,
                                    int ahead, int col_blocks, int threads, int window,
                                    void* stream) {
  const int lanes_log2 = log2_of(lanes);
  const int width = vector ? c / 4 : c;
  const long long slots = (long long)b * m * k;
  if (c < 1 || n < 1 || m < 1 || k < 1 || window < 1 || lanes_log2 < 0 || threads < 32 ||
      threads % 32 || threads > kMaxThreads || threads < lanes || col_blocks < 1 ||
      col_blocks > kMaxColBlocks || (long long)col_blocks * lanes * per_lane < width ||
      slots >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (vector && (c % 4 || (uintptr_t)g % 16 || (uintptr_t)dp % 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int windows = (int)((slots + window - 1) / window);
  const long long keys = (long long)b * n;
  const long long groups = windows + (keys + kZeroKeys - 1) / kZeroKeys;  // windows, then zeros
  const long long per_block = threads / lanes;
  const long long blocks = (groups + per_block - 1) / per_block;
  if (keys >= (1LL << 31) || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)first_key % 8) return (int)cudaErrorInvalidValue;
  const int2* first = reinterpret_cast<const int2*>(first_key);
  csr::Windows win;
  win.first = reinterpret_cast<int2*>(first_key);
  win.size = window;
  win.count = windows;
  cudaError_t err = csr::build(idx, nullptr, offsets, entries, hist, b, m * k, n, fused, steps,
                               warps, smem_bytes, s, win);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, col_blocks);
  if (!launch_consume(vector, per_lane, ahead, g, idx, entries, offsets, first, dp, windows,
                      (int)keys, width, n, m * k, lanes_log2, grid, threads, s)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
