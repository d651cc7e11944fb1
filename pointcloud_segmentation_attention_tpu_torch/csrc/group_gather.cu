// Neighbourhood gather: out[b, m, s, :] = points[b, idx[b, m, s], :].
//
// Replaces: pointcloud_segmentation_attention_tpu/ops/pallas/group_gather_kernel.py
//   group_gather -> _group_gather_fwd_impl (body _group_gather_kernel).
//
// Bound on this card: bytes.  The output (B, M, nsample, C) f32 dominates;
// at SA1 (B16, M1024, ns32, C9) the call must move about 26 MB, 7.7 us at
// 3.35 TB/s.
//
// Design: P warps per (b, m) centre: one where there are centres enough
// to fill the card (4096 warps: SA1, SA2), else up to one per 1024 floats
// of a 32-slot run, at most 8 (4 at SA3, 8 at SA4).  Lane s loads idx[b, m, s] once and keeps it in a
// register (32 slots at a time, looping when nsample > 32).  The centre's
// output is one contiguous run of nsample*C floats, written with 16-byte
// float4 stores (warp p of P takes every P-th group of 32), plus a scalar
// head and tail where the run does not start or end on 16 bytes.  Each
// store's four source floats are loaded with the row index fetched from
// its lane by __shfl_sync; slot and
// channel advance by counters (one 32-bit divide per lane and 32-slot run),
// never by a divide per element.  The TPU kernel copied only the cnt
// distinct rows of a group and broadcast the rest to save per-row DMA cost;
// here every slot is one plain load, right for any idx, and given
// ball-query output the result is identical.  A pure copy: bit-identical to
// the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRunPerWarp = 1024;   // floats of a 32-slot run one warp takes at least
constexpr long long kFillWarps = 4096;  // warps that keep all 132 SMs busy
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarps * 32)
group_gather_kernel(const float* __restrict__ points, const int32_t* __restrict__ idx,
                    float* __restrict__ out, int centres, int m, int n, int c, int nsample,
                    int parts, int step_slots, int step_chans) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int centre = warp / parts;
  const int part = warp - centre * parts;
  if (centre >= centres) return;  // whole warps only
  const float* src = points + (size_t)(centre / m) * n * c;
  const int32_t* gi = idx + (size_t)centre * nsample;
  float* run = out + (size_t)centre * nsample * c;

  for (int s0 = 0; s0 < nsample; s0 += 32) {
    const int cnt = min(32, nsample - s0);
    const int row = lane < cnt ? __ldg(gi + s0 + lane) : 0;
    float* dst = run + (size_t)s0 * c;
    const int len = cnt * c;
    const int misalign = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    const int head = min((4 - misalign) & 3, len);
    const int nvec = (len - head) >> 2;
    const int tail = head + 4 * nvec;

    // Head and tail: at most 3 + 3 floats, one lane each of part 0.
    if (part == 0) {
      const bool act = lane < head + (len - tail);
      const int e = lane < head ? lane : tail + (lane - head);
      const int s = act ? e / c : 0;
      const int r = __shfl_sync(kFull, row, s);
      if (act) dst[e] = __ldg(src + (size_t)r * c + (e - s * c));
    }

    // Body: lane l of part p stores float4 32p + l, then 32 P further on;
    // every lane runs the same number of iterations so the shuffles see
    // the whole warp.
    float4* body = reinterpret_cast<float4*>(dst + head);
    const int first = 32 * part + lane;
    int s = (head + 4 * first) / c;
    int ch = head + 4 * first - s * c;
    for (int v = first; v - lane < nvec; v += 32 * parts) {
      const bool act = v < nvec;
      float val[4];
      int ss = s, cc = ch;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = __shfl_sync(kFull, row, ss & 31);
        val[t] = act ? __ldg(src + (size_t)r * c + cc) : 0.f;
        if (++cc == c) {
          cc = 0;
          ++ss;
        }
      }
      if (act) body[v] = make_float4(val[0], val[1], val[2], val[3]);
      // Advance 128 P floats: step_slots = 128 P / c, step_chans = 128 P % c.
      s += step_slots;
      ch += step_chans;
      if (ch >= c) {
        ch -= c;
        ++s;
      }
    }
  }
}

}  // namespace

extern "C" int psa_group_gather(const float* points, const int32_t* idx, float* out, int b,
                                int n, int c, int m, int nsample, void* stream) {
  const long long centres = (long long)b * m;
  if (c < 1 || nsample < 1 || centres < 1) return (int)cudaErrorInvalidValue;
  const long long run = (long long)(nsample < 32 ? nsample : 32) * c;
  long long parts = (run + kRunPerWarp - 1) / kRunPerWarp;
  const long long fill = (kFillWarps + centres - 1) / centres;
  parts = parts < fill ? parts : fill;
  parts = parts < 8 ? parts : 8;
  if (centres * parts > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long blocks = (centres * parts + kWarps - 1) / kWarps;
  group_gather_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      points, idx, out, (int)centres, m, n, c, nsample, (int)parts, (int)(128 * parts / c),
      (int)(128 * parts % c));
  return (int)cudaGetLastError();
}
