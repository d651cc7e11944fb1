// Host three-NN and ball query: the port's own copy of the JAX package's
// native_ops.cpp:three_nn_cpu and native_ops.cpp:ball_query_cpu (the
// capability of the reference's tf_interpolate.cpp and tf_grouping_g.cu),
// built with g++ at first use into the same library as grid_chunk.cpp
// (native/__init__.py).  They are host oracles: the port's plain versions
// are ops/geometry.py, its kernels csrc/ball_query.cu and csrc/three_nn.cu.
//
// The JAX package builds native_ops.cpp with -march=native, and on a host
// with FMA g++ contracts its squared distance (dx*dx + dy*dy) + dz*dz into
// fma(dz, dz, fma(dx, dx, dy*dy)).  This file writes those two fused
// multiply-adds out and is built with -ffp-contract=off, so it computes the
// same bits on every host.  In double (three-NN) dx*dx is exact, so the
// fused and the unfused sums are equal there; in float32 (ball query) they
// can differ in the last bit, which decides points on the radius.
#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// 3 nearest neighbours by squared L2 in double.  xyz1: (b,n,3) unknown,
// xyz2: (b,m,3) known.  dist: (b,n,3) float out, idx: (b,n,3) int32 out.
// A strict < keeps the lower index on a tie; with m < 3 the missing slots
// hold 1e40 (inf as float) and index 0.
void psa_three_nn_cpu(int b, int n, int m, const float* xyz1, const float* xyz2,
                      float* dist, int32_t* idx) {
  for (int bi = 0; bi < b; ++bi) {
    const float* p1 = xyz1 + (size_t)bi * n * 3;
    const float* p2 = xyz2 + (size_t)bi * m * 3;
    float* d = dist + (size_t)bi * n * 3;
    int32_t* id = idx + (size_t)bi * n * 3;
    for (int i = 0; i < n; ++i) {
      double x1 = p1[i * 3], y1 = p1[i * 3 + 1], z1 = p1[i * 3 + 2];
      double best1 = 1e40, best2 = 1e40, best3 = 1e40;
      int besti1 = 0, besti2 = 0, besti3 = 0;
      for (int j = 0; j < m; ++j) {
        double dx = p2[j * 3] - x1, dy = p2[j * 3 + 1] - y1, dz = p2[j * 3 + 2] - z1;
        double dd = std::fma(dz, dz, std::fma(dx, dx, dy * dy));
        if (dd < best1) {
          best3 = best2; besti3 = besti2;
          best2 = best1; besti2 = besti1;
          best1 = dd; besti1 = j;
        } else if (dd < best2) {
          best3 = best2; besti3 = besti2;
          best2 = dd; besti2 = j;
        } else if (dd < best3) {
          best3 = dd; besti3 = j;
        }
      }
      d[i * 3] = (float)best1; d[i * 3 + 1] = (float)best2; d[i * 3 + 2] = (float)best3;
      id[i * 3] = besti1; id[i * 3 + 1] = besti2; id[i * 3 + 2] = besti3;
    }
  }
}

// First-nsample-in-point-order ball query in float32: a point is in the
// ball when max(sqrt(d2), 1e-20) < radius.  Every slot holds the first hit
// before the hits are written in order, so the slots past the count repeat
// it; an empty ball gives index 0 in every slot.  cnt: hits, at most nsample.
void psa_ball_query_cpu(int b, int n, int m, float radius, int nsample,
                        const float* xyz, const float* centers,
                        int32_t* idx, int32_t* cnt) {
  for (int bi = 0; bi < b; ++bi) {
    const float* p = xyz + (size_t)bi * n * 3;
    const float* c = centers + (size_t)bi * m * 3;
    for (int j = 0; j < m; ++j) {
      int32_t* out = idx + ((size_t)bi * m + j) * nsample;
      int count = 0;
      float x2 = c[j * 3], y2 = c[j * 3 + 1], z2 = c[j * 3 + 2];
      for (int k = 0; k < n && count < nsample; ++k) {
        float dx = x2 - p[k * 3], dy = y2 - p[k * 3 + 1], dz = z2 - p[k * 3 + 2];
        float d = std::max(std::sqrt(std::fma(dz, dz, std::fma(dx, dx, dy * dy))), 1e-20f);
        if (d < radius) {
          if (count == 0)
            for (int l = 0; l < nsample; ++l) out[l] = k;
          out[count++] = k;
        }
      }
      if (count == 0) for (int l = 0; l < nsample; ++l) out[l] = 0;
      cnt[(size_t)bi * m + j] = count;
    }
  }
}

}  // extern "C"
