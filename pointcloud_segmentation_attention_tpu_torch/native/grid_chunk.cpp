// Grid-cell assignment of the full-scene chunker: the port's own copy of
// the JAX package's native_ops.cpp:grid_chunk_assign, built with g++ at
// first use (native/__init__.py).  All arithmetic is float32:
// x = p - min, then floor((x -+ margin) / cell) per axis.
#include <cmath>
#include <cstdint>

extern "C" {

// Every (cell, point) pair where the point's +-margin box overlaps the
// cell, point-major, then cell x, then cell y.  Writes at most ``capacity``
// pairs to ``pairs`` ((capacity, 2) int64 [cell_id, point_id]) and returns
// the number of pairs there are.
int64_t psa_grid_chunk_assign(int64_t n, const float* points,
                              float min_x, float min_y, int ncell_x, int ncell_y,
                              float cell, float margin,
                              int64_t capacity, int64_t* pairs) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    float x = points[i * 3] - min_x;
    float y = points[i * 3 + 1] - min_y;
    int cx_lo = (int)std::floor((x - margin) / cell);
    int cx_hi = (int)std::floor((x + margin) / cell);
    int cy_lo = (int)std::floor((y - margin) / cell);
    int cy_hi = (int)std::floor((y + margin) / cell);
    for (int cx = cx_lo; cx <= cx_hi; ++cx) {
      if (cx < 0 || cx >= ncell_x) continue;
      for (int cy = cy_lo; cy <= cy_hi; ++cy) {
        if (cy < 0 || cy >= ncell_y) continue;
        if (w < capacity) {
          pairs[w * 2] = (int64_t)cx * ncell_y + cy;
          pairs[w * 2 + 1] = i;
        }
        ++w;
      }
    }
  }
  return w;
}

}  // extern "C"
