// Z-buffered ball-splat point renderer: the port's own copy of the JAX
// package's native_ops.cpp:render_ball (the capability of the reference's
// pointnet2_tensorflow/utils/render_balls_so.cpp), built with g++ at first
// use into the same library as grid_chunk.cpp (native/__init__.py).
// native.render_ball_numpy is its plain version, equal byte for byte.
#include <cmath>

extern "C" {

// points: (n,3) float (already projected to screen space: x,y in pixels,
// z depth), colors: (n,3) uint8, image: (h,w,3) uint8 (pre-filled with
// background), zbuf: (h,w) float workspace (caller passes +inf-filled).
// radius: splat radius in pixels.  Points are drawn in order; a pixel
// takes a point's color when its bumped depth is strictly nearer, so the
// earlier point wins a tie.
void psa_render_ball(int h, int w, unsigned char* image, float* zbuf,
                     int n, const float* points, const unsigned char* colors,
                     int radius) {
  for (int i = 0; i < n; ++i) {
    float x = points[i * 3 + 0];
    float y = points[i * 3 + 1];
    float z = points[i * 3 + 2];
    int xi = (int)std::lround(x);
    int yi = (int)std::lround(y);
    for (int dy = -radius; dy <= radius; ++dy) {
      for (int dx = -radius; dx <= radius; ++dx) {
        if (dx * dx + dy * dy > radius * radius) continue;
        int px = xi + dx, py = yi + dy;
        if (px < 0 || px >= w || py < 0 || py >= h) continue;
        // Spherical bump so overlapping balls intersect like spheres.
        float dz = std::sqrt((float)(radius * radius - dx * dx - dy * dy));
        float zz = z - dz;
        int idx = py * w + px;
        if (zz < zbuf[idx]) {
          zbuf[idx] = zz;
          image[idx * 3 + 0] = colors[i * 3 + 0];
          image[idx * 3 + 1] = colors[i * 3 + 1];
          image[idx * 3 + 2] = colors[i * 3 + 2];
        }
      }
    }
  }
}

}  // extern "C"
