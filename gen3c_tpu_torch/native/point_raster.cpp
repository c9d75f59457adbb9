// Native point-cloud rasterizer for instant serving previews.
//
// Replaces the reference GUI's interactive point-cloud display
// (gui/src/testbed.cu:380-386 cache-rendering view; point rendering is
// GPU-side in the instant-ngp viewer) with a host-side z-buffered point
// splatter: the serving layer can render camera-path previews of the
// seeded 3D cache without touching the TPU (the TPU splat pipeline,
// ops/geometry.py, stays the fidelity-grade path used for diffusion
// conditioning).
//
// Pure C++17, no deps. Built on demand by point_raster.py (g++ -O2).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Mat34 {
  float m[12];  // row-major 3x4 (R | t)
};

inline void project_point(const Mat34& P, const float* K, const float* p,
                          float* u, float* v, float* z) {
  const float x = P.m[0] * p[0] + P.m[1] * p[1] + P.m[2] * p[2] + P.m[3];
  const float y = P.m[4] * p[0] + P.m[5] * p[1] + P.m[6] * p[2] + P.m[7];
  const float zz = P.m[8] * p[0] + P.m[9] * p[1] + P.m[10] * p[2] + P.m[11];
  *z = zz;
  if (zz <= 0.f) return;
  const float inv_z = 1.f / zz;
  *u = K[0] * x * inv_z + K[1] * y * inv_z + K[2];
  *v = K[3] * x * inv_z + K[4] * y * inv_z + K[5];
}

}  // namespace

extern "C" {

// Rasterize one frame.
//   points: (n, 3) float32 world-space
//   colors: (n, 3) uint8
//   w2c:    (4, 4) float32 row-major world-to-camera
//   K:      (3, 3) float32 row-major intrinsics (pixel units)
//   out_rgb: (h, w, 3) uint8 — cleared to `bg` then splatted
//   point_radius: splat half-size in pixels (0 => single pixel)
void point_raster_frame(const float* points, const uint8_t* colors,
                        int64_t n, const float* w2c, const float* K,
                        int h, int w, float point_radius, uint8_t bg,
                        float znear, uint8_t* out_rgb, float* depth_buf) {
  Mat34 P;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c) P.m[r * 4 + c] = w2c[r * 4 + c];

  std::memset(out_rgb, bg, static_cast<size_t>(h) * w * 3);
  std::fill(depth_buf, depth_buf + static_cast<size_t>(h) * w,
            std::numeric_limits<float>::infinity());

  const int rad = std::max(0, static_cast<int>(std::lround(point_radius)));
  for (int64_t i = 0; i < n; ++i) {
    float u = 0.f, v = 0.f, z = -1.f;
    project_point(P, K, points + i * 3, &u, &v, &z);
    if (z <= znear || !std::isfinite(u) || !std::isfinite(v)) continue;
    // bounds-check in float BEFORE the int cast: a huge projected
    // coordinate would make lround->int undefined behavior and could
    // wrap back into the frame with a tiny depth
    if (u < -rad - 1.f || u > static_cast<float>(w) + rad ||
        v < -rad - 1.f || v > static_cast<float>(h) + rad)
      continue;
    const int cu = static_cast<int>(std::lround(u));
    const int cv = static_cast<int>(std::lround(v));
    if (cu + rad < 0 || cu - rad >= w || cv + rad < 0 || cv - rad >= h)
      continue;
    const uint8_t* col = colors + i * 3;
    const int y0 = std::max(0, cv - rad), y1 = std::min(h - 1, cv + rad);
    const int x0 = std::max(0, cu - rad), x1 = std::min(w - 1, cu + rad);
    for (int y = y0; y <= y1; ++y) {
      float* drow = depth_buf + static_cast<size_t>(y) * w;
      uint8_t* crow = out_rgb + (static_cast<size_t>(y) * w) * 3;
      for (int x = x0; x <= x1; ++x) {
        if (z < drow[x]) {
          drow[x] = z;
          crow[x * 3 + 0] = col[0];
          crow[x * 3 + 1] = col[1];
          crow[x * 3 + 2] = col[2];
        }
      }
    }
  }
}

// Rasterize a whole camera path: w2cs (f,4,4), Ks (f,3,3),
// out_rgb (f,h,w,3). Reuses one depth buffer across frames.
void point_raster_path(const float* points, const uint8_t* colors,
                       int64_t n, const float* w2cs, const float* Ks,
                       int f, int h, int w, float point_radius, uint8_t bg,
                       float znear, uint8_t* out_rgb) {
  std::vector<float> depth(static_cast<size_t>(h) * w);
  const size_t frame_px = static_cast<size_t>(h) * w * 3;
  for (int i = 0; i < f; ++i) {
    point_raster_frame(points, colors, n, w2cs + i * 16, Ks + i * 9, h, w,
                       point_radius, bg, znear, out_rgb + i * frame_px,
                       depth.data());
  }
}

}  // extern "C"
