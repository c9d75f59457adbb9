// K6: nearest ray-triangle hit per ray (Moller-Trumbore), for Hopper (sm_90a).
//
// Replaces gen3c_tpu/ops/raycast.py::ray_triangle_depth (:97-140), the XLA
// stand-in of the reference's Warp kernel (ray_triangle_intersection_warp.py,
// which keeps the minimum with atomic_min). Foreground masking renders the
// boundary mesh of each (target frame, buffer) pair with it: rays from the
// camera centre through every pixel (R = 901,120 at 704x1280) against the
// mesh's triangles (T up to ~112k, data-dependent).
//
// Per ray: the smallest t > 1e-8 over the triangles it hits, 0.0 if none.
// A hit is |a| >= 1e-8, u >= 0, u <= 1, v >= 0, u + v <= 1 and t > 1e-8,
// with the JAX formula (origins at 0):
//   h = cross(d, e2), a = dot(e1, h), f = 1 / a, u = f dot(s, h),
//   q = cross(s, e1), v = f dot(d, q), t = f dot(e2, q)
// where e1 = v1 - v0, e2 = v2 - v0, s = -v0. The ray-independent s, q and
// dot(e2, q) come precomputed per triangle (13 floats: e1, e2, s, q,
// dot(e2, q); ``reference.ray_triangle_setup``, the same torch code the
// plain version runs). Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction) in the plain
// version's order, and 1 / a is the correctly rounded reciprocal, so a ray
// grazing an edge takes the same u >= 0 / u + v <= 1 decision in both.
//
// Design: one thread per ray, its running minimum in a register (no
// atomics: each thread owns its ray); each CTA stages tiles of 512
// triangles (26 KB) in shared memory, read as broadcasts.
//
// What bounds it: R x T pairs of ~36 fp32 operations (29 arithmetic, 7
// comparisons) against 16 bytes per ray and 52 per triangle moved, so the
// fp32 rate bounds it (at R = 901,120, T = 20,000: 9.7 ms at 67 TF/s).
// This first version issues one MUFU-plus-Newton reciprocal per pair and
// tests every pair; culling triangles per tile of rays is left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // rays per CTA
constexpr int kTile = 512;      // triangles per shared-memory tile
constexpr int kTriFloats = 13;  // e1, e2, s, q, dot(e2, q)
constexpr float kEps = 1e-8f;
constexpr float kMiss = 1e10f;  // the JAX version's no-hit value before the final select

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kThreads)
    ray_triangle_depth_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                              int R, int T, float* __restrict__ out) {
  __shared__ float sTri[kTile * kTriFloats];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float dx = 0.f, dy = 0.f, dz = 0.f;
  if (r < R) {
    dx = rays[3LL * r];
    dy = rays[3LL * r + 1];
    dz = rays[3LL * r + 2];
  }
  float best = kMiss;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();  // the previous tile fully read
    const float* src = tris + static_cast<long long>(t0) * kTriFloats;
    for (int i = threadIdx.x; i < n * kTriFloats; i += kThreads) sTri[i] = src[i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* tr = sTri + j * kTriFloats;
      const float e1x = tr[0], e1y = tr[1], e1z = tr[2];
      const float e2x = tr[3], e2y = tr[4], e2z = tr[5];
      // h = cross(d, e2)
      const float hx = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
      const float hy = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
      const float hz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
      const float a = dot3(e1x, e1y, e1z, hx, hy, hz);
      const bool parallel = fabsf(a) < kEps;
      const float f = __frcp_rn(parallel ? 1.f : a);
      const float u = __fmul_rn(f, dot3(tr[6], tr[7], tr[8], hx, hy, hz));
      const float v = __fmul_rn(f, dot3(dx, dy, dz, tr[9], tr[10], tr[11]));
      const float t = __fmul_rn(f, tr[12]);
      const bool hit = !parallel && u >= 0.f && u <= 1.f && v >= 0.f &&
                       __fadd_rn(u, v) <= 1.f && t > kEps;
      if (hit && t < best) best = t;
    }
  }
  if (r < R) out[r] = best < kMiss ? best : 0.f;
}

}  // namespace

// rays: (R, 3) fp32 unit directions from the camera centre; tris: (T, 13)
// fp32 rows (e1, e2, s, q, dot(e2, q)); out: (R,) fp32. R > 0 and T > 0 (the
// wrapper answers T == 0 with zeros and launches nothing). Returns a
// cudaError_t (0 on success).
extern "C" int gen3c_ray_triangle_depth(const float* rays, const float* tris, int R, int T,
                                        float* out, void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (R + kThreads - 1) / kThreads;
  ray_triangle_depth_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, tris, R, T, out);
  return static_cast<int>(cudaGetLastError());
}
