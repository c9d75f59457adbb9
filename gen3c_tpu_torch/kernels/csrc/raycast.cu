// K6: nearest ray-triangle hit per ray (Moller-Trumbore), for Hopper (sm_90a),
// with the triangles culled per tile of rays.
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
// dot(e2, q) are formed once per mesh (13 floats a triangle: e1, e2, s, q,
// dot(e2, q)) by ray_triangle_prepare, in the operations and order of
// ``reference.ray_triangle_setup``, which the plain version runs, so the
// rows are its bits. Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction) in the plain
// version's order, and 1 / a is the correctly rounded reciprocal, so a ray
// grazing an edge takes the same u >= 0 / u + v <= 1 decision in both.
//
// Culling. A boundary-mesh triangle covers a few hundred pixels at most,
// so nearly every (ray, triangle) pair misses. ray_triangle_prepare gives
// each triangle a rectangle of d_x/d_z, d_y/d_z that holds every ray able
// to pass its fp32 test (``reference.ray_triangle_bounds``, whose fp64
// operations it repeats one for one: the projected vertices widened by a
// bound on the test's rounding; the whole plane for a triangle it cannot
// bound), and each chunk of 32 consecutive triangles the union of theirs
// (``reference.ray_chunk_bounds``). A CTA of 256 consecutive rays (a
// 256 x 1 strip of a row-major image) takes the exact min / max of its rays' d_x/d_z, d_y/d_z (a ray with
// d_z <= 0 or a non-finite ratio makes the tile test every triangle), then
//   1. tests 256 chunk rectangles at a time, a thread each, and compacts
//      the overlapping chunks with warp ballots into shared memory;
//   2. a warp a surviving chunk, a lane a triangle: tests the triangle's
//      rectangle and stages the survivors' 13 floats in a shared list;
//   3. when the list holds more than 256 (and at the end), every thread
//      runs the exact test of its ray against the whole list, keeping its
//      minimum in a register (no atomics: each thread owns its ray).
// A culled pair is a certain miss and the minimum is exact, so the result
// is the all-pairs result bit for bit.
//
// What bounds it: the pairs that survive the culling, ~36 fp32 operations
// each (29 arithmetic, 7 comparisons), against 16 bytes per ray and 52 per
// triangle; at the smoke's mesh the survivors are ~3% of all pairs, and
// the ~1% of triangles that cannot be bounded (seen almost edge-on) are a
// third of them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // rays per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;               // triangles under one chunk rectangle
constexpr int kList = 2 * kThreads;      // staged triangles (26 KB)
constexpr int kTriFloats = 13;           // e1, e2, s, q, dot(e2, q)
constexpr float kEps = 1e-8f;
constexpr float kMiss = 1e10f;  // the JAX version's no-hit value before the final select
// reference.py's culling constants
constexpr double kRound = 5.9604644775390625e-08;  // 2^-24, the fp32 unit roundoff
constexpr double kTestErr = 16.0 * kRound;
constexpr double kMaxEta = 0.5;
constexpr double kMinCos = 0.17;
constexpr double kBoxRel = 1e-6;
constexpr double kBoxAbs = 1e-6;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// closed overlap of two (x_lo, y_lo, x_hi, y_hi) rectangles
__device__ __forceinline__ bool overlaps(float4 b, float4 tile) {
  return b.x <= tile.z && b.z >= tile.x && b.y <= tile.w && b.w >= tile.y;
}

// append `index` to list[*count] for the lanes whose `keep` holds (a whole warp calls)
__device__ __forceinline__ int warp_append(bool keep, int* count) {
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// the nearest hit of ray d over the n staged triangles, the plain version's arithmetic
__device__ __forceinline__ float nearest(const float* sTri, int n, float dx, float dy, float dz,
                                         float best) {
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
  return best;
}

// fp64 operations rounded one at a time (no contraction), as torch runs them
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double ddot(const double* a, const double* b) {
  return dadd(dadd(dmul(a[0], b[0]), dmul(a[1], b[1])), dmul(a[2], b[2]));
}
__device__ __forceinline__ void dcross(const double* a, const double* b, double* out) {
  out[0] = dsub(dmul(a[1], b[2]), dmul(a[2], b[1]));
  out[1] = dsub(dmul(a[2], b[0]), dmul(a[0], b[2]));
  out[2] = dsub(dmul(a[0], b[1]), dmul(a[1], b[0]));
}

// the culling rectangle of one triangle row (reference.ray_triangle_bounds)
__device__ float4 triangle_box(const float* row) {
  bool finite = true;
  for (int k = 0; k < kTriFloats; ++k) finite = finite && isfinite(row[k]);
  double e1[3], e2[3], p[3][3];
  for (int k = 0; k < 3; ++k) {
    e1[k] = row[k];
    e2[k] = row[3 + k];
    p[0][k] = -static_cast<double>(row[6 + k]);
  }
  for (int k = 0; k < 3; ++k) {
    p[1][k] = dadd(p[0][k], e1[k]);
    p[2][k] = dadd(p[0][k], e2[k]);
  }
  double c12[3];
  dcross(p[1], p[2], c12);
  const double det = fabs(ddot(p[0], c12));
  const double n_e1 = __dsqrt_rn(ddot(e1, e1)), n_e2 = __dsqrt_rn(ddot(e2, e2));
  const double n_s = __dsqrt_rn(ddot(p[0], p[0]));  // |s| = |-s|
  const double err_a = dmul(dmul(kTestErr, n_e1), n_e2);
  const double err_u = dmul(dmul(kTestErr, n_s), n_e2);
  const double err_v = dmul(dmul(kTestErr, n_s), n_e1);
  const double err_w = dadd(dadd(dadd(err_a, err_u), err_v), dmul(dmul(4.0 * kRound, n_e1), n_e2));
  const double err_t = dmul(dmul(dmul(kTestErr, n_e1), n_e2), n_s);
  double n_p[3];
  for (int j = 0; j < 3; ++j) n_p[j] = __dsqrt_rn(ddot(p[j], p[j]));
  const double eta = __ddiv_rn(
      dadd(dadd(dmul(err_w, n_p[0]), dmul(err_u, n_p[1])), dmul(err_v, n_p[2])), det);
  const double cos_polar = fmin(fmin(__ddiv_rn(p[0][2], n_p[0]), __ddiv_rn(p[1][2], n_p[1])),
                                __ddiv_rn(p[2][2], n_p[2]));
  const double cos_beta = __dsqrt_rn(dsub(1.0, dmul(eta, eta)));
  const double cos_far = dsub(dmul(cos_polar, cos_beta),
                              dmul(__dsqrt_rn(dsub(1.0, dmul(cos_polar, cos_polar))), eta));
  const double margin = __ddiv_rn(eta, dmul(dmul(cos_beta, cos_far), cos_far));
  const bool cullable = finite && p[0][2] > 0.0 && p[1][2] > 0.0 && p[2][2] > 0.0 &&
                        det > 2.0 * err_t && eta <= kMaxEta && cos_far >= kMinCos;
  if (!cullable) return make_float4(-INFINITY, -INFINITY, INFINITY, INFINITY);
  double lo[2], hi[2];
  for (int axis = 0; axis < 2; ++axis) {
    const double x0 = __ddiv_rn(p[0][axis], p[0][2]), x1 = __ddiv_rn(p[1][axis], p[1][2]);
    const double x2 = __ddiv_rn(p[2][axis], p[2][2]);
    const double l = dsub(fmin(fmin(x0, x1), x2), margin);
    const double h = dadd(fmax(fmax(x0, x1), x2), margin);
    lo[axis] = dsub(dsub(l, dmul(kBoxRel, fabs(l))), kBoxAbs);
    hi[axis] = dadd(dadd(h, dmul(kBoxRel, fabs(h))), kBoxAbs);
  }
  return make_float4(__double2float_rn(lo[0]), __double2float_rn(lo[1]),
                     __double2float_rn(hi[0]), __double2float_rn(hi[1]));
}

// per triangle its 13-float row and rectangle, per 32 its chunk's rectangle
__global__ void __launch_bounds__(kThreads)
    ray_triangle_prepare(const float* __restrict__ v0, const float* __restrict__ v1,
                         const float* __restrict__ v2, int T, float* __restrict__ tris,
                         float4* __restrict__ boxes, float4* __restrict__ chunks) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  float4 box = make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);  // the chunk's padding
  if (t < T) {
    float a[3], e1[3], e2[3], s[3], q[3];
    for (int k = 0; k < 3; ++k) {
      a[k] = v0[3 * t + k];
      e1[k] = __fsub_rn(v1[3 * t + k], a[k]);
      e2[k] = __fsub_rn(v2[3 * t + k], a[k]);
      s[k] = -a[k];
    }
    // q = cross(s, e1), each product and difference rounded (reference._cross)
    q[0] = __fsub_rn(__fmul_rn(s[1], e1[2]), __fmul_rn(s[2], e1[1]));
    q[1] = __fsub_rn(__fmul_rn(s[2], e1[0]), __fmul_rn(s[0], e1[2]));
    q[2] = __fsub_rn(__fmul_rn(s[0], e1[1]), __fmul_rn(s[1], e1[0]));
    const float row[kTriFloats] = {e1[0], e1[1], e1[2], e2[0], e2[1], e2[2], s[0], s[1], s[2],
                                   q[0], q[1], q[2], dot3(e2[0], e2[1], e2[2], q[0], q[1], q[2])};
    for (int k = 0; k < kTriFloats; ++k) tris[static_cast<long long>(t) * kTriFloats + k] = row[k];
    box = triangle_box(row);
    boxes[t] = box;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    box.x = fminf(box.x, __shfl_xor_sync(0xffffffffu, box.x, o));
    box.y = fminf(box.y, __shfl_xor_sync(0xffffffffu, box.y, o));
    box.z = fmaxf(box.z, __shfl_xor_sync(0xffffffffu, box.z, o));
    box.w = fmaxf(box.w, __shfl_xor_sync(0xffffffffu, box.w, o));
  }
  const int chunk = t / kChunk;
  if ((threadIdx.x & 31) == 0 && chunk * kChunk < T) chunks[chunk] = box;
}

__global__ void __launch_bounds__(kThreads)
    ray_triangle_depth_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                              const float4* __restrict__ boxes,
                              const float4* __restrict__ chunks, int R, int T,
                              float* __restrict__ out) {
  __shared__ float sTri[kList * kTriFloats];
  __shared__ int sChunk[kThreads];
  __shared__ float4 sBox[kWarps];
  __shared__ int sBad[kWarps];
  __shared__ int sNumChunks, sNumTris;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const long long r = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool valid = r < R;
  float dx = 0.f, dy = 0.f, dz = 0.f;
  if (valid) {
    dx = rays[3 * r];
    dy = rays[3 * r + 1];
    dz = rays[3 * r + 2];
  }

  // the tile's rectangle: exact min / max of its rays' d_x/d_z, d_y/d_z
  const float rx = __fdiv_rn(dx, dz), ry = __fdiv_rn(dy, dz);
  const bool good = dz > 0.f && isfinite(rx) && isfinite(ry);
  float4 box = valid && good ? make_float4(rx, ry, rx, ry)
                             : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  int bad = valid && !good;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    box.x = fminf(box.x, __shfl_xor_sync(0xffffffffu, box.x, o));
    box.y = fminf(box.y, __shfl_xor_sync(0xffffffffu, box.y, o));
    box.z = fmaxf(box.z, __shfl_xor_sync(0xffffffffu, box.z, o));
    box.w = fmaxf(box.w, __shfl_xor_sync(0xffffffffu, box.w, o));
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
  }
  if (lane == 0) {
    sBox[warp] = box;
    sBad[warp] = bad;
  }
  if (tid == 0) sNumChunks = sNumTris = 0;
  __syncthreads();
  float4 tile = sBox[0];
  bool cull = !sBad[0];
  for (int w = 1; w < kWarps; ++w) {
    tile.x = fminf(tile.x, sBox[w].x);
    tile.y = fminf(tile.y, sBox[w].y);
    tile.z = fmaxf(tile.z, sBox[w].z);
    tile.w = fmaxf(tile.w, sBox[w].w);
    cull = cull && !sBad[w];
  }

  float best = kMiss;
  const int num_chunks = (T + kChunk - 1) / kChunk;
  for (int c0 = 0; c0 < num_chunks; c0 += kThreads) {
    // 1. the chunks whose rectangle overlaps the tile
    const int c = c0 + tid;
    const bool keep_chunk = c < num_chunks && (!cull || overlaps(chunks[c], tile));
    const int chunk_slot = warp_append(keep_chunk, &sNumChunks);
    if (keep_chunk) sChunk[chunk_slot] = c;
    __syncthreads();
    const int nc = sNumChunks;
    for (int g = 0; g < nc; g += kWarps) {
      // 2. a warp a chunk: its triangles whose rectangle overlaps the tile
      if (g + warp < nc) {
        const int t = sChunk[g + warp] * kChunk + lane;
        const bool keep = t < T && (!cull || overlaps(boxes[t], tile));
        const int slot = warp_append(keep, &sNumTris);
        if (keep) {
          const float* src = tris + static_cast<long long>(t) * kTriFloats;
#pragma unroll
          for (int k = 0; k < kTriFloats; ++k) sTri[slot * kTriFloats + k] = src[k];
        }
      }
      __syncthreads();
      const int n = sNumTris;
      __syncthreads();  // every thread holds n before the next round appends
      if (n > kList - kThreads) {  // 3. room for one more round of 8 chunks only
        best = nearest(sTri, n, dx, dy, dz, best);
        __syncthreads();
        if (tid == 0) sNumTris = 0;
        __syncthreads();
      }
    }
    __syncthreads();  // every warp has read sChunk
    if (tid == 0) sNumChunks = 0;
    __syncthreads();
  }
  best = nearest(sTri, sNumTris, dx, dy, dz, best);
  if (valid) out[r] = best < kMiss ? best : 0.f;
}

}  // namespace

// v0 / v1 / v2: (T, 3) fp32; fills tris (T, 13) fp32, boxes (T, 4) and
// chunks (ceil(T / 32), 4) fp32, 16-byte aligned. T > 0. Returns a
// cudaError_t.
extern "C" int gen3c_ray_triangle_prepare(const float* v0, const float* v1, const float* v2,
                                          int T, float* tris, float* boxes, float* chunks,
                                          void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ray_triangle_prepare<<<(T + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      v0, v1, v2, T, tris, reinterpret_cast<float4*>(boxes), reinterpret_cast<float4*>(chunks));
  return static_cast<int>(cudaGetLastError());
}

// rays: (R, 3) fp32 unit directions from the camera centre; tris: (T, 13)
// fp32 rows (e1, e2, s, q, dot(e2, q)); boxes: (T, 4) and chunks:
// (ceil(T / 32), 4) fp32 rectangles (x_lo, y_lo, x_hi, y_hi), 16-byte
// aligned; out: (R,) fp32. R > 0 and T > 0 (the wrapper answers T == 0
// with zeros and launches nothing). Returns a cudaError_t.
extern "C" int gen3c_ray_triangle_depth(const float* rays, const float* tris,
                                        const float* boxes, const float* chunks, int R, int T,
                                        float* out, void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((R + kThreads - 1LL) / kThreads);
  ray_triangle_depth_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, tris, reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(chunks), R, T, out);
  return static_cast<int>(cudaGetLastError());
}
