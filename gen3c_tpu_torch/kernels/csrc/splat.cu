// K5: bilinear forward splatting with log-depth soft z-weights (Hopper, sm_90a).
//
// Replaces the TPU stand-in for gen3c_tpu/ops/geometry.py::bilinear_splatting
// (:205-316): on the TPU the accumulation is a sort + segmented sum
// (_sorted_segment_accumulate, :172-202) because XLA's scatter-add
// serialises there. On the card it is what the reference did on CUDA: one
// thread per (batch, source pixel) adding (value * w, w) into the four
// bilinear corners of an (h+2) x (w+2) padded grid with fp32 atomics.
//
// One call, three kernels on the caller's stream (after a 4-byte-a-group
// memset):
//   prepare     zero the accumulator, and each group's log-depth maximum
//               max(log1p(max(d, 0))) by an integer atomicMax on the
//               float's bits: the values are >= +0 or NaN, so their bits
//               order as ints once -0 is made +0 and every NaN the largest
//               int (amax / jnp.max propagate NaN, so must this).
//   accumulate  per source pixel (geometry.py line numbers):
//     corners  floor/ceil of (flow + grid + 1), clamped to the padded grid
//              (:240-247; NaN clamps to 0 as XLA's saturating float->int does)
//     weights  the four proximity weights (:251-254) times
//              mask * flow_mask / (exp(min(log1p(max(d,0)) /
//                                       (max_logd + 1e-7) * scale, 80)) + 1e-7)
//              (:256-263), where max and min keep a NaN (torch.clamp,
//              jnp.maximum / jnp.minimum; fmaxf / fminf would drop it);
//     then (C values * w, w) into each corner: one 16-byte (C = 3) or
//     8-byte (C = 1) vector atomic a corner (sm_90's float4 / float2
//     atomicAdd; the accumulator's rows are C + 1 floats), scalar atomics
//     for other C. Where a lane's east corners land on the cells of the next
//     lane's west corners (a smooth flow: neighbouring pixels, neighbouring
//     targets), the next lane adds them into its rows through warp
//     shuffles and one atomic a cell goes out: about 2 a pixel, not 4. A
//     shared-memory accumulator per CTA, flushed cell by cell, measured
//     slower than these atomics and was not kept.
//   finish      normalise and crop (:306-315) straight into warped
//               (B, C, H, W) and mask (B, 1, H, W): weights =
//               nan_to_num(w, nan=1000) (+-inf to +-FLT_MAX), known =
//               weights > 0, warped / weights where known, else the fill
//               (-1 for an image, then clamped to [-1, 1], NaN kept; 0
//               otherwise).
// The C port uses C = 3 (frames) and C = 1 (forward_warp's depth).
//
// What bounds it: the bytes (frame, mask, depth, flow, outputs) and the
// accumulator's round trip through L2; the atomics (4 a pixel, about 2
// where the warp merges them) go to L2 as well. The order of the fp32
// sums changes from run to run.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPrepPixels = 4;     // depth pixels a thread of prepare reads
constexpr float kMaxExponent = 80.f;

// torch.clamp(x, min=0) and torch.clamp(x, max=hi): a NaN stays NaN
__device__ __forceinline__ float clamp_min0(float x) { return x != x ? x : fmaxf(x, 0.f); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x != x ? x : fminf(x, hi); }

__device__ __forceinline__ float log_depth(float d) { return log1pf(clamp_min0(d)); }

// bits of a log-depth (>= +-0 or NaN) that order as ints: -0 -> +0, NaN -> INT_MAX
__device__ __forceinline__ int order_bits(float v) {
  return v != v ? 0x7fffffff : __float_as_int(v + 0.f);
}

__device__ __forceinline__ int block_max(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kThreads / 32; ++w) v = max(v, red[w]);
  return v;
}

// grid (ceil(HW / (kThreads * kPrepPixels)), B)
__global__ void __launch_bounds__(kThreads)
    splat_prepare(const float* __restrict__ depth, float* __restrict__ acc, long long acc_n,
                  int* __restrict__ max_bits, int HW, int group) {
  __shared__ int sRed[kThreads / 32];
  const int b = blockIdx.y;
  const float* d = depth + static_cast<long long>(b) * HW;
  int m = 0;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < HW; i += stride) {
    m = max(m, order_bits(log_depth(d[i])));
  }
  m = block_max(m, sRed);
  if (threadIdx.x == 0) atomicMax(max_bits + b / group, m);

  // zero the accumulator: 16 bytes a thread a step over every CTA
  const long long cta = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const long long all = static_cast<long long>(gridDim.x) * gridDim.y * kThreads;
  const long long n4 = acc_n / 4;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (long long i = cta * kThreads + threadIdx.x; i < n4; i += all) {
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (long long i = 4 * n4 + cta * kThreads + threadIdx.x; i < acc_n; i += all) acc[i] = 0.f;
}

// one row of C + 1 floats (values then weight) added into dst
template <int kRow>
__device__ __forceinline__ void add_row(float* dst, const float* row) {
  if constexpr (kRow == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(row[0], row[1], row[2], row[3]));
  } else if constexpr (kRow == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(row[0], row[1]));
  } else {
#pragma unroll
    for (int c = 0; c < kRow; ++c) atomicAdd(dst + c, row[c]);
  }
}

// kRow = C + 1 for C = 1 and 3 (vector atomics, corners merged with the
// lane to the left); kRow = 0: any C, scalar atomics, nothing merged
template <int kRow>
__global__ void __launch_bounds__(kThreads)
    splat_accumulate(const float* __restrict__ frame, const float* __restrict__ mask,
                     const float* __restrict__ depth, const float* __restrict__ flow,
                     const float* __restrict__ flow_mask, const int* __restrict__ max_bits,
                     float* __restrict__ acc, int C, int H, int W, int group,
                     float depth_weight_scale, int* __restrict__ counts) {
  const int b = blockIdx.y;
  const long long hw = static_cast<long long>(H) * W;
  const long long pix = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = pix < hw;
  const int W2 = W + 2;
  const long long npix = static_cast<long long>(H + 2) * W2;
  const int row_n = kRow > 0 ? kRow : C + 1;
  float* acc_b = acc + static_cast<long long>(b) * npix * row_n;

  // corners NW (iy0, ix0), SW (iy1, ix0), NE (iy0, ix1), SE (iy1, ix1): cell and weight
  int cell[4] = {-1, -1, -1, -1};
  float wts[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    const int y = static_cast<int>(pix / W);
    const int x = static_cast<int>(pix - static_cast<long long>(y) * W);
    // trans_pos = flow12 + grid, then + 1 (two roundings, as geometry.py)
    const float tx = flow[(2LL * b) * hw + pix] + static_cast<float>(x);
    const float ty = flow[(2LL * b + 1) * hw + pix] + static_cast<float>(y);
    const float ox = tx + 1.0f;
    const float oy = ty + 1.0f;
    const float wmax = static_cast<float>(W + 1);
    const float hmax = static_cast<float>(H + 1);
    // nan_to_num(nan=0) then clamp: fmaxf(NaN, 0) = 0, and +-inf clamp to the edges
    const float off_x = fminf(fmaxf(ox, 0.f), wmax);
    const float off_y = fminf(fmaxf(oy, 0.f), hmax);
    const float fl_x = fminf(fmaxf(floorf(ox), 0.f), wmax);
    const float fl_y = fminf(fmaxf(floorf(oy), 0.f), hmax);
    const float ce_x = fminf(fmaxf(ceilf(ox), 0.f), wmax);
    const float ce_y = fminf(fmaxf(ceilf(oy), 0.f), hmax);

    const float prox_nw = __fmul_rn(1.f - (off_y - fl_y), 1.f - (off_x - fl_x));
    const float prox_sw = __fmul_rn(1.f - (ce_y - off_y), 1.f - (off_x - fl_x));
    const float prox_ne = __fmul_rn(1.f - (off_y - fl_y), 1.f - (ce_x - off_x));
    const float prox_se = __fmul_rn(1.f - (ce_y - off_y), 1.f - (ce_x - off_x));

    const float max_logd = __int_as_float(max_bits[b / group]);
    const float expo = __fmul_rn(__fdiv_rn(log_depth(depth[b * hw + pix]), max_logd + 1e-7f),
                                 depth_weight_scale);
    const float dw = expf(clamp_max(expo, kMaxExponent)) + 1e-7f;
    const float m = __fmul_rn(mask ? mask[b * hw + pix] : 1.f,
                              flow_mask ? flow_mask[b * hw + pix] : 1.f);
    const float base = __fdiv_rn(m, dw);
    const int ix0 = static_cast<int>(fl_x), iy0 = static_cast<int>(fl_y);
    const int ix1 = static_cast<int>(ce_x), iy1 = static_cast<int>(ce_y);
    cell[0] = iy0 * W2 + ix0;
    cell[1] = iy1 * W2 + ix0;
    cell[2] = iy0 * W2 + ix1;
    cell[3] = iy1 * W2 + ix1;
    wts[0] = __fmul_rn(prox_nw, base);
    wts[1] = __fmul_rn(prox_sw, base);
    wts[2] = __fmul_rn(prox_ne, base);
    wts[3] = __fmul_rn(prox_se, base);
  }
  const float* src = frame + static_cast<long long>(b) * C * hw + pix;

  if constexpr (kRow > 0) {
    float rows[4][kRow];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < kRow - 1; ++c) rows[k][c] = valid ? __fmul_rn(src[c * hw], wts[k]) : 0.f;
      rows[k][kRow - 1] = wts[k];
    }
    // A smooth flow sends this lane's east corners (NE, SE) to the cells of
    // the next lane's west corners (NW, SW). The next lane adds them into
    // its own rows and this lane skips their atomics: NE goes to NW if the
    // cells match, else to SW; SE to SW, else to NW. Each is taken once.
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int prev_ne = __shfl_up_sync(full, cell[2], 1);
    const int prev_se = __shfl_up_sync(full, cell[3], 1);
    const int next_nw = __shfl_down_sync(full, cell[0], 1);
    const int next_sw = __shfl_down_sync(full, cell[1], 1);
    const bool has_prev = lane > 0 && valid, has_next = lane < 31 && valid;
    // cells are >= 0 for a valid lane and -1 for the others
    const bool skip[4] = {false, false,
                          has_next && (next_nw == cell[2] || next_sw == cell[2]),
                          has_next && (next_sw == cell[3] || next_nw == cell[3])};
    const int ne_to = !has_prev ? -1 : prev_ne == cell[0] ? 0 : prev_ne == cell[1] ? 1 : -1;
    const int se_to = !has_prev ? -1 : prev_se == cell[1] ? 1 : prev_se == cell[0] ? 0 : -1;
#pragma unroll
    for (int c = 0; c < kRow; ++c) {
      const float ne = __shfl_up_sync(full, rows[2][c], 1);
      const float se = __shfl_up_sync(full, rows[3][c], 1);
      if (ne_to == 0) rows[0][c] += ne;
      if (ne_to == 1) rows[1][c] += ne;
      if (se_to == 1) rows[1][c] += se;
      if (se_to == 0) rows[0][c] += se;
    }
    if (counts) {  // corners added, corners merged into the next lane's
      int added = 0, merged = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        added += valid && !skip[k];
        merged += skip[k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        added += __shfl_xor_sync(full, added, o);
        merged += __shfl_xor_sync(full, merged, o);
      }
      if (lane == 0) {
        atomicAdd(counts, added);
        atomicAdd(counts + 1, merged);
      }
    }
    if (valid) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!skip[k]) add_row<kRow>(acc_b + static_cast<long long>(cell[k]) * kRow, rows[k]);
      }
    }
  } else if (valid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* dst = acc_b + static_cast<long long>(cell[k]) * row_n;
      for (int c = 0; c < C; ++c) atomicAdd(dst + c, __fmul_rn(src[c * hw], wts[k]));
      atomicAdd(dst + C, wts[k]);
    }
  }
}

// grid (ceil(HW / kThreads), B)
__global__ void __launch_bounds__(kThreads)
    splat_finish(const float* __restrict__ acc, float* __restrict__ out,
                 float* __restrict__ known_out, int C, int H, int W, int is_image) {
  const int b = blockIdx.y;
  const long long hw = static_cast<long long>(H) * W;
  const long long pix = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int y = static_cast<int>(pix / W);
  const int x = static_cast<int>(pix - static_cast<long long>(y) * W);
  const long long npix = static_cast<long long>(H + 2) * (W + 2);
  const float* row = acc + (static_cast<long long>(b) * npix +
                            static_cast<long long>(y + 1) * (W + 2) + x + 1) * (C + 1);
  float w = row[C];
  // nan_to_num(w, nan=1000.0): NaN -> 1000, +-inf -> +-FLT_MAX
  w = w != w ? 1000.f : (isinf(w) ? copysignf(FLT_MAX, w) : w);
  const bool known = w > 0.f;
  for (int c = 0; c < C; ++c) {
    float v = known ? __fdiv_rn(row[c], w) : (is_image ? -1.f : 0.f);
    if (is_image) v = v != v ? v : fminf(fmaxf(v, -1.f), 1.f);
    out[(static_cast<long long>(b) * C + c) * hw + pix] = v;
  }
  known_out[b * hw + pix] = known ? 1.f : 0.f;
}

}  // namespace

// frame (B, C, H, W), mask / depth / flow_mask (B, 1, H, W), flow (B, 2, H,
// W), all fp32 contiguous (mask and flow_mask may be null: ones); acc
// (B, (H+2)*(W+2), C+1) fp32 scratch, 16-byte aligned; max_bits (B / group)
// int32 scratch; out (B, C, H, W) and known (B, 1, H, W) fp32. group divides
// B. counts, if not null, gets the corners added by atomics and those merged
// added (2 int32). part_ms, if not null (host), gets the ms of prepare
// (with the memset), accumulate and finish, timed with events and waited
// for. Returns a cudaError_t.
extern "C" int gen3c_splat(const void* frame, const void* mask, const void* depth,
                           const void* flow, const void* flow_mask, void* acc, void* max_bits,
                           void* out, void* known, int B, int C, int H, int W, int group,
                           float depth_weight_scale, int is_image, void* counts,
                           float* part_ms, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || group <= 0 || B % group != 0 ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long hw = static_cast<long long>(H) * W;
  const long long blocks = (hw + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaEvent_t ev[4];
  if (part_ms) {
    for (auto& e : ev) {
      const cudaError_t rc = cudaEventCreate(&e);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    cudaEventRecord(ev[0], s);
  }
  cudaError_t rc = cudaMemsetAsync(max_bits, 0, sizeof(int) * (B / group), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long acc_n = static_cast<long long>(B) * (H + 2) * (W + 2) * (C + 1);
  const long long prep_x = (hw + kThreads * kPrepPixels - 1) / (kThreads * kPrepPixels);
  splat_prepare<<<dim3(static_cast<unsigned>(prep_x), B), kThreads, 0, s>>>(
      static_cast<const float*>(depth), static_cast<float*>(acc), acc_n,
      static_cast<int*>(max_bits), static_cast<int>(hw), group);
  if (part_ms) cudaEventRecord(ev[1], s);
  const dim3 grid(static_cast<unsigned>(blocks), B);
#define GEN3C_SPLAT_ACCUMULATE(ROW)                                                        \
  splat_accumulate<ROW><<<grid, kThreads, 0, s>>>(                                         \
      static_cast<const float*>(frame), static_cast<const float*>(mask),                   \
      static_cast<const float*>(depth), static_cast<const float*>(flow),                   \
      static_cast<const float*>(flow_mask), static_cast<const int*>(max_bits),             \
      static_cast<float*>(acc), C, H, W, group, depth_weight_scale,                        \
      static_cast<int*>(counts))
  if (C == 3) {
    GEN3C_SPLAT_ACCUMULATE(4);
  } else if (C == 1) {
    GEN3C_SPLAT_ACCUMULATE(2);
  } else {
    GEN3C_SPLAT_ACCUMULATE(0);
  }
#undef GEN3C_SPLAT_ACCUMULATE
  if (part_ms) cudaEventRecord(ev[2], s);
  splat_finish<<<grid, kThreads, 0, s>>>(static_cast<const float*>(acc),
                                         static_cast<float*>(out), static_cast<float*>(known),
                                         C, H, W, is_image);
  rc = cudaGetLastError();
  if (part_ms) {
    cudaEventRecord(ev[3], s);
    cudaEventSynchronize(ev[3]);
    for (int i = 0; i < 3; ++i) cudaEventElapsedTime(part_ms + i, ev[i], ev[i + 1]);
    for (auto& e : ev) cudaEventDestroy(e);
  }
  return static_cast<int>(rc);
}
