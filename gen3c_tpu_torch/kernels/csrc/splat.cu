// Bilinear forward splatting with log-depth soft z-weights (Hopper, sm_90a).
//
// Replaces the TPU stand-in for the scatter-add of
// gen3c_tpu/ops/geometry.py::bilinear_splatting (:205-316): on the TPU the
// accumulation is a sort + segmented sum (_sorted_segment_accumulate,
// :172-202) because XLA's scatter-add serialises there. On the card it is
// what the reference did on CUDA: one thread per (batch, source pixel)
// adding (value * w, w) into the four bilinear corners of an (h+2) x (w+2)
// padded grid with fp32 atomicAdd.
//
// Per source pixel (geometry.py line numbers):
//   corners  floor/ceil of (flow + grid + 1), clamped to the padded grid
//            (:240-247; NaN clamps to 0 as XLA's saturating float->int does)
//   weights  the four proximity weights (:251-254) times
//            mask * flow_mask / (exp(min(log1p(max(d,0)) /
//                                     (max_logd + 1e-7) * scale, 80)) + 1e-7)
//            (:256-263). max_logd is the log-depth maximum of the splat
//            group this batch entry belongs to, computed by the caller.
// Normalisation, nan_to_num and the crop (:306-315) stay in PyTorch.
//
// What bounds it: ~4 * (C + 1) atomics and ~(C + 4) * 4 bytes of reads per
// source pixel; the atomics into L2 are the bound. Neighbouring threads
// write neighbouring target pixels for smooth flows, so contention is low.
// The order of the fp32 sums changes from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void splat_fwd(const float* __restrict__ frame,
                          const float* __restrict__ mask,
                          const float* __restrict__ depth,
                          const float* __restrict__ flow,
                          const float* __restrict__ flow_mask,
                          const float* __restrict__ max_logd,
                          float* __restrict__ acc, int B, int C, int H, int W,
                          float depth_weight_scale) {
  const long long hw = static_cast<long long>(H) * W;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * hw) return;
  const int b = static_cast<int>(i / hw);
  const long long pix = i - b * hw;
  const int y = static_cast<int>(pix / W);
  const int x = static_cast<int>(pix - static_cast<long long>(y) * W);

  // trans_pos = flow12 + grid, then + 1 (two roundings, as geometry.py)
  const float tx = flow[(2LL * b) * hw + pix] + static_cast<float>(x);
  const float ty = flow[(2LL * b + 1) * hw + pix] + static_cast<float>(y);
  const float ox = tx + 1.0f;
  const float oy = ty + 1.0f;
  const float wmax = static_cast<float>(W + 1);
  const float hmax = static_cast<float>(H + 1);
  // fmaxf(NaN, 0) = 0
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

  const float log_d = log1pf(fmaxf(depth[b * hw + pix], 0.f));
  const float expo =
      __fmul_rn(__fdiv_rn(log_d, max_logd[b] + 1e-7f), depth_weight_scale);
  const float dw = expf(fminf(expo, 80.f)) + 1e-7f;
  const float m = __fmul_rn(mask ? mask[b * hw + pix] : 1.f,
                            flow_mask ? flow_mask[b * hw + pix] : 1.f);
  const float base = __fdiv_rn(m, dw);

  const int W2 = W + 2;
  const int ix0 = static_cast<int>(fl_x), iy0 = static_cast<int>(fl_y);
  const int ix1 = static_cast<int>(ce_x), iy1 = static_cast<int>(ce_y);
  const long long npix = static_cast<long long>(H + 2) * W2;
  float* acc_b = acc + static_cast<long long>(b) * npix * (C + 1);
  const int idx[4] = {iy0 * W2 + ix0, iy1 * W2 + ix0, iy0 * W2 + ix1,
                      iy1 * W2 + ix1};
  const float wts[4] = {__fmul_rn(prox_nw, base), __fmul_rn(prox_sw, base),
                        __fmul_rn(prox_ne, base), __fmul_rn(prox_se, base)};
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    float* dst = acc_b + static_cast<long long>(idx[corner]) * (C + 1);
    const float w = wts[corner];
    for (int c = 0; c < C; ++c) {
      atomicAdd(dst + c, __fmul_rn(frame[(static_cast<long long>(b) * C + c) * hw + pix], w));
    }
    atomicAdd(dst + C, w);
  }
}

}  // namespace

// frame (B, C, H, W), mask/depth/flow_mask (B, 1, H, W), flow (B, 2, H, W),
// max_logd (B,), acc (B, (H+2)*(W+2), C+1) zero-initialised; all fp32,
// contiguous. mask and flow_mask may be null (ones). Returns a cudaError_t.
extern "C" int gen3c_splat(const void* frame, const void* mask,
                           const void* depth, const void* flow,
                           const void* flow_mask, const void* max_logd,
                           void* acc, int B, int C, int H, int W,
                           float depth_weight_scale, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(B) * H * W;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  splat_fwd<<<static_cast<unsigned int>(blocks), threads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frame), static_cast<const float*>(mask),
      static_cast<const float*>(depth), static_cast<const float*>(flow),
      static_cast<const float*>(flow_mask), static_cast<const float*>(max_logd),
      static_cast<float*>(acc), B, C, H, W, depth_weight_scale);
  return static_cast<int>(cudaGetLastError());
}
