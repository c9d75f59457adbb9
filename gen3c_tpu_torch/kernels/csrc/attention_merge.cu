// K1merge: the merge step of ring attention for Hopper (sm_90a).
//
// Replaces the online-softmax state update of gen3c_tpu/models/dit.py
// ::_ring_attention (:614-625, with the all-masked-row gate of :617-619),
// an XLA stand-in on the TPU. Each ring step folds one KV shard into the
// queries with K1ring (attention_bwd.cu, gen3c_attention_ring_fold), which
// gives that shard's normalised output O_s and row logsumexp lse_s; this
// kernel combines them into the running fp32 result, in place:
//   m   = max(lse, lse_s)
//   w   = exp(lse - m),  w_s = exp(lse_s - m)
//   O   = (O * w + O_s * w_s) / (w + w_s)
//   lse = m + log(w + w_s)
// A row with lse_s = -inf (no visible key in that shard) contributes
// nothing; a row with both -inf stays O = 0, lse = -inf (no NaN). The
// running state starts at O = 0, lse = -inf. The last step writes the
// result in the output dtype instead of updating the state, and a call
// without a step (the last ring step skipped under the band) only writes.
//
// Layout: O and O_s (B, L, H, D) contiguous, lse and lse_s (B, H, L) fp32;
// O_s bf16 or fp32, the final output bf16 or fp32. One warp per (b, l, h)
// row, lanes over D.
//
// What bounds it: ~10 bytes moved per element (fp32 O read and written, O_s
// read) against ~6 flops, far below the card's flop:byte ridge, so HBM
// bandwidth; the kernel reads and writes each element once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename TS, typename TO>
__global__ void __launch_bounds__(kWarps * 32)
    attn_merge(float* acc, float* acc_lse, const TS* step, const float* step_lse, TO* final_out,
               int B, int L, int H, int D) {
  const long long rows = static_cast<long long>(B) * L * H;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int h = static_cast<int>(r % H);
  const long long bl = r / H;  // b * L + l
  const int l = static_cast<int>(bl % L);
  const int b = static_cast<int>(bl / L);
  const long long li = (static_cast<long long>(b) * H + h) * L + l;
  const float la = acc_lse[li];
  const float ls = step != nullptr ? step_lse[li] : -INFINITY;
  const float m = fmaxf(la, ls);
  float wa = 0.f, ws = 0.f;
  if (m != -INFINITY) {
    wa = expf(la - m);  // exp(-inf) = 0
    ws = expf(ls - m);
  }
  const float sum = wa + ws;
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  float* a = acc + r * D;
  const TS* s = step != nullptr ? step + r * D : nullptr;
  for (int d = lane; d < D; d += 32) {
    const float sv = s != nullptr ? to_f32(s[d]) : 0.f;
    const float val = (a[d] * wa + sv * ws) * inv;
    if (final_out != nullptr) {
      store(final_out + r * D + d, val);
    } else {
      a[d] = val;
    }
  }
  if (final_out == nullptr && lane == 0) acc_lse[li] = sum > 0.f ? m + logf(sum) : -INFINITY;
}

template <typename TS, typename TO>
cudaError_t launch(float* acc, float* acc_lse, const void* step, const float* step_lse,
                   void* final_out, int B, int L, int H, int D, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * L * H;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_merge<TS, TO><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      acc, acc_lse, static_cast<const TS*>(step), step_lse, static_cast<TO*>(final_out), B, L,
      H, D);
  return cudaGetLastError();
}

}  // namespace

// acc (B, L, H, D) and acc_lse (B, H, L): the running fp32 state, updated in
// place unless final_out is given. step / step_lse: one K1ring step's output
// (bf16 if step_bf16, else fp32) and lse, or both null (nothing to fold: only
// write the result). final_out: null, or the result (B, L, H, D) in bf16 if
// final_bf16, else fp32. Returns a cudaError_t (0 on success).
extern "C" int gen3c_attention_merge(float* acc, float* acc_lse, const void* step,
                                     const float* step_lse, void* final_out, int B, int L, int H,
                                     int D, int step_bf16, int final_bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || (step == nullptr) != (step_lse == nullptr) ||
      (step == nullptr && final_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (step_bf16) {
    err = final_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(acc, acc_lse, step, step_lse,
                                                            final_out, B, L, H, D, s)
                     : launch<__nv_bfloat16, float>(acc, acc_lse, step, step_lse, final_out, B,
                                                    L, H, D, s);
  } else {
    err = final_bf16 ? launch<float, __nv_bfloat16>(acc, acc_lse, step, step_lse, final_out, B,
                                                    L, H, D, s)
                     : launch<float, float>(acc, acc_lse, step, step_lse, final_out, B, L, H, D,
                                            s);
  }
  return static_cast<int>(err);
}
