// K8bwd: the backward of K8's grouped-query attention, for Hopper (sm_90a).
//
// Replaces the gradient XLA's autodiff takes of the XLA stand-in
// gen3c_tpu/models/ar_transformer.py::_gqa_attention (:252-297), which
// jax.value_and_grad reaches from gen3c_tpu/training/ar_train.py:52 through
// ar_forward's causal self-attention (:404) and its cross-attention to the
// T5 context (:417). Hq query heads read Hkv key/value heads (rep = Hq / Hkv:
// query head h reads KV head h / rep), the logits scaled by 1/sqrt(d), key j
// visible to query i iff kv_start[b] <= j and (offset < 0 or j <= offset + i).
//
// With P = softmax(S) over the visible keys, S = q.k^T * scale, O = P.v and
// the fp32 row logsumexp lse of S from the forward (K8's training forward:
// attention_wgmma.cu's kGqa mode with lse for bf16, gqa_attention.cu's
// gqa_f32 with lse for fp32), the backward is FlashAttention-2's:
//   Delta_i = sum_d dO_id * O_id                                (gqa_bwd_delta)
//   P_ij    = exp(S_ij - lse_i) on the visible pairs, else 0
//   dS_ij   = P_ij * (dO_i . v_j - Delta_i)
//   dQ_i    = scale * sum_j dS_ij k_j                            (gqa_bwd_dq_f32)
//   dK_g    = scale * sum over the rep heads h of g of sum_i dS_ij q_i
//   dV_g    = sum over the rep heads h of g of sum_i P_ij dO_i    (gqa_bwd_dkdv_f32)
// dK and dV of a KV head are summed over its query heads inside the CTA that
// owns its rows: K and V are never repeated in memory, no atomics, the bits
// are the same at every call. A query row that sees no key (a left-pad
// query) has lse -inf and O = 0 from the forward: its P is 0 here, so it
// adds nothing to dK / dV and its dQ is 0 (the XLA form averages every key
// there; no later layer reads such a row).
//
// This file holds the fp32 bodies, on the CUDA cores, for ar_tiny: one warp
// per query (gqa_bwd_dq_f32) or per key (gqa_bwd_dkdv_f32), 32-wide tiles,
// every pair's visibility tested element by element and tiles no row sees
// not visited; and gqa_bwd_delta. K8bwd in bf16 is attention_wgmma.cu's
// backward pair in its kGqa mode (gen3c_gqa_attention_wgmma_bwd: TMA +
// wgmma, the same sums, a split dK/dV grid where the key axis is short).
//
// Layout: q, o, dO (B, Lq, Hq, d), k, v (B, Lk, Hkv, d), contiguous fp32
// (the wrapper makes them so), d <= 128; lse and Delta (B, Hq, Lq) fp32;
// dq, dk, dv like q, k, v.
//
// What bounds it: ar_tiny's shape (255 tokens, 4 / 2 heads, d 32) is 42 Mflop
// against 0.8 MB; either bound is under a microsecond, so a call costs its
// launches and the loads of each tile: the fp32 bodies are the simple
// form that serves it (faster than SDPA's backward there, PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;           // (B, Hq, Lq), natural log; -inf: the row sees no key
  float* delta;               // (B, Hq, Lq)
  void* dq;
  void* dk;
  void* dv;
  const long long* kv_start;  // (B,) or null
  int B, Lq, Lk, Hq, Hkv, D, rep;
  int offset;                 // < 0: no causal mask
  float scale;
};

// The first key row b sees.
__device__ __forceinline__ int first_key(const Params& p, int b) {
  if (p.kv_start == nullptr) return 0;
  return static_cast<int>(min(max(p.kv_start[b], 0LL), static_cast<long long>(p.Lk)));
}

// Key j visible to query i, given the row's first key lo.
__device__ __forceinline__ bool visible(const Params& p, int lo, int i, int j) {
  return j >= lo && j < p.Lk && (p.offset < 0 || j <= p.offset + i);
}

// Element offsets of row `row` of head h in a contiguous (B, L, H, D) tensor.
__device__ __forceinline__ long long row_at(int b, int L, int H, int D, int h, int row) {
  return ((static_cast<long long>(b) * L + row) * H + h) * D;
}

// Delta = rowsum(dO * O) in fp32, (B, Hq, Lq); one warp per (b, row, h).
__global__ void __launch_bounds__(256) gqa_bwd_delta(const Params p) {
  const long long rows = static_cast<long long>(p.B) * p.Lq * p.Hq;
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* o = static_cast<const float*>(p.o) + r * p.D;
  const float* dO = static_cast<const float*>(p.dout) + r * p.D;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc += o[d] * dO[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % p.Hq);
    const long long bl = r / p.Hq;  // b * Lq + row
    const int row = static_cast<int>(bl % p.Lq);
    const int b = static_cast<int>(bl / p.Lq);
    p.delta[(static_cast<long long>(b) * p.Hq + h) * p.Lq + row] = acc;
  }
}

// ------------------------------- fp32 (CUDA cores) -------------------------------

constexpr int kF32Warps = 8;  // one query (dQ) or key (dK/dV) per warp
constexpr int kF32Tile = 32;  // keys (dQ) or queries (dK/dV) per tile
constexpr int kF32MaxD = 128;

// Stage kF32Tile rows of a and b (rows s_l elements apart) into sA / sB
// (row pitch kF32MaxD + 1), zero past L or D.
__device__ __forceinline__ void load_f32_pair(float (*sA)[kF32MaxD + 1],
                                              float (*sB)[kF32MaxD + 1], const float* a,
                                              const float* b, long long s_l, int row0, int L,
                                              int D) {
  for (int i = threadIdx.x; i < kF32Tile * kF32MaxD; i += kF32Warps * 32) {
    const int r = i / kF32MaxD;
    const int c = i % kF32MaxD;
    const bool ok = row0 + r < L && c < D;
    sA[r][c] = ok ? a[static_cast<long long>(row0 + r) * s_l + c] : 0.f;
    sB[r][c] = ok ? b[static_cast<long long>(row0 + r) * s_l + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kF32Warps * 32) gqa_bwd_dq_f32(const Params p) {
  __shared__ float sQ[kF32Warps][kF32MaxD];
  __shared__ float sDO[kF32Warps][kF32MaxD];
  __shared__ float sK[kF32Tile][kF32MaxD + 1];
  __shared__ float sV[kF32Tile][kF32MaxD + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / p.rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kF32Warps;
  const int row = q0 + warp;
  const bool row_ok = row < p.Lq;
  const long long s_q = static_cast<long long>(p.Hq) * p.D;
  const long long s_k = static_cast<long long>(p.Hkv) * p.D;
  const long long bh = static_cast<long long>(b) * p.Hq + h;

  const float* q = static_cast<const float*>(p.q) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
  const float* dO = static_cast<const float*>(p.dout) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
  const float* k = static_cast<const float*>(p.k) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  const float* v = static_cast<const float*>(p.v) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  for (int d = lane; d < kF32MaxD; d += 32) {
    const bool ok = row_ok && d < p.D;
    sQ[warp][d] = ok ? q[static_cast<long long>(row) * s_q + d] : 0.f;
    sDO[warp][d] = ok ? dO[static_cast<long long>(row) * s_q + d] : 0.f;
  }
  const float lse = row_ok ? p.lse[bh * p.Lq + row] : INFINITY;
  const float lse_use = lse == -INFINITY ? INFINITY : lse;
  const float dlt = row_ok ? p.delta[bh * p.Lq + row] : 0.f;
  float acc[kF32MaxD / 32] = {0.f, 0.f, 0.f, 0.f};

  const int lo = first_key(p, b);
  const int hi = p.offset < 0 ? p.Lk : min(p.Lk, p.offset + min(q0 + kF32Warps, p.Lq));
  for (int n0 = lo / kF32Tile * kF32Tile; n0 < hi; n0 += kF32Tile) {
    __syncthreads();
    load_f32_pair(sK, sV, k, v, s_k, n0, p.Lk, p.D);
    __syncthreads();
    float sc = 0.f, dpj = 0.f;  // lane j: key n0 + j
    for (int d = 0; d < p.D; ++d) {
      sc += sQ[warp][d] * sK[lane][d];
      dpj += sDO[warp][d] * sV[lane][d];
    }
    const bool vis = row_ok && visible(p, lo, row, n0 + lane);
    const float pj = vis ? expf(sc * p.scale - lse_use) : 0.f;
    const float ds = pj * (dpj - dlt);
    for (int j = 0; j < kF32Tile; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < kF32MaxD / 32; ++i) acc[i] += dsj * sK[j][lane + 32 * i];
    }
  }
  if (!row_ok) return;
  float* out = static_cast<float*>(p.dq) + row_at(b, p.Lq, p.Hq, p.D, h, row);
#pragma unroll
  for (int i = 0; i < kF32MaxD / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < p.D) out[d] = acc[i] * p.scale;
  }
}

__global__ void __launch_bounds__(kF32Warps * 32) gqa_bwd_dkdv_f32(const Params p) {
  __shared__ float sK[kF32Warps][kF32MaxD];
  __shared__ float sV[kF32Warps][kF32MaxD];
  __shared__ float sQ[kF32Tile][kF32MaxD + 1];
  __shared__ float sDO[kF32Tile][kF32MaxD + 1];
  __shared__ float sLse[kF32Tile];
  __shared__ float sDelta[kF32Tile];

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kF32Warps;
  const int key = k0 + warp;
  const bool key_ok = key < p.Lk;
  const long long s_q = static_cast<long long>(p.Hq) * p.D;
  const long long s_k = static_cast<long long>(p.Hkv) * p.D;

  const float* k = static_cast<const float*>(p.k) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  const float* v = static_cast<const float*>(p.v) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  for (int d = lane; d < kF32MaxD; d += 32) {
    const bool ok = key_ok && d < p.D;
    sK[warp][d] = ok ? k[static_cast<long long>(key) * s_k + d] : 0.f;
    sV[warp][d] = ok ? v[static_cast<long long>(key) * s_k + d] : 0.f;
  }
  float dk[kF32MaxD / 32] = {0.f, 0.f, 0.f, 0.f};
  float dv[kF32MaxD / 32] = {0.f, 0.f, 0.f, 0.f};

  const int lo = first_key(p, b);
  const int key_first = max(k0, lo);
  const int key_last = min(k0 + kF32Warps, p.Lk) - 1;
  const int m_first = p.offset < 0 ? 0 : max(0, key_first - p.offset);
  if (key_first <= key_last) {
    for (int h = hk * p.rep; h < (hk + 1) * p.rep; ++h) {
      const long long bh = static_cast<long long>(b) * p.Hq + h;
      const float* q = static_cast<const float*>(p.q) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
      const float* dO = static_cast<const float*>(p.dout) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
      for (int m0 = m_first / kF32Tile * kF32Tile; m0 < p.Lq; m0 += kF32Tile) {
        __syncthreads();
        load_f32_pair(sQ, sDO, q, dO, s_q, m0, p.Lq, p.D);
        if (threadIdx.x < kF32Tile) {
          const int row = m0 + threadIdx.x;
          const float lse = row < p.Lq ? p.lse[bh * p.Lq + row] : INFINITY;
          sLse[threadIdx.x] = lse == -INFINITY ? INFINITY : lse;
          sDelta[threadIdx.x] = row < p.Lq ? p.delta[bh * p.Lq + row] : 0.f;
        }
        __syncthreads();
        float sc = 0.f, dpi = 0.f;  // lane i: query m0 + i
        for (int d = 0; d < p.D; ++d) {
          sc += sQ[lane][d] * sK[warp][d];
          dpi += sDO[lane][d] * sV[warp][d];
        }
        const bool vis = key_ok && m0 + lane < p.Lq && visible(p, lo, m0 + lane, key);
        const float pi = vis ? expf(sc * p.scale - sLse[lane]) : 0.f;
        const float ds = pi * (dpi - sDelta[lane]);
        for (int j = 0; j < kF32Tile; ++j) {
          const float pjj = __shfl_sync(0xffffffffu, pi, j);
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int i = 0; i < kF32MaxD / 32; ++i) {
            dv[i] += pjj * sDO[j][lane + 32 * i];
            dk[i] += dsj * sQ[j][lane + 32 * i];
          }
        }
      }
    }
  }
  if (!key_ok) return;
  float* dkrow = static_cast<float*>(p.dk) + row_at(b, p.Lk, p.Hkv, p.D, hk, key);
  float* dvrow = static_cast<float*>(p.dv) + row_at(b, p.Lk, p.Hkv, p.D, hk, key);
#pragma unroll
  for (int i = 0; i < kF32MaxD / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < p.D) {
      dkrow[d] = dk[i] * p.scale;
      dvrow[d] = dv[i];
    }
  }
}

}  // namespace

// K8bwd in fp32: dq, dk, dv (like q, k, v, contiguous) of K8's attention
// from q (B, Lq, Hq, D), k / v (B, Lk, Hkv, D), the forward's out (like q)
// and its fp32 lse (B, Hq, Lq), and dout (like out), all contiguous fp32.
// kv_start null or (B,) int64 on the card; causal_offset < 0: no causal
// mask. delta is (B, Hq, Lq) fp32 scratch. Three launches: Delta, dK/dV,
// dQ. Returns a cudaError_t (0 on success).
extern "C" int gen3c_gqa_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       const long long* kv_start, float* delta, void* dq,
                                       void* dk, void* dv, int B, int Lq, int Lk, int Hq, int Hkv,
                                       int D, int causal_offset, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > 128 || Hq > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.kv_start = kv_start;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.rep = Hq / Hkv;
  p.offset = causal_offset;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * Lq * Hq;
  gqa_bwd_delta<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = kF32Warps * 32;
  gqa_bwd_dkdv_f32<<<dim3((Lk + kF32Warps - 1) / kF32Warps, Hkv, B), threads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gqa_bwd_dq_f32<<<dim3((Lq + kF32Warps - 1) / kF32Warps, Hq, B), threads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
