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
//   dQ_i    = scale * sum_j dS_ij k_j                            (gqa_bwd_dq_*)
//   dK_g    = scale * sum over the rep heads h of g of sum_i dS_ij q_i
//   dV_g    = sum over the rep heads h of g of sum_i P_ij dO_i    (gqa_bwd_dkdv_*)
// dK and dV of a KV head are summed over its query heads inside the CTA that
// owns its rows: K and V are never repeated in memory, no atomics, the bits
// are the same at every call. A query row that sees no key (a left-pad
// query) has lse -inf and O = 0 from the forward: its P is 0 here, so it
// adds nothing to dK / dV and its dQ is 0 (the XLA form averages every key
// there; no later layer reads such a row).
//
// Kernels (bf16: tensor cores, mma.sync m16n8k16, bf16 in, fp32 sums; the
// tiles, fragments and loads of attention_bwd.cu's K4 bodies, with K8's mask
// and the head map; fp32: the CUDA cores, for ar_tiny):
//   gqa_bwd_dkdv_bf16  one CTA per (64-key tile, KV head, batch), four warps
//                      of 16 keys, looping over its rep query heads and, per
//                      head, the 32-query tiles from the first query that
//                      sees one of its keys: S^T = K Q^T, dP^T = V dO^T, P^T
//                      and dS^T in fp32 registers, dV += P^T dO, dK += dS^T Q.
//                      A key tile wholly before kv_start writes zeros.
//   gqa_bwd_dq_bf16    one CTA per (64-query tile, query head, batch), the
//                      tiles with the most keys first, looping over the
//                      64-key tiles its rows see: S = Q K^T, dP = dO V^T,
//                      dQ += dS K.
//   gqa_bwd_delta      Delta in fp32, one warp per (batch, query, head) row.
//   *_f32              the same passes on the CUDA cores, one warp per query
//                      (dQ) or per key (dK/dV), 32-wide tiles.
// Every pair's visibility is tested element by element; tiles no row sees
// are not visited.
//
// Layout: q, o, dO (B, Lq, Hq, d), k, v (B, Lk, Hkv, d), contiguous (the
// wrapper makes them so), d <= 128 zero-padded in shared memory to the MMA
// depth DP; lse and Delta (B, Hq, Lq) fp32; dq, dk, dv like q, k, v.
//
// What bounds it: at the 4B's training shape (12,800 queries, causal, 32 x
// 128 heads over 8 KV heads) the backward is 2.5 times the forward's matrix
// work, 3.4 Tflop a layer, against ~50 MB: the tensor cores. This first
// version keeps K4's mma.sync design (synchronous tile loads, 32-bit shared
// reads, S recomputed in both kernels: 7 products against FlashAttention-2's
// 5), so it runs at the rate mma.sync is fed, not at wgmma's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBlockM = 64;    // dQ: queries per CTA
constexpr int kBlockN = 64;    // dQ: keys per tile; dK/dV: keys per CTA
constexpr int kBlockQ = 32;    // dK/dV: queries per tile (register budget)
constexpr float kLog2e = 1.4426950408889634f;

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

// A row's lse in log2 units for exp2f(S * scale * log2e - lse): a row that
// sees no key (-inf) becomes +inf, so its P is 0 and never NaN.
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// Element offsets of row `row` of head h in a contiguous (B, L, H, D) tensor.
__device__ __forceinline__ long long row_at(int b, int L, int H, int D, int h, int row) {
  return ((static_cast<long long>(b) * L + row) * H + h) * D;
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage ROWS rows [row0, row0 + ROWS) x [0, DP) of one (batch, head) slice
// (rows s_l elements apart) into shared memory (row pitch DP + 8),
// zero-filling rows >= L and dims >= D.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* base,
                                          long long s_l, int row0, int L, int D) {
  constexpr int kPitch = DP + 8;
  if (VEC) {  // D % 8 == 0 and 16-byte aligned rows: one uint4 per 8 dims
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < L && c < D) {
        val = *reinterpret_cast<const uint4*>(base + static_cast<long long>(row0 + r) * s_l + c);
      }
      *reinterpret_cast<uint4*>(smem + r * kPitch + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP;
      const int c = i % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row0 + r < L && c < D) val = base[static_cast<long long>(row0 + r) * s_l + c];
      smem[r * kPitch + c] = val;
    }
  }
}

// C[16 x 8*NT] += A[16 rows of sA from row a_row] . B^T[8*NT rows of sB]^T
// over DP dims, both row-major in shared memory with the head dim contiguous.
template <int DP, int NT>
__device__ __forceinline__ void mma_rows_rows(float c[NT][4], const __nv_bfloat16* sA,
                                              int a_row, const __nv_bfloat16* sB) {
  constexpr int kPitch = DP + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* pa = sA + (a_row + g) * kPitch + kk * 16 + tg * 2;
    const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * kPitch), ld_u32(pa + 8),
                           ld_u32(pa + 8 * kPitch + 8)};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const __nv_bfloat16* pb = sB + (t * 8 + g) * kPitch + kk * 16 + tg * 2;
      const uint32_t bb[2] = {ld_u32(pb), ld_u32(pb + 8)};
      mma_16816(c[t], a, bb);
    }
  }
}

// acc[16 x DP] += X[16 x 16*KT] . sB[16*KT rows x DP]: X as 2*KT fp32
// accumulator fragments (the C layout of two adjacent n-tiles is the A
// layout of one k16 step), sB row-major with the output dim contiguous.
template <int DP, int KT>
__device__ __forceinline__ void mma_acc_rows(float acc[DP / 8][4], const float x[2 * KT][4],
                                             const __nv_bfloat16* sB) {
  constexpr int kPitch = DP + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const uint32_t a[4] = {pack_f32x2(x[2 * j][0], x[2 * j][1]),
                           pack_f32x2(x[2 * j][2], x[2 * j][3]),
                           pack_f32x2(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_f32x2(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const __nv_bfloat16* pb = sB + (j * 16 + tg * 2) * kPitch + t * 8 + g;
      const uint32_t bb[2] = {pack_bf16x2(pb[0], pb[kPitch]),
                              pack_bf16x2(pb[8 * kPitch], pb[9 * kPitch])};
      mma_16816(acc[t], a, bb);
    }
  }
}

// Write a warp's 16 x DP fp32 accumulator rows [row0, row0 + 16), times mul,
// as bf16 rows of `out` (rows s_l elements apart), rows < L, dims < D.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long s_l, int L, int D,
                                           int row0, const float acc[DP / 8][4], float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= L) continue;
    __nv_bfloat16* orow = out + static_cast<long long>(row) * s_l;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int col = t * 8 + tg * 2;
      if (col < D) orow[col] = __float2bfloat16(acc[t][2 * i] * mul);
      if (col + 1 < D) orow[col + 1] = __float2bfloat16(acc[t][2 * i + 1] * mul);
    }
  }
}

// ------------------------------------ bf16 ------------------------------------

// dK/dV of 64 keys of KV head hk: every query tile of every query head of
// the group that holds a query seeing one of the keys.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 3) gqa_bwd_dkdv_bf16(const Params p) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBlockN * kPitch;
  __nv_bfloat16* sQ = sV + kBlockN * kPitch;
  __nv_bfloat16* sDO = sQ + kBlockQ * kPitch;
  float* sLse = reinterpret_cast<float*>(sDO + kBlockQ * kPitch);  // log2 units
  float* sDelta = sLse + kBlockQ;

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wrow = warp * 16;
  const long long s_q = static_cast<long long>(p.Hq) * p.D;
  const long long s_k = static_cast<long long>(p.Hkv) * p.D;

  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  load_tile<DP, kBlockN, VEC>(sK, k, s_k, n0, p.Lk, p.D);
  load_tile<DP, kBlockN, VEC>(sV, v, s_k, n0, p.Lk, p.D);

  const float scale_log2 = p.scale * kLog2e;
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) {
    dk[t][0] = dk[t][1] = dk[t][2] = dk[t][3] = 0.f;
    dv[t][0] = dv[t][1] = dv[t][2] = dv[t][3] = 0.f;
  }
  const int lo = first_key(p, b);
  const int key_first = max(n0, lo);
  const int key_last = min(n0 + kBlockN, p.Lk) - 1;
  // the first query that sees one of the tile's visible keys
  const int m_first = p.offset < 0 ? 0 : max(0, key_first - p.offset);
  const int key_row[2] = {n0 + wrow + g, n0 + wrow + g + 8};

  if (key_first <= key_last) {
    for (int h = hk * p.rep; h < (hk + 1) * p.rep; ++h) {
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
      const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
      const float* lse = p.lse + (static_cast<long long>(b) * p.Hq + h) * p.Lq;
      const float* delta = p.delta + (static_cast<long long>(b) * p.Hq + h) * p.Lq;
      for (int m0 = m_first / kBlockQ * kBlockQ; m0 < p.Lq; m0 += kBlockQ) {
        __syncthreads();  // previous query tile fully consumed (and K/V staged)
        load_tile<DP, kBlockQ, VEC>(sQ, q, s_q, m0, p.Lq, p.D);
        load_tile<DP, kBlockQ, VEC>(sDO, dO, s_q, m0, p.Lq, p.D);
        if (threadIdx.x < kBlockQ) {
          const int row = m0 + threadIdx.x;
          sLse[threadIdx.x] = row < p.Lq ? lse_log2(lse[row]) : INFINITY;
          sDelta[threadIdx.x] = row < p.Lq ? delta[row] : 0.f;
        }
        __syncthreads();

        float st[kBlockQ / 8][4], dpt[kBlockQ / 8][4];
#pragma unroll
        for (int t = 0; t < kBlockQ / 8; ++t) {
          st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
          dpt[t][0] = dpt[t][1] = dpt[t][2] = dpt[t][3] = 0.f;
        }
        mma_rows_rows<DP, kBlockQ / 8>(st, sK, wrow, sQ);
        mma_rows_rows<DP, kBlockQ / 8>(dpt, sV, wrow, sDO);

        // P^T = exp(S^T scale - lse) per column (query) on the visible
        // pairs, dS^T = P^T (dP^T - Delta)
#pragma unroll
        for (int t = 0; t < kBlockQ / 8; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = t * 8 + tg * 2 + (e & 1);
            const bool vis = m0 + col < p.Lq && visible(p, lo, m0 + col, key_row[e >> 1]);
            const float pe = vis ? exp2f(st[t][e] * scale_log2 - sLse[col]) : 0.f;
            st[t][e] = pe;
            dpt[t][e] = pe * (dpt[t][e] - sDelta[col]);
          }
        }
        mma_acc_rows<DP, kBlockQ / 16>(dv, st, sDO);  // dV += P^T dO
        mma_acc_rows<DP, kBlockQ / 16>(dk, dpt, sQ);  // dK += dS^T Q
      }
    }
  }
  store_rows<DP>(static_cast<__nv_bfloat16*>(p.dk) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0), s_k,
                 p.Lk, p.D, n0 + wrow, dk, p.scale);
  store_rows<DP>(static_cast<__nv_bfloat16*>(p.dv) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0), s_k,
                 p.Lk, p.D, n0 + wrow, dv, 1.f);
}

// dQ of 64 queries of query head h over the key tiles its rows see; the
// query tiles with the most keys (the last, when causal) first.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads) gqa_bwd_dq_bf16(const Params p) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kBlockM * kPitch;
  __nv_bfloat16* sK = sDO + kBlockM * kPitch;
  __nv_bfloat16* sV = sK + kBlockN * kPitch;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / p.rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wrow = warp * 16;
  const long long s_q = static_cast<long long>(p.Hq) * p.D;
  const long long s_k = static_cast<long long>(p.Hkv) * p.D;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + row_at(b, p.Lq, p.Hq, p.D, h, 0);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + row_at(b, p.Lk, p.Hkv, p.D, hk, 0);
  const float* lse = p.lse + (static_cast<long long>(b) * p.Hq + h) * p.Lq;
  const float* delta = p.delta + (static_cast<long long>(b) * p.Hq + h) * p.Lq;

  load_tile<DP, kBlockM, VEC>(sQ, q, s_q, q0, p.Lq, p.D);
  load_tile<DP, kBlockM, VEC>(sDO, dO, s_q, q0, p.Lq, p.D);
  // rows g and g + 8 of this warp; a missing row or one that sees no key
  // gets an lse of +inf: its P is 0
  float lse_l2[2], dlt[2];
  int qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + wrow + g + 8 * i;
    lse_l2[i] = qrow[i] < p.Lq ? lse_log2(lse[qrow[i]]) : INFINITY;
    dlt[i] = qrow[i] < p.Lq ? delta[qrow[i]] : 0.f;
  }

  const float scale_log2 = p.scale * kLog2e;
  float dq[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;

  const int lo = first_key(p, b);
  const int hi = p.offset < 0 ? p.Lk : min(p.Lk, p.offset + min(q0 + kBlockM, p.Lq));
  for (int n0 = lo / kBlockN * kBlockN; n0 < hi; n0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP, kBlockN, VEC>(sK, k, s_k, n0, p.Lk, p.D);
    load_tile<DP, kBlockN, VEC>(sV, v, s_k, n0, p.Lk, p.D);
    __syncthreads();

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
    }
    mma_rows_rows<DP, kBlockN / 8>(s, sQ, wrow, sK);
    mma_rows_rows<DP, kBlockN / 8>(dp, sDO, wrow, sV);
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + t * 8 + tg * 2 + (e & 1);
        const bool vis = visible(p, lo, qrow[e >> 1], col);
        const float pe = vis ? exp2f(s[t][e] * scale_log2 - lse_l2[e >> 1]) : 0.f;
        s[t][e] = pe * (dp[t][e] - dlt[e >> 1]);  // dS
      }
    }
    mma_acc_rows<DP, kBlockN / 16>(dq, s, sK);  // dQ += dS K
  }
  store_rows<DP>(static_cast<__nv_bfloat16*>(p.dq) + row_at(b, p.Lq, p.Hq, p.D, h, 0), s_q,
                 p.Lq, p.D, q0 + wrow, dq, p.scale);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Delta = rowsum(dO * O) in fp32, (B, Hq, Lq); one warp per (b, row, h).
template <typename T>
__global__ void __launch_bounds__(256) gqa_bwd_delta(const Params p) {
  const long long rows = static_cast<long long>(p.B) * p.Lq * p.Hq;
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = static_cast<const T*>(p.o) + r * p.D;
  const T* dO = static_cast<const T*>(p.dout) + r * p.D;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc += to_f32(o[d]) * to_f32(dO[d]);
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

// ------------------------------- launchers -------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, bool VEC>
cudaError_t bwd_bf16(const Params& p, cudaStream_t s) {
  const size_t pitch = (DP + 8) * sizeof(__nv_bfloat16);
  const size_t smem_dkdv = (2 * kBlockN + 2 * kBlockQ) * pitch + 2 * kBlockQ * sizeof(float);
  cudaError_t err = launch(gqa_bwd_dkdv_bf16<DP, VEC>,
                           dim3((p.Lk + kBlockN - 1) / kBlockN, p.Hkv, p.B), smem_dkdv, s, p);
  if (err != cudaSuccess) return err;
  const size_t smem_dq = (2 * kBlockM + 2 * kBlockN) * pitch;
  return launch(gqa_bwd_dq_bf16<DP, VEC>, dim3((p.Lq + kBlockM - 1) / kBlockM, p.Hq, p.B),
                smem_dq, s, p);
}

template <bool VEC>
cudaError_t bwd_bf16_by_dp(const Params& p, cudaStream_t s) {
  if (p.D <= 32) return bwd_bf16<32, VEC>(p, s);
  if (p.D <= 64) return bwd_bf16<64, VEC>(p, s);
  return bwd_bf16<128, VEC>(p, s);
}

}  // namespace

// K8bwd: dq, dk, dv (like q, k, v, contiguous) of K8's attention from q (B,
// Lq, Hq, D), k / v (B, Lk, Hkv, D), the forward's out (like q) and its fp32
// lse (B, Hq, Lq), and dout (like out). kv_start null or (B,) int64 on the
// card; causal_offset < 0: no causal mask. delta is (B, Hq, Lq) fp32
// scratch. bf16 != 0: bf16 tensors (mma.sync), else fp32 (CUDA cores). vec:
// nonzero when D % 8 == 0 and every bf16 tensor is 16-byte aligned. Three
// launches: Delta, dK/dV, dQ. Returns a cudaError_t (0 on success).
extern "C" int gen3c_gqa_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       const long long* kv_start, float* delta, void* dq,
                                       void* dk, void* dv, int B, int Lq, int Lk, int Hq, int Hkv,
                                       int D, int causal_offset, int bf16, int vec,
                                       void* stream) {
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
  const dim3 delta_grid(static_cast<unsigned>((rows + 7) / 8));
  if (bf16) {
    gqa_bwd_delta<__nv_bfloat16><<<delta_grid, 256, 0, s>>>(p);
  } else {
    gqa_bwd_delta<float><<<delta_grid, 256, 0, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!bf16) {
    const int threads = kF32Warps * 32;
    gqa_bwd_dkdv_f32<<<dim3((Lk + kF32Warps - 1) / kF32Warps, Hkv, B), threads, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gqa_bwd_dq_f32<<<dim3((Lq + kF32Warps - 1) / kF32Warps, Hq, B), threads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(vec != 0 ? bwd_bf16_by_dp<true>(p, s) : bwd_bf16_by_dp<false>(p, s));
}
