// K4: non-causal multi-head attention backward for Hopper (sm_90a), with the
// forward that training needs beside it (the output plus its row logsumexp).
//
// Replaces the backward of the Pallas TPU kernels of
// gen3c_tpu/models/dit.py::attention_op, which jax.value_and_grad reaches from
// gen3c_tpu/training/train_step.py:233:
//   splash attention backward (make_splash_mha's custom VJP, dit.py:464-470),
//     DiT self-attention
//   flash attention backward (flash_attention's _bwd_dkv / _bwd_dq, dit.py:508),
//     DiT cross-attention (the Lq != Lk case of the same kernels)
//
// With P = softmax(S), S = q.k^T * scale, O = P.v and the fp32 row
// logsumexp lse of S saved by the forward, the backward is (FlashAttention-2):
//   Delta_i = sum_d dO_id * O_id                              (attn_bwd_delta)
//   P_ij    = exp(S_ij - lse_i)
//   dV_j    = sum_i P_ij dO_i
//   dS_ij   = P_ij * (dO_i . v_j - Delta_i)
//   dK_j    = scale * sum_i dS_ij q_i                         (attn_bwd_dkdv)
//   dQ_i    = scale * sum_j dS_ij k_j                         (attn_bwd_dq)
// dK/dV and dQ are separate kernels, each owning its output rows, so there
// are no atomics and the result is deterministic (the remat recompute of
// the forward is bitwise the first forward too).
//
// Layout: q (B, Lq, H, D), k/v (B, Lk, H, D), o/dO like q, all contiguous
// (the wrapper makes them so); lse and Delta (B, H, Lq) fp32. Lq and Lk are
// arbitrary (ragged tiles masked); any D <= 128 is zero-padded in shared
// memory to the MMA depth.
//
// Kernels (bf16: tensor cores, mma.sync m16n8k16, bf16 in, fp32 accumulate;
// fp32: the backward on the CUDA cores, for the fp32 tiny preset, whose
// tolerance bf16 or single TF32 products would not hold; the fp32 forward
// with lse is attention_f32.cu's three TF32 products, the body every fp32
// forward runs, which the fp32 entries here call):
//   attn_fwd_lse_bf16  K1's FlashAttention-2 forward (a copy of attn_fwd_bf16 in
//                      attention.cu, which stays byte-for-byte untouched: its
//                      code generation is fragile) that also writes lse.
//   attn_bwd_dkdv_bf16 one CTA per (64-key tile, head, batch), four warps of
//                      16 keys, looping over 32-query tiles: S^T = K Q^T and
//                      dP^T = V dO^T on the tensor cores, P^T and dS^T in fp32
//                      registers, then dV += P^T dO and dK += dS^T Q with the
//                      fp32 accumulators as the next MMA's A operand (never
//                      leaving registers). dK and dV accumulate in fp32
//                      registers over all queries and are cast once.
//   attn_bwd_dq_bf16   one CTA per (64-query tile, head, batch), looping over
//                      64-key tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
//   attn_bwd_delta     Delta in fp32, one warp per (batch, query, head) row.
//   *_f32              the backward's passes on the CUDA cores, one warp per
//                      query (dQ) or per key (dK/dV), 32-wide tiles; they
//                      take the band below too (hw 0: full attention).
//
// K4-band: the same forward and backward under K3's temporal band (the
// splash kernel's VJP with make_temporal_band_mask, gen3c_tpu/models/
// dit.py:370-409 and :459-470): query token i sees key token j iff
// |i/hw - j/hw| <= window or j/hw < prefix. Each bf16 kernel has one body,
// templated on kBand, with two entry points: K4's take Params only, K4-band's
// (attn_fwd_lse_bf16_band, attn_bwd_dq_bf16_band, attn_bwd_dkdv_bf16_band)
// also take the band as a separate Band argument. So the full-attention
// kernels keep their parameter lists and code generation (attention.cu's K3
// note: one more parameter field cost K1 three registers and 2.3x its time).
//   forward, dQ        a 64-query CTA visits only the 64-key tiles K3 visits
//                      (band_key_tiles: the prefix tiles and the tiles of the
//                      frames within the window, merged where they touch).
//   dK/dV              the transpose: a 64-key CTA holding a prefix key
//                      visits every 32-query tile, any other only the query
//                      tiles of its key frames +/- window.
// A tile pair that is not wholly visible (band boundary, ragged end) masks
// per element; P of a masked pair is 0. Every CTA still owns its output rows
// (no atomics). At a window >= T - 1 the kernels visit K4's tiles in K4's
// order with K4's arithmetic, so they give K4's bits. The band forward's
// arithmetic is K3's (attn_fwd_bf16_band), so its output is K3's bit for bit.
//
// K1ring (gen3c_attention_ring_fold): one step of ring attention, the
// forward with lse of a query shard over one KV shard. Without a band it is
// attn_fwd_lse_bf16 itself; under the band, attn_fwd_lse_bf16_ring, the band
// forward's body with the shards' global offsets (Band.q_off, Band.k_off).
//
// What bounds it: per (batch, head) the backward does 2.5x the forward's
// matrix work (S recomputed twice, four more products) against ~8 L D bytes,
// so at the GEN3C-7B shape (L = 56,320, D = 128) the rate at which the
// tensor-core instructions are fed bounds it, as it does K1. This first version, like K1, loads tiles
// synchronously and reads MMA operands with 32-bit shared loads (no ldmatrix,
// cp.async/TMA or WGMMA), and recomputes S in both backward kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// attention_f32.cu: the fp32 forward with lse
extern "C" int gen3c_attention_f32_lse(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int Lq, int Lk, int H, int D,
                                       float scale, const int* band, int q_off, int k_off,
                                       void* stream);

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBlockM = 64;    // forward and dQ: queries per CTA
constexpr int kBlockN = 64;    // forward and dQ: keys per tile; dK/dV: keys per CTA
constexpr int kBlockQ = 32;    // dK/dV: queries per tile (register budget)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;        // forward: O
  float* lse;       // (B, H, Lq), natural log
  float* delta;     // (B, H, Lq)
  void* dq;
  void* dk;
  void* dv;
  int B, Lq, Lk, H, D;
  float scale;
};

#include "band.h"

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

// Element offset of row `row` of (batch b, head h) in a contiguous (B, L, H, D)
// tensor; consecutive rows are H * D apart.
__device__ __forceinline__ long long row_offset(const Params& p, int b, int h, int L,
                                                int row) {
  return ((static_cast<long long>(b) * L + row) * p.H + h) * p.D;
}

// Stage ROWS rows [row0, row0 + ROWS) x [0, DP) of one (batch, head) slice
// into shared memory (row pitch DP + 8), zero-filling rows >= L and dims >= D.
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

// C[16 x 8*NT] += A[16 rows of sA from row a_row] . B^T[8*NT rows of sB]^T over
// DP dims: both operands row-major in shared memory with the reduction (head)
// dim contiguous, as S = Q K^T and dP = dO V^T are.
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

// acc[16 x DP] += X[16 x 16*KT] . sB[16*KT rows x DP]: X is held as NT = 2*KT
// fp32 accumulator fragments (the C layout of two adjacent n-tiles is the A
// layout of one k16 step), sB row-major with the output dim contiguous, as
// O += P V, dV += P^T dO, dK += dS^T Q and dQ += dS K are.
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

// Write a warp's 16 x DP fp32 accumulator rows, times mul, as bf16 rows
// [row0, row0 + 16) of a contiguous (B, L, H, D) tensor.
template <int DP>
__device__ __forceinline__ void store_rows(const Params& p, __nv_bfloat16* out, int b, int h,
                                           int L, int row0, const float acc[DP / 8][4],
                                           float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= L) continue;
    __nv_bfloat16* orow = out + row_offset(p, b, h, L, row);
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int col = t * 8 + tg * 2;
      if (col < p.D) orow[col] = __float2bfloat16(acc[t][2 * i] * mul);
      if (col + 1 < p.D) orow[col + 1] = __float2bfloat16(acc[t][2 * i + 1] * mul);
    }
  }
}

// ------------------------- bf16 forward and backward -------------------------
//
// Each of the three bf16 kernels has one body, templated on kBand: false is
// K4 (every tile, the Params-only entry points), true is K4-band (the tiles
// the band reaches, the Params + Band entry points). The band's code sits
// behind `if constexpr (kBand)`, so K4's instantiations compile as if it were
// not there, and each family keeps its own register cap and count.

// The forward with lse. K4: every key tile, K1's arithmetic. K4-band: the key
// tiles K3 visits with K3's arithmetic tile for tile and operation for
// operation, so the output is K3's bits; band.visited[0] += the key tiles
// each CTA visits.
// kRing (K1ring, one step of ring attention under the band): the same with
// the queries and keys at the global positions band.q_off + i and
// band.k_off + j. A query row that sees no key of the shard writes out 0
// and lse -inf (no NaN), which the merge (attention_merge.cu) takes as no
// contribution. Without kRing the offsets are the constant 0.
template <int DP, bool VEC, bool kBand, bool kRing = false>
__device__ __forceinline__ void fwd_lse_bf16_body(const Params& p, const Band& band) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kPitch;
  __nv_bfloat16* sV = sK + kBlockN * kPitch;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wrow = warp * 16;
  const long long s_l = static_cast<long long>(p.H) * p.D;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + row_offset(p, b, h, p.Lq, 0);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + row_offset(p, b, h, p.Lk, 0);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + row_offset(p, b, h, p.Lk, 0);
  const int q_off = kRing ? band.q_off : 0;  // global position of query row 0
  const int k_off = kRing ? band.k_off : 0;  // and of key row 0

  load_tile<DP, kBlockM, VEC>(sQ, q, s_l, q0, p.Lq, p.D);

  const float scale_log2 = p.scale * kLog2e;
  float o[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  // One 64-key tile from n0: S = Q K^T, the online softmax, O += P V. A
  // band tile that is all_visible skips the mask (K3's whole tiles); any
  // other tile masks per element.
  auto key_tile = [&](int n0, bool all_visible) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP, kBlockN, VEC>(sK, k, s_l, n0, p.Lk, p.D);
    load_tile<DP, kBlockN, VEC>(sV, v, s_l, n0, p.Lk, p.D);
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    mma_rows_rows<DP, kBlockN / 8>(s, sQ, wrow, sK);

    float mx[2] = {m_run[0], m_run[1]};
    if (kBand && all_visible) {
#pragma unroll
      for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        }
      }
    } else {
      int qf_row[2] = {0, 0};  // the frames of rows g and g + 8
      if constexpr (kBand) {
        qf_row[0] = (q_off + q0 + wrow + g) / band.hw;
        qf_row[1] = (q_off + q0 + wrow + g + 8) / band.hw;
      }
#pragma unroll
      for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + t * 8 + tg * 2 + (e & 1);
          bool vis = col < p.Lk;
          if constexpr (kBand) {
            vis = vis && band_frames_visible(band, qf_row[e >> 1], (k_off + col) / band.hw);
          }
          const float x = vis ? s[t][e] * scale_log2 : -INFINITY;
          s[t][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a band row with no visible key yet (max -inf) exponentiates against
      // 0, so that p and alpha are 0, not NaN; a K4 tile always has a key
      m_use[i] = kBand && mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m_run[i] - m_use[i]);  // 0 on the first tile
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[t][e] - m_use[e >> 1]);
        s[t][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }
    mma_acc_rows<DP, kBlockN / 16>(o, s, sV);
  };

  if constexpr (kBand) {
    const int q_last = min(q0 + kBlockM, p.Lq) - 1;
    int b0, e0, b1, e1;
    band_key_tiles(band, p.Lk, q_off + q0, q_off + q_last, kBlockN, b0, e0, b1, e1, k_off);
    const int n_tiles = (e0 - b0) + (e1 - b1);
    const int qf_lo = (q_off + q0) / band.hw, qf_hi = (q_off + q_last) / band.hw;
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = (it < e0 - b0 ? b0 + it : b1 + it - (e0 - b0)) * kBlockN;
      key_tile(n0, band_tile_visible(band, p.Lk, n0, kBlockN, qf_lo, qf_hi, k_off));
    }
    if (band.visited != nullptr && threadIdx.x == 0) {
      atomicAdd(band.visited, static_cast<unsigned long long>(n_tiles));
    }
  } else {
    for (int n0 = 0; n0 < p.Lk; n0 += kBlockN) key_tile(n0, false);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= p.Lq) continue;
    // kRing: a row without a visible key has l_run 0 (and m_run -inf)
    const float inv = kRing && l_run[i] == 0.f ? 0.f : 1.f / l_run[i];
    __nv_bfloat16* orow = out + row_offset(p, b, h, p.Lq, row);
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int col = t * 8 + tg * 2;
      if (col < p.D) orow[col] = __float2bfloat16(o[t][2 * i] * inv);
      if (col + 1 < p.D) orow[col + 1] = __float2bfloat16(o[t][2 * i + 1] * inv);
    }
    if (tg == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row] =
          (m_run[i] + log2f(l_run[i])) * kLn2;
    }
  }
}

// dK/dV: the 64-key CTA loops over 32-query tiles (K4: all of them; K4-band:
// those whose queries see one of its keys, band_query_tiles, masking per
// element in the tiles that are not wholly visible; band.visited[0] += the
// query tiles each CTA visits).
template <int DP, bool VEC, bool kBand>
__device__ __forceinline__ void bwd_dkdv_bf16_body(const Params& p, const Band& band) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBlockN * kPitch;
  __nv_bfloat16* sQ = sV + kBlockN * kPitch;
  __nv_bfloat16* sDO = sQ + kBlockQ * kPitch;
  float* sLse = reinterpret_cast<float*>(sDO + kBlockQ * kPitch);  // log2 units
  float* sDelta = sLse + kBlockQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wrow = warp * 16;
  const long long s_l = static_cast<long long>(p.H) * p.D;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + row_offset(p, b, h, p.Lq, 0);
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + row_offset(p, b, h, p.Lq, 0);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + row_offset(p, b, h, p.Lk, 0);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + row_offset(p, b, h, p.Lk, 0);
  const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Lq;
  const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Lq;

  load_tile<DP, kBlockN, VEC>(sK, k, s_l, n0, p.Lk, p.D);
  load_tile<DP, kBlockN, VEC>(sV, v, s_l, n0, p.Lk, p.D);

  const float scale_log2 = p.scale * kLog2e;
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) {
    dk[t][0] = dk[t][1] = dk[t][2] = dk[t][3] = 0.f;
    dv[t][0] = dv[t][1] = dv[t][2] = dv[t][3] = 0.f;
  }
  // band: the query tiles [mb, me) to visit, and the frames of this
  // thread's key rows g and g + 8 (rows >= Lk are not stored)
  int mb = 0, me = 0, kf_row[2] = {0, 0};
  if constexpr (kBand) {
    band_query_tiles(band, p.Lq, n0, min(n0 + kBlockN, p.Lk) - 1, kBlockQ, mb, me);
    kf_row[0] = (n0 + wrow + g) / band.hw;
    kf_row[1] = (n0 + wrow + g + 8) / band.hw;
  }

  auto query_tile = [&](int m0, bool all_visible) {
    __syncthreads();  // previous query tile fully consumed (and K/V staged)
    load_tile<DP, kBlockQ, VEC>(sQ, q, s_l, m0, p.Lq, p.D);
    load_tile<DP, kBlockQ, VEC>(sDO, dO, s_l, m0, p.Lq, p.D);
    if (threadIdx.x < kBlockQ) {
      const int row = m0 + threadIdx.x;
      // a missing query row gets lse 0 and Delta 0: its P is exp2(0) = 1
      // times zero rows of Q and dO, so its dS and P . dO terms vanish
      sLse[threadIdx.x] = row < p.Lq ? lse[row] * kLog2e : 0.f;
      sDelta[threadIdx.x] = row < p.Lq ? delta[row] : 0.f;
    }
    __syncthreads();

    // S^T (this warp's 16 keys x 32 queries) and dP^T = V dO^T
    float st[kBlockQ / 8][4], dpt[kBlockQ / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockQ / 8; ++t) {
      st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
      dpt[t][0] = dpt[t][1] = dpt[t][2] = dpt[t][3] = 0.f;
    }
    mma_rows_rows<DP, kBlockQ / 8>(st, sK, wrow, sQ);
    mma_rows_rows<DP, kBlockQ / 8>(dpt, sV, wrow, sDO);

    // P^T = exp(S^T * scale - lse) with lse per column (query), and
    // dS^T = P^T (dP^T - Delta); queries >= Lq and masked pairs give 0
#pragma unroll
    for (int t = 0; t < kBlockQ / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 8 + tg * 2 + (e & 1);
        bool vis = true;
        if constexpr (kBand) {
          vis = all_visible || band_frames_visible(band, (m0 + col) / band.hw, kf_row[e >> 1]);
        }
        const float pe = m0 + col < p.Lq && vis ? exp2f(st[t][e] * scale_log2 - sLse[col]) : 0.f;
        st[t][e] = pe;
        dpt[t][e] = pe * (dpt[t][e] - sDelta[col]);
      }
    }
    mma_acc_rows<DP, kBlockQ / 16>(dv, st, sDO);   // dV += P^T dO
    mma_acc_rows<DP, kBlockQ / 16>(dk, dpt, sQ);   // dK += dS^T Q
  };

  if constexpr (kBand) {
    for (int mt = mb; mt < me; ++mt) {
      const int m0 = mt * kBlockQ;
      query_tile(m0, band_tile_visible(band, p.Lk, n0, kBlockN, m0 / band.hw,
                                       (min(m0 + kBlockQ, p.Lq) - 1) / band.hw));
    }
    if (band.visited != nullptr && threadIdx.x == 0) {
      atomicAdd(band.visited, static_cast<unsigned long long>(me - mb));
    }
  } else {
    for (int m0 = 0; m0 < p.Lq; m0 += kBlockQ) query_tile(m0, false);
  }

  store_rows<DP>(p, static_cast<__nv_bfloat16*>(p.dk), b, h, p.Lk, n0 + wrow, dk, p.scale);
  store_rows<DP>(p, static_cast<__nv_bfloat16*>(p.dv), b, h, p.Lk, n0 + wrow, dv, 1.f);
}

// dQ: the 64-query CTA loops over 64-key tiles (K4: all of them; K4-band: the
// forward's, band.visited[1] += the key tiles each CTA visits).
template <int DP, bool VEC, bool kBand>
__device__ __forceinline__ void bwd_dq_bf16_body(const Params& p, const Band& band) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kBlockM * kPitch;
  __nv_bfloat16* sK = sDO + kBlockM * kPitch;
  __nv_bfloat16* sV = sK + kBlockN * kPitch;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wrow = warp * 16;
  const long long s_l = static_cast<long long>(p.H) * p.D;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + row_offset(p, b, h, p.Lq, 0);
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + row_offset(p, b, h, p.Lq, 0);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + row_offset(p, b, h, p.Lk, 0);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + row_offset(p, b, h, p.Lk, 0);
  const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Lq;
  const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Lq;

  load_tile<DP, kBlockM, VEC>(sQ, q, s_l, q0, p.Lq, p.D);
  load_tile<DP, kBlockM, VEC>(sDO, dO, s_l, q0, p.Lq, p.D);
  // rows g and g + 8 of this warp; a missing row gets lse 0 and Delta 0
  // (zero q and dO rows: its dS is 0 and it is not written)
  float lse_l2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    lse_l2[i] = row < p.Lq ? lse[row] * kLog2e : 0.f;
    dlt[i] = row < p.Lq ? delta[row] : 0.f;
  }

  const float scale_log2 = p.scale * kLog2e;
  float dq[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;
  int qf_row[2] = {0, 0};  // band: the frames of rows g and g + 8
  if constexpr (kBand) {
    qf_row[0] = (q0 + wrow + g) / band.hw;
    qf_row[1] = (q0 + wrow + g + 8) / band.hw;
  }

  auto key_tile = [&](int n0, bool all_visible) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP, kBlockN, VEC>(sK, k, s_l, n0, p.Lk, p.D);
    load_tile<DP, kBlockN, VEC>(sV, v, s_l, n0, p.Lk, p.D);
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
        bool vis;
        if constexpr (kBand) {
          vis = all_visible ||
                (col < p.Lk && band_frames_visible(band, qf_row[e >> 1], col / band.hw));
        } else {
          vis = col < p.Lk;
        }
        const float pe = vis ? exp2f(s[t][e] * scale_log2 - lse_l2[e >> 1]) : 0.f;
        s[t][e] = pe * (dp[t][e] - dlt[e >> 1]);  // dS
      }
    }
    mma_acc_rows<DP, kBlockN / 16>(dq, s, sK);  // dQ += dS K
  };

  if constexpr (kBand) {
    const int q_last = min(q0 + kBlockM, p.Lq) - 1;
    int b0, e0, b1, e1;
    band_key_tiles(band, p.Lk, q0, q_last, kBlockN, b0, e0, b1, e1);
    const int n_tiles = (e0 - b0) + (e1 - b1);
    const int qf_lo = q0 / band.hw, qf_hi = q_last / band.hw;
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = (it < e0 - b0 ? b0 + it : b1 + it - (e0 - b0)) * kBlockN;
      key_tile(n0, band_tile_visible(band, p.Lk, n0, kBlockN, qf_lo, qf_hi));
    }
    if (band.visited != nullptr && threadIdx.x == 0) {
      atomicAdd(band.visited + 1, static_cast<unsigned long long>(n_tiles));
    }
  } else {
    for (int n0 = 0; n0 < p.Lk; n0 += kBlockN) key_tile(n0, false);
  }
  store_rows<DP>(p, static_cast<__nv_bfloat16*>(p.dq), b, h, p.Lq, q0 + wrow, dq, p.scale);
}

// The entry points: K4's take Params only, K4-band's Params and the Band.

// At most 128 registers (4 CTAs per SM): left free, nvcc takes 130 and one
// CTA per SM fewer, which cost 15% (333 against 284 ms at the 7B self shape,
// B=1, on an H100 80GB HBM3 at 700 W). The band forward takes the same cap.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) attn_fwd_lse_bf16(const Params p) {
  fwd_lse_bf16_body<DP, VEC, false>(p, Band{});
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) attn_fwd_lse_bf16_band(const Params p,
                                                                      const Band band) {
  fwd_lse_bf16_body<DP, VEC, true>(p, band);
}

// K1ring under the band: a kernel of its own, so that K3lse's code stays as it was.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) attn_fwd_lse_bf16_ring(const Params p,
                                                                      const Band band) {
  fwd_lse_bf16_body<DP, VEC, true, true>(p, band);
}

// At most 168 registers (3 CTAs per SM): left free, nvcc takes 229 (2 CTAs
// per SM); the cap spills 88 bytes to the stack and still gains 10% (1,511
// against 1,355 ms for the whole backward at the 7B self shape, B=1, on an
// H100 80GB HBM3 at 700 W), with bitwise the same result. The band kernel
// takes the same cap.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 3) attn_bwd_dkdv_bf16(const Params p) {
  bwd_dkdv_bf16_body<DP, VEC, false>(p, Band{});
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 3) attn_bwd_dkdv_bf16_band(const Params p,
                                                                       const Band band) {
  bwd_dkdv_bf16_body<DP, VEC, true>(p, band);
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_bf16(const Params p) {
  bwd_dq_bf16_body<DP, VEC, false>(p, Band{});
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_bf16_band(const Params p,
                                                                  const Band band) {
  bwd_dq_bf16_body<DP, VEC, true>(p, band);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Delta = rowsum(dO * O) in fp32, (B, H, Lq); one warp per (b, row, h).
template <typename T>
__global__ void __launch_bounds__(256) attn_bwd_delta(const Params p) {
  const long long rows = static_cast<long long>(p.B) * p.Lq * p.H;
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
    const int h = static_cast<int>(r % p.H);
    const long long bl = r / p.H;  // b * Lq + row
    const int row = static_cast<int>(bl % p.Lq);
    const int b = static_cast<int>(bl / p.Lq);
    p.delta[(static_cast<long long>(b) * p.H + h) * p.Lq + row] = acc;
  }
}

// ------------------------------- fp32 (CUDA cores) -------------------------------

constexpr int kF32Warps = 8;  // one query (dQ) or key (dK/dV) per warp
constexpr int kF32Tile = 32;  // keys (dQ) or queries (dK/dV) per tile
constexpr int kF32MaxD = 128;

// Stage kF32Tile rows of a and b into sA/sB (row pitch kF32MaxD + 1), zero past L or D.
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

// The f32 kernels take the band too (hw <= 0: full attention): the CTA's 8
// queries (dQ) visit band_key_tiles' 32-key tiles, its 8 keys (dK/dV)
// band_query_tiles' 32-query tiles, and every element is masked.
__global__ void __launch_bounds__(kF32Warps * 32) attn_bwd_dq_f32(const Params p,
                                                                  const Band band) {
  __shared__ float sQ[kF32Warps][kF32MaxD];
  __shared__ float sDO[kF32Warps][kF32MaxD];
  __shared__ float sK[kF32Tile][kF32MaxD + 1];
  __shared__ float sV[kF32Tile][kF32MaxD + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kF32Warps + warp;
  const bool row_ok = row < p.Lq;
  const long long s_l = static_cast<long long>(p.H) * p.D;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const float* q = static_cast<const float*>(p.q) + row_offset(p, b, h, p.Lq, 0);
  const float* dO = static_cast<const float*>(p.dout) + row_offset(p, b, h, p.Lq, 0);
  const float* k = static_cast<const float*>(p.k) + row_offset(p, b, h, p.Lk, 0);
  const float* v = static_cast<const float*>(p.v) + row_offset(p, b, h, p.Lk, 0);
  for (int d = lane; d < kF32MaxD; d += 32) {
    const bool ok = row_ok && d < p.D;
    sQ[warp][d] = ok ? q[static_cast<long long>(row) * s_l + d] : 0.f;
    sDO[warp][d] = ok ? dO[static_cast<long long>(row) * s_l + d] : 0.f;
  }
  const float lse = row_ok ? p.lse[bh * p.Lq + row] : 0.f;
  const float dlt = row_ok ? p.delta[bh * p.Lq + row] : 0.f;
  float acc[kF32MaxD / 32] = {0.f, 0.f, 0.f, 0.f};

  const int q0 = blockIdx.x * kF32Warps;
  int b0, e0, b1, e1;
  band_key_tiles(band, p.Lk, q0, min(q0 + kF32Warps, p.Lq) - 1, kF32Tile, b0, e0, b1, e1);
  const int n_tiles = (e0 - b0) + (e1 - b1);
  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = (it < e0 - b0 ? b0 + it : b1 + it - (e0 - b0)) * kF32Tile;
    __syncthreads();
    load_f32_pair(sK, sV, k, v, s_l, n0, p.Lk, p.D);
    __syncthreads();
    float sc = 0.f, dpj = 0.f;  // lane j: key n0 + j
    for (int d = 0; d < p.D; ++d) {
      sc += sQ[warp][d] * sK[lane][d];
      dpj += sDO[warp][d] * sV[lane][d];
    }
    const bool vis = n0 + lane < p.Lk && band_tokens_visible(band, row, n0 + lane);
    const float pj = vis ? expf(sc * p.scale - lse) : 0.f;
    const float ds = pj * (dpj - dlt);
    for (int j = 0; j < kF32Tile; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < kF32MaxD / 32; ++i) acc[i] += dsj * sK[j][lane + 32 * i];
    }
  }
  if (!row_ok) return;
  float* out = static_cast<float*>(p.dq) + row_offset(p, b, h, p.Lq, row);
#pragma unroll
  for (int i = 0; i < kF32MaxD / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < p.D) out[d] = acc[i] * p.scale;
  }
}

__global__ void __launch_bounds__(kF32Warps * 32) attn_bwd_dkdv_f32(const Params p,
                                                                    const Band band) {
  __shared__ float sK[kF32Warps][kF32MaxD];
  __shared__ float sV[kF32Warps][kF32MaxD];
  __shared__ float sQ[kF32Tile][kF32MaxD + 1];
  __shared__ float sDO[kF32Tile][kF32MaxD + 1];
  __shared__ float sLse[kF32Tile];
  __shared__ float sDelta[kF32Tile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key = blockIdx.x * kF32Warps + warp;
  const bool key_ok = key < p.Lk;
  const long long s_l = static_cast<long long>(p.H) * p.D;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const float* q = static_cast<const float*>(p.q) + row_offset(p, b, h, p.Lq, 0);
  const float* dO = static_cast<const float*>(p.dout) + row_offset(p, b, h, p.Lq, 0);
  const float* k = static_cast<const float*>(p.k) + row_offset(p, b, h, p.Lk, 0);
  const float* v = static_cast<const float*>(p.v) + row_offset(p, b, h, p.Lk, 0);
  for (int d = lane; d < kF32MaxD; d += 32) {
    const bool ok = key_ok && d < p.D;
    sK[warp][d] = ok ? k[static_cast<long long>(key) * s_l + d] : 0.f;
    sV[warp][d] = ok ? v[static_cast<long long>(key) * s_l + d] : 0.f;
  }
  float dk[kF32MaxD / 32] = {0.f, 0.f, 0.f, 0.f};
  float dv[kF32MaxD / 32] = {0.f, 0.f, 0.f, 0.f};

  const int k0 = blockIdx.x * kF32Warps;
  int mb, me;
  band_query_tiles(band, p.Lq, k0, min(k0 + kF32Warps, p.Lk) - 1, kF32Tile, mb, me);
  for (int mt = mb; mt < me; ++mt) {
    const int m0 = mt * kF32Tile;
    __syncthreads();
    load_f32_pair(sQ, sDO, q, dO, s_l, m0, p.Lq, p.D);
    if (threadIdx.x < kF32Tile) {
      const int row = m0 + threadIdx.x;
      sLse[threadIdx.x] = row < p.Lq ? p.lse[bh * p.Lq + row] : 0.f;
      sDelta[threadIdx.x] = row < p.Lq ? p.delta[bh * p.Lq + row] : 0.f;
    }
    __syncthreads();
    float sc = 0.f, dpi = 0.f;  // lane i: query m0 + i
    for (int d = 0; d < p.D; ++d) {
      sc += sQ[lane][d] * sK[warp][d];
      dpi += sDO[lane][d] * sV[warp][d];
    }
    const bool vis = m0 + lane < p.Lq && band_tokens_visible(band, m0 + lane, key);
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
  if (!key_ok) return;
  float* dkrow = static_cast<float*>(p.dk) + row_offset(p, b, h, p.Lk, key);
  float* dvrow = static_cast<float*>(p.dv) + row_offset(p, b, h, p.Lk, key);
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

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Args&... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// hw > 0: the band kernels (K4-band, or K1ring's with ring); else the
// full-attention ones (K4, which is also K1ring's full-attention step)
template <int DP, bool VEC>
cudaError_t fwd_bf16(const Params& p, const Band& band, cudaStream_t s, bool ring = false) {
  const size_t smem = static_cast<size_t>(kBlockM + 2 * kBlockN) * (DP + 8) * sizeof(__nv_bfloat16);
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, p.H, p.B);
  if (band.hw > 0 && ring) return launch(attn_fwd_lse_bf16_ring<DP, VEC>, grid, smem, s, p, band);
  if (band.hw > 0) return launch(attn_fwd_lse_bf16_band<DP, VEC>, grid, smem, s, p, band);
  return launch(attn_fwd_lse_bf16<DP, VEC>, grid, smem, s, p);
}

template <int DP, bool VEC>
cudaError_t bwd_bf16(const Params& p, const Band& band, cudaStream_t s) {
  const size_t pitch = (DP + 8) * sizeof(__nv_bfloat16);
  const size_t smem_dkdv = (2 * kBlockN + 2 * kBlockQ) * pitch + 2 * kBlockQ * sizeof(float);
  const dim3 grid_dkdv((p.Lk + kBlockN - 1) / kBlockN, p.H, p.B);
  cudaError_t err =
      band.hw > 0 ? launch(attn_bwd_dkdv_bf16_band<DP, VEC>, grid_dkdv, smem_dkdv, s, p, band)
                  : launch(attn_bwd_dkdv_bf16<DP, VEC>, grid_dkdv, smem_dkdv, s, p);
  if (err != cudaSuccess) return err;
  const size_t smem_dq = (2 * kBlockM + 2 * kBlockN) * pitch;
  const dim3 grid_dq((p.Lq + kBlockM - 1) / kBlockM, p.H, p.B);
  if (band.hw > 0) return launch(attn_bwd_dq_bf16_band<DP, VEC>, grid_dq, smem_dq, s, p, band);
  return launch(attn_bwd_dq_bf16<DP, VEC>, grid_dq, smem_dq, s, p);
}

bool bad_shape(int B, int Lq, int Lk, int H, int D) {
  return B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D > 128 || H > 65535 ||
         B > 65535;
}

// band: null (full attention) or {hw, window, prefix}, hw > 0
bool bad_band(const int* band) {
  return band != nullptr && (band[0] <= 0 || band[1] < 0 || band[2] < 0);
}

Band make_band(const int* band, void* visited, int q_off = 0, int k_off = 0) {
  Band b;
  b.hw = band != nullptr ? band[0] : 0;
  b.window = band != nullptr ? band[1] : 0;
  b.prefix = band != nullptr ? band[2] : 0;
  b.visited = static_cast<unsigned long long*>(visited);
  b.q_off = q_off;
  b.k_off = k_off;
  return b;
}

// The forward with lse of gen3c_attention_fwd_lse; ring selects K1ring's
// band kernel, which reads the band's offsets.
int fwd_lse(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Lq,
            int Lk, int H, int D, float scale, int bf16, int vec, const Band& bd, bool ring,
            cudaStream_t s) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.D = D;
  p.scale = scale;
  if (!bf16) {  // attention_f32.cu's body (it counts no visited tiles)
    const int band[3] = {bd.hw, bd.window, bd.prefix};
    return gen3c_attention_f32_lse(q, k, v, out, lse, B, Lq, Lk, H, D, scale,
                                   bd.hw > 0 ? band : nullptr, bd.q_off, bd.k_off, s);
  }
  const bool vv = vec != 0;
  if (D <= 32) {
    return static_cast<int>(vv ? fwd_bf16<32, true>(p, bd, s, ring)
                               : fwd_bf16<32, false>(p, bd, s, ring));
  }
  if (D <= 64) {
    return static_cast<int>(vv ? fwd_bf16<64, true>(p, bd, s, ring)
                               : fwd_bf16<64, false>(p, bd, s, ring));
  }
  return static_cast<int>(vv ? fwd_bf16<128, true>(p, bd, s, ring)
                             : fwd_bf16<128, false>(p, bd, s, ring));
}

}  // namespace

// Forward with logsumexp. q (B, Lq, H, D), k/v (B, Lk, H, D), out like q, all
// contiguous; lse (B, H, Lq) fp32. bf16 != 0: bf16 tensors (tensor cores),
// else fp32 (attention_f32.cu, three TF32 products). vec: nonzero when D % 8 == 0 and every tensor is
// 16-byte aligned (bf16 only). band: null for full attention, else {hw,
// window, prefix} (K4-band's forward); visited: null, or one device counter
// that a bf16 band call adds its visited 64-key tiles to. Returns a
// cudaError_t (0 on success).
extern "C" int gen3c_attention_fwd_lse(const void* q, const void* k, const void* v, void* out,
                                       float* lse, int B, int Lq, int Lk, int H, int D,
                                       float scale, int bf16, int vec, const int* band,
                                       void* visited, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D) || bad_band(band)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fwd_lse(q, k, v, out, lse, B, Lq, Lk, H, D, scale, bf16, vec, make_band(band, visited),
                 false, static_cast<cudaStream_t>(stream));
}

// K1ring: one step of ring attention (gen3c_tpu/models/dit.py:597-645, the
// fold of one KV shard into a query shard). The forward with lse of the
// queries, at global sequence positions q_off + i, over the keys of one
// shard, at k_off + j: without a band K4's forward (positions do not
// matter), with one the ring band kernel, whose rows that see no key of the
// shard write out 0 and lse -inf. Arguments otherwise as
// gen3c_attention_fwd_lse. attention_merge.cu folds the (out, lse) into the
// running result.
extern "C" int gen3c_attention_ring_fold(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int B, int Lq, int Lk, int H, int D,
                                         float scale, int bf16, int vec, const int* band,
                                         int q_off, int k_off, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D) || bad_band(band) || q_off < 0 || k_off < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fwd_lse(q, k, v, out, lse, B, Lq, Lk, H, D, scale, bf16, vec,
                 make_band(band, nullptr, q_off, k_off), true, static_cast<cudaStream_t>(stream));
}

// Backward (K4, or K4-band with a band): dq, dk, dv (like q, k, v, contiguous)
// from q, k, v, the forward's out and lse, and dout (like out). delta is (B,
// H, Lq) fp32 scratch. Three launches: Delta, dK/dV, dQ. Arguments as
// gen3c_attention_fwd_lse, but visited is null or two device counters: a bf16
// band call adds the 32-query tiles its dK/dV CTAs visit to [0] and the
// 64-key tiles its dQ CTAs visit to [1].
extern "C" int gen3c_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Lq, int Lk, int H, int D,
                                   float scale, int bf16, int vec, const int* band,
                                   void* visited, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D) || bad_band(band)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Band bd = make_band(band, visited);
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.D = D;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * Lq * H;
  const dim3 delta_grid(static_cast<unsigned>((rows + 7) / 8));
  if (bf16) {
    attn_bwd_delta<__nv_bfloat16><<<delta_grid, 256, 0, s>>>(p);
  } else {
    attn_bwd_delta<float><<<delta_grid, 256, 0, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!bf16) {
    const int threads = kF32Warps * 32;
    attn_bwd_dkdv_f32<<<dim3((Lk + kF32Warps - 1) / kF32Warps, H, B), threads, 0, s>>>(p, bd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_f32<<<dim3((Lq + kF32Warps - 1) / kF32Warps, H, B), threads, 0, s>>>(p, bd);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vv = vec != 0;
  if (D <= 32) {
    return static_cast<int>(vv ? bwd_bf16<32, true>(p, bd, s) : bwd_bf16<32, false>(p, bd, s));
  }
  if (D <= 64) {
    return static_cast<int>(vv ? bwd_bf16<64, true>(p, bd, s) : bwd_bf16<64, false>(p, bd, s));
  }
  return static_cast<int>(vv ? bwd_bf16<128, true>(p, bd, s) : bwd_bf16<128, false>(p, bd, s));
}
