// Non-causal multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gen3c_tpu/models/dit.py::attention_op:
//   K1  splash attention, FullMask, DiT self-attention   (dit.py:445-471)
//   K2  flash attention, causal=False, DiT cross-attention (dit.py:472-510)
//   K3  splash attention with the temporal-band block mask
//       (make_temporal_band_mask, dit.py:370-409, used at :459-460)
// All compute softmax(q.k^T / sqrt(d)) . v per (batch, head) with the
// softmax in fp32; K2 is the Lq != Lk case of the same kernel.
//
// K3's band (hw, window, prefix): query token i sees key token j iff
// |i/hw - j/hw| <= window or j/hw < prefix (frames of hw tokens, t-major
// token order). Like splash's block skipping, a CTA visits only the key
// tiles that can hold a visible key for one of its queries: the union of
// [0, prefix*hw) and [(qf_lo - window)*hw, (qf_hi + window + 1)*hw), with
// the two tile ranges merged where they touch, so no tile is loaded twice.
// Keys are masked per element only in tiles that are not wholly visible
// to every query of the CTA (at the 7B shape, hw = 3,520 = 55 * 64, none).
// At T = 16 frames, window 2, prefix 1 that is 87 of 256 frame pairs.
//
// Layout: q (B, Lq, H, D), k/v (B, Lk, H, D), any element strides for the
// batch, sequence and head axes, unit stride along D; out (B, Lq, H, D)
// contiguous. Lq and Lk are arbitrary (ragged last tiles are masked); any
// D <= 128 is zero-padded to the MMA depth inside the kernel.
//
// The bf16 mma.sync body: the inputs no TMA tensor map describes
// (kernels/cuda.py attention_route; attention_wgmma.cu serves the rest; the
// fp32 forward is attention_f32.cu).
//   attn_fwd_bf16  bf16 in/out, FlashAttention-2 structure: one CTA per
//                  (64-query tile, head, batch), four warps of 16 query
//                  rows each, a loop over 64-key K/V tiles staged in shared
//                  memory, online softmax in fp32 registers, q.k^T and p.v
//                  on the tensor cores with mma.sync m16n8k16 (bf16 in,
//                  fp32 accumulate). The scale is applied to the fp32
//                  logits.
//   attn_fwd_bf16_band  the same restricted to K3's band.
//
// What bounds it: at the GEN3C-7B self-attention shape (L = 56,320, D = 128)
// the work is ~2 * 2 * L^2 * D flop per (batch, head) against ~4 * L * D
// bytes of q/k/v, far above the card's flop:byte ridge, so the tensor-core
// rate is the bound. This body loads tiles synchronously (no cp.async/TMA
// pipeline) and reads MMA operands with plain 32-bit shared loads; the
// TMA + wgmma body (attention_wgmma.cu) serves every input a tensor map
// describes, so this one serves only the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // queries per CTA
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;    // 16 query rows per warp
constexpr int kThreads = kWarps * 32;

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int B, Lq, Lk, H, D;
  float scale;
};

// K3's temporal band, a kernel argument of its own: a larger AttnParams
// changes attn_fwd_bf16's code generation (127 -> 130 registers, one CTA
// per SM fewer, 2.3x slower), so K1 keeps its original parameter struct.
struct Band {
  int hw, window, prefix;        // hw == 0: full attention
  unsigned long long* visited;   // optional: += key tiles visited
};

// Key-tile ranges [b0, e0) and [b1, e1) a CTA with queries
// [q_first, q_last] must visit (the second may be empty).
__device__ __forceinline__ void kv_tile_ranges(const AttnParams& p, const Band& band,
                                               int q_first, int q_last, int tile,
                                               int& b0, int& e0, int& b1, int& e1) {
  const int ntiles = (p.Lk + tile - 1) / tile;
  b0 = 0;
  e0 = ntiles;
  b1 = e1 = 0;
  if (band.hw <= 0) return;
  const long long hw = band.hw;
  const long long qf_lo = q_first / band.hw;
  const long long qf_hi = q_last / band.hw;
  const long long pre_end = min(static_cast<long long>(band.prefix) * hw,
                                static_cast<long long>(p.Lk));
  e0 = static_cast<int>((pre_end + tile - 1) / tile);
  const long long lo = max(0LL, qf_lo - band.window) * hw;
  const long long hi =
      min((qf_hi + band.window + 1) * hw, static_cast<long long>(p.Lk));
  if (lo < hi) {
    b1 = static_cast<int>(lo / tile);
    e1 = static_cast<int>((hi + tile - 1) / tile);
  }
  if (b1 < e1 && b1 <= e0) {  // the ranges touch: one range
    e0 = max(e0, e1);
    b1 = e1 = 0;
  }
}

// True when every key of [n0, n0 + tile) exists and every query of the
// CTA (frames qf_lo..qf_hi) may see it: no per-element mask needed.
__device__ __forceinline__ bool tile_all_visible(const AttnParams& p, const Band& band,
                                                 int n0, int tile, int qf_lo,
                                                 int qf_hi) {
  const long long end = static_cast<long long>(n0) + tile;
  if (end > p.Lk) return false;
  if (band.hw <= 0) return true;
  const long long hw = band.hw;
  if (end <= static_cast<long long>(band.prefix) * hw) return true;
  return static_cast<long long>(n0) >= (qf_hi - band.window) * hw &&
         end <= (static_cast<long long>(qf_lo) + band.window + 1) * hw;
}

// The band mask of one (query frame, key) pair, keys < Lk only.
__device__ __forceinline__ bool key_visible(const AttnParams& p, const Band& band,
                                            int qf, int col) {
  if (col >= p.Lk) return false;
  if (band.hw <= 0) return true;
  const int kf = col / band.hw;
  return kf < band.prefix || abs(qf - kf) <= band.window;
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [row0, row0 + 64) x [0, DP) of one (batch, head) slice into
// shared memory (row pitch DP + 8), zero-filling rows >= L and dims >= D.
template <int DP, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long s_l, int row0, int L,
                                          int D) {
  constexpr int kPitch = DP + 8;
  if (VEC) {  // D % 8 == 0 and 16-byte aligned rows: one uint4 per 8 dims
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < L && c < D) {
        val = *reinterpret_cast<const uint4*>(
            base + static_cast<long long>(row0 + r) * s_l + c);
      }
      *reinterpret_cast<uint4*>(smem + r * kPitch + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < 64 * DP; i += kThreads) {
      const int r = i / DP;
      const int c = i % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row0 + r < L && c < D) {
        val = base[static_cast<long long>(row0 + r) * s_l + c];
      }
      smem[r * kPitch + c] = val;
    }
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_bf16(const AttnParams p) {
  constexpr int kPitch = DP + 8;  // +16 bytes: conflict-free fragment reads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kPitch;
  __nv_bfloat16* sV = sK + kBlockN * kPitch;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int wrow = warp * 16;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<DP, VEC>(sQ, q, p.q_sl, q0, p.Lq, p.D);

  const float scale_log2 = p.scale * 1.4426950408889634f;
  float o[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) {
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int n0 = 0; n0 < p.Lk; n0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP, VEC>(sK, k, p.k_sl, n0, p.Lk, p.D);
    load_tile<DP, VEC>(sV, v, p.v_sl, n0, p.Lk, p.D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + (wrow + g) * kPitch + kk * 16 + tg * 2;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * kPitch),
                             ld_u32(qa + 8), ld_u32(qa + 8 * kPitch + 8)};
#pragma unroll
      for (int t = 0; t < kBlockN / 8; ++t) {
        const __nv_bfloat16* kb = sK + (t * 8 + g) * kPitch + kk * 16 + tg * 2;
        const uint32_t bb[2] = {ld_u32(kb), ld_u32(kb + 8)};
        mma_16816(s[t], a, bb);
      }
    }

    // online softmax: scale the fp32 logits, mask keys >= Lk
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + t * 8 + tg * 2 + (e & 1);
        const float x = col < p.Lk ? s[t][e] * scale_log2 : -INFINITY;
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_run[i] - mx[i]);  // 0 on the first tile
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[t][e] - m_run[e >> 1]);
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

    // O += P V: the accumulator layout of two adjacent key n-tiles is the
    // A-operand layout of one k16 step, so P never leaves registers.
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t a[4] = {pack_f32x2(s[2 * j][0], s[2 * j][1]),
                             pack_f32x2(s[2 * j][2], s[2 * j][3]),
                             pack_f32x2(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_f32x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int t = 0; t < DP / 8; ++t) {
        const __nv_bfloat16* vb = sV + (j * 16 + tg * 2) * kPitch + t * 8 + g;
        const uint32_t bb[2] = {pack_bf16x2(vb[0], vb[kPitch]),
                                pack_bf16x2(vb[8 * kPitch], vb[9 * kPitch])};
        mma_16816(o[t], a, bb);
      }
    }
  }

  // full row sums across the four threads of each row group
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= p.Lq) continue;
    const float inv = 1.f / l_run[i];
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * p.D;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int col = t * 8 + tg * 2;
      if (col < p.D) orow[col] = __float2bfloat16(o[t][2 * i] * inv);
      if (col + 1 < p.D) orow[col + 1] = __float2bfloat16(o[t][2 * i + 1] * inv);
    }
  }
}

// K3: attn_fwd_bf16 restricted to the key tiles of each query tile's band.
// A kernel of its own (not a flag of attn_fwd_bf16), so that K1's code
// generation stays exactly as it was (127 registers, 4 CTAs per SM).
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_bf16_band(const AttnParams p, const Band band) {
  constexpr int kPitch = DP + 8;  // +16 bytes: conflict-free fragment reads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kPitch;
  __nv_bfloat16* sV = sK + kBlockN * kPitch;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int wrow = warp * 16;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<DP, VEC>(sQ, q, p.q_sl, q0, p.Lq, p.D);

  const float scale_log2 = p.scale * 1.4426950408889634f;
  float o[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) {
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  const int q_last = min(q0 + kBlockM, p.Lq) - 1;
  int b0, e0, b1, e1;
  kv_tile_ranges(p, band, q0, q_last, kBlockN, b0, e0, b1, e1);
  const int n_tiles = (e0 - b0) + (e1 - b1);
  const int qf_lo = q0 / band.hw, qf_hi = q_last / band.hw;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = (it < e0 - b0 ? b0 + it : b1 + it - (e0 - b0)) * kBlockN;
    // every key of the tile exists and is visible to every query of the CTA
    const bool all_visible = tile_all_visible(p, band, n0, kBlockN, qf_lo, qf_hi);
    __syncthreads();  // previous tile fully consumed
    load_tile<DP, VEC>(sK, k, p.k_sl, n0, p.Lk, p.D);
    load_tile<DP, VEC>(sV, v, p.v_sl, n0, p.Lk, p.D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + (wrow + g) * kPitch + kk * 16 + tg * 2;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * kPitch),
                             ld_u32(qa + 8), ld_u32(qa + 8 * kPitch + 8)};
#pragma unroll
      for (int t = 0; t < kBlockN / 8; ++t) {
        const __nv_bfloat16* kb = sK + (t * 8 + g) * kPitch + kk * 16 + tg * 2;
        const uint32_t bb[2] = {ld_u32(kb), ld_u32(kb + 8)};
        mma_16816(s[t], a, bb);
      }
    }

    // online softmax: scale the fp32 logits; in a tile that is not wholly
    // visible (ragged end, band boundary), mask keys >= Lk and keys outside
    // a row's band. The branch is uniform across the CTA, so whole tiles
    // pay nothing for the mask.
    float mx[2] = {m_run[0], m_run[1]};
    if (all_visible) {
#pragma unroll
      for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        }
      }
    } else {
      const int qf_row[2] = {(q0 + wrow + g) / band.hw, (q0 + wrow + g + 8) / band.hw};
#pragma unroll
      for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + t * 8 + tg * 2 + (e & 1);
          const float x =
              key_visible(p, band, qf_row[e >> 1], col) ? s[t][e] * scale_log2 : -INFINITY;
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
      // a row may have no visible key yet (max -inf): exponentiate
      // against 0 so that its p and alpha are 0, not NaN
      m_use[i] = mx[i] == -INFINITY ? 0.f : mx[i];
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

    // O += P V: the accumulator layout of two adjacent key n-tiles is the
    // A-operand layout of one k16 step, so P never leaves registers.
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t a[4] = {pack_f32x2(s[2 * j][0], s[2 * j][1]),
                             pack_f32x2(s[2 * j][2], s[2 * j][3]),
                             pack_f32x2(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_f32x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int t = 0; t < DP / 8; ++t) {
        const __nv_bfloat16* vb = sV + (j * 16 + tg * 2) * kPitch + t * 8 + g;
        const uint32_t bb[2] = {pack_bf16x2(vb[0], vb[kPitch]),
                                pack_bf16x2(vb[8 * kPitch], vb[9 * kPitch])};
        mma_16816(o[t], a, bb);
      }
    }
  }
  if (band.visited != nullptr && threadIdx.x == 0) {
    atomicAdd(band.visited, static_cast<unsigned long long>(n_tiles));
  }

  // full row sums across the four threads of each row group
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= p.Lq) continue;
    const float inv = 1.f / l_run[i];
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * p.D;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int col = t * 8 + tg * 2;
      if (col < p.D) orow[col] = __float2bfloat16(o[t][2 * i] * inv);
      if (col + 1 < p.D) orow[col + 1] = __float2bfloat16(o[t][2 * i + 1] * inv);
    }
  }
}

template <int DP, bool VEC>
cudaError_t launch_bf16(const AttnParams& p, const Band& band, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBlockM + 2 * kBlockN) * (DP + 8) *
                      sizeof(__nv_bfloat16);
  const void* kernel = band.hw > 0 ? reinterpret_cast<const void*>(attn_fwd_bf16_band<DP, VEC>)
                                   : reinterpret_cast<const void*>(attn_fwd_bf16<DP, VEC>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, p.H, p.B);
  if (band.hw > 0) {
    attn_fwd_bf16_band<DP, VEC><<<grid, kThreads, smem, stream>>>(p, band);
  } else {
    attn_fwd_bf16<DP, VEC><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_vec(const AttnParams& p, const Band& band, bool vec,
                         cudaStream_t stream) {
  return vec ? launch_bf16<DP, true>(p, band, stream)
             : launch_bf16<DP, false>(p, band, stream);
}

AttnParams make_params(const void* q, const void* k, const void* v, void* o,
                       const long long* strides, int B, int Lq, int Lk, int H,
                       int D, float scale) {
  AttnParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_sl = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_sl = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_sl = strides[7];
  p.v_sh = strides[8];
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.D = D;
  p.scale = scale;
  return p;
}

Band make_band(const int* band, void* visited) {
  Band b;
  b.hw = band != nullptr ? band[0] : 0;
  b.window = band != nullptr ? band[1] : 0;
  b.prefix = band != nullptr ? band[2] : 0;
  b.visited = static_cast<unsigned long long*>(visited);
  return b;
}

bool bad_band(const int* band) {
  return band != nullptr && (band[0] <= 0 || band[1] < 0 || band[2] < 0);
}

}  // namespace

// strides: 9 element strides (batch, seq, head) of q, k, v in that order.
// band: null for full attention, else {hw, window, prefix} (K3).
// visited: null, or a device counter that each CTA of a band call adds its
// visited 64-key tiles to.
// vec: nonzero when D % 8 == 0 and every row start is 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int gen3c_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, const long long* strides, int B,
                                    int Lq, int Lk, int H, int D, float scale,
                                    const int* band, void* visited, int vec,
                                    void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D > 128 ||
      H > 65535 || B > 65535 || bad_band(band)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AttnParams p = make_params(q, k, v, o, strides, B, Lq, Lk, H, D, scale);
  const Band bd = make_band(band, visited);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(dispatch_vec<32>(p, bd, vec != 0, s));
  if (D <= 64) return static_cast<int>(dispatch_vec<64>(p, bd, vec != 0, s));
  return static_cast<int>(dispatch_vec<128>(p, bd, vec != 0, s));
}
