// Non-causal multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gen3c_tpu/models/dit.py::attention_op:
//   K1  splash attention, FullMask, DiT self-attention   (dit.py:445-471)
//   K2  flash attention, causal=False, DiT cross-attention (dit.py:472-510)
// Both compute softmax(q.k^T / sqrt(d)) . v per (batch, head) with the
// softmax in fp32; K2 is the Lq != Lk case of the same kernel.
//
// Layout: q (B, Lq, H, D), k/v (B, Lk, H, D), any element strides for the
// batch, sequence and head axes, unit stride along D; out (B, Lq, H, D)
// contiguous. Lq and Lk are arbitrary (ragged last tiles are masked); any
// D <= 128 is zero-padded to the MMA depth inside the kernel.
//
// Two kernels:
//   attn_fwd_bf16  bf16 in/out, FlashAttention-2 structure: one CTA per
//                  (64-query tile, head, batch), four warps of 16 query
//                  rows each, a loop over 64-key K/V tiles staged in shared
//                  memory, online softmax in fp32 registers, q.k^T and p.v
//                  on the tensor cores with mma.sync m16n8k16 (bf16 in,
//                  fp32 accumulate). The scale is applied to the fp32
//                  logits.
//   attn_fwd_f32   fp32 in/out on the CUDA cores (one warp per query, 32-key
//                  tiles), for the fp32 tiny preset: bf16 or TF32 tensor-core
//                  products would not hold the fp32 tolerance.
//
// What bounds it: at the GEN3C-7B self-attention shape (L = 56,320, D = 128)
// the work is ~2 * 2 * L^2 * D flop per (batch, head) against ~4 * L * D
// bytes of q/k/v, far above the card's flop:byte ridge, so the tensor-core
// rate is the bound. This first version loads tiles synchronously (no
// cp.async/TMA pipeline) and reads MMA operands with plain 32-bit shared
// loads instead of ldmatrix; WGMMA, TMA and warp specialisation are left to
// later work.

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

constexpr int kF32Warps = 8;  // one query per warp
constexpr int kF32Keys = 32;  // keys per tile: one per lane
constexpr int kF32MaxD = 128;

__global__ void __launch_bounds__(kF32Warps * 32)
    attn_fwd_f32(const AttnParams p) {
  __shared__ float sQ[kF32Warps][kF32MaxD];
  __shared__ float sK[kF32Keys][kF32MaxD + 1];  // +1: lane-per-key reads
  __shared__ float sV[kF32Keys][kF32MaxD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kF32Warps + warp;
  const bool row_ok = row < p.Lq;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int d = lane; d < kF32MaxD; d += 32) {
    sQ[warp][d] =
        (row_ok && d < p.D) ? q[static_cast<long long>(row) * p.q_sl + d] : 0.f;
  }
  float acc[kF32MaxD / 32] = {0.f, 0.f, 0.f, 0.f};  // dims lane + 32 i
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int n0 = 0; n0 < p.Lk; n0 += kF32Keys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Keys * kF32MaxD; i += kF32Warps * 32) {
      const int r = i / kF32MaxD;
      const int c = i % kF32MaxD;
      const bool ok = n0 + r < p.Lk && c < p.D;
      sK[r][c] = ok ? k[static_cast<long long>(n0 + r) * p.k_sl + c] : 0.f;
      sV[r][c] = ok ? v[static_cast<long long>(n0 + r) * p.v_sl + c] : 0.f;
    }
    __syncthreads();

    float sc = 0.f;  // lane j scores key n0 + j
    for (int d = 0; d < p.D; ++d) sc += sQ[warp][d] * sK[lane][d];
    sc = (n0 + lane < p.Lk) ? sc * p.scale : -INFINITY;
    float mx = sc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    const float pj = expf(sc - m_new);
    float psum = pj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    }
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < kF32MaxD / 32; ++i) acc[i] *= alpha;
    for (int j = 0; j < kF32Keys; ++j) {
      const float pjj = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
      for (int i = 0; i < kF32MaxD / 32; ++i) acc[i] += pjj * sV[j][lane + 32 * i];
    }
  }
  if (!row_ok) return;
  float* orow = static_cast<float*>(p.o) +
                ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * p.D;
#pragma unroll
  for (int i = 0; i < kF32MaxD / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < p.D) orow[d] = acc[i] / l_run;
  }
}

template <int DP, bool VEC>
cudaError_t launch_bf16(const AttnParams& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBlockM + 2 * kBlockN) * (DP + 8) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<DP, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, p.H, p.B);
  attn_fwd_bf16<DP, VEC><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_vec(const AttnParams& p, bool vec, cudaStream_t stream) {
  return vec ? launch_bf16<DP, true>(p, stream) : launch_bf16<DP, false>(p, stream);
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

}  // namespace

// strides: 9 element strides (batch, seq, head) of q, k, v in that order.
// vec: nonzero when D % 8 == 0 and every row start is 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int gen3c_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, const long long* strides, int B,
                                    int Lq, int Lk, int H, int D, float scale,
                                    int vec, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D > 128 ||
      H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AttnParams p = make_params(q, k, v, o, strides, B, Lq, Lk, H, D, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(dispatch_vec<32>(p, vec != 0, s));
  if (D <= 64) return static_cast<int>(dispatch_vec<64>(p, vec != 0, s));
  return static_cast<int>(dispatch_vec<128>(p, vec != 0, s));
}

extern "C" int gen3c_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, const long long* strides, int B,
                                   int Lq, int Lk, int H, int D, float scale,
                                   void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D > kF32MaxD ||
      H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AttnParams p = make_params(q, k, v, o, strides, B, Lq, Lk, H, D, scale);
  const dim3 grid((Lq + kF32Warps - 1) / kF32Warps, H, B);
  attn_fwd_f32<<<grid, kF32Warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
