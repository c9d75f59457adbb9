// K8: grouped-query attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the XLA stand-in gen3c_tpu/models/ar_transformer.py::_gqa_attention
// (:252-297) of the Cosmos AR world model: causal GQA of Hq query heads over
// Hkv key/value heads (Hq % Hkv == 0), the logits scaled by 1/sqrt(d), key j
// visible to query i iff kv_start[b] <= j <= offset + i (no offset: every
// key, the T5 cross-attention). In the int8 mode K and V are int8 codes and
// fp32 per-(position, head) scales multiply logit column j and probability
// column j before P.V (:271-296). The softmax runs in fp32; the output is in
// q's dtype. A row that sees no key (a left-pad query) gives 0, where the
// XLA form averages every key: no later layer reads such a row.
//
// What bounds it. Decode (one query, the 4B's 32 x 128 heads over 8 KV heads
// of a 12,800-row cache) moves the visible K and V once: 2 * pos * 8 * 128
// bf16 = 21 MB at pos 5,120, 6.3 us at 3.35 TB/s, with ~8 flop a byte: HBM
// bandwidth. The XLA form instead repeats K and V to 32 heads and reads the
// whole masked cache. Prefill (5,120 queries causal) is 2.15e11 flop a layer
// against 21 MB: compute.
//
// The design. A CTA takes one KV head g of one batch row, a tile of R query
// rows (each row a (query, head) pair among the rep = Hq / Hkv heads that
// share g, so K and V are read once for all of them and never repeated), and
// one split of the keys the rows can see: [kv_start, min(Lk, offset + last
// query + 1)), never the masked tail of the cache. Four warps of RW rows
// each; keys in tiles of 32, one key a lane: each tile of K and V is read
// from the cache in place (16-byte loads where the rows allow, int8 codes
// converted in registers) into fp32 shared memory, then
//   S: lane j forms q_r . k_j for its warp's rows (float4 dots from shared
//      memory; the query rows are broadcast, K rows padded by 4 floats so a
//      quarter-warp's float4 reads hit distinct banks);
//   online softmax per row in the log2 domain, max and sum over the warp by
//      shuffles, the v scale folded into the probability;
//   O += P V: each lane owns d / 32 columns of every row of its warp.
// Decode has only B * Hkv = 8 (b, g) pairs, so the wrapper splits the keys
// over enough CTAs to fill the card (about four a SM); each split writes its
// normalised partial output and log2-sum-exp, and gqa_merge rescales and sums
// them (the rescale-and-sum of attention_merge.cu, over all splits at once).
// Prefill takes RW = 8 (32 rows a CTA) and one split. CUDA cores, no tensor
// cores: simple and right first.
//
// Layout: q (B, Lq, Hq, d), k/v (B, Lk, Hkv, d), scales (B, Lk, Hkv, 1), any
// element strides for the batch, sequence and head axes, unit stride along
// d <= 128 (zero-padded to DP = 32, 64 or 128 in shared memory); out (B, Lq,
// Hq, d) contiguous. vec: 16-byte K/V loads (every row of K and V 16-byte
// aligned, d a multiple of 16 bytes), else element loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;  // keys a tile: one a lane
constexpr float kLog2e = 1.4426950408889634f;

struct GqaParams {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // null unless int8
  const float* v_scale;
  const int* kv_start;   // (B,) or null
  void* out;
  float* part_o;    // (splits, B, Lq, Hq, d) when splits > 1
  float* part_lse;  // (splits, B, Lq, Hq), log2 units
  long long q_b, q_l, q_h;
  long long k_b, k_l, k_h;
  long long v_b, v_l, v_h;
  long long ks_b, ks_l, ks_h;
  long long vs_b, vs_l, vs_h;
  int B, Lq, Lk, Hq, Hkv, D;
  int causal;  // 1: key j visible to query i iff j <= offset + i
  int offset;
  int kv_end;  // no query sees a key at or past kv_end
  int splits;
  int vec;
  float scale_log2;  // log2(e) / sqrt(d)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of T at src -> 16 / sizeof(T) floats at dst (both 16-byte aligned)
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* src, float* dst) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [j0, j0 + kKeys) of one head of K or V (row stride s_l) into dst as
// fp32, row stride DP + 4; rows at or past j1 and columns at or past D are 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long s_l, int j0,
                                          int j1, int D, int vec) {
  constexpr int SK = DP + 4;
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    constexpr int chunks = DP / E;
    for (int idx = threadIdx.x; idx < kKeys * chunks; idx += kThreads) {
      const int r = idx / chunks, col = (idx % chunks) * E;
      float* d = dst + r * SK + col;
      const int j = j0 + r;
      if (j < j1 && col < D) {
        load16(base + j * s_l + col, d);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) d[e] = 0.f;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kKeys * DP; idx += kThreads) {
      const int r = idx / DP, col = idx % DP;
      const int j = j0 + r;
      dst[r * SK + col] = (j < j1 && col < D) ? to_f32(base[j * s_l + col]) : 0.f;
    }
  }
}

template <int RW, int DP>
constexpr int smem_floats() {
  return (kWarps * RW + 2 * kKeys) * (DP + 4) + kWarps * RW * kKeys + 2 * kKeys;
}

template <typename TQ, typename TKV, int RW, int DP>
__global__ void __launch_bounds__(kThreads) gqa_attn(const GqaParams p) {
  extern __shared__ float4 smem4[];
  constexpr int SK = DP + 4;
  constexpr int R = kWarps * RW;  // query rows a CTA
  constexpr int C = DP / 32;      // output columns a lane
  float* sQ = reinterpret_cast<float*>(smem4);  // [R][SK]
  float* sK = sQ + R * SK;                      // [kKeys][SK]
  float* sV = sK + kKeys * SK;                  // [kKeys][SK]
  float* sP = sV + kKeys * SK;                  // [R][kKeys]
  float* sKs = sP + R * kKeys;                  // [kKeys]
  float* sVs = sKs + kKeys;                     // [kKeys]

  const int split = blockIdx.x;
  const int b = blockIdx.y / p.Hkv, g = blockIdx.y % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const int rows = p.Lq * rep;
  const int row0 = blockIdx.z * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the keys this CTA's rows can see, cut to this split
  const int lo = p.kv_start != nullptr ? max(p.kv_start[b], 0) : 0;
  int hi = p.kv_end;
  if (p.causal) hi = min(hi, p.offset + (min(row0 + R, rows) - 1) / rep + 1);
  const int len = max(hi - lo, 0);
  const int per = (len + p.splits - 1) / p.splits;
  const int k_begin = lo + split * per;
  const int k_end = min(k_begin + per, hi);

  const TQ* q = static_cast<const TQ*>(p.q);
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, col = idx % DP;
    const int grow = row0 + r;
    float val = 0.f;
    if (grow < rows && col < p.D) {
      const int i = grow / rep, h = g * rep + grow % rep;
      val = to_f32(q[b * p.q_b + i * p.q_l + h * p.q_h + col]);
    }
    sQ[r * SK + col] = val;
  }

  float m[RW], l[RW], acc[RW][C];
  int row_hi[RW];  // the last key row r sees (lo - 1: none)
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int grow = row0 + warp * RW + r;
    const int i = grow / rep;
    row_hi[r] = grow >= rows ? lo - 1 : (p.causal ? min(p.offset + i, p.kv_end - 1) : p.kv_end - 1);
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const TKV* kbase = static_cast<const TKV*>(p.k) + b * p.k_b + g * p.k_h;
  const TKV* vbase = static_cast<const TKV*>(p.v) + b * p.v_b + g * p.v_h;
  __syncthreads();
  for (int kb = k_begin; kb < k_end; kb += kKeys) {
    const int kn = min(kb + kKeys, k_end);
    load_tile<TKV, DP>(sK, kbase, p.k_l, kb, kn, p.D, p.vec);
    load_tile<TKV, DP>(sV, vbase, p.v_l, kb, kn, p.D, p.vec);
    if (threadIdx.x < kKeys) {
      const int j = kb + threadIdx.x;
      const bool in = j < kn && p.k_scale != nullptr;
      sKs[threadIdx.x] = in ? p.k_scale[b * p.ks_b + j * p.ks_l + g * p.ks_h] : 1.f;
      sVs[threadIdx.x] = in ? p.v_scale[b * p.vs_b + j * p.vs_l + g * p.vs_h] : 1.f;
    }
    __syncthreads();

    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float* krow = sK + lane * SK;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (warp * RW + r) * SK + c);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int j = kb + lane;
    const float kscale = sKs[lane] * p.scale_log2;
    const float vscale = sVs[lane];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float x = (j < kn && j <= row_hi[r]) ? s[r] * kscale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float pj = m_new == -INFINITY ? 0.f : exp2f(x - m_new);
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pj);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
      sP[(warp * RW + r) * kKeys + lane] = pj * vscale;
    }
    __syncwarp();
    const int nk = kn - kb;
    for (int jj = 0; jj < nk; ++jj) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = sV[jj * SK + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pp = sP[(warp * RW + r) * kKeys + jj];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(pp, vv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int grow = row0 + warp * RW + r;
    if (grow >= rows) continue;
    const int i = grow / rep, h = g * rep + grow % rep;
    const long long orow = (static_cast<long long>(b) * p.Lq + i) * p.Hq + h;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if (p.splits == 1) {
      TQ* o = static_cast<TQ*>(p.out) + orow * p.D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col < p.D) store(o + col, acc[r][c] * inv);
      }
    } else {
      const long long prow = static_cast<long long>(split) * p.B * p.Lq * p.Hq + orow;
      float* o = p.part_o + prow * p.D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col < p.D) o[col] = acc[r][c] * inv;
      }
      if (lane == 0) p.part_lse[prow] = l[r] > 0.f ? m[r] + log2f(l[r]) : -INFINITY;
    }
  }
}

// One warp a row (b, i, h): rescale the splits' partial outputs by
// 2^(lse_s - max) and sum, normalised; a row no split saw gives 0.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    gqa_merge(const float* part_o, const float* part_lse, TQ* out, int splits, long long rows,
              int D) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_lse[s * rows + row]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float wsum = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ls = part_lse[s * rows + row];
      if (ls == -INFINITY) continue;
      const float w = exp2f(ls - mx);
      wsum += w;
      const float* o = part_o + (s * rows + row) * D;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = lane + 32 * c;
        if (col < D) acc[c] = fmaf(w, o[col], acc[c]);
      }
    }
  }
  const float inv = wsum > 0.f ? 1.f / wsum : 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = lane + 32 * c;
    if (col < D) store(out + row * D + col, acc[c] * inv);
  }
}

template <typename TQ, typename TKV, int RW, int DP>
cudaError_t launch(const GqaParams& p, int row_tiles, cudaStream_t stream) {
  constexpr int bytes = smem_floats<RW, DP>() * 4;
  auto kernel = gqa_attn<TQ, TKV, RW, DP>;
  static bool attribute_set = false;  // once a process (one card)
  cudaError_t err;
  if (!attribute_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  kernel<<<dim3(p.splits, p.B * p.Hkv, row_tiles), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long rows = static_cast<long long>(p.B) * p.Lq * p.Hq;
  gqa_merge<TQ><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      p.part_o, p.part_lse, static_cast<TQ*>(p.out), p.splits, rows, p.D);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int RW>
cudaError_t by_dp(const GqaParams& p, int row_tiles, cudaStream_t s) {
  if (p.D <= 32) return launch<TQ, TKV, RW, 32>(p, row_tiles, s);
  if (p.D <= 64) return launch<TQ, TKV, RW, 64>(p, row_tiles, s);
  return launch<TQ, TKV, RW, 128>(p, row_tiles, s);
}

template <typename TQ, typename TKV>
cudaError_t by_rw(const GqaParams& p, int rw, cudaStream_t s) {
  const int rows = p.Lq * (p.Hq / p.Hkv);
  if (rw == 1) return by_dp<TQ, TKV, 1>(p, (rows + kWarps - 1) / kWarps, s);
  return by_dp<TQ, TKV, 8>(p, (rows + kWarps * 8 - 1) / (kWarps * 8), s);
}

}  // namespace

// q, k, v, out as above; k_scale / v_scale null or fp32 (B, Lk, Hkv, 1) with
// int8 k/v; kv_start null or (B,) int32 on the card. strides: 15 element
// strides (batch, sequence, head) of q, k, v, k_scale, v_scale. causal_offset
// < 0: no causal mask. kv_end: keys at or past it are seen by no query
// (min(Lk, offset + Lq) when causal). splits > 1 needs part_o (splits, B, Lq,
// Hq, D) and part_lse (splits, B, Lq, Hq) fp32 scratch. q_bf16: q and out
// bf16 (else fp32); kv_int8: k/v int8 codes (else q's dtype). rows_per_warp:
// 1 (decode) or 8. Returns a cudaError_t (0 on success).
extern "C" int gen3c_gqa_attention(const void* q, const void* k, const void* v,
                                   const float* k_scale, const float* v_scale,
                                   const int* kv_start, void* out, float* part_o,
                                   float* part_lse, const long long* strides, int B, int Lq,
                                   int Lk, int Hq, int Hkv, int D, int causal_offset, int kv_end,
                                   int splits, int q_bf16, int kv_int8, int rows_per_warp,
                                   int vec, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 128 ||
      splits <= 0 || (splits > 1 && (part_o == nullptr || part_lse == nullptr)) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (rows_per_warp != 1 && rows_per_warp != 8) || B * Hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GqaParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = kv_int8 ? k_scale : nullptr;
  p.v_scale = kv_int8 ? v_scale : nullptr;
  p.kv_start = kv_start;
  p.out = out;
  p.part_o = part_o;
  p.part_lse = part_lse;
  p.q_b = strides[0], p.q_l = strides[1], p.q_h = strides[2];
  p.k_b = strides[3], p.k_l = strides[4], p.k_h = strides[5];
  p.v_b = strides[6], p.v_l = strides[7], p.v_h = strides[8];
  p.ks_b = strides[9], p.ks_l = strides[10], p.ks_h = strides[11];
  p.vs_b = strides[12], p.vs_l = strides[13], p.vs_h = strides[14];
  p.B = B, p.Lq = Lq, p.Lk = Lk, p.Hq = Hq, p.Hkv = Hkv, p.D = D;
  p.causal = causal_offset >= 0;
  p.offset = causal_offset >= 0 ? causal_offset : 0;
  p.kv_end = kv_end;
  p.splits = splits;
  p.vec = vec;
  p.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = kv_int8 ? by_rw<__nv_bfloat16, int8_t>(p, rows_per_warp, s)
                  : by_rw<__nv_bfloat16, __nv_bfloat16>(p, rows_per_warp, s);
  } else {
    err = kv_int8 ? by_rw<float, int8_t>(p, rows_per_warp, s)
                  : by_rw<float, float>(p, rows_per_warp, s);
  }
  return static_cast<int>(err);
}
