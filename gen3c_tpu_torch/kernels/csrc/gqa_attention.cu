// K8: grouped-query attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the XLA stand-in gen3c_tpu/models/ar_transformer.py::_gqa_attention
// (:252-297) of the Cosmos AR world model: causal GQA of Hq query heads over
// Hkv key/value heads (rep = Hq / Hkv), the logits scaled by 1/sqrt(d), key j
// visible to query i iff kv_start[b] <= j <= offset + i (no offset: every
// key, the T5 cross-attention). In the int8 mode K and V are int8 codes and
// fp32 per-(position, head) scales multiply logit column j and probability
// column j before P.V (:271-296). The softmax runs in fp32; the output is in
// q's dtype. A row that sees no key (a left-pad query) gives 0, where the
// XLA form averages every key: no later layer reads such a row.
//
// What bounds it. Decode (the 4B: one query, 32 x 128 heads over 8 KV heads
// of a 12,800-row cache) moves the visible K and V once: 2 * (pos + 1) * 8 *
// 128 bf16 = 21 MB at pos 5,120, 6.3 us at 3.35 TB/s, with ~8 flop a byte:
// HBM bandwidth, plus a fixed cost (launch, the first tile's latency, the
// split merge) that dominates short caches. Prefill (5,120 queries, causal)
// is 2.15e11 flop a layer against 21 MB: the tensor cores. A bf16 prefill
// whose tensors a TMA map describes runs attention_wgmma.cu's forward (its
// kGqa mode: query head h reads K/V head h / rep, the key tiles past the
// diagonal or before kv_start skipped); this file holds the rest.
//
// gqa_mma<TKV, DP, kDecode>: bf16 queries over bf16 K/V or int8 codes, on
// mma.sync m16n8k16 (bf16 in, fp32 sums). A CTA takes one KV head g of one
// batch row and query rows that are (query, head) pairs among the rep heads
// sharing g, so each K/V tile is read once for all of them. K and V stream in
// their storage type through a ring of kStages 64-key stages filled by
// 16-byte cp.async, two tiles in flight while one is computed (a head's rows
// lie 2 KB apart in the cache, so no bulk copy takes a tile, and a tensor
// map would need encoding per call); int8 codes are converted to bf16 in
// shared memory once a stage (a byte permute and a subtraction a code), the
// scales riding in the same stage. Q stays in registers as the A fragments,
// K's and V's B fragments come by ldmatrix (.trans for V), P stays in
// registers.
//   decode (rows = Lq * rep <= 16, one m16 tile): the four warps share the
//   16 rows and take 16 keys each of every stage, merged through shared
//   memory at the end. The keys the rows see are cut into `splits` ranges,
//   a CTA each; `splits` follows the cache's capacity and the SM count
//   (kernels/cuda.py gqa_plan), never the position, so the grid is the same
//   at every step, and a split past the visible keys writes lse = -inf and
//   zeros. Each CTA writes its (o, lse) to scratch, and the last CTA of its
//   (b, g) to take a ticket (an atomic counter it resets) rescales and sums
//   the splits, in split order, into the output: one launch a layer, the
//   same bits at every call. Queries on M (the m16 tile padded past rep * Lq
//   rows) keep P's accumulator layout the A operand of P.V, no transpose;
//   the padded rows cost tensor-core work the bandwidth leaves idle.
//   prefill (more rows): four warps of 16 rows a CTA, each over every key
//   its rows see, one split, the CTAs with the most keys first: the int8
//   prefill, and a bf16 one no TMA map describes.
// gqa_f32: fp32 queries (ar_tiny with TF32 off, the card-against-CPU check)
// over fp32 K/V or int8 codes, on the CUDA cores: 32-key tiles in fp32
// shared memory, four warps of RW rows, one split.
//
// Layout: q (B, Lq, Hq, d), k/v (B, Lk, Hkv, d), scales (B, Lk, Hkv, 1), any
// element strides for the batch, sequence and head axes, unit stride along
// d <= 128 (zero-padded to DP = 32, 64 or 128 in shared memory); out (B, Lq,
// Hq, d) contiguous. vec: 16-byte K/V copies (every row of K and V 16-byte
// aligned, d a multiple of 16 bytes), else element loads.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.h"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;        // gqa_mma: keys a stage
constexpr int kStages = 3;       // gqa_mma's ring: two CTAs an SM
constexpr int kMergeBatch = 16;  // splits whose partials the last CTA loads at once
constexpr int kDecodeRows = 16;  // gqa_mma: rows of the decode body (one m16 tile)
constexpr int kF32Keys = 32;     // gqa_f32: keys a tile, one a lane
constexpr float kLog2e = 1.4426950408889634f;

struct GqaParams {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;      // null unless int8
  const float* v_scale;
  const long long* kv_start;  // (B,) or null
  void* out;
  float* part_o;    // decode, splits > 1: (B * Hkv, splits, rows, DP)
  float* part_lse;  // (B * Hkv, splits, rows), log2 units
  int* ticket;      // (B * Hkv,), 0 between launches
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

// The first key row b sees.
__device__ __forceinline__ int first_key(const GqaParams& p, int b) {
  if (p.kv_start == nullptr) return 0;
  return static_cast<int>(min(max(p.kv_start[b], 0LL), static_cast<long long>(p.kv_end)));
}

// ------------------------------------ gqa_mma -------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}


// c (+)= a b: m16n8k16, bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// The shared memory of gqa_mma. A stage holds K's and V's 64 rows in their
// storage type, each row DP elements + 16 bytes (ldmatrix and the int8
// converter read conflict-free), then the 64 k and 64 v scales (int8). int8
// also has one bf16 tile pair, the converter's output.
template <typename TKV, int DP>
struct MmaSmem {
  static constexpr bool kInt8 = sizeof(TKV) == 1;
  static constexpr int kPitch = DP * static_cast<int>(sizeof(TKV)) + 16;  // a stored row
  static constexpr int kBfPitch = 2 * DP + 16;                            // a bf16 row
  static constexpr int kTile = kKeys * kPitch;
  static constexpr int kStage = 2 * kTile + (kInt8 ? 2 * kKeys * 4 : 0);
  static constexpr int kCvt = kInt8 ? 2 * kKeys * kBfPitch : 0;
  static constexpr int kMergePitch = DP + 8;  // floats a row of the decode's warp merge
  static constexpr int kMerge = kWarps * kDecodeRows * (kMergePitch + 2) * 4;
  static constexpr int kBytes =
      kStages * kStage + kCvt > kMerge ? kStages * kStage + kCvt : kMerge;
};

// Copies of keys [kb, kb + kKeys) of K, V (and their scales) into a stage:
// rows at or past k_end, and dims at or past D, zero.
template <typename TKV, int DP>
__device__ __forceinline__ void load_stage(unsigned char* st, const GqaParams& p, const TKV* kbase,
                                           const TKV* vbase, const float* ksb, const float* vsb,
                                           int kb, int k_end) {
  using S = MmaSmem<TKV, DP>;
  unsigned char* sk = st;
  unsigned char* sv = st + S::kTile;
  if (p.vec) {
    constexpr int kChunks = DP * static_cast<int>(sizeof(TKV)) / 16;
    const int d_bytes = p.D * static_cast<int>(sizeof(TKV));
    for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int j = kb + r;
      const bool in = j < k_end && c * 16 < d_bytes;
      const long long jj = in ? j : 0;
      cp_async_16(sk + r * S::kPitch + c * 16,
                  reinterpret_cast<const unsigned char*>(kbase + jj * p.k_l) + (in ? c * 16 : 0),
                  in ? 16 : 0);
      cp_async_16(sv + r * S::kPitch + c * 16,
                  reinterpret_cast<const unsigned char*>(vbase + jj * p.v_l) + (in ? c * 16 : 0),
                  in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const int j = kb + r;
      TKV x = TKV(), y = TKV();  // zero
      if (j < k_end && c < p.D) {
        x = kbase[j * p.k_l + c];
        y = vbase[j * p.v_l + c];
      }
      reinterpret_cast<TKV*>(sk + r * S::kPitch)[c] = x;
      reinterpret_cast<TKV*>(sv + r * S::kPitch)[c] = y;
    }
  }
  if constexpr (S::kInt8) {
    float* sks = reinterpret_cast<float*>(st + 2 * S::kTile);
    for (int r = threadIdx.x; r < kKeys; r += kThreads) {
      const int j = kb + r;
      const bool in = j < k_end;
      cp_async_4(sks + r, ksb + (in ? j * p.ks_l : 0), in ? 4 : 0);
      cp_async_4(sks + kKeys + r, vsb + (in ? j * p.vs_l : 0), in ? 4 : 0);
    }
  }
}

// Four int8 codes (a word) -> two words of two bf16, exactly: a code plus
// 128 is the low byte of the float 2^23 + code + 128 (one byte permute and
// one subtraction a code, where an int-to-float conversion runs at a quarter
// of the rate).
__device__ __forceinline__ uint2 codes_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) - 8388736.f;
  }
  return make_uint2(pack2(f[0], f[1]), pack2(f[2], f[3]));
}

// A stage's int8 K and V codes -> the bf16 tile pair (codes are exact in bf16).
template <int DP>
__device__ __forceinline__ void convert_stage(const unsigned char* st, unsigned char* cvt) {
  using S = MmaSmem<int8_t, DP>;
  constexpr int kChunks = DP / 8;  // 8 codes a chunk
  for (int i = threadIdx.x; i < 2 * kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;  // r: K's rows, then V's
    const uint2 raw = *reinterpret_cast<const uint2*>(st + r * S::kPitch + c * 8);
    const uint2 lo = codes_to_bf16(raw.x), hi = codes_to_bf16(raw.y);
    *reinterpret_cast<uint4*>(cvt + r * S::kBfPitch + c * 16) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// Query rows of a CTA: row r of (b, g) is query r / rep of head g * rep + r % rep.
// The decode's four warps share its 16 rows and take 16 keys each of every
// stage (their partials merged through shared memory at the end); the
// prefill's take 16 rows each and every key.
template <typename TKV, int DP, bool kDecode>
__global__ void __launch_bounds__(kThreads) gqa_mma(const GqaParams p) {
  using S = MmaSmem<TKV, DP>;
  constexpr int kNt = kDecode ? 2 : kKeys / 8;  // 8-key n-tiles a warp takes of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* cvt = smem + kStages * S::kStage;

  const int bg = blockIdx.y;
  const int b = bg / p.Hkv, g = bg % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const int rows = p.Lq * rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;
  // prefill: the CTAs with the most keys (the last rows) first
  const int row0 = kDecode ? 0 : (gridDim.x - 1 - blockIdx.x) * (kWarps * 16);
  const int wrow0 = kDecode ? 0 : row0 + warp * 16;  // this warp's first row
  const int kofs = kDecode ? warp * 16 : 0;          // and first key of a stage
  const int split = kDecode ? blockIdx.x : 0;

  // the keys this CTA takes: its rows' visible range, cut to its split
  const int lo = first_key(p, b);
  int hi = p.kv_end;
  if (!kDecode && p.causal) hi = min(hi, p.offset + (min(row0 + kWarps * 16, rows) - 1) / rep + 1);
  const int len = max(hi - lo, 0);
  const int per = (len + p.splits - 1) / p.splits;
  const int k_begin = lo + min(split * per, len);
  const int k_end = min(k_begin + per, hi);
  const int n_tiles = (max(k_end - k_begin, 0) + kKeys - 1) / kKeys;

  const TKV* kbase = static_cast<const TKV*>(p.k) + b * p.k_b + g * p.k_h;
  const TKV* vbase = static_cast<const TKV*>(p.v) + b * p.v_b + g * p.v_h;
  const float* ksb = p.k_scale != nullptr ? p.k_scale + b * p.ks_b + g * p.ks_h : nullptr;
  const float* vsb = p.v_scale != nullptr ? p.v_scale + b * p.vs_b + g * p.vs_h : nullptr;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      load_stage<TKV, DP>(smem + t * S::kStage, p, kbase, vbase, ksb, vsb, k_begin + t * kKeys,
                          k_end);
    }
    cp_async_commit();
  }

  // Q as the A fragments of every k16 step; the last key each row sees
  uint32_t qa[DP / 16][4];
  int row_hi[2];
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = wrow0 + gr + 8 * h2;
    const bool real = r < rows;
    const int i = r / rep, h = g * rep + r % rep;
    row_hi[h2] = !real ? -1 : (p.causal ? p.offset + i : INT_MAX);
    const __nv_bfloat16* qrow = q + b * p.q_b + static_cast<long long>(i) * p.q_l + h * p.q_h;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 16 * kk + 8 * half + 2 * tg;
        const uint32_t lo16 = real && d < p.D ? bf16_bits(qrow[d]) : 0u;
        const uint32_t hi16 = real && d + 1 < p.D ? bf16_bits(qrow[d + 1]) : 0u;
        qa[kk][h2 + 2 * half] = lo16 | (hi16 << 16);
      }
    }
  }
  // the last key every real row of this warp sees (its first row's)
  const int warp_hi = p.causal ? p.offset + wrow0 / rep : INT_MAX;

  float o[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows gr and gr + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    {
      const int nt = it + kStages - 1;
      if (nt < n_tiles) {
        load_stage<TKV, DP>(smem + (nt % kStages) * S::kStage, p, kbase, vbase, ksb, vsb,
                            k_begin + nt * kKeys, k_end);
      }
      cp_async_commit();
    }
    const unsigned char* st = smem + (it % kStages) * S::kStage;
    const float* sks = reinterpret_cast<const float*>(st + 2 * S::kTile);
    uint32_t k_at, v_at;
    constexpr int kP = S::kInt8 ? S::kBfPitch : S::kPitch;  // bf16 rows the products read
    if constexpr (S::kInt8) {
      convert_stage<DP>(st, cvt);
      __syncthreads();
      k_at = smem_u32(cvt);
      v_at = k_at + kKeys * S::kBfPitch;
    } else {
      k_at = smem_u32(st);
      v_at = k_at + S::kTile;
    }
    const int kb = k_begin + it * kKeys + kofs;  // the key of this warp's column 0

    // S = Q K^T: 16 rows x kNt * 8 keys
    float s[kNt][4];
#pragma unroll
    for (int t = 0; t < kNt; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    const uint32_t k_lane =
        k_at + (kofs + ((lane >> 4) << 3) + (lane & 7)) * kP + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int t2 = 0; t2 < kNt / 2; ++t2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_lane + t2 * 16 * kP + kk * 32);
        mma_bf16(s[2 * t2], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * t2 + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // online softmax: scale (k scale) and mask the fp32 logits; a tile
    // every real row of the warp sees whole skips the mask
    float mx[2] = {m_run[0], m_run[1]};
    const bool whole = kb + kNt * 8 <= k_end && kb + kNt * 8 - 1 <= warp_hi;
#pragma unroll
    for (int t = 0; t < kNt; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kofs + 8 * t + 2 * tg + (e & 1);  // the key's row in the stage
        const int j = kb - kofs + c;
        const float ks = S::kInt8 ? sks[c] * p.scale_log2 : p.scale_log2;
        const float x =
            (whole || (j < k_end && j <= row_hi[e >> 1])) ? s[t][e] * ks : -INFINITY;
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no visible key yet (max -inf) exponentiates against 0,
      // so that its p and alpha are 0, not NaN
      m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      const float alpha = exp2f(m_run[r] - m_use[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha;
#pragma unroll
      for (int t = 0; t < DP / 8; ++t) {
        o[t][2 * r] *= alpha;
        o[t][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int t = 0; t < kNt; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[t][e] - m_use[e >> 1]);
        l_run[e >> 1] += pe;
        // the v scale multiplies the probability, not the row sum
        s[t][e] = S::kInt8 ? pe * sks[kKeys + kofs + 8 * t + 2 * tg + (e & 1)] : pe;
      }
    }

    // O += P V: two adjacent key n-tiles of P are the A fragment of one k16 step
    const uint32_t v_lane =
        v_at + (kofs + ((lane >> 3) & 1) * 8 + (lane & 7)) * kP + (lane >> 4) * 16;
#pragma unroll
    for (int j = 0; j < kNt / 2; ++j) {
      const uint32_t pa[4] = {pack2(s[2 * j][0], s[2 * j][1]),
                              pack2(s[2 * j][2], s[2 * j][3]),
                              pack2(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int t2 = 0; t2 < DP / 16; ++t2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_lane + j * 16 * kP + t2 * 32);
        mma_bf16(o[2 * t2], pa, bv[0], bv[1]);
        mma_bf16(o[2 * t2 + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  if constexpr (!kDecode) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow0 + gr + 8 * r;
      if (row >= rows) continue;
      const int i = row / rep, h = g * rep + row % rep;
      // a row that sees no key has l_run 0: out 0
      const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
      __nv_bfloat16* orow = out + ((static_cast<long long>(b) * p.Lq + i) * p.Hq + h) * p.D;
#pragma unroll
      for (int t = 0; t < DP / 8; ++t) {
        const int col = 8 * t + 2 * tg;
        if (col < p.D) orow[col] = __float2bfloat16(o[t][2 * r] * inv);
        if (col + 1 < p.D) orow[col + 1] = __float2bfloat16(o[t][2 * r + 1] * inv);
      }
    }
    return;
  }

  // decode: merge the four warps' rows (each saw 16 keys of every tile)
  // through shared memory, rows kMergePitch floats apart (float2 stores
  // without bank conflicts)
  __syncthreads();  // the ring is free
  constexpr int kMP = S::kMergePitch;
  float* sm_o = reinterpret_cast<float*>(smem);                // [warp][16][kMP]
  float* sm_m = sm_o + kWarps * kDecodeRows * kMP;              // [warp][16]
  float* sm_l = sm_m + kWarps * kDecodeRows;                    // [warp][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gr + 8 * r;
    float* orow = sm_o + (warp * kDecodeRows + row) * kMP;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      *reinterpret_cast<float2*>(orow + 8 * t + 2 * tg) = make_float2(o[t][2 * r], o[t][2 * r + 1]);
    }
    if (tg == 0) {
      sm_m[warp * kDecodeRows + row] = m_run[r];
      sm_l[warp * kDecodeRows + row] = l_run[r];
    }
  }
  __syncthreads();
  const long long bgs = static_cast<long long>(bg) * p.splits + split;
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kDecodeRows + r]);
    float l = 0.f, acc = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = exp2f(sm_m[w * kDecodeRows + r] - mx);
        l += wt * sm_l[w * kDecodeRows + r];
        acc += wt * sm_o[(w * kDecodeRows + r) * kMP + c];
      }
    }
    const float val = l > 0.f ? acc / l : 0.f;
    if (p.splits > 1) {
      p.part_o[(bgs * rows + r) * DP + c] = val;
      if (c == 0) p.part_lse[bgs * rows + r] = l > 0.f ? mx + log2f(l) : -INFINITY;
    } else if (c < p.D) {
      const int i = r / rep, h = g * rep + r % rep;
      out[((static_cast<long long>(b) * p.Lq + i) * p.Hq + h) * p.D + c] = __float2bfloat16(val);
    }
  }
  if (p.splits == 1) return;

  // the last split of (b, g) to finish merges them all: a ticket taken
  // after the CTA's stores (the fence is cumulative over the barrier)
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.ticket + bg, 1) == p.splits - 1;
    if (last) p.ticket[bg] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a thread four columns of a row: kMergeBatch splits' (lse, o) loaded at
  // once, then folded in with a running max (empty splits: lse -inf, o 0)
  const float* lse = p.part_lse + static_cast<long long>(bg) * p.splits * rows;
  const float4* po = reinterpret_cast<const float4*>(p.part_o) +
                     static_cast<long long>(bg) * p.splits * rows * (DP / 4);
  for (int e = threadIdx.x; e < rows * (DP / 4); e += kThreads) {
    const int r = e / (DP / 4), c = 4 * (e % (DP / 4));
    float m = -INFINITY, wsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < p.splits; s0 += kMergeBatch) {
      float ls[kMergeBatch];
      float4 x[kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const int s = s0 + i;
        const bool in = s < p.splits;
        ls[i] = in ? __ldcg(lse + s * rows + r) : -INFINITY;
        x[i] = in ? __ldcg(po + static_cast<long long>(s) * rows * (DP / 4) + e)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mb = m;
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) mb = fmaxf(mb, ls[i]);
      if (mb == -INFINITY) continue;
      const float scale = exp2f(m - mb);
      wsum *= scale;
      acc.x *= scale;
      acc.y *= scale;
      acc.z *= scale;
      acc.w *= scale;
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const float w = exp2f(ls[i] - mb);
        wsum += w;
        acc.x = fmaf(w, x[i].x, acc.x);
        acc.y = fmaf(w, x[i].y, acc.y);
        acc.z = fmaf(w, x[i].z, acc.z);
        acc.w = fmaf(w, x[i].w, acc.w);
      }
      m = mb;
    }
    const int i = r / rep, h = g * rep + r % rep;
    __nv_bfloat16* orow = out + ((static_cast<long long>(b) * p.Lq + i) * p.Hq + h) * p.D;
    const float inv = wsum > 0.f ? 1.f / wsum : 0.f;
    const float v4[4] = {acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c + k < p.D) orow[c + k] = __float2bfloat16(v4[k]);
    }
  }
}

// ------------------------------------ gqa_f32 -------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

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

// Rows [j0, j0 + kF32Keys) of one head of K or V (row stride s_l) into dst
// as fp32, row stride DP + 4; rows at or past j1 and columns at or past D 0.
template <typename T, int DP>
__device__ __forceinline__ void load_f32_tile(float* dst, const T* base, long long s_l, int j0,
                                              int j1, int D) {
  constexpr int SK = DP + 4;
  for (int idx = threadIdx.x; idx < kF32Keys * DP; idx += kThreads) {
    const int r = idx / DP, col = idx % DP;
    const int j = j0 + r;
    dst[r * SK + col] = (j < j1 && col < D) ? to_f32(base[j * s_l + col]) : 0.f;
  }
}

template <int RW, int DP>
constexpr int f32_smem_floats() {
  return (kWarps * RW + 2 * kF32Keys) * (DP + 4) + kWarps * RW * kF32Keys + 2 * kF32Keys;
}

// A CTA: one KV head g of one batch row, kWarps * RW query rows, every key
// they see in tiles of kF32Keys (one a lane): S by float4 dots from shared
// memory, the online softmax by warp shuffles, O += P V with d / 32 columns
// a lane.
template <typename TKV, int RW, int DP>
__global__ void __launch_bounds__(kThreads) gqa_f32(const GqaParams p) {
  extern __shared__ float4 smem4[];
  constexpr int SK = DP + 4;
  constexpr int R = kWarps * RW;  // query rows a CTA
  constexpr int C = DP / 32;      // output columns a lane
  float* sQ = reinterpret_cast<float*>(smem4);  // [R][SK]
  float* sK = sQ + R * SK;                      // [kF32Keys][SK]
  float* sV = sK + kF32Keys * SK;               // [kF32Keys][SK]
  float* sP = sV + kF32Keys * SK;               // [R][kF32Keys]
  float* sKs = sP + R * kF32Keys;               // [kF32Keys]
  float* sVs = sKs + kF32Keys;                  // [kF32Keys]

  const int b = blockIdx.y / p.Hkv, g = blockIdx.y % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const int rows = p.Lq * rep;
  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int lo = first_key(p, b);
  int hi = p.kv_end;
  if (p.causal) hi = min(hi, p.offset + (min(row0 + R, rows) - 1) / rep + 1);

  const float* q = static_cast<const float*>(p.q);
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, col = idx % DP;
    const int grow = row0 + r;
    float val = 0.f;
    if (grow < rows && col < p.D) {
      const int i = grow / rep, h = g * rep + grow % rep;
      val = q[b * p.q_b + i * p.q_l + h * p.q_h + col];
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
  for (int kb = lo; kb < hi; kb += kF32Keys) {
    const int kn = min(kb + kF32Keys, hi);
    load_f32_tile<TKV, DP>(sK, kbase, p.k_l, kb, kn, p.D);
    load_f32_tile<TKV, DP>(sV, vbase, p.v_l, kb, kn, p.D);
    if (threadIdx.x < kF32Keys) {
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
      sP[(warp * RW + r) * kF32Keys + lane] = pj * vscale;
    }
    __syncwarp();
    const int nk = kn - kb;
    for (int jj = 0; jj < nk; ++jj) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = sV[jj * SK + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pp = sP[(warp * RW + r) * kF32Keys + jj];
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
    float* o = static_cast<float*>(p.out) + ((static_cast<long long>(b) * p.Lq + i) * p.Hq + h) * p.D;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < p.D) o[col] = acc[r][c] * inv;
    }
  }
}

// ------------------------------------- host ---------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename TKV, int DP>
cudaError_t launch_mma(const GqaParams& p, cudaStream_t stream) {
  constexpr int bytes = MmaSmem<TKV, DP>::kBytes;
  const int rows = p.Lq * (p.Hq / p.Hkv);
  static bool ready = false;  // the attributes, once a process (one card)
  cudaError_t err;
  if (!ready) {
    if ((err = prepare(gqa_mma<TKV, DP, true>, bytes)) != cudaSuccess) return err;
    if ((err = prepare(gqa_mma<TKV, DP, false>, bytes)) != cudaSuccess) return err;
    ready = true;
  }
  if (rows <= kDecodeRows) {
    gqa_mma<TKV, DP, true><<<dim3(p.splits, p.B * p.Hkv), kThreads, bytes, stream>>>(p);
  } else {
    if (p.splits != 1) return cudaErrorInvalidValue;
    gqa_mma<TKV, DP, false><<<dim3((rows + kWarps * 16 - 1) / (kWarps * 16), p.B * p.Hkv),
                              kThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename TKV, int RW, int DP>
cudaError_t launch_f32(const GqaParams& p, cudaStream_t stream) {
  constexpr int bytes = f32_smem_floats<RW, DP>() * 4;
  auto kernel = gqa_f32<TKV, RW, DP>;
  static bool ready = false;
  cudaError_t err;
  if (!ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int rows = p.Lq * (p.Hq / p.Hkv);
  kernel<<<dim3((rows + kWarps * RW - 1) / (kWarps * RW), p.B * p.Hkv), kThreads, bytes,
           stream>>>(p);
  return cudaGetLastError();
}

template <typename TKV, int RW>
cudaError_t f32_by_dp(const GqaParams& p, cudaStream_t s) {
  if (p.D <= 32) return launch_f32<TKV, RW, 32>(p, s);
  if (p.D <= 64) return launch_f32<TKV, RW, 64>(p, s);
  return launch_f32<TKV, RW, 128>(p, s);
}

template <typename TKV>
cudaError_t mma_by_dp(const GqaParams& p, cudaStream_t s) {
  if (p.D <= 32) return launch_mma<TKV, 32>(p, s);
  if (p.D <= 64) return launch_mma<TKV, 64>(p, s);
  return launch_mma<TKV, 128>(p, s);
}

}  // namespace

// The words of a call's plan (kernels/cuda.py ``gqa_plan_words``, cached per
// shape, layout and stream): 15 element strides (batch, sequence, head) of
// q, k, v, k_scale, v_scale; B, Lq, Lk, Hq, Hkv, D; splits; q_bf16; kv_int8;
// vec; the scratch part_o, part_lse and ticket (device pointers, 0 unless
// splits > 1).
constexpr int kPlanWords = 28;

extern "C" int gen3c_gqa_plan_words() { return kPlanWords; }

// q, k, v, out as above; k_scale / v_scale null or fp32 (B, Lk, Hkv, 1) with
// int8 k/v; kv_start null or (B,) int64 on the card. causal_offset < 0: no
// causal mask. kv_end: keys at or past it are seen by no query (min(Lk,
// offset + Lq) when causal). bf16 q: gqa_mma (decode when Lq * rep <= 16,
// with `splits` ranges, else the prefill body with one); fp32 q: gqa_f32
// (splits 1). Returns a cudaError_t (0 on success).
extern "C" int gen3c_gqa_attention(const void* q, const void* k, const void* v,
                                   const float* k_scale, const float* v_scale,
                                   const long long* kv_start, void* out, const long long* plan,
                                   int causal_offset, int kv_end, void* stream) {
  GqaParams p;
  p.q_b = plan[0], p.q_l = plan[1], p.q_h = plan[2];
  p.k_b = plan[3], p.k_l = plan[4], p.k_h = plan[5];
  p.v_b = plan[6], p.v_l = plan[7], p.v_h = plan[8];
  p.ks_b = plan[9], p.ks_l = plan[10], p.ks_h = plan[11];
  p.vs_b = plan[12], p.vs_l = plan[13], p.vs_h = plan[14];
  p.B = static_cast<int>(plan[15]), p.Lq = static_cast<int>(plan[16]);
  p.Lk = static_cast<int>(plan[17]), p.Hq = static_cast<int>(plan[18]);
  p.Hkv = static_cast<int>(plan[19]), p.D = static_cast<int>(plan[20]);
  p.splits = static_cast<int>(plan[21]);
  const bool q_bf16 = plan[22] != 0, kv_int8 = plan[23] != 0;
  p.vec = static_cast<int>(plan[24]);
  p.part_o = reinterpret_cast<float*>(plan[25]);
  p.part_lse = reinterpret_cast<float*>(plan[26]);
  p.ticket = reinterpret_cast<int*>(plan[27]);
  if (p.B <= 0 || p.Lq <= 0 || p.Lk <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.D <= 0 ||
      p.D > 128 || p.splits <= 0 || kv_end < 0 || kv_end > p.Lk ||
      (p.splits > 1 && (p.part_o == nullptr || p.part_lse == nullptr || p.ticket == nullptr ||
                        !q_bf16)) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) || p.B * p.Hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = kv_int8 ? k_scale : nullptr;
  p.v_scale = kv_int8 ? v_scale : nullptr;
  p.kv_start = kv_start;
  p.out = out;
  p.causal = causal_offset >= 0;
  p.offset = causal_offset >= 0 ? causal_offset : 0;
  p.kv_end = kv_end;
  p.scale_log2 = kLog2e / sqrtf(static_cast<float>(p.D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = kv_int8 ? mma_by_dp<int8_t>(p, s) : mma_by_dp<__nv_bfloat16>(p, s);
  } else {
    const bool decode = p.Lq * (p.Hq / p.Hkv) <= kDecodeRows;
    if (kv_int8) {
      err = decode ? f32_by_dp<int8_t, 1>(p, s) : f32_by_dp<int8_t, 8>(p, s);
    } else {
      err = decode ? f32_by_dp<float, 1>(p, s) : f32_by_dp<float, 8>(p, s);
    }
  }
  return static_cast<int>(err);
}
