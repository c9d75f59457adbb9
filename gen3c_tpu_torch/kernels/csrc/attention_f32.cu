// fp32 attention forward for Hopper (sm_90a) on the tensor cores, as three
// TF32 products ("3xTF32").
//
// Replaces, for fp32 inputs, the XLA attention of gen3c_tpu:
//   K1vit  gen3c_tpu/aux/moge.py:159-173 (_attn): MoGe ViT-L's self-attention,
//          (1, 1,351, 16, 64) at a 704x1280 frame, 24 launches a MoGe call;
//   and the fp32 forwards of K1, K2 and K3 (gen3c_tpu/models/dit.py:445-510,
//   attention_op's XLA path; K3's band, :370-409): the fp32 tiny preset;
//   with the row logsumexp, the fp32 forward that K4's backward needs and
//   K1ring's fp32 step (dit.py:597-645, a query shard over one KV shard at
//   global offsets): attention_bwd.cu's gen3c_attention_fwd_lse and
//   gen3c_attention_ring_fold launch this body for fp32 inputs.
// softmax(q.k^T / sqrt(d)) . v per (batch, head), the softmax in fp32.
//
// What bounds it: at MoGe's shape 4 L^2 D H = 7.48 GFLOP against 5.5 MB of
// q, k, v and out: 0.112 ms at the card's 67 TF/s of fp32 on the CUDA
// cores, 0.045 ms as three TF32 products at 495 TF/s, 0.002 ms of bytes.
// One TF32 product (10 mantissa bits) errs by ~2^-11 a term and misses the
// fp32 tolerance (1e-4); three TF32 products of each operand's split (x =
// big + small, hopper.h) err by ~2^-21, near fp32's own rounding.
//
// The design. A CTA takes 64 queries of one (batch, head): one warpgroup of
// 128 threads, wgmma's M. It loads its queries once into registers, split,
// as the register A operand of every S = Q K^T step. It walks tiles of 32
// keys (with the band, only the tiles the band reaches: band.h): each raw K
// and V tile arrives by cp.async into a ring of two stages, issued two tiles
// ahead; one split pass writes the tile's parts in the layouts the products
// read:
//   K  big and small, K-major (dims contiguous) in the 128-byte swizzle, 32
//      dims a 128-byte row, DP / 32 such halves: S's B operand;
//   V  big and small transposed, V^T K-major (keys contiguous): TF32 wgmma
//      has no transposed B, so P V's B operand is V^T, one 128-byte row of
//      32 keys per dim.
// S (m64n32) = Qs Kb + Qb Ks + Qb Kb, then the online softmax in fp32
// registers (the scale on the fp32 logits, log2 units), then O (m64nDP) +=
// Ps Vb + Pb Vs + Pb Vb with P, split in registers, as the register A
// operand. S's accumulator holds keys 2 tg and 2 tg + 1 of each 8-key block
// where the A fragment wants columns tg and tg + 4, so the A fragment takes
// them as they lie (column tg <- key 2 tg, column tg + 4 <- key 2 tg + 1)
// and the split pass writes V^T's keys in the same order: within each 8-key
// block, position p holds key 2 p (p < 4) or 2 (p - 4) + 1.
// Shared memory: the parts (2 x 32 x DP x 4 bytes of K, the same of V^T) and
// the ring (2 x 2 raw tiles of 32 rows, DP + 4 floats a row: a row offset of
// 4 banks keeps the split pass's reads free of bank conflicts): 68,608
// bytes at DP = 64, so three CTAs share an SM and MoGe's 22 x 16 = 352
// CTAs run in one wave on 132 SMs.
//
// Layout: q (B, Lq, H, D), k/v (B, Lk, H, D), any element strides for the
// batch, sequence and head axes, unit stride along D (MoGe's q, k, v are
// views of one qkv projection, rows of 3,072 floats); out (B, Lq, H, D)
// contiguous. Lq and Lk are arbitrary (ragged tiles are zero-filled and
// masked); D <= 128 is zero-padded to DP = 32, 64 or 128. VEC: 16-byte
// copies (D % 4 == 0 and 16-byte aligned rows), else 4-byte copies.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.h"

namespace {

using namespace hopper;

#include "band.h"

constexpr int kRows = 64;     // queries per CTA: wgmma's M
constexpr int kKeys = 32;     // keys per tile: one 128-byte row of V^T
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, H, Lq), natural log; null: not written
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int Lq, Lk, H, D;
  float scale;
};

template <int DP>
struct F32Smem {
  static constexpr int kPitch = DP + 4;         // floats a raw row
  static constexpr int kRaw = kKeys * kPitch;   // floats of one raw K or V tile
  static constexpr int kKHalf = kKeys * 128;    // bytes: 32 keys x 32 dims of K
  static constexpr int kK = (DP / 32) * kKHalf; // bytes of K's big (or small) part
  static constexpr int kVT = DP * 128;          // bytes of V^T's big (or small) part
  static constexpr int kBytes = 1024 + 2 * kK + 2 * kVT + kStages * 2 * kRaw * 4;
};

// Rows [n0, n0 + kKeys) x [0, DP) of one (batch, head) slice into a raw
// tile (rows of DP + 4 floats) by cp.async, zero-filling rows >= L and dims
// >= D.
template <int DP, bool VEC>
__device__ __forceinline__ void load_raw(float* dst, const float* base, long long s_l, int n0,
                                         int L, int D) {
  if (VEC) {
    constexpr int kChunks = DP / 4;
    for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks, c = 4 * (i % kChunks);
      const bool ok = n0 + r < L && c < D;
      cp_async_16(dst + r * (DP + 4) + c, ok ? base + (n0 + r) * s_l + c : base, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool ok = n0 + r < L && c < D;
      cp_async_4(dst + r * (DP + 4) + c, ok ? base + (n0 + r) * s_l + c : base, ok ? 4 : 0);
    }
  }
}

// The split pass of K: each 16-byte chunk (4 dims) of a raw row to the same
// chunk of the K-major parts. Eight neighbouring threads take one row's
// eight chunks of a half: conflict-free reads, and the swizzle spreads
// their writes over all banks.
template <int DP>
__device__ __forceinline__ void split_k(const float* raw, unsigned char* big,
                                        unsigned char* small) {
  constexpr int kChunks = DP / 4;
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * (DP + 4) + 4 * c);
    uint4 b, s;
    tf32_split(x.x, b.x, s.x);
    tf32_split(x.y, b.y, s.y);
    tf32_split(x.z, b.z, s.z);
    tf32_split(x.w, b.w, s.w);
    const int off = (c / 8) * (kKeys * 128) + r * 128 + (((c % 8) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(big + off) = b;
    *reinterpret_cast<uint4*>(small + off) = s;
  }
}

// The split pass of V, transposed: lane r takes key r (a warp the whole
// tile's keys at four dims), so each 4-byte write of a warp lands in one
// V^T row at 32 distinct banks. Key r sits at position (r & ~7) | ((r & 7)
// >> 1) | ((r & 1) << 2) of its row: the order of the file's note.
template <int DP>
__device__ __forceinline__ void split_v(const float* raw, unsigned char* big,
                                        unsigned char* small) {
  constexpr int kChunks = DP / 4;
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int r = i % kKeys, c = i / kKeys;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * (DP + 4) + 4 * c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const int pos = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      const int off = d * 128 + (((pos >> 2) ^ (d & 7)) << 4) + ((pos & 3) << 2);
      uint32_t b, s;
      tf32_split(xs[e], b, s);
      *reinterpret_cast<uint32_t*>(big + off) = b;
      *reinterpret_cast<uint32_t*>(small + off) = s;
    }
  }
}

template <int DP>
__device__ __forceinline__ void wgmma_tf32_o(float (&o)[DP / 2], const uint32_t (&a)[4],
                                             uint64_t desc) {
  if constexpr (DP == 32) {
    wgmma_tf32_n32(o, a, desc, 1);
  } else if constexpr (DP == 64) {
    wgmma_tf32_n64(o, a, desc, 1);
  } else {
    wgmma_tf32_n128(o, a, desc, 1);
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 3 : 1)
    attn_fwd_tf32x3(const F32Params p, const Band band) {
  using S = F32Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* sKb = smem;
  unsigned char* sKs = sKb + S::kK;
  unsigned char* sVb = sKs + S::kK;
  unsigned char* sVs = sVb + S::kVT;
  float* ring = reinterpret_cast<float*>(sVs + S::kVT);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;

  // the band sees queries and keys at their global positions: q_off + i
  // and k_off + j (0 outside a ring step)
  const int q_last = min(q0 + kRows, p.Lq) - 1;
  int b0, e0, b1, e1;
  band_key_tiles(band, p.Lk, band.q_off + q0, band.q_off + q_last, kKeys, b0, e0, b1, e1,
                 band.k_off);
  const int n_tiles = (e0 - b0) + (e1 - b1);
  const int hw = max(band.hw, 1);
  const int qf_lo = (band.q_off + q0) / hw, qf_hi = (band.q_off + q_last) / hw;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int qf_row[2] = {(band.q_off + row0) / hw, (band.q_off + row0 + 8) / hw};

  // tile `it` into stage it % kStages; past the last tile an empty group,
  // so that every thread always has two groups in flight to wait on
  auto load_tile = [&](int it) {
    if (it < n_tiles) {
      const int n0 = (it < e0 - b0 ? b0 + it : b1 + it - (e0 - b0)) * kKeys;
      float* stage = ring + (it % kStages) * 2 * S::kRaw;
      load_raw<DP, VEC>(stage, k, p.k_sl, n0, p.Lk, p.D);
      load_raw<DP, VEC>(stage + S::kRaw, v, p.v_sl, n0, p.Lk, p.D);
    }
    cp_async_commit();
  };
  load_tile(0);
  load_tile(1);

  // Q's A fragments, split: step kk holds dims 8 kk + tg (+ 4), rows row0 (+ 8)
  uint32_t qb[DP / 8][4], qs[DP / 8][4];
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e & 1);
      const int col = 8 * kk + tg + 4 * (e >> 1);
      const float x = row < p.Lq && col < p.D ? q[row * p.q_sl + col] : 0.f;
      tf32_split(x, qb[kk][e], qs[kk][e]);
    }
  }

  const float scale_log2 = p.scale * kLog2e;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows row0 and row0 + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = (it < e0 - b0 ? b0 + it : b1 + it - (e0 - b0)) * kKeys;
    cp_async_wait<kStages - 1>();  // this thread's copies of tile `it` landed
    __syncthreads();               // everyone's; and the last tile's products are done
    const float* stage = ring + (it % kStages) * 2 * S::kRaw;
    split_k<DP>(stage, sKb, sKs);
    split_v<DP>(stage + S::kRaw, sVb, sVs);
    fence_proxy_async();
    __syncthreads();  // the parts are complete, the stage is free
    load_tile(it + kStages);

    // S = Q K^T: 64 rows x 32 keys
    float sc[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    const uint32_t kb = opaque(smem_u32(sKb)), ks = smem_u32(sKs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t off = (kk / 4) * S::kKHalf + (kk % 4) * 32;
      const uint64_t db = wgmma_desc(kb + off, 16, 1024), ds = wgmma_desc(ks + off, 16, 1024);
      wgmma_tf32_n32(sc, qs[kk], db, kk > 0);
      wgmma_tf32_n32(sc, qb[kk], ds, 1);
      wgmma_tf32_n32(sc, qb[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax: scale the fp32 logits; a tile that is not wholly
    // visible to the CTA's rows (the ragged end, a band edge) masks per
    // element (a branch uniform across the CTA)
    float mx[2] = {m_run[0], m_run[1]};
    if (band_tile_visible(band, p.Lk, n0, kKeys, qf_lo, qf_hi, band.k_off)) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        sc[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int col = n0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        const bool vis = col < p.Lk && (band.hw <= 0 || band_frames_visible(
                                                             band, qf_row[(i >> 1) & 1],
                                                             (band.k_off + col) / hw));
        sc[i] = vis ? sc[i] * scale_log2 : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no visible key yet (max -inf) exponentiates against 0,
      // so that its p and alpha are 0, not NaN
      m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m_run[r] - m_use[r]);  // 0 on the first tile
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const float pe = exp2f(sc[i] - m_use[(i >> 1) & 1]);
      sc[i] = pe;
      l_run[(i >> 1) & 1] += pe;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: step kk's A fragment takes keys 8 kk + 2 tg (column tg) and
    // 8 kk + 2 tg + 1 (column tg + 4) of rows row0 and row0 + 8
    uint32_t pb[kKeys / 8][4], ps[kKeys / 8][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const float x[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1], sc[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(x[e], pb[kk][e], ps[kk][e]);
    }
    const uint32_t vb = opaque(smem_u32(sVb)), vs = smem_u32(sVs);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const uint64_t db = wgmma_desc(vb + kk * 32, 16, 1024),
                     ds = wgmma_desc(vs + kk * 32, 16, 1024);
      wgmma_tf32_o<DP>(o, ps[kk], db);
      wgmma_tf32_o<DP>(o, pb[kk], ds);
      wgmma_tf32_o<DP>(o, pb[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();
  if (band.visited != nullptr && threadIdx.x == 0) {
    atomicAdd(band.visited, static_cast<unsigned long long>(n_tiles));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // a row that saw no key (a ring step's shard the band hides) writes out 0
  // and lse -inf (log 0 - inf), no NaN
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Lq) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    if (p.lse != nullptr && tg == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row] = m_run[r] * kLn2 + logf(l_run[r]);
    }
    float* orow = p.o + ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tg + c;
        if (col < p.D) orow[col] = o[4 * j + 2 * r + c] * inv;
      }
    }
  }
}

template <int DP, bool VEC>
cudaError_t launch(const F32Params& p, const Band& band, int B, cudaStream_t stream) {
  auto kernel = attn_fwd_tf32x3<DP, VEC>;
  const int smem = F32Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kRows - 1) / kRows, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p, band);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch(const F32Params& p, const Band& band, int B, bool vec, cudaStream_t s) {
  return vec ? launch<DP, true>(p, band, B, s) : launch<DP, false>(p, band, B, s);
}

// Validates the arguments of both entries, then launches.
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        const long long* strides, int B, int Lq, int Lk, int H, int D, float scale,
        const int* band, int q_off, int k_off, void* visited, bool vec, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D > 128 || H > 65535 || B > 65535 ||
      (band != nullptr && (band[0] <= 0 || band[1] < 0 || band[2] < 0)) || q_off < 0 ||
      k_off < 0 || (vec && D % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  F32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.q_sb = strides[0];
  p.q_sl = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_sl = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_sl = strides[7];
  p.v_sh = strides[8];
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.D = D;
  p.scale = scale;
  Band bd;
  bd.hw = band != nullptr ? band[0] : 0;
  bd.window = band != nullptr ? band[1] : 0;
  bd.prefix = band != nullptr ? band[2] : 0;
  bd.visited = static_cast<unsigned long long*>(visited);
  bd.q_off = q_off;
  bd.k_off = k_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(dispatch<32>(p, bd, B, vec, s));
  if (D <= 64) return static_cast<int>(dispatch<64>(p, bd, B, vec, s));
  return static_cast<int>(dispatch<128>(p, bd, B, vec, s));
}

}  // namespace

// The dynamic shared memory attn_fwd_tf32x3 asks for at DP = dp (32, 64,
// 128), or -1.
extern "C" int gen3c_attention_f32_smem(int dp) {
  return dp == 32 ? F32Smem<32>::kBytes
                  : dp == 64 ? F32Smem<64>::kBytes : dp == 128 ? F32Smem<128>::kBytes : -1;
}

// strides: 9 element strides (batch, seq, head) of q, k, v in that order.
// band: null for full attention, else {hw, window, prefix} (K3). visited:
// null, or a device counter that each CTA adds its visited 32-key tiles to.
// vec: nonzero when D % 4 == 0 and every row start is 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int gen3c_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int Lq, int Lk, int H, int D,
                                   float scale, const int* band, void* visited, int vec,
                                   void* stream) {
  return run(q, k, v, o, nullptr, strides, B, Lq, Lk, H, D, scale, band, 0, 0, visited, vec != 0,
             stream);
}

// The forward with the row logsumexp, for attention_bwd.cu's fp32 entries
// (K4's forward, K4-band's under a band, K1ring's step at global offsets
// q_off, k_off): q (B, Lq, H, D), k/v (B, Lk, H, D), out like q, all
// contiguous; lse (B, H, Lq) fp32, natural log. A row that sees no key
// writes out 0 and lse -inf. Returns a cudaError_t (0 on success).
extern "C" int gen3c_attention_f32_lse(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int Lq, int Lk, int H, int D,
                                       float scale, const int* band, int q_off, int k_off,
                                       void* stream) {
  const long long row = static_cast<long long>(H) * D;
  const long long strides[9] = {Lq * row, row, D, Lk * row, row, D, Lk * row, row, D};
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                  reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  return run(q, k, v, o, lse, strides, B, Lq, Lk, H, D, scale, band, q_off, k_off, nullptr, vec,
             stream);
}
