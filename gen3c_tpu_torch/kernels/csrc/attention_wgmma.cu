// Attention forward and backward for Hopper (sm_90a) on wgmma and TMA.
//
// One forward body and one backward pair for every bf16 entry whose tensors a
// TMA tensor map can describe (kernels/cuda.py ``attention_route``: head dim a
// multiple of 8 up to 128, 16-byte aligned base and strides). They replace,
// for those inputs, the mma.sync bodies of attention.cu and attention_bwd.cu,
// which stay for the rest. P2, K1's tile sweep, is this forward built at
// other points of its shape (the forward's constants below):
//   attn_fwd_wgmma<DP, kBand, kLse, kGqa>  K1, K2, K1cp, K1ag (no band, no
//       lse), K3 and K1cp under the band (band), the training forward of K4
//       and K1ring's full-attention step (lse), K3lse and K1ring under the
//       band (band and lse), K8's bf16 prefill (kGqa: see GqaMask; with lse
//       the training forward whose backward is gqa_attention_bwd.cu's K8bwd). The TPU
//       kernels: gen3c_tpu/models/dit.py:445-471 (splash), :472-510 (flash),
//       :459-460 (the temporal band), :653-678 (Ulysses), the XLA ring fold
//       (:529) and gen3c_tpu/models/ar_transformer.py:252 (K8). Every entry
//       instantiates this one body, so their bit-for-bit relations hold by
//       construction: the output with lse is the output without it, and a
//       band whose window covers every frame visits every tile, unmasked, in
//       order: K1's bits.
//   attn_bwd_dkdv_wgmma / attn_bwd_dq_wgmma <DP, kBand, kGqa>  K4 and K4-band,
//       the splash / flash VJPs (dit.py:464-470, :508), two kernels that each
//       own their output rows: no atomics, deterministic bits, and the
//       full-window band gives K4's bits; kGqa: K8bwd in bf16, the gradient
//       of K8 (ar_transformer.py:252, reached from
//       gen3c_tpu/training/ar_train.py:52), with K8's mask and head map (see
//       GqaMask, GqaBwd) and, where the key axis is short, a split dK/dV grid
//       whose fp32 partial sums gqa_bwd_reduce adds in a fixed order.
//   attn_bwd_delta_wgmma  Delta = rowsum(dO * O), one bandwidth-bound pass.
//
// Shape of the kernels: two consumer warpgroups (warps 0-7) that own 64 rows
// each (wgmma's M), and a ring of stages in shared memory filled by TMA,
// each with a "full" mbarrier (the bytes landed) and an "empty" one (both
// consumers are done with it). Products run on wgmma with both operands in
// shared memory in the 128-byte swizzle TMA writes, or with P / dS as the
// register A operand. The forward and dQ add a producer warpgroup (warps
// 8-11) of which one thread issues the loads (the forward: setmaxnreg,
// producer 40, consumers 232); dK/dV loads from its first consumer warp
// instead (see there).
//   forward  128 queries a CTA; Q loaded once; K and V tiles of 64 keys
//            through 4 stages. S = Q K^T (K-major B), the online softmax in
//            fp32 registers with the scale on the fp32 logits, O += P V (V
//            the MN-major B operand), O in fp32 registers; bf16 O (and fp32
//            lse) written from registers.
//   dK/dV    128 keys a CTA (64 a consumer), K and V loaded once; Q and dO
//            tiles of 32 queries, with their lse and Delta, through 4 stages,
//            loaded by the first consumer warp (no producer warpgroup: see
//            the kernel).
//            S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T scale - lse) and
//            dS^T = P^T (dP^T - Delta) in fp32 registers, dV += P^T dO and
//            dK += dS^T Q with P^T and dS^T as register A operands.
//   dQ       128 queries a CTA, Q and dO loaded once; K and V tiles of 64
//            keys through 3 stages: S, dP, dS as above, dQ += dS K (K the
//            MN-major B operand).
// The design recomputes S in both backward kernels (7 products against
// FlashAttention-2's 5), the price of owning every output row.
//
// The backward's GQA mode (kGqa, K8bwd): query head h reads K/V head h /
// rep, key j is visible to query i iff kv_start[b] <= j and (offset < 0 or
// j <= offset + i), and a row that sees no key (lse -inf) stages lse +inf,
// so that its P is 0: dq 0, nothing added to dk or dv. A dK/dV CTA takes
// (128 keys, KV head, split, batch) and walks the rep query heads of its KV
// head, each over the 32-query tiles from the first that sees one of its
// keys, summing dK and dV in registers over all of them; dQ's CTA takes
// (128 queries, query head, batch), its key tiles from kv_start to its last
// query's diagonal. Tiles no row of a consumer sees are skipped; only those
// across kv_start or the diagonal are masked per element. Where key tiles x
// Hkv x B CTAs do not fill the SMs (the cross-attention's 512 keys: 32
// CTAs), kernels/cuda.py gqa_bwd_plan splits each tile's units over
// several CTAs, each writing fp32 partial sums for gqa_bwd_reduce.
//
// The band (K3's temporal band, gen3c_tpu/models/dit.py:370-409): query
// token i sees key token j iff |i/hw - j/hw| <= window or j/hw < prefix, at
// global positions q_off + i and k_off + j (K1ring's shards; 0 otherwise).
// Each consumer warpgroup (64 rows) visits exactly the tiles a 64-row tile
// of the mma.sync kernels visits (band_key_tiles / band_query_tiles: the
// prefix and the frames within the window, merged where they touch) and
// masks per element only a tile that is not wholly visible to its rows; the
// producer loads the union of its two consumers' tiles. At the 7B shape (hw
// = 3,520 = 55 x 64) a 64-row group never straddles a frame, so no 7B tile
// is masked, although a 128-row CTA straddles every other frame edge.
// band.visited counts, per consumer, the tiles it computed: forward and dQ
// 64-key tiles ([0] and [1]), dK/dV 32-query tiles ([0]), the units of the
// mma.sync kernels.
//
// Layout: q (B, Lq, H, D), k/v (B, Lk, H, D), each through its own tensor
// map (dims D, then head, sequence and batch in any order of their strides:
// the wrapper sorts them, and `order` says which map dim holds which); rows
// past L and dims past D arrive zero-filled. Outputs (B, L, H, D) and lse /
// Delta (B, H, Lq) contiguous.
//
// What bounds it: at the 7B self shape (L = 56,320, D = 128) the work is
// 4 L^2 D flop per (batch, head) forward and 14 L^2 D backward (this
// design) against ~4 L D bytes: the tensor-core rate. wgmma is the only
// instruction that reaches it (mma.sync tops out at 315.5 TF/s, PERF.md).
// K8bwd at the 4B's training shape (12,800 tokens, causal, 32 / 8 heads,
// D 128) is 3.4 Tflop over ~50 MB: the tensor cores too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.h"

namespace {

using namespace hopper;

constexpr int kConsumerThreads = 256;               // dQ, dK/dV: two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;    // dQ: and one producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kBlockM = 128;  // dQ: queries per CTA; dK/dV: keys per CTA
constexpr int kBlockN = 64;   // dQ: keys per tile
constexpr int kBlockQ = 32;   // dK/dV: queries per tile
constexpr int kDqStages = 3;

// The forward's own shape, compile-time constants that -D overrides: its
// consumer warpgroups (64 queries each), keys per tile, ring stages and
// register split (setmaxnreg). The defaults are K1's; P2, K1's sweep
// (scripts/sweep_attention.py), builds this source at other points with
// GEN3C_ATTN_FWD_ONLY (the forward entry alone). ptxas budgets a 384-thread
// CTA at 168 registers a thread either way; with setmaxnreg in a kernel it
// uses all 168, without it fewer (the forward 134-147 at D 128, and K3 then
// ran 11% slower: PERF.md). The dQ kernel takes none: without it K4 ran 3%
// faster (dQ at 155 registers) and K4-band 2.5% slower.
#ifndef GEN3C_FWD_WARPGROUPS
#define GEN3C_FWD_WARPGROUPS 2
#endif
#ifndef GEN3C_FWD_BLOCK_N
#define GEN3C_FWD_BLOCK_N 64
#endif
#ifndef GEN3C_FWD_STAGES
#define GEN3C_FWD_STAGES 4
#endif
#ifndef GEN3C_FWD_PRODUCER_REGS
#define GEN3C_FWD_PRODUCER_REGS 40
#endif
#ifndef GEN3C_FWD_CONSUMER_REGS
#define GEN3C_FWD_CONSUMER_REGS 232
#endif
constexpr int kFwdConsumerThreads = 128 * GEN3C_FWD_WARPGROUPS;
constexpr int kFwdThreads = kFwdConsumerThreads + 128;  // and one producer warpgroup
constexpr int kFwdConsumerWarps = kFwdConsumerThreads / 32;
constexpr int kFwdBlockM = 64 * GEN3C_FWD_WARPGROUPS;  // queries per CTA
constexpr int kFwdBlockN = GEN3C_FWD_BLOCK_N;          // keys per tile
constexpr int kFwdStages = GEN3C_FWD_STAGES;
constexpr int kProducerRegs = GEN3C_FWD_PRODUCER_REGS, kConsumerRegs = GEN3C_FWD_CONSUMER_REGS;
static_assert(kFwdBlockN == 64 || kFwdBlockN == 128, "the forward takes 64 or 128 keys a tile");
static_assert(128 * kProducerRegs + kFwdConsumerThreads * kConsumerRegs <=
                  kFwdThreads * (65536 / kFwdThreads / 8 * 8),
              "the register split must fit what the CTA launches with");
constexpr int kDkdvStages = 4;
// the backward's tensor-map box rows: dK/dV q, k, v, dout, then dQ q, k, v, dout
constexpr int kBwdBoxRows[8] = {kBlockQ, kBlockM, kBlockM, kBlockQ,
                                kBlockM, kBlockN, kBlockN, kBlockM};
constexpr int kRowBytes = 128;  // one 64-dim half of a row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdParams {
  __nv_bfloat16* o;  // (B, Lq, H, D)
  float* lse;        // (B, H, Lq), natural log; kLse only
  int Lq, Lk, H, D;
  float scale;
  int order_q, order_k, order_v;  // see map_coord
};

struct BwdParams {
  const __nv_bfloat16* o;     // Delta's input, like dout
  const __nv_bfloat16* dout;  // (B, Lq, H, D)
  const float* lse;           // (B, H, Lq)
  float* delta;               // (B, H, Lq)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Lq, Lk, H, D;
  float scale;
  int order_q, order_k, order_v, order_do;
};

// `order` packs, for map dims 1..3, which of (head 0, row 1, batch 2) each
// holds, two bits a dim.
__device__ __forceinline__ int map_coord(int order, int dim, int h, int row, int b) {
  const int which = (order >> (2 * (dim - 1))) & 3;
  return which == 0 ? h : (which == 1 ? row : b);
}

// Load rows [row, row + box rows) of (batch b, head h), DP / 64 halves.
template <int DP>
__device__ __forceinline__ void load_rows(unsigned char* dst, int half_bytes,
                                          const CUtensorMap* map, int order, uint64_t* bar, int h,
                                          int row, int b) {
#pragma unroll
  for (int half = 0; half < DP / 64; ++half) {
    tma_load_4d(dst + half * half_bytes, map, bar, half * 64, map_coord(order, 1, h, row, b),
                map_coord(order, 2, h, row, b), map_coord(order, 3, h, row, b));
  }
}

// ---------------------------------- the band ----------------------------------

#include "band.h"

// The n-th tile of ranges [b0, e0) + [b1, e1).
__device__ __forceinline__ int nth_tile(int n, int b0, int e0, int b1) {
  return n < e0 - b0 ? b0 + n : b1 + n - (e0 - b0);
}

__device__ __forceinline__ bool in_ranges(int t, int b0, int e0, int b1, int e1) {
  return (t >= b0 && t < e0) || (t >= b1 && t < e1);
}

// ------------------------------ K8's prefill mask ------------------------------

// The forward's kGqa mode, K8's bf16 prefill (gqa_attention.cu): query head h
// reads K/V head h / rep, and key j is visible to query i iff kv_start[b] <=
// j and (offset < 0 or j <= offset + i). A kernel argument of its own, as the
// band is, read only under kGqa.
struct GqaMask {
  const long long* kv_start;  // (B,) or null
  int rep;
  int offset;  // < 0: no causal mask
};

constexpr GqaMask kNoGqa = {nullptr, 1, -1};

// The backward pair's kGqa mode, K8bwd in bf16: K8's mask and head map, K/V
// and dK/dV with Hkv heads. dK/dV: `splits` CTAs share one (key tile, KV
// head, batch), each taking a run of its (rep head, query tile) units
// (kernels/cuda.py gqa_split_range over them); with splits > 1 each writes its fp32 partial sums
// to ws (dK's (splits, B, Lk, Hkv, D), then dV's) and gqa_bwd_reduce adds
// them in split order.
struct GqaBwd {
  GqaMask mask;
  int Hkv;
  int splits;
  float* ws;
};

constexpr GqaBwd kNoGqaBwd = {kNoGqa, 0, 1, nullptr};

// The first key (clamped to [0, Lk]) batch b sees.
__device__ __forceinline__ int gqa_first_key(const GqaMask& gqa, int b, int Lk) {
  if (gqa.kv_start == nullptr) return 0;
  return static_cast<int>(min(max(gqa.kv_start[b], 0LL), static_cast<long long>(Lk)));
}

// A row's lse in log2 units under kGqa: a row that sees no key (lse -inf)
// or lies past Lq stages +inf, so that its P is 0 and never NaN.
__device__ __forceinline__ float gqa_lse_log2(const float* lse, int row, int Lq) {
  const float l = row < Lq ? lse[row] : -INFINITY;
  return l == -INFINITY ? INFINITY : l * kLog2e;
}

// The first 32-query tile (of [0, me)) whose rows see one of the keys
// [k0, k_end) (k_end <= Lk), given the batch's first key lo; me when none.
__device__ __forceinline__ int gqa_first_query_tile(const GqaMask& gqa, int k0, int k_end, int lo,
                                                    int me, int block_q) {
  const int first = max(k0, lo);  // the first visible key of the range
  if (first >= k_end) return me;
  return gqa.offset < 0 ? 0 : min(me, max(0, first - gqa.offset) / block_q);
}

// ---------------------------------- forward -----------------------------------

template <int DP>
struct FwdSmem {
  static constexpr int kHalves = DP / 64;
  static constexpr int kQHalf = kFwdBlockM * kRowBytes;
  static constexpr int kKvHalf = kFwdBlockN * kRowBytes;
  static constexpr int kStage = 2 * kHalves * kKvHalf;  // K halves, then V halves
  static constexpr int kQ = kHalves * kQHalf;
  static constexpr int kBars = (1 + 2 * kFwdStages) * 8;
  static constexpr int kBytes = 1024 + kQ + kFwdStages * kStage + kBars;
};

template <int DP, bool kBand, bool kLse, bool kGqa>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const FwdParams p, const Band band,
                   const GqaMask gqa) {
  using S = FwdSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + S::kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + kFwdStages * S::kStage);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kFwdStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = kGqa ? h / gqa.rep : h;  // K's and V's head
  // kGqa: the query tiles with the most keys (the last) first
  const int q0 = (kGqa ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kFwdBlockM;
  const int q_off = kBand ? band.q_off : 0;
  const int k_off = kBand ? band.k_off : 0;
  int b0 = 0, e0 = (p.Lk + kFwdBlockN - 1) / kFwdBlockN, b1 = 0, e1 = 0;
  if constexpr (kBand) {
    band_key_tiles(band, p.Lk, q_off + q0, q_off + min(q0 + kFwdBlockM, p.Lq) - 1, kFwdBlockN,
                   b0, e0, b1, e1, k_off);
  }
  int lo = 0;  // kGqa: the CTA's keys are [lo, hi), the tiles [b0, e0)
  if constexpr (kGqa) {
    if (gqa.kv_start != nullptr) {
      lo = static_cast<int>(min(max(gqa.kv_start[b], 0LL), static_cast<long long>(p.Lk)));
    }
    const int hi = gqa.offset < 0 ? p.Lk : min(p.Lk, gqa.offset + min(q0 + kFwdBlockM, p.Lq));
    b0 = lo / kFwdBlockN;
    e0 = hi > lo ? (hi + kFwdBlockN - 1) / kFwdBlockN : b0;
  }
  const int n_tiles = (e0 - b0) + (e1 - b1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFwdConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFwdConsumerThreads) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kFwdConsumerThreads) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, S::kQ);
      load_rows<DP>(sQ, S::kQHalf, &tq, p.order_q, q_full, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kFwdStages;
        mbar_wait(&empty[s], ((it / kFwdStages) & 1) ^ 1);
        const int n0 = nth_tile(it, b0, e0, b1) * kFwdBlockN;
        unsigned char* stage = sKV + s * S::kStage;
        mbar_arrive_expect_tx(&full[s], S::kStage);
        load_rows<DP>(stage, S::kKvHalf, &tk, p.order_k, &full[s], hk, n0, b);
        load_rows<DP>(stage + S::kHalves * S::kKvHalf, S::kKvHalf, &tv, p.order_v, &full[s], hk,
                      n0, b);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int cw = threadIdx.x / 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int wq0 = q0 + cw * 64;  // this warpgroup's first query
    const bool active = wq0 < p.Lq;
    // this warpgroup's own tiles: a band's for its 64 rows, else every tile
    int wb0 = b0, we0 = e0, wb1 = b1, we1 = e1, qf_lo = 0, qf_hi = 0;
    int qf_row[2] = {0, 0};
    if constexpr (kBand) {
      const int wq_last = min(wq0 + 64, p.Lq) - 1;
      wb0 = we0 = wb1 = we1 = 0;
      if (active) {
        band_key_tiles(band, p.Lk, q_off + wq0, q_off + wq_last, kFwdBlockN, wb0, we0, wb1, we1,
                       k_off);
      }
      qf_lo = (q_off + wq0) / band.hw;
      qf_hi = (q_off + wq_last) / band.hw;
      qf_row[0] = (q_off + wq0 + warp * 16 + g) / band.hw;
      qf_row[1] = (q_off + wq0 + warp * 16 + g + 8) / band.hw;
    }
    int whi0 = p.Lk;  // kGqa: this warpgroup's first row sees keys [lo, whi0)
    if constexpr (kGqa) {
      if (!active) {
        we0 = wb0;
      } else if (gqa.offset >= 0) {
        const int whi = min(p.Lk, gqa.offset + min(wq0 + 64, p.Lq));
        we0 = whi > lo ? (whi + kFwdBlockN - 1) / kFwdBlockN : wb0;
        whi0 = min(p.Lk, gqa.offset + wq0 + 1);
      }
    }

    const float scale_log2 = p.scale * kLog2e;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
    float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
    int visited = 0;
    const uint32_t q_base = smem_u32(sQ) + cw * 64 * kRowBytes;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kFwdStages;
      const int tile = nth_tile(it, b0, e0, b1);
      mbar_wait(&full[s], (it / kFwdStages) & 1);
      if (active && in_ranges(tile, wb0, we0, wb1, we1)) {
        ++visited;
        const int n0 = tile * kFwdBlockN;
        const uint32_t q_at = opaque(q_base);
        const uint32_t k_base = smem_u32(sKV + s * S::kStage);
        const uint32_t v_base = k_base + S::kHalves * S::kKvHalf;

        // S = Q K^T, 64 rows x kFwdBlockN keys
        float sc[kFwdBlockN / 2];
#pragma unroll
        for (int i = 0; i < kFwdBlockN / 2; ++i) sc[i] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          if constexpr (kFwdBlockN == 64) {
            wgmma_ss_n64(sc, wgmma_desc(q_at + (kk / 4) * S::kQHalf + off, 16, 1024),
                         wgmma_desc(k_base + (kk / 4) * S::kKvHalf + off, 16, 1024), kk > 0);
          } else {
            wgmma_ss_n128(sc, wgmma_desc(q_at + (kk / 4) * S::kQHalf + off, 16, 1024),
                          wgmma_desc(k_base + (kk / 4) * S::kKvHalf + off, 16, 1024), kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // online softmax: scale the fp32 logits; a tile that is not wholly
        // visible to this warpgroup's rows (the ragged end, a band edge)
        // masks per element
        bool masked = n0 + kFwdBlockN > p.Lk;
        if constexpr (kBand) {
          masked = !band_tile_visible(band, p.Lk, n0, kFwdBlockN, qf_lo, qf_hi, k_off);
        }
        if constexpr (kGqa) masked = n0 < lo || n0 + kFwdBlockN > whi0;
        float mx[2] = {m_run[0], m_run[1]};
        if (!masked) {
#pragma unroll
          for (int i = 0; i < kFwdBlockN / 2; ++i) {
            sc[i] *= scale_log2;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kFwdBlockN / 2; ++i) {
            const int col = n0 + 8 * (i >> 2) + 2 * tg + (i & 1);
            bool vis = col < p.Lk;
            if constexpr (kBand) {
              vis = vis && band_frames_visible(band, qf_row[(i >> 1) & 1], (k_off + col) / band.hw);
            }
            if constexpr (kGqa) {
              vis = vis && col >= lo &&
                    (gqa.offset < 0 ||
                     col <= gqa.offset + wq0 + warp * 16 + g + 8 * ((i >> 1) & 1));
            }
            const float x = vis ? sc[i] * scale_log2 : -INFINITY;
            sc[i] = x;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
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
        for (int i = 0; i < kFwdBlockN / 2; ++i) {
          const float pe = exp2f(sc[i] - m_use[(i >> 1) & 1]);
          sc[i] = pe;
          l_run[(i >> 1) & 1] += pe;
        }
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P V
        uint32_t pa[kFwdBlockN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kFwdBlockN / 16; ++kk) acc_to_a(sc, kk, pa[kk]);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kFwdBlockN / 16; ++kk) {
          const uint64_t dv = wgmma_desc(v_base + kk * 2048, S::kKvHalf, 1024);
          if constexpr (DP == 128) {
            wgmma_rs_n128(o, pa[kk], dv);
          } else {
            wgmma_rs_n64(o, pa[kk], dv);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (kBand && band.visited != nullptr && tid == 0) {
      atomicAdd(band.visited, static_cast<unsigned long long>(visited));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + warp * 16 + g + 8 * r;
      if (row >= p.Lq) continue;
      // a row that sees no key (K1ring's shards) has l_run 0: out 0, lse -inf
      const float inv = l_run[r] == 0.f ? 0.f : 1.f / l_run[r];
      __nv_bfloat16* orow = p.o + ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * p.D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * tg;
        if (col < p.D) {
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16x2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
      }
      if (kLse && tg == 0) {
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row] =
            (m_run[r] + log2f(l_run[r])) * kLn2;
      }
    }
  }
}

#ifndef GEN3C_ATTN_FWD_ONLY

// ------------------------------- backward: dK/dV ------------------------------

template <int DP>
struct DkdvSmem {
  static constexpr int kHalves = DP / 64;
  static constexpr int kKvHalf = kBlockM * kRowBytes;  // 128 keys
  static constexpr int kQHalf = kBlockQ * kRowBytes;   // 32 queries
  static constexpr int kKV = 2 * kHalves * kKvHalf;    // K halves, then V halves
  static constexpr int kStage = 2 * kHalves * kQHalf;  // Q halves, then dO halves
  static constexpr int kVec = kDkdvStages * kBlockQ * 4;  // lse (log2 units) or Delta
  static constexpr int kBars = (1 + 2 * kDkdvStages) * 8;
  static constexpr int kBytes = 1024 + kKV + kDkdvStages * kStage + 2 * kVec + kBars;
};

// No producer warpgroup here: the first warp of consumer 0 also loads, a
// stage behind (tile it - 1 + stages into the stage tile it - 1 freed), so
// that the CTA launches with 256 threads and its consumers may take up to
// 255 registers each: dK and dV are 128 fp32 registers a thread, and in a
// 384-thread CTA they spilled (ptxas compiles it for 168 registers a thread,
// and setmaxnreg does not raise that).
//
// kGqa (K8bwd): the CTA is (key tile, KV head g, split, batch), grid x
// walking the key tiles slowest, so that the causal tiles with the most
// queries launch first. Its units are the rep query heads g rep + r, each
// over the 32-query tiles from the first that sees one of its keys, r
// slowest; split s takes run s of gqa_split_range(s, splits, 0, units),
// ceil(units / splits) a run. Q and dO load at
// head g rep + r, lse and Delta at (b, g rep + r, row): dK and dV of the
// KV head sum over its query heads here, without atomics.
template <int DP, bool kBand, bool kGqa>
__global__ void __launch_bounds__(kConsumerThreads, 1)
    attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const BwdParams p,
                        const Band band, const GqaBwd gqa) {
  using S = DkdvSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* sKV = smem;
  unsigned char* sQD = smem + S::kKV;
  float* sLse = reinterpret_cast<float*>(sQD + kDkdvStages * S::kStage);
  float* sDelta = sLse + kDkdvStages * kBlockQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sDelta + kDkdvStages * kBlockQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kDkdvStages;

  const int b = blockIdx.z;
  const int h = kGqa ? blockIdx.x % gqa.Hkv : blockIdx.y;  // K's and V's head
  const int n0 = (kGqa ? blockIdx.x / gqa.Hkv : blockIdx.x) * kBlockM;  // the CTA's first key
  const long long bh = static_cast<long long>(b) * p.H + h;
  int mb = 0, me = (p.Lq + kBlockQ - 1) / kBlockQ;
  if constexpr (kBand) {
    band_query_tiles(band, p.Lq, n0, min(n0 + kBlockM, p.Lk) - 1, kBlockQ, mb, me);
  }
  int n_tiles = me - mb;
  int lo = 0, u0 = 0;  // kGqa: the batch's first key; the split's first unit
  if constexpr (kGqa) {
    lo = gqa_first_key(gqa.mask, b, p.Lk);
    mb = gqa_first_query_tile(gqa.mask, n0, min(n0 + kBlockM, p.Lk), lo, me, kBlockQ);
    const int units = gqa.mask.rep * (me - mb);
    const int per = (units + gqa.splits - 1) / gqa.splits;
    u0 = min(static_cast<int>(blockIdx.y) * per, units);
    n_tiles = min(u0 + per, units) - u0;
  }
  // unit `it` of this CTA: its query head and query tile
  auto unit_head = [&](int it) { return kGqa ? h * gqa.mask.rep + (u0 + it) / (me - mb) : h; };
  auto unit_tile = [&](int it) { return kGqa ? mb + (u0 + it) % (me - mb) : mb + it; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkdvStages; ++s) {
      mbar_init(&full[s], 32);  // the loading warp's lanes (lse and Delta) + the bytes
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // tile `it` into its stage (free) by the loading warp: each lane stages
  // one query row's lse and Delta, lane 0 the Q and dO tiles
  const bool loader = threadIdx.x < 32;
  auto load_tile = [&](int it) {
    const int s = it % kDkdvStages;
    const int m0 = unit_tile(it) * kBlockQ;
    const int row = m0 + static_cast<int>(threadIdx.x);
    const int hq = unit_head(it);
    const long long bq = static_cast<long long>(b) * p.H + hq;
    // a missing query row gets lse 0 and Delta 0 (its Q and dO rows are
    // zero, so its terms vanish); kGqa: lse +inf (gqa_lse_log2)
    sLse[s * kBlockQ + threadIdx.x] = kGqa ? gqa_lse_log2(p.lse + bq * p.Lq, row, p.Lq)
                                           : row < p.Lq ? p.lse[bh * p.Lq + row] * kLog2e : 0.f;
    sDelta[s * kBlockQ + threadIdx.x] = row < p.Lq ? p.delta[bq * p.Lq + row] : 0.f;
    if (threadIdx.x == 0) {
      unsigned char* stage = sQD + s * S::kStage;
      mbar_arrive_expect_tx(&full[s], S::kStage);
      load_rows<DP>(stage, S::kQHalf, &tq, p.order_q, &full[s], hq, m0, b);
      load_rows<DP>(stage + S::kHalves * S::kQHalf, S::kQHalf, &tdo, p.order_do, &full[s], hq,
                    m0, b);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  // kGqa: a CTA without units (its keys before kv_start or past every
  // query's diagonal, or an empty split) loads nothing and writes zeros
  const bool has_units = !kGqa || n_tiles > 0;
  if (loader) {
    if (threadIdx.x == 0 && has_units) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(kv_full, S::kKV);
      load_rows<DP>(sKV, S::kKvHalf, &tk, p.order_k, kv_full, h, n0, b);
      load_rows<DP>(sKV + S::kHalves * S::kKvHalf, S::kKvHalf, &tv, p.order_v, kv_full, h, n0, b);
    }
    for (int it = 0; it < min(kDkdvStages, n_tiles); ++it) load_tile(it);
  }

  {
    const int tid = threadIdx.x % 128;
    const int cw = threadIdx.x / 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int wk0 = n0 + cw * 64;  // this warpgroup's first key
    const bool active = wk0 < p.Lk;
    int wmb = mb, wme = me;
    int kf_row[2] = {0, 0};  // band: the frames of this thread's key rows g and g + 8
    if constexpr (kBand) {
      wmb = wme = 0;
      if (active) band_query_tiles(band, p.Lq, wk0, min(wk0 + 64, p.Lk) - 1, kBlockQ, wmb, wme);
      kf_row[0] = (wk0 + warp * 16 + g) / band.hw;
      kf_row[1] = (wk0 + warp * 16 + g + 8) / band.hw;
    }
    if constexpr (kGqa) {  // the query tiles before the first that sees one of its keys: skipped
      wmb = active ? gqa_first_query_tile(gqa.mask, wk0, min(wk0 + 64, p.Lk), lo, me, kBlockQ)
                   : me;
    }

    const float scale_log2 = p.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    int visited = 0;
    const uint32_t k_base = smem_u32(sKV) + cw * 64 * kRowBytes;
    const uint32_t v_base = k_base + S::kHalves * S::kKvHalf;

    if (has_units) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDkdvStages;
      const int mt = unit_tile(it);
      mbar_wait(&full[s], (it / kDkdvStages) & 1);
      if (active && mt >= wmb && mt < wme) {
        ++visited;
        const int m0 = mt * kBlockQ;
        const uint32_t k_at = opaque(k_base), v_at = opaque(v_base);
        const uint32_t q_base = smem_u32(sQD + s * S::kStage);
        const uint32_t do_base = q_base + S::kHalves * S::kQHalf;
        const float* lse = sLse + s * kBlockQ;
        const float* dlt = sDelta + s * kBlockQ;

        // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 32 queries
        float st[16], dpt[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n32(st, wgmma_desc(k_at + (kk / 4) * S::kKvHalf + off, 16, 1024),
                       wgmma_desc(q_base + (kk / 4) * S::kQHalf + off, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n32(dpt, wgmma_desc(v_at + (kk / 4) * S::kKvHalf + off, 16, 1024),
                       wgmma_desc(do_base + (kk / 4) * S::kQHalf + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T = exp(S^T scale - lse) with lse per column (query), dS^T = P^T
        // (dP^T - Delta); queries >= Lq and masked pairs give 0
        bool masked = m0 + kBlockQ > p.Lq;
        if constexpr (kBand) {
          masked = masked || !band_tile_visible(band, p.Lk, wk0, 64, m0 / band.hw,
                                                (min(m0 + kBlockQ, p.Lq) - 1) / band.hw, 0);
        }
        if constexpr (kGqa) {  // keys before kv_start, or past the first query's diagonal
          masked = masked || wk0 < lo || (gqa.mask.offset >= 0 && wk0 + 63 > gqa.mask.offset + m0);
        }
        if (!masked) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = 8 * (i >> 2) + 2 * tg + (i & 1);
            const float pe = exp2f(st[i] * scale_log2 - lse[col]);
            st[i] = pe;
            dpt[i] = pe * (dpt[i] - dlt[col]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = 8 * (i >> 2) + 2 * tg + (i & 1);
            bool vis = m0 + col < p.Lq;
            if constexpr (kBand) {
              vis = vis && band_frames_visible(band, (m0 + col) / band.hw, kf_row[(i >> 1) & 1]);
            }
            if constexpr (kGqa) {
              const int key = wk0 + warp * 16 + g + 8 * ((i >> 1) & 1);
              vis = vis && key >= lo && (gqa.mask.offset < 0 || key <= gqa.mask.offset + m0 + col);
            }
            const float pe = vis ? exp2f(st[i] * scale_log2 - lse[col]) : 0.f;
            st[i] = pe;
            dpt[i] = pe * (dpt[i] - dlt[col]);
          }
        }

        // dV += P^T dO and dK += dS^T Q, the queries the reduction dim
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          acc_to_a(st, kk, pa[kk]);
          acc_to_a(dpt, kk, da[kk]);
        }
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t desc = wgmma_desc(do_base + kk * 2048, S::kQHalf, 1024);
          if constexpr (DP == 128) {
            wgmma_rs_n128(dv, pa[kk], desc);
          } else {
            wgmma_rs_n64(dv, pa[kk], desc);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t desc = wgmma_desc(q_base + kk * 2048, S::kQHalf, 1024);
          if constexpr (DP == 128) {
            wgmma_rs_n128(dk, da[kk], desc);
          } else {
            wgmma_rs_n64(dk, da[kk], desc);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // refill the stage of the tile before this one, once both consumers
      // have released it
      const int next = it - 1 + kDkdvStages;
      if (loader && it >= 1 && next < n_tiles) {
        mbar_wait(&empty[(it - 1) % kDkdvStages], ((it - 1) / kDkdvStages) & 1);
        load_tile(next);
      }
    }
    if (kBand && band.visited != nullptr && tid == 0) {
      atomicAdd(band.visited, static_cast<unsigned long long>(visited));
    }

    // kGqa: dK and dV have Hkv heads; a split grid writes fp32 partial sums
    const int H_out = kGqa ? gqa.Hkv : p.H;
    const bool partial = kGqa && gqa.splits > 1;
    const long long ws_part = static_cast<long long>(p.B) * p.Lk * H_out * p.D;
    float* ws_dk = partial ? gqa.ws + blockIdx.y * ws_part : nullptr;
    float* ws_dv = partial ? ws_dk + gqa.splits * ws_part : nullptr;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wk0 + warp * 16 + g + 8 * r;
      if (row >= p.Lk) continue;
      const long long off = ((static_cast<long long>(b) * p.Lk + row) * H_out + h) * p.D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * tg;
        if (col < p.D) {
          if (partial) {
            *reinterpret_cast<float2*>(ws_dk + off + col) =
                make_float2(dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
            *reinterpret_cast<float2*>(ws_dv + off + col) =
                make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(p.dk + off + col) =
                pack_bf16x2(dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(p.dv + off + col) =
                pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
}

// K8bwd's split dK/dV: dk and dv (bf16, n elements each) from the splits'
// fp32 partial sums in ws (dK's splits, then dV's, n each), added in split
// order, so the bits repeat. Four elements a thread (n % 8 == 0).
__global__ void __launch_bounds__(256)
    gqa_bwd_reduce(const float* ws, int splits, long long n, __nv_bfloat16* dk,
                   __nv_bfloat16* dv) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(ws + s * n + i);
    const float4 y = *reinterpret_cast<const float4*>(ws + (splits + s) * n + i);
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
  }
  *reinterpret_cast<uint2*>(dk + i) = make_uint2(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w));
  *reinterpret_cast<uint2*>(dv + i) = make_uint2(pack_bf16x2(c.x, c.y), pack_bf16x2(c.z, c.w));
}

// --------------------------------- backward: dQ -------------------------------

template <int DP>
struct DqSmem {
  static constexpr int kHalves = DP / 64;
  static constexpr int kQHalf = kBlockM * kRowBytes;
  static constexpr int kKvHalf = kBlockN * kRowBytes;
  static constexpr int kQD = 2 * kHalves * kQHalf;     // Q halves, then dO halves
  static constexpr int kStage = 2 * kHalves * kKvHalf;  // K halves, then V halves
  static constexpr int kBars = (1 + 2 * kDqStages) * 8;
  static constexpr int kBytes = 1024 + kQD + kDqStages * kStage + kBars;
};

// kGqa (K8bwd): query head h reads K/V head h / rep; the CTA's key tiles
// run from kv_start to the last query's diagonal, the query tiles with the
// most keys (the last) first, as the forward's kGqa mode.
template <int DP, bool kBand, bool kGqa>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const BwdParams p,
                      const Band band, const GqaMask gqa) {
  using S = DqSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* sQD = smem;
  unsigned char* sKV = smem + S::kQD;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + kDqStages * S::kStage);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kDqStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = kGqa ? h / gqa.rep : h;  // K's and V's head
  const int q0 = (kGqa ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBlockM;
  int b0 = 0, e0 = (p.Lk + kBlockN - 1) / kBlockN, b1 = 0, e1 = 0;
  if constexpr (kBand) {
    band_key_tiles(band, p.Lk, q0, min(q0 + kBlockM, p.Lq) - 1, kBlockN, b0, e0, b1, e1, 0);
  }
  int lo = 0;  // kGqa: the CTA's keys are [lo, hi), the tiles [b0, e0)
  if constexpr (kGqa) {
    lo = gqa_first_key(gqa, b, p.Lk);
    const int hi = gqa.offset < 0 ? p.Lk : min(p.Lk, gqa.offset + min(q0 + kBlockM, p.Lq));
    b0 = lo / kBlockN;
    e0 = hi > lo ? (hi + kBlockN - 1) / kBlockN : b0;
  }
  const int n_tiles = (e0 - b0) + (e1 - b1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // producer
    if (threadIdx.x == kConsumerThreads) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(q_full, S::kQD);
      load_rows<DP>(sQD, S::kQHalf, &tq, p.order_q, q_full, h, q0, b);
      load_rows<DP>(sQD + S::kHalves * S::kQHalf, S::kQHalf, &tdo, p.order_do, q_full, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kDqStages;
        mbar_wait(&empty[s], ((it / kDqStages) & 1) ^ 1);
        const int n0 = nth_tile(it, b0, e0, b1) * kBlockN;
        unsigned char* stage = sKV + s * S::kStage;
        mbar_arrive_expect_tx(&full[s], S::kStage);
        load_rows<DP>(stage, S::kKvHalf, &tk, p.order_k, &full[s], hk, n0, b);
        load_rows<DP>(stage + S::kHalves * S::kKvHalf, S::kKvHalf, &tv, p.order_v, &full[s], hk,
                      n0, b);
      }
    }
  } else {  // consumers
    const int tid = threadIdx.x % 128;
    const int cw = threadIdx.x / 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int wq0 = q0 + cw * 64;
    const bool active = wq0 < p.Lq;
    int wb0 = b0, we0 = e0, wb1 = b1, we1 = e1, qf_lo = 0, qf_hi = 0;
    int qf_row[2] = {0, 0};
    if constexpr (kBand) {
      const int wq_last = min(wq0 + 64, p.Lq) - 1;
      wb0 = we0 = wb1 = we1 = 0;
      if (active) band_key_tiles(band, p.Lk, wq0, wq_last, kBlockN, wb0, we0, wb1, we1, 0);
      qf_lo = wq0 / band.hw;
      qf_hi = wq_last / band.hw;
      qf_row[0] = (wq0 + warp * 16 + g) / band.hw;
      qf_row[1] = (wq0 + warp * 16 + g + 8) / band.hw;
    }
    int whi0 = p.Lk;  // kGqa: this warpgroup's first row sees keys [lo, whi0)
    if constexpr (kGqa) {
      if (!active) {
        we0 = wb0;
      } else if (gqa.offset >= 0) {
        const int whi = min(p.Lk, gqa.offset + min(wq0 + 64, p.Lq));
        we0 = whi > lo ? (whi + kBlockN - 1) / kBlockN : wb0;
        whi0 = min(p.Lk, gqa.offset + wq0 + 1);
      }
    }
    // rows g and g + 8; a missing row gets lse 0 and Delta 0 (zero q and dO
    // rows: its dS is 0 and it is not written); kGqa: lse +inf (gqa_lse_log2)
    const long long bh = static_cast<long long>(b) * p.H + h;
    float lse_l2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + warp * 16 + g + 8 * r;
      lse_l2[r] = kGqa ? gqa_lse_log2(p.lse + bh * p.Lq, row, p.Lq)
                       : row < p.Lq ? p.lse[bh * p.Lq + row] * kLog2e : 0.f;
      dlt[r] = row < p.Lq ? p.delta[bh * p.Lq + row] : 0.f;
    }

    const float scale_log2 = p.scale * kLog2e;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    int visited = 0;
    const uint32_t q_base = smem_u32(sQD) + cw * 64 * kRowBytes;
    const uint32_t do_base = q_base + S::kHalves * S::kQHalf;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDqStages;
      const int tile = nth_tile(it, b0, e0, b1);
      mbar_wait(&full[s], (it / kDqStages) & 1);
      if (active && in_ranges(tile, wb0, we0, wb1, we1)) {
        ++visited;
        const int n0 = tile * kBlockN;
        const uint32_t q_at = opaque(q_base), do_at = opaque(do_base);
        const uint32_t k_base = smem_u32(sKV + s * S::kStage);
        const uint32_t v_base = k_base + S::kHalves * S::kKvHalf;

        // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(sc, wgmma_desc(q_at + (kk / 4) * S::kQHalf + off, 16, 1024),
                       wgmma_desc(k_base + (kk / 4) * S::kKvHalf + off, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(dp, wgmma_desc(do_at + (kk / 4) * S::kQHalf + off, 16, 1024),
                       wgmma_desc(v_base + (kk / 4) * S::kKvHalf + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        bool masked = n0 + kBlockN > p.Lk;
        if constexpr (kBand) {
          masked = !band_tile_visible(band, p.Lk, n0, kBlockN, qf_lo, qf_hi, 0);
        }
        if constexpr (kGqa) masked = n0 < lo || n0 + kBlockN > whi0;
        if (!masked) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float pe = exp2f(sc[i] * scale_log2 - lse_l2[(i >> 1) & 1]);
            sc[i] = pe * (dp[i] - dlt[(i >> 1) & 1]);  // dS
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = n0 + 8 * (i >> 2) + 2 * tg + (i & 1);
            bool vis = col < p.Lk;
            if constexpr (kBand) {
              vis = vis && band_frames_visible(band, qf_row[(i >> 1) & 1], col / band.hw);
            }
            if constexpr (kGqa) {
              vis = vis && col >= lo &&
                    (gqa.offset < 0 ||
                     col <= gqa.offset + wq0 + warp * 16 + g + 8 * ((i >> 1) & 1));
            }
            const float pe = vis ? exp2f(sc[i] * scale_log2 - lse_l2[(i >> 1) & 1]) : 0.f;
            sc[i] = pe * (dp[i] - dlt[(i >> 1) & 1]);
          }
        }

        // dQ += dS K, the keys the reduction dim
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(sc, kk, da[kk]);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t desc = wgmma_desc(k_base + kk * 2048, S::kKvHalf, 1024);
          if constexpr (DP == 128) {
            wgmma_rs_n128(dq, da[kk], desc);
          } else {
            wgmma_rs_n64(dq, da[kk], desc);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (kBand && band.visited != nullptr && tid == 0) {
      atomicAdd(band.visited + 1, static_cast<unsigned long long>(visited));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + warp * 16 + g + 8 * r;
      if (row >= p.Lq) continue;
      __nv_bfloat16* out = p.dq + ((static_cast<long long>(b) * p.Lq + row) * p.H + h) * p.D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * tg;
        if (col < p.D) {
          *reinterpret_cast<uint32_t*>(out + col) =
              pack_bf16x2(dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

// Delta = rowsum(dO * O) in fp32, (B, H, Lq); one warp per (b, row, h) of
// the contiguous (B, Lq, H, D) O and dO.
__global__ void __launch_bounds__(256) attn_bwd_delta_wgmma(const BwdParams p) {
  const long long rows = static_cast<long long>(p.B) * p.Lq * p.H;
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const __nv_bfloat16* o = p.o + r * p.D;
  const __nv_bfloat16* dO = p.dout + r * p.D;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc += __bfloat162float(o[d]) * __bfloat162float(dO[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % p.H);
    const long long bl = r / p.H;  // b * Lq + row
    const int row = static_cast<int>(bl % p.Lq);
    const long long b = bl / p.Lq;
    p.delta[(b * p.H + h) * p.Lq + row] = acc;
  }
}

#endif  // GEN3C_ATTN_FWD_ONLY

// ------------------------------------ host -------------------------------------

// The map words of one tensor, as kernels/cuda.py tensor_map_params packs
// them: dims[4] (D first, elements), byte strides of dims 1..3, box[4],
// swizzle bytes, order (see map_coord). The box must be 64 elements of D by
// `rows` of the sequence; the swizzle 128 bytes.
constexpr int kMapWords = 13;

cudaError_t make_map(CUtensorMap* map, const void* base, const long long* w, int rows) {
  const int order = static_cast<int>(w[12]);
  for (int d = 1; d <= 3; ++d) {
    const int which = (order >> (2 * (d - 1))) & 3;
    if (which > 2 || w[7 + d] != (which == 1 ? rows : 1)) return cudaErrorInvalidValue;
  }
  if (w[7] != 64 || w[11] != 128 || (reinterpret_cast<uintptr_t>(base) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(w[i]);
    box[i] = static_cast<cuuint32_t>(w[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(w[4 + i]);
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP, bool kBand, bool kLse, bool kGqa = false>
cudaError_t launch_fwd(const CUtensorMap* maps, const FwdParams& p, const Band& band, int B,
                       cudaStream_t stream, const GqaMask& gqa = kNoGqa) {
  auto kernel = attn_fwd_wgmma<DP, kBand, kLse, kGqa>;
  const int smem = FwdSmem<DP>::kBytes;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kFwdBlockM - 1) / kFwdBlockM, p.H, B);
  kernel<<<grid, kFwdThreads, smem, stream>>>(maps[0], maps[1], maps[2], p, band, gqa);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_fwd(const CUtensorMap* maps, const FwdParams& p, const Band& band, int B,
                         bool lse, cudaStream_t s) {
  const bool bd = band.hw > 0;
  if (bd && lse) return launch_fwd<DP, true, true>(maps, p, band, B, s);
  if (bd) return launch_fwd<DP, true, false>(maps, p, band, B, s);
  if (lse) return launch_fwd<DP, false, true>(maps, p, band, B, s);
  return launch_fwd<DP, false, false>(maps, p, band, B, s);
}

#ifndef GEN3C_ATTN_FWD_ONLY
// dK/dV (kGqa with a split grid: then the reduction), then dQ.
template <int DP, bool kBand, bool kGqa = false>
cudaError_t launch_bwd(const CUtensorMap* dkdv_maps, const CUtensorMap* dq_maps,
                       const BwdParams& p, const Band& band, int B, cudaStream_t stream,
                       const GqaBwd& gqa = kNoGqaBwd) {
  auto dkdv = attn_bwd_dkdv_wgmma<DP, kBand, kGqa>;
  const int smem_dkdv = DkdvSmem<DP>::kBytes;
  cudaError_t err = set_smem(dkdv, smem_dkdv);
  if (err != cudaSuccess) return err;
  const int key_tiles = (p.Lk + kBlockM - 1) / kBlockM;
  const dim3 dkdv_grid = kGqa ? dim3(key_tiles * gqa.Hkv, gqa.splits, B) : dim3(key_tiles, p.H, B);
  dkdv<<<dkdv_grid, kConsumerThreads, smem_dkdv, stream>>>(dkdv_maps[0], dkdv_maps[1],
                                                          dkdv_maps[2], dkdv_maps[3], p, band, gqa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (kGqa && gqa.splits > 1) {
    const long long n = static_cast<long long>(B) * p.Lk * gqa.Hkv * p.D;
    gqa_bwd_reduce<<<static_cast<unsigned>((n / 4 + 255) / 256), 256, 0, stream>>>(
        gqa.ws, gqa.splits, n, p.dk, p.dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto dq = attn_bwd_dq_wgmma<DP, kBand, kGqa>;
  const int smem_dq = DqSmem<DP>::kBytes;
  err = set_smem(dq, smem_dq);
  if (err != cudaSuccess) return err;
  dq<<<dim3((p.Lq + kBlockM - 1) / kBlockM, p.H, B), kThreads, smem_dq, stream>>>(
      dq_maps[0], dq_maps[1], dq_maps[2], dq_maps[3], p, band, gqa.mask);
  return cudaGetLastError();
}
#endif  // GEN3C_ATTN_FWD_ONLY

#ifndef GEN3C_ATTN_FWD_ONLY
// The backward's eight tensor maps (the dK/dV kernel's q, k, v, dout, then
// the dQ kernel's: box rows as gen3c_attention_wgmma_box_rows) and its
// parameters; H is q's heads.
cudaError_t bwd_setup(CUtensorMap* maps, BwdParams* p, const void* q, const void* k,
                      const void* v, const void* out, const void* dout, const long long* words,
                      const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Lq,
                      int Lk, int H, int D, float scale) {
  const void* bases[8] = {q, k, v, dout, q, k, v, dout};
  for (int i = 0; i < 8; ++i) {
    cudaError_t err = make_map(&maps[i], bases[i], words + i * kMapWords, kBwdBoxRows[i]);
    if (err != cudaSuccess) return err;
  }
  for (int i = 0; i < 4; ++i) {  // the dQ kernel's maps must hold the same orders
    if (words[i * kMapWords + 12] != words[(4 + i) * kMapWords + 12]) return cudaErrorInvalidValue;
  }
  p->o = static_cast<const __nv_bfloat16*>(out);
  p->dout = static_cast<const __nv_bfloat16*>(dout);
  p->lse = lse;
  p->delta = delta;
  p->dq = static_cast<__nv_bfloat16*>(dq);
  p->dk = static_cast<__nv_bfloat16*>(dk);
  p->dv = static_cast<__nv_bfloat16*>(dv);
  p->B = B;
  p->Lq = Lq;
  p->Lk = Lk;
  p->H = H;
  p->D = D;
  p->scale = scale;
  p->order_q = static_cast<int>(words[12]);
  p->order_k = static_cast<int>(words[kMapWords + 12]);
  p->order_v = static_cast<int>(words[2 * kMapWords + 12]);
  p->order_do = static_cast<int>(words[3 * kMapWords + 12]);
  return cudaSuccess;
}

cudaError_t launch_delta(const BwdParams& p, cudaStream_t s) {
  const long long rows = static_cast<long long>(p.B) * p.Lq * p.H;
  attn_bwd_delta_wgmma<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(p);
  return cudaGetLastError();
}
#endif  // GEN3C_ATTN_FWD_ONLY

bool bad_shape(int B, int Lq, int Lk, int H, int D) {
  return B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D > 128 || D % 8 != 0 ||
         H > 65535 || B > 65535;
}

Band make_band(const int* band, void* visited, int q_off, int k_off) {
  Band b;
  b.hw = band != nullptr ? band[0] : 0;
  b.window = band != nullptr ? band[1] : 0;
  b.prefix = band != nullptr ? band[2] : 0;
  b.visited = static_cast<unsigned long long*>(visited);
  b.q_off = q_off;
  b.k_off = k_off;
  return b;
}

}  // namespace

// The box rows each tensor map of a call must have (kernels/cuda.py builds
// the maps' words with them): forward q, k, v; backward dK/dV q, k, v, dout,
// then dQ q, k, v, dout.
extern "C" void gen3c_attention_wgmma_box_rows(int* fwd, int* bwd) {
  fwd[0] = kFwdBlockM;
  fwd[1] = fwd[2] = kFwdBlockN;
  for (int i = 0; i < 8; ++i) bwd[i] = kBwdBoxRows[i];
}

// The forward's shape as built (kernels/cuda.py checks each build of P2's
// sweep, K1's included, against the point it asked for): consumer
// warpgroups, keys a tile, ring stages, producer and consumer registers.
extern "C" void gen3c_attention_wgmma_fwd_point(int* shape) {
  shape[0] = GEN3C_FWD_WARPGROUPS;
  shape[1] = kFwdBlockN;
  shape[2] = kFwdStages;
  shape[3] = kProducerRegs;
  shape[4] = kConsumerRegs;
}

// The dynamic shared memory each kernel asks for at head dim dp (64 or
// 128): fwd, dK/dV, dQ.
extern "C" void gen3c_attention_wgmma_smem(int dp, int* bytes) {
  bytes[0] = dp == 64 ? FwdSmem<64>::kBytes : FwdSmem<128>::kBytes;
#ifndef GEN3C_ATTN_FWD_ONLY
  bytes[1] = dp == 64 ? DkdvSmem<64>::kBytes : DkdvSmem<128>::kBytes;
  bytes[2] = dp == 64 ? DqSmem<64>::kBytes : DqSmem<128>::kBytes;
#endif
}

// Forward (lse null: without the row logsumexp). q, k, v bf16 with their
// map words (3 x kMapWords: see make_map); out (B, Lq, H, D) and lse (B, H,
// Lq) contiguous. band: null or {hw, window, prefix}; q_off / k_off the ring
// step's global offsets; visited: null or one device counter. Returns a
// cudaError_t (0 on success).
extern "C" int gen3c_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                                         const long long* words, void* out, float* lse, int B,
                                         int Lq, int Lk, int H, int D, float scale,
                                         const int* band, int q_off, int k_off, void* visited,
                                         void* stream) {
  if (bad_shape(B, Lq, Lk, H, D) || q_off < 0 || k_off < 0 ||
      (band != nullptr && (band[0] <= 0 || band[1] < 0 || band[2] < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int rows[3] = {kFwdBlockM, kFwdBlockN, kFwdBlockN};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = make_map(&maps[i], bases[i], words + i * kMapWords, rows[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  FwdParams p;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.D = D;
  p.scale = scale;
  p.order_q = static_cast<int>(words[12]);
  p.order_k = static_cast<int>(words[kMapWords + 12]);
  p.order_v = static_cast<int>(words[2 * kMapWords + 12]);
  const Band bd = make_band(band, visited, q_off, k_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_lse = lse != nullptr;
  if (D <= 64) return static_cast<int>(dispatch_fwd<64>(maps, p, bd, B, with_lse, s));
  return static_cast<int>(dispatch_fwd<128>(maps, p, bd, B, with_lse, s));
}

#ifndef GEN3C_ATTN_FWD_ONLY
// K8's bf16 prefill: the forward (no band) in its kGqa mode over q (B, Lq,
// Hq, D) and k/v (B, Lk, Hkv, D) with their map words (3 x kMapWords, box
// rows as the forward's); kv_start null or (B,) int64 on the card;
// causal_offset < 0: no causal mask; scale multiplies the logits (1/sqrt(d)
// of the head dim before kernels/cuda.py zero-padded it to D, a multiple of
// 8: zero columns add nothing to a logit or an output row). out (B, Lq, Hq,
// D) contiguous; lse null
// (inference) or (B, Hq, Lq) fp32, the row logsumexp K8bwd reads (training;
// -inf for a row that sees no key). Returns a cudaError_t (0 on success).
extern "C" int gen3c_gqa_attention_wgmma(const void* q, const void* k, const void* v,
                                         const long long* words, void* out,
                                         const long long* kv_start, int B, int Lq, int Lk, int Hq,
                                         int Hkv, int D, int causal_offset, float scale,
                                         float* lse, void* stream) {
  if (bad_shape(B, Lq, Lk, Hq, D) || Hkv <= 0 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int rows[3] = {kFwdBlockM, kFwdBlockN, kFwdBlockN};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = make_map(&maps[i], bases[i], words + i * kMapWords, rows[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  FwdParams p;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = Hq;
  p.D = D;
  p.scale = scale;
  p.order_q = static_cast<int>(words[12]);
  p.order_k = static_cast<int>(words[kMapWords + 12]);
  p.order_v = static_cast<int>(words[2 * kMapWords + 12]);
  const GqaMask gqa = {kv_start, Hq / Hkv, causal_offset};
  const Band bd = make_band(nullptr, nullptr, 0, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr) {
    if (D <= 64) return static_cast<int>(launch_fwd<64, false, true, true>(maps, p, bd, B, s, gqa));
    return static_cast<int>(launch_fwd<128, false, true, true>(maps, p, bd, B, s, gqa));
  }
  if (D <= 64) return static_cast<int>(launch_fwd<64, false, false, true>(maps, p, bd, B, s, gqa));
  return static_cast<int>(launch_fwd<128, false, false, true>(maps, p, bd, B, s, gqa));
}

// Backward (K4; K4-band with a band): dq, dk, dv (contiguous, like q, k, v)
// from q, k, v, out, dout (contiguous bf16), the forward's lse (B, H, Lq);
// delta (B, H, Lq) fp32 scratch. words: 8 x kMapWords, the dK/dV kernel's
// maps of q, k, v, dout, then the dQ kernel's (box rows as
// gen3c_attention_wgmma_box_rows). visited: null or two device counters.
// Three launches: Delta, dK/dV, dQ.
extern "C" int gen3c_attention_wgmma_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout,
                                         const long long* words, const float* lse, float* delta,
                                         void* dq, void* dk, void* dv, int B, int Lq, int Lk,
                                         int H, int D, float scale, const int* band,
                                         void* visited, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D) ||
      (band != nullptr && (band[0] <= 0 || band[1] < 0 || band[2] < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[8];
  BwdParams p;
  cudaError_t err = bwd_setup(maps, &p, q, k, v, out, dout, words, lse, delta, dq, dk, dv, B, Lq,
                              Lk, H, D, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Band bd = make_band(band, visited, 0, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_delta(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bnd = bd.hw > 0;
  if (D <= 64) {
    err = bnd ? launch_bwd<64, true>(maps, maps + 4, p, bd, B, s)
              : launch_bwd<64, false>(maps, maps + 4, p, bd, B, s);
  } else {
    err = bnd ? launch_bwd<128, true>(maps, maps + 4, p, bd, B, s)
              : launch_bwd<128, false>(maps, maps + 4, p, bd, B, s);
  }
  return static_cast<int>(err);
}

// K8bwd in bf16: dq (like q), dk, dv (like k, v) of K8's attention (the
// backward pair in its kGqa mode) from q (B, Lq, Hq, D), k / v (B, Lk, Hkv,
// D), the forward's out and dout (like q), all contiguous bf16, and the
// forward's lse (B, Hq, Lq) fp32 (-inf: a row that sees no key). words: 8 x
// kMapWords as gen3c_attention_wgmma_bwd's; kv_start null or (B,) int64 on
// the card; causal_offset < 0: no causal mask; scale as
// gen3c_gqa_attention_wgmma's; delta (B, Hq, Lq) fp32
// scratch. splits: the dK/dV grid's split of each key tile (kernels/cuda.py
// gqa_bwd_plan); with splits > 1, ws holds 2 x splits x B x Lk x Hkv x D fp32
// (null otherwise). Launches Delta, dK/dV, (the split's reduction,) dQ.
// Returns a cudaError_t (0 on success).
extern "C" int gen3c_gqa_attention_wgmma_bwd(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout,
                                             const long long* words, const float* lse,
                                             const long long* kv_start, float* delta, void* dq,
                                             void* dk, void* dv, float* ws, int B, int Lq, int Lk,
                                             int Hq, int Hkv, int D, int causal_offset,
                                             float scale, int splits, void* stream) {
  if (bad_shape(B, Lq, Lk, Hq, D) || Hkv <= 0 || Hq % Hkv != 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[8];
  BwdParams p;
  cudaError_t err = bwd_setup(maps, &p, q, k, v, out, dout, words, lse, delta, dq, dk, dv, B, Lq,
                              Lk, Hq, D, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GqaBwd gqa = {{kv_start, Hq / Hkv, causal_offset}, Hkv, splits, ws};
  const Band bd = make_band(nullptr, nullptr, 0, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_delta(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D <= 64) return static_cast<int>(launch_bwd<64, false, true>(maps, maps + 4, p, bd, B, s, gqa));
  return static_cast<int>(launch_bwd<128, false, true>(maps, maps + 4, p, bd, B, s, gqa));
}
#endif  // GEN3C_ATTN_FWD_ONLY
