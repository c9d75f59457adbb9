// W8A8 linear for Hopper (sm_90a): per-token int8 activations x per-channel
// int8 weights, int32 accumulation, fp32 rescale.
//
// Replaces gen3c_tpu/models/quantize.py::w8a8_matmul (:48-69), which XLA
// runs on the TPU's int8 MXU path, as two kernels:
//   K7q  quant_rows   x (M, K) bf16/fp32 -> codes (M, K) int8 + scale (M,)
//        fp32: scale = max(absmax * fp32(1/127), 1e-12) (XLA compiles
//        quantize.py's `absmax / 127.0` into that multiply), code =
//        clip(rint(x / scale), -127, 127) with a true division (__fdiv_rn)
//        and round-half-even (__float2int_rn): the numbers of the compiled
//        JAX function, bit for bit. The same kernel quantizes a weight
//        stored (out, in).
//   K7   w8a8_gemm_wgmma   codes (M, K) x weight codes (N, K)^T -> (M, N):
//        int32 accumulators, then (float(acc) * xscale[m]) * wscale[n] cast
//        to bf16 or fp32 (or the raw int32 accumulators), in that order.
//
// What bounds them. K7 at the GEN3C-7B linear shapes (M = 112,640 tokens, K
// and N 4,096 or 16,384) does 2*M*N*K int8 operations against (M + N)*K
// bytes of codes and 2*M*N of bf16 output: far above the card's op:byte
// ridge, so the tensor-core rate bounds it (1,979 TOPS int8 dense), which
// only wgmma reaches (mma.sync s8 topped out at 560.7 TOPS, PERF.md). K7q
// moves 2 bytes in and 1 out per element: the HBM rate bounds it.
//
// K7's body (w8a8_gemm_wgmma) reads both operands through 2-d TMA tensor
// maps, which need 16-byte aligned bases and row strides in 16-byte
// multiples; kernels/cuda.py copies any other operand into rows of that
// pitch first (the map's K stays the true K, so TMA zero-fills the pad).
// It writes 128 x 256 output tiles in grouped order (a band of kGroupM row
// tiles walks every column tile, so the band's codes and each weight panel
// are read from L2, not HBM, while the band runs), walked by a persistent
// grid of one CTA a SM. A producer warpgroup (one thread issues, setmaxnreg
// 40) loads 128-byte K stages of both operands with 2-d TMA (128-byte
// swizzle; a ragged M, N or K tail is zero-filled, and zero codes add
// nothing to the exact sum) into a 4-stage mbarrier ring, and runs on into
// the next tile while the consumers write one out; two consumer warpgroups
// (setmaxnreg 232) own 64 rows each and run wgmma m64n256k32 s8 x s8 -> s32,
// 128 accumulators a thread, one stage's products in flight while the next
// is issued. The epilogue rescales in registers with the tile's scales
// staged in shared memory, stages the tile beside the ring in chunks of 128
// bytes a row (padded against bank conflicts) and writes each with 16-byte
// coalesced stores. (A two-CTA cluster multicasting the weight tile, 32 KB
// a stage from L2 instead of 48, ran no faster: PERF.md.)
//
// K7q (quant_rows): one pass. A group of threads takes a row (a warp up to
// 4,096 bf16, four warps at 16,384; kQuantChunks 16-byte chunks a thread),
// loads it once into registers with 16-byte loads, reduces the absmax by
// shuffles (and across the group's warps in shared memory), and writes the
// codes 8 (bf16) or 4 (fp32) at a time. A row longer than a whole CTA holds
// (32,768 bf16, 16,384 fp32) is walked in slices of that size, each read
// again for its codes. Elements before a row's first 16-byte aligned chunk
// and after its last whole chunk are loaded one each by the first threads of
// the group, and a code chunk whose destination is unaligned is stored byte
// by byte: any K, any row stride.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.h"

namespace {

using namespace hopper;

// ------------------------------- K7q --------------------------------------

constexpr int kQuantThreads = 256;
constexpr int kQuantChunks = 16;  // 16-byte chunks of its row each thread holds

// 16 bytes of T as fp32 values.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void values(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float one(float x) { return x; }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void values(const uint4& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) { return __bfloat162float(x); }
};

__device__ __forceinline__ uint32_t code_byte(float x, float s) {
  const int v = max(-127, min(127, __float2int_rn(__fdiv_rn(x, s))));
  return static_cast<uint32_t>(v) & 0xffu;
}

// E codes (packed little-endian in w) to dst: one store where dst is
// E-byte aligned, else byte by byte.
template <int E>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint32_t (&w)[E / 4]) {
  if ((reinterpret_cast<uintptr_t>(dst) & (E - 1)) == 0) {
    if constexpr (E == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
  }
}

// Chunks [first, first + kQuantChunks * group) of a row's whole 16-byte
// chunks, chunk first + c * group + t in v[c] (zero past n_vec).
__device__ __forceinline__ void load_slice(uint4 (&v)[kQuantChunks], const uint4* xv, int first,
                                           int group, int t, int n_vec, bool live) {
#pragma unroll
  for (int c = 0; c < kQuantChunks; ++c) {
    const int ch = first + c * group + t;
    v[c] = live && ch < n_vec ? xv[ch] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// `group` threads (32 to kQuantThreads, a power of two) per row, the CTA's
// kQuantThreads / group rows one after the other. A row of more than
// kQuantChunks * group chunks is walked in slices of that many.
//
// Row-scale mode, for a row split over ranks (the input of a row-parallel
// W8A8 linear, its columns over tp): amax_out non-null writes each row's
// absmax there and nothing else (the shard's part, which the caller reduces
// by max over the ranks); amax_in non-null takes each row's absmax from
// there instead of its own, so every rank's codes and scale are those of
// the whole row. Both null: the one-pass kernel above.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows(const T* __restrict__ x, long long ld, int M, int K, int group,
               int8_t* __restrict__ q, float* __restrict__ scale,
               const float* __restrict__ amax_in, float* __restrict__ amax_out) {
  constexpr int E = Chunk<T>::kElems;
  __shared__ float part[kQuantThreads / 32];
  const int slot = threadIdx.x / group;
  const int t = threadIdx.x % group;
  const int row = blockIdx.x * (kQuantThreads / group) + slot;
  const bool live = row < M;
  const T* xr = x + static_cast<long long>(live ? row : 0) * ld;
  // the row: `head` elements to its first 16-byte aligned chunk, n_vec whole
  // chunks, `tail` elements
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(xr) & 15) / sizeof(T));
  const int head = min(mis == 0 ? 0 : E - mis, K);
  const int n_vec = (K - head) / E;
  const int tail = K - head - n_vec * E;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  const int span = kQuantChunks * group;  // chunks of a slice
  const int last = n_vec > 0 ? (n_vec - 1) / span : 0;  // the last slice

  // head and tail are < E <= 32 <= group: one element of each a thread at most
  const float xh = live && t < head ? Chunk<T>::one(xr[t]) : 0.f;
  const float xt = live && t < tail ? Chunk<T>::one(xr[head + n_vec * E + t]) : 0.f;
  float amax = fmaxf(fabsf(xh), fabsf(xt));
  uint4 v[kQuantChunks];
  for (int sl = 0; sl <= last; ++sl) {  // one slice, but for rows longer than a CTA holds
    load_slice(v, xv, sl * span, group, t, n_vec, live);
#pragma unroll
    for (int c = 0; c < kQuantChunks; ++c) {
      float f[E];
      Chunk<T>::values(v[c], f);
#pragma unroll
      for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (group > 32) {  // the row's warps meet in shared memory
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
    const int w0 = slot * (group / 32);
    amax = part[w0];
    for (int i = 1; i < group / 32; ++i) amax = fmaxf(amax, part[w0 + i]);
  }
  if (!live) return;
  if (amax_out != nullptr) {  // the row-absmax pass of the row-scale mode
    if (t == 0) amax_out[row] = amax;
    return;
  }
  if (amax_in != nullptr) amax = amax_in[row];

  const float s = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-12f);
  int8_t* qr = q + static_cast<long long>(row) * K;
  for (int sl = last; sl >= 0; --sl) {  // the last slice is still in v
    if (sl < last) load_slice(v, xv, sl * span, group, t, n_vec, live);
#pragma unroll
    for (int c = 0; c < kQuantChunks; ++c) {
      const int ch = sl * span + c * group + t;
      if (ch < n_vec) {
        float f[E];
        Chunk<T>::values(v[c], f);
        uint32_t w[E / 4];
#pragma unroll
        for (int i = 0; i < E / 4; ++i) {
          w[i] = code_byte(f[4 * i], s) | (code_byte(f[4 * i + 1], s) << 8) |
                 (code_byte(f[4 * i + 2], s) << 16) | (code_byte(f[4 * i + 3], s) << 24);
        }
        store_codes<E>(qr + head + ch * E, w);
      }
    }
  }
  if (t < head) qr[t] = static_cast<int8_t>(code_byte(xh, s));
  if (t < tail) qr[head + n_vec * E + t] = static_cast<int8_t>(code_byte(xt, s));
  if (t == 0) scale[row] = s;
}

// --------------------------- K7: the wgmma body -----------------------------

enum Epilogue { kAccInt32 = 0, kOutF32 = 1, kOutBF16 = 2 };

constexpr int kWgBM = 128;       // rows of x per CTA (two consumer warpgroups of 64)
constexpr int kWgBN = 256;       // rows of the weight (output columns) per CTA
constexpr int kWgBK = 128;       // bytes of K per stage: one 128-byte swizzle row
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 256;
constexpr int kWgThreads = kWgConsumers + 128;  // and one producer warpgroup
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;
static_assert(128 * kWgProducerRegs + kWgConsumers * kWgConsumerRegs <= 65536,
              "the register split must fit the SM");
constexpr int kGroupM = 16;  // row tiles per band of the tile order

// The epilogue stages a warpgroup's 64 rows in chunks of 128 bytes of
// output a row (64 bf16 or 32 int32 / fp32 columns), rows padded by 8
// elements so that the accumulator layout's stores hit distinct banks.
template <int EPI>
struct Staged {
  static constexpr int kEs = EPI == kOutBF16 ? 2 : 4;
  static constexpr int kCols = 128 / kEs;
  static constexpr int kPitch = 128 + 8 * kEs;
  static constexpr int kChunks = kWgBN / kCols;
};

struct WgSmem {
  static constexpr int kA = kWgBM * kWgBK;  // 16 KB
  static constexpr int kB = kWgBN * kWgBK;  // 32 KB
  static constexpr int kStage = kA + kB;
  static constexpr int kRing = kWgStages * kStage;  // 192 KB
  // per consumer warpgroup, after the ring: a staged chunk, then its 64
  // xscale rows and the tile's kWgBN wscale columns
  static constexpr int kChunk = 64 * Staged<kAccInt32>::kPitch;
  static constexpr int kPerWg = kChunk + (64 + kWgBN) * 4;
  static constexpr int kBars = 2 * kWgStages * 8;
  static constexpr int kBytes = 1024 + kRing + 2 * kPerWg + kBars;
};
static_assert(Staged<kOutBF16>::kPitch <= Staged<kAccInt32>::kPitch, "kChunk holds every epilogue");

struct WgParams {
  const float* xscale;  // (M,)
  const float* wscale;  // (N,)
  void* out;            // (M, N) contiguous
  int M, N, K;
  int tiles_m, tiles_n;
  int vec_out;  // rows of out are whole 16-byte chunks from a 16-byte aligned base
};

// The origin of output tile `tile` in grouped order: kGroupM row tiles walk
// every column tile, then the next band.
__device__ __forceinline__ void tile_origin(int tile, const WgParams& p, int& m0, int& n0) {
  const int per_band = kGroupM * p.tiles_n;
  const int first_m = (tile / per_band) * kGroupM;
  const int band_m = min(kGroupM, p.tiles_m - first_m);
  const int in_band = tile % per_band;
  m0 = (first_m + in_band % band_m) * kWgBM;
  n0 = (in_band / band_m) * kWgBN;
}

// Persistent: each CTA walks the tiles blockIdx.x, + gridDim.x, ... The
// producer runs on into the next tile's stages while the consumers finish
// a tile and write it out, so the ring is full when they start the next.
template <int EPI>
__global__ void __launch_bounds__(kWgThreads, 1)
    w8a8_gemm_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                    const WgParams p) {
  using S = WgSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kRing + 2 * S::kPerWg);
  uint64_t* empty = full + kWgStages;
  const int ktiles = (p.K + kWgBK - 1) / kWgBK;
  const int n_tiles = p.tiles_m * p.tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {  // producer
    setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == kWgConsumers) {
      tma_prefetch_map(&ta);
      tma_prefetch_map(&tb);
      int it = 0;  // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, p, m0, n0);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kWgStages;
          mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          unsigned char* stage = smem + s * S::kStage;
          mbar_arrive_expect_tx(&full[s], S::kStage);
          tma_load_2d(stage, &ta, &full[s], kt * kWgBK, m0);
          tma_load_2d(stage + S::kA, &tb, &full[s], kt * kWgBK, n0);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<kWgConsumerRegs>();
    using St = Staged<EPI>;
    const int tid = threadIdx.x % 128;
    const int cw = threadIdx.x / 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int tg = lane & 3;
    unsigned char* chunk = smem + S::kRing + cw * S::kPerWg;
    float* xs = reinterpret_cast<float*>(chunk + S::kChunk);  // 64 rows, then kWgBN columns
    const float* ws = xs + 64;
    const uint32_t ring = smem_u32(smem);
    unsigned char* out = static_cast<unsigned char*>(p.out);
    int it = 0;  // stages consumed so far, over all tiles
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, p, m0, n0);
      int acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kWgStages;
        mbar_wait(&full[s], (it / kWgStages) & 1);
        const uint32_t a_at = ring + s * S::kStage + cw * 64 * kWgBK;
        const uint32_t b_at = ring + s * S::kStage + S::kA;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 32; ++kk) {
          wgmma_ss_s8_n256(acc, wgmma_desc(a_at + kk * 32, 16, 1024),
                           wgmma_desc(b_at + kk * 32, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_regs(acc);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kWgStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kWgStages]);  // the tile's last stage

      // Epilogue of this warpgroup's 64 rows, beside the ring: the scales,
      // then the tile in chunks, each staged, then stored 16 bytes a thread.
      named_barrier_sync(2 + cw, 128);  // the previous tile's chunk and scales are read
      if constexpr (EPI != kAccInt32) {
        for (int i = tid; i < 64 + kWgBN; i += 128) {
          float v = 0.f;
          if (i < 64) {
            if (m0 + cw * 64 + i < p.M) v = p.xscale[m0 + cw * 64 + i];
          } else if (n0 + i - 64 < p.N) {
            v = p.wscale[n0 + i - 64];
          }
          xs[i] = v;
        }
        named_barrier_sync(2 + cw, 128);
      }
#pragma unroll
      for (int c = 0; c < St::kChunks; ++c) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + g + 8 * i;
          unsigned char* trow = chunk + r * St::kPitch;
          const float xsr = EPI == kAccInt32 ? 0.f : xs[r];
#pragma unroll
          for (int jj = 0; jj < St::kCols / 8; ++jj) {
            const int j = c * (St::kCols / 8) + jj;
            const int col = 8 * jj + 2 * tg;  // in the chunk
            const int v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
            if constexpr (EPI == kAccInt32) {
              *reinterpret_cast<int2*>(trow + col * 4) = make_int2(v0, v1);
            } else {
              const float2 wsc = *reinterpret_cast<const float2*>(ws + c * St::kCols + col);
              const float r0 = __fmul_rn(__fmul_rn(__int2float_rn(v0), xsr), wsc.x);
              const float r1 = __fmul_rn(__fmul_rn(__int2float_rn(v1), xsr), wsc.y);
              if constexpr (EPI == kOutF32) {
                *reinterpret_cast<float2*>(trow + col * 4) = make_float2(r0, r1);
              } else {
                *reinterpret_cast<uint32_t*>(trow + col * 2) = pack_bf16x2(r0, r1);
              }
            }
          }
        }
        named_barrier_sync(2 + cw, 128);  // the chunk is staged
#pragma unroll
        for (int piece = tid; piece < 64 * 8; piece += 128) {  // 8 pieces of 16 bytes a row
          const int r = piece / 8;
          const int row = m0 + cw * 64 + r;
          const int col = n0 + c * St::kCols + (piece % 8) * (16 / St::kEs);
          if (row >= p.M || col >= p.N) continue;
          const unsigned char* src = chunk + r * St::kPitch + (piece % 8) * 16;
          unsigned char* dst = out + (static_cast<long long>(row) * p.N + col) * St::kEs;
          if (p.vec_out && col + 16 / St::kEs <= p.N) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < 16 / St::kEs && col + e < p.N; ++e) {
              if constexpr (St::kEs == 2) {
                reinterpret_cast<uint16_t*>(dst)[e] = reinterpret_cast<const uint16_t*>(src)[e];
              } else {
                reinterpret_cast<uint32_t*>(dst)[e] = reinterpret_cast<const uint32_t*>(src)[e];
              }
            }
          }
        }
        if (c + 1 < St::kChunks) named_barrier_sync(2 + cw, 128);  // read before rewritten
      }
    }
  }
}

// ---------------------------------- host ------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The map words of one operand, as kernels/cuda.py w8a8_map_params packs
// them: dims (K, rows), the row stride in bytes, box (kWgBK bytes, `rows`
// rows), swizzle bytes.
constexpr int kGemmMapWords = 6;

cudaError_t make_gemm_map(CUtensorMap* map, const void* base, const long long* w, int K,
                          int n_rows, int box_rows) {
  if (w[0] != K || w[1] != n_rows || w[2] < K || w[2] % 16 != 0 || w[3] != kWgBK ||
      w[4] != box_rows || w[5] != 128 || (reinterpret_cast<uintptr_t>(base) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w[0]), static_cast<cuuint64_t>(w[1])};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(w[2])};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(w[3]), static_cast<cuuint32_t>(w[4])};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What a launch needs of the runtime besides the kernel, asked once a device:
// K7 runs 280 times a 7B forward, the text k/v calls in tens of microseconds.
constexpr int kMaxDevices = 64;

cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  if (device < kMaxDevices && (*sms = known[device].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) known[device].store(*sms);
  return err;
}

template <int EPI>
cudaError_t launch_wgmma(const CUtensorMap* maps, const WgParams& p, cudaStream_t stream) {
  auto kernel = w8a8_gemm_wgmma<EPI>;
  static std::atomic<bool> smem_set[kMaxDevices];  // this instantiation's, a device
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && !(device < kMaxDevices && smem_set[device].load())) {
    err = set_smem(kernel, WgSmem::kBytes);
    if (err == cudaSuccess && device < kMaxDevices) smem_set[device].store(true);
  }
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int tiles = p.tiles_m * p.tiles_n;  // one CTA a SM, each walking its tiles
  kernel<<<min(tiles, sms), kWgThreads, WgSmem::kBytes, stream>>>(maps[0], maps[1], p);
  return cudaGetLastError();
}

}  // namespace

// K7q. x: (M, K) rows of stride ld elements, unit stride along K, any
// alignment; is_bf16: 1 for bf16 x, 0 for fp32. q: (M, K) int8 contiguous;
// scale: (M,). amax_in / amax_out (M,) fp32 or null: the row-scale mode
// (quant_rows): amax_out set writes the rows' absmax only (q and scale
// unused), amax_in set quantizes with the given absmax.
extern "C" int gen3c_quant_rows(const void* x, long long ld, int M, int K,
                                int is_bf16, void* q, void* scale,
                                const void* amax_in, void* amax_out,
                                void* stream) {
  if (M <= 0 || K <= 0 || ld < K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elems = is_bf16 ? 8 : 4;
  int group = 32;
  while (group < kQuantThreads && group * kQuantChunks * elems < K) group *= 2;
  const int rows = kQuantThreads / group;
  const dim3 grid((M + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    quant_rows<__nv_bfloat16><<<grid, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ld, M, K, group, static_cast<int8_t*>(q),
        static_cast<float*>(scale), static_cast<const float*>(amax_in),
        static_cast<float*>(amax_out));
  } else {
    quant_rows<float><<<grid, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), ld, M, K, group, static_cast<int8_t*>(q),
        static_cast<float*>(scale), static_cast<const float*>(amax_in),
        static_cast<float*>(amax_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The box rows of K7's tensor maps (kernels/cuda.py builds the maps' words
// with them, and checks them when the library loads): x, then the weight.
extern "C" void gen3c_w8a8_box_rows(int* rows) {
  rows[0] = kWgBM;
  rows[1] = kWgBN;
}

// K7. a: (M, K) int8, b: (N, K) int8, each through its
// tensor map (words: 2 x kGemmMapWords, see make_gemm_map); xscale (M,),
// wscale (N,) fp32 (ignored for epi 0); out (M, N) contiguous: epi 0 int32
// accumulators, 1 fp32, 2 bf16. Returns a cudaError_t (0 on success).
extern "C" int gen3c_w8a8_gemm_wgmma(const void* a, const void* b, const long long* words,
                                     const void* xscale, const void* wscale, void* out, int M,
                                     int N, int K, int epi, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epi < 0 || epi > 2 ||
      (epi != kAccInt32 && (xscale == nullptr || wscale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgParams p;
  p.tiles_m = (M + kWgBM - 1) / kWgBM;
  p.tiles_n = (N + kWgBN - 1) / kWgBN;
  if (static_cast<long long>(p.tiles_m) * p.tiles_n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[2];
  cudaError_t err = make_gemm_map(&maps[0], a, words, K, M, kWgBM);
  if (err == cudaSuccess) err = make_gemm_map(&maps[1], b, words + kGemmMapWords, K, N, kWgBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.xscale = static_cast<const float*>(xscale);
  p.wscale = static_cast<const float*>(wscale);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  const int es = epi == kOutBF16 ? 2 : 4;
  p.vec_out = (static_cast<long long>(N) * es) % 16 == 0 &&
              (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi == kAccInt32) return static_cast<int>(launch_wgmma<kAccInt32>(maps, p, s));
  if (epi == kOutF32) return static_cast<int>(launch_wgmma<kOutF32>(maps, p, s));
  return static_cast<int>(launch_wgmma<kOutBF16>(maps, p, s));
}
