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
//   K7   w8a8_gemm    codes (M, K) x weight codes (N, K)^T -> (M, N): int32
//        accumulators, then (float(acc) * xscale[m]) * wscale[n] cast to
//        bf16 or fp32 (or the raw int32 accumulators), in that order.
//
// What bounds it: at the GEN3C-7B linear shapes (M = 112,640 tokens, K and N
// 4,096 or 16,384) the GEMM does 2*M*N*K int8 operations against (M + N)*K
// bytes of codes: far above the card's op:byte ridge, so the tensor-core
// rate bounds it (1,979 TOPS int8 dense). This first version uses
// mma.sync.m16n8k32 (s8 x s8 -> s32) on 128 x 128 CTA tiles with 64-byte K
// steps, eight warps of 64 x 32, a three-stage cp.async ring, and 32-bit
// shared loads of the fragments from rows padded to 80 bytes (conflict
// free). WGMMA and TMA are left to later work. K7q is bound by the bytes of
// x (one read for the absmax, one for the codes, mostly from L1/L2).
//
// Shapes: M, N, K arbitrary. Ragged tiles are zero-filled in shared memory;
// rows whose K-extent is not 16-byte aligned are loaded byte by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------- K7q --------------------------------------

constexpr int kQuantWarps = 8;  // one row per warp

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
    quant_rows(const T* __restrict__ x, long long ld, int M, int K,
               int8_t* __restrict__ q, float* __restrict__ scale) {
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + static_cast<long long>(row) * ld;
  float amax = 0.f;
  for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float s = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-12f);
  int8_t* qr = q + static_cast<long long>(row) * K;
  for (int c = lane; c < K; c += 32) {
    const int v = __float2int_rn(__fdiv_rn(to_f32(xr[c]), s));
    qr[c] = static_cast<int8_t>(max(-127, min(127, v)));
  }
  if (lane == 0) scale[row] = s;
}

// ------------------------------- K7 ---------------------------------------

constexpr int kBM = 128;        // rows of x per CTA
constexpr int kBN = 128;        // rows of the weight (output columns) per CTA
constexpr int kBK = 64;         // bytes of K per stage
constexpr int kPitch = kBK + 16;  // padded smem row: conflict-free fragments
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;  // 8 warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int kStageBytes = (kBM + kBN) * kPitch;
static_assert(kBM == kBN, "load_operand stages kBM rows of either operand");

enum Epilogue { kAccInt32 = 0, kOutF32 = 1, kOutBF16 = 2 };

struct GemmParams {
  const int8_t* a;  // (M, K), row stride lda
  const int8_t* b;  // (N, K), row stride ldb
  const float* xscale;  // (M,)
  const float* wscale;  // (N,)
  void* out;            // (M, N) contiguous
  long long lda, ldb;
  int M, N, K;
};

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [r0, r0 + 128) x bytes [k0, k0 + 64) of a (rows, K) int8 matrix
// into smem (pitch kPitch), zero-filling rows >= rows and bytes >= K.
template <bool VEC>
__device__ __forceinline__ void load_operand(int8_t* smem, const int8_t* g,
                                             long long ld, int r0, int rows,
                                             int k0, int K) {
  constexpr int kChunks = kBK / 16;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBM * kChunks; i += kGemmThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    int8_t* dst = smem + r * kPitch + c;
    const int gr = r0 + r;
    const int gk = k0 + c;
    if (VEC) {  // K % 16 == 0 and 16-byte aligned rows: a chunk is all in or out
      if (gr < rows && gk < K) {
        cp_async16(dst, g + static_cast<long long>(gr) * ld + gk);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
        const int8_t* src = g + static_cast<long long>(gr) * ld;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (gk + j < K) {
            w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[gk + j]))
                        << (8 * (j % 4));
          }
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_stage(int8_t* stage, const GemmParams& p,
                                           int m0, int n0, int kt) {
  load_operand<VEC>(stage, p.a, p.lda, m0, p.M, kt * kBK, p.K);
  load_operand<VEC>(stage + kBM * kPitch, p.b, p.ldb, n0, p.N, kt * kBK, p.K);
}

template <int EPI, bool VEC>
__global__ void __launch_bounds__(kGemmThreads) w8a8_gemm(const GemmParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread in group
  const int wm = (warp / 4) * 64;  // warp's rows in the CTA tile
  const int wn = (warp % 4) * 32;  // warp's columns

  int acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage<VEC>(smem + s * kStageBytes, p, m0, n0, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; tile kt-1 consumed
    const int nt = kt + kStages - 1;
    if (nt < ktiles) load_stage<VEC>(smem + (nt % kStages) * kStageBytes, p, m0, n0, nt);
    cp_async_commit();

    const int8_t* sA = smem + (kt % kStages) * kStageBytes;
    const int8_t* sB = sA + kBM * kPitch;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* pa = sA + (wm + i * 16 + g) * kPitch + ks + tg * 4;
        a[i][0] = lds32(pa);
        a[i][1] = lds32(pa + 8 * kPitch);
        a[i][2] = lds32(pa + 16);
        a[i][3] = lds32(pa + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* pb = sB + (wn + j * 8 + g) * kPitch + ks + tg * 4;
        b[j][0] = lds32(pb);
        b[j][1] = lds32(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment e holds row g (+8 for e >= 2), column tg*2 + (e & 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + wm + i * 16 + g + 8 * e2;
      if (row >= p.M) continue;
      const float xs = EPI == kAccInt32 ? 0.f : p.xscale[row];
      const long long base = static_cast<long long>(row) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int col = n0 + wn + j * 8 + tg * 2 + e1;
          if (col >= p.N) continue;
          const int v = acc[i][j][2 * e2 + e1];
          if (EPI == kAccInt32) {
            static_cast<int*>(p.out)[base + col] = v;
          } else {
            const float r =
                __fmul_rn(__fmul_rn(__int2float_rn(v), xs), p.wscale[col]);
            if (EPI == kOutF32) {
              static_cast<float*>(p.out)[base + col] = r;
            } else {
              static_cast<__nv_bfloat16*>(p.out)[base + col] = __float2bfloat16_rn(r);
            }
          }
        }
      }
    }
  }
}

template <int EPI, bool VEC>
cudaError_t launch_gemm(const GemmParams& p, cudaStream_t stream) {
  const int smem = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_gemm<EPI, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  w8a8_gemm<EPI, VEC><<<grid, kGemmThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t dispatch_gemm(const GemmParams& p, bool vec, cudaStream_t stream) {
  return vec ? launch_gemm<EPI, true>(p, stream) : launch_gemm<EPI, false>(p, stream);
}

}  // namespace

// K7q. x: (M, K) rows of stride ld elements, unit stride along K;
// is_bf16: 1 for bf16 x, 0 for fp32. q: (M, K) int8 contiguous; scale: (M,).
extern "C" int gen3c_quant_rows(const void* x, long long ld, int M, int K,
                                int is_bf16, void* q, void* scale,
                                void* stream) {
  if (M <= 0 || K <= 0 || ld < K) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kQuantWarps - 1) / kQuantWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    quant_rows<__nv_bfloat16><<<grid, kQuantWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ld, M, K, static_cast<int8_t*>(q),
        static_cast<float*>(scale));
  } else {
    quant_rows<float><<<grid, kQuantWarps * 32, 0, s>>>(
        static_cast<const float*>(x), ld, M, K, static_cast<int8_t*>(q),
        static_cast<float*>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

// K7. a: (M, K) int8, row stride lda; b: (N, K) int8, row stride ldb;
// xscale (M,), wscale (N,) fp32 (ignored for epi 0); out (M, N) contiguous:
// epi 0 int32 accumulators, 1 fp32, 2 bf16. vec: nonzero when K, lda and
// ldb are multiples of 16 and a and b are 16-byte aligned.
extern "C" int gen3c_w8a8_gemm(const void* a, long long lda, const void* b,
                               long long ldb, const void* xscale,
                               const void* wscale, void* out, int M, int N,
                               int K, int epi, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || lda < K || ldb < K || epi < 0 || epi > 2 ||
      (M + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GemmParams p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.xscale = static_cast<const float*>(xscale);
  p.wscale = static_cast<const float*>(wscale);
  p.out = out;
  p.lda = lda;
  p.ldb = ldb;
  p.M = M;
  p.N = N;
  p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (epi == kAccInt32) return static_cast<int>(dispatch_gemm<kAccInt32>(p, v, s));
  if (epi == kOutF32) return static_cast<int>(dispatch_gemm<kOutF32>(p, v, s));
  return static_cast<int>(dispatch_gemm<kOutBF16>(p, v, s));
}
