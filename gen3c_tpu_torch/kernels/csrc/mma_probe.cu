// P1: a matmul-rate probe of the card's mma.sync tensor-core path, bf16
// against int8, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/probe_int8_attention.py
// (_mm_loop_kernel, :37-62, pl.pallas_call at :59), which keeps one (M, K) x
// (K, N) tile resident in VMEM and issues the product R times inside a
// fori_loop, adding i % 2 to A on each pass so that the compiler cannot hoist
// the product out of the loop:
//   out = sum_{i < R} (A + i % 2) . B      (bf16 -> fp32, int8 -> int32)
// A + 1 is rounded to bf16 (__hadd2) or wraps in int8 (__vadd4), as the
// Pallas add in the operand dtype does; int32 sums wrap as the MMA's do.
//
// Here each CTA (four warps) holds a 64 x BN block of the output, with its
// 64 x K rows of A and BN x K rows of B^T resident in shared memory for the
// whole run, and issues the block's product R times: per 16 (bf16) or 32
// (int8) of K, each warp reads its A fragment and BN/8 B fragments with
// 32-bit shared loads and issues BN/8 mma.sync m16n8k16 (bf16 x bf16 -> fp32)
// or m16n8k32 (s8 x s8 -> s32), the instruction and the operand path that
// the port's kernels (attention.cu, attention_bwd.cu, w8a8.cu) are built on.
// The grid has at least min_ctas CTAs (the wrapper asks for one or more per
// SM): CTA c computes block c % nblocks, so small outputs are computed
// several times over (each copy writes the same bits). What bounds it is
// the rate at which the SM issues the MMAs and their shared loads, and,
// with one CTA of four warps per SM, each MMA's latency: its time against
// the dense tensor-core peak (989 TF/s bf16, 1,979 TOPS int8) tells how far
// mma.sync can go before wgmma.
//
// Layout: a (M, K) and bT (N, K) row-major contiguous, K % 32 == 0 and K <=
// 1024, out (M, N) contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kBM = 64;

struct Probe {
  const void* a;
  const void* bT;
  void* out;
  int M, N, K, reps, nblocks;
};

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A + 1 on a register of packed operands: two bf16 (rounded) or four int8 (wrapping)
__device__ __forceinline__ uint32_t plus_one(uint32_t x, __nv_bfloat16) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  v = __hadd2(v, __floats2bfloat162_rn(1.f, 1.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t plus_one(uint32_t x, int8_t) {
  return __vadd4(x, 0x01010101u);
}

template <typename T> struct Acc;
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads) mma_probe(const Probe p) {
  constexpr int kElem = sizeof(T);
  constexpr int kStep = 32 / kElem;          // K per MMA: 16 bf16, 32 int8
  constexpr int kPad = 16 / kElem;           // 16 bytes: conflict-free fragment reads
  using AccT = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = p.K + kPad;              // elements
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sB = sA + kBM * pitch;

  const int nb_n = (p.N + BN - 1) / BN;
  const int block = blockIdx.x % p.nblocks;
  const int m0 = (block / nb_n) * kBM;
  const int n0 = (block % nb_n) * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;

  // stage the CTA's operands once, 16 bytes at a time, zero past M or N
  const int chunks = p.K * kElem / 16;
  const T* a = static_cast<const T*>(p.a);
  const T* bT = static_cast<const T*>(p.bT);
  for (int i = threadIdx.x; i < (kBM + BN) * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * (16 / kElem);
    const bool is_a = r < kBM;
    const int row = is_a ? m0 + r : n0 + r - kBM;
    const bool ok = row < (is_a ? p.M : p.N);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok) v = *reinterpret_cast<const uint4*>((is_a ? a : bT) + static_cast<long long>(row) * p.K + c);
    *reinterpret_cast<uint4*>((is_a ? sA + r * pitch : sB + (r - kBM) * pitch) + c) = v;
  }
  __syncthreads();

  AccT acc[BN / 8][4];
#pragma unroll
  for (int t = 0; t < BN / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = AccT(0);

  const int wrow = warp * 16;
  for (int it = 0; it < p.reps; ++it) {
    const bool odd = it & 1;
    for (int kk = 0; kk < p.K; kk += kStep) {
      // A fragment: rows g, g + 8; K elements tg*(4/kElem)... as the MMA's layout
      const T* pa = sA + (wrow + g) * pitch + kk + tg * (4 / kElem);
      uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(pa),
                        *reinterpret_cast<const uint32_t*>(pa + 8 * pitch),
                        *reinterpret_cast<const uint32_t*>(pa + kStep / 2),
                        *reinterpret_cast<const uint32_t*>(pa + 8 * pitch + kStep / 2)};
      if (odd) {
#pragma unroll
        for (int j = 0; j < 4; ++j) af[j] = plus_one(af[j], T());
      }
#pragma unroll
      for (int t = 0; t < BN / 8; ++t) {
        const T* pb = sB + (t * 8 + g) * pitch + kk + tg * (4 / kElem);
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(pb),
                                *reinterpret_cast<const uint32_t*>(pb + kStep / 2)};
        mma(acc[t], af, bf);
      }
    }
  }

  // fragment e holds row g (+8 for e >= 2), column tg*2 + (e & 1)
  AccT* out = static_cast<AccT*>(p.out);
#pragma unroll
  for (int t = 0; t < BN / 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wrow + g + 8 * (e >> 1);
      const int col = n0 + t * 8 + tg * 2 + (e & 1);
      if (row < p.M && col < p.N) out[static_cast<long long>(row) * p.N + col] = acc[t][e];
    }
  }
}

template <typename T, int BN>
cudaError_t launch(const Probe& p, int grid, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kBM + BN) * (p.K + 16 / sizeof(T)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(mma_probe<T, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mma_probe<T, BN><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// a (M, K), bT (N, K), out (M, N): bf16 -> fp32 (int8 == 0) or int8 -> int32.
// bn: the CTA's output columns, 32 or 64 (the caller picks what fits in
// shared memory: (64 + bn) * (K + 16 bytes)). min_ctas: the least grid,
// e.g. the SM count. Returns a cudaError_t (0 on success).
extern "C" int gen3c_mma_probe(const void* a, const void* bT, void* out, int M, int N, int K,
                               int reps, int int8, int bn, int min_ctas, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || K > 1024 || reps < 0 ||
      (bn != 32 && bn != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Probe p = {a, bT, out, M, N, K, reps, 0};
  p.nblocks = ((M + kBM - 1) / kBM) * ((N + bn - 1) / bn);
  const int grid = p.nblocks > min_ctas ? p.nblocks : min_ctas;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return static_cast<int>(bn == 64 ? launch<int8_t, 64>(p, grid, s)
                                             : launch<int8_t, 32>(p, grid, s));
  return static_cast<int>(bn == 64 ? launch<__nv_bfloat16, 64>(p, grid, s)
                                   : launch<__nv_bfloat16, 32>(p, grid, s));
}
