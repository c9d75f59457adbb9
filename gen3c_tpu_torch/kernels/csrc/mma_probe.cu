// P1: a matmul-rate probe of the card's wgmma tensor-core path, bf16 against
// int8, at the instruction forms the port's kernels issue, for Hopper (sm_90a).
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
// What bounds it. Operations: 2 M K N R of them against the dense
// tensor-core peak (989 TF/s bf16, 1,979 TOPS int8), since the operands stay
// in shared memory and device memory sees them once a unit. Under that, the
// SM's shared-memory bandwidth (128 bytes a clock) where an instruction
// reads both operands from it: at 4,096 bf16 flops (8,192 int8 ops) a clock
// an SM, an m64nNk16 SS product reads (64 + N) x 32 bytes in N / 8 clocks,
// so n64 needs 128 bytes a clock (the limit), n128 96, n256 80; the RS form
// (A in registers) reads only B, 64 bytes a clock at n128. The s8 k32 forms
// read the same bytes in the same clocks. P1 measures how near each form
// comes to the peak: the ceilings of K1's S product (SS n64), P2's 128-key
// points (SS n128), K1's P.V (RS n128) and K7's product (s8 SS n256).
//
// Design. The work is cut into units of (a 128-row M tile, an N tile of the
// instruction's width, a K chunk, a slice of the R passes), one CTA a unit
// (kernels/cuda.py mma_probe_plan, recomputed and checked here). A K chunk
// is as many k steps (32 bytes of K) as fit the unit's A, A + 1 and B^T in
// shared memory (SS) or A and A + 1 in registers (RS, kRsMaxSteps); R is
// cut into slices so that the units fill the SMs in whole waves of one CTA
// an SM (every CTA asks for at least kOneCta bytes). A CTA stages its
// operands once, 16 bytes a thread, in the 128-byte swizzle of hopper.h,
// with A + 1 computed in the same pass, so an odd pass only switches
// descriptors. Two warpgroups of 64 rows then issue the unit's products,
// one pass committed as a group and kept in flight behind the next
// (wgmma_wait<1>), and write their sums to a scratch partial. A second
// kernel sums the partials into out: int32 wrapping in any order, fp32 in
// partial order.
//
// Layout: a (M, K) row-major; SS: bT (N, K) row-major; RS (bf16 only): b
// (K, b_pitch) row-major, b_pitch >= N a multiple of 8, zero past N. K % 32
// == 0. out (M, N) contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.h"

namespace {

using namespace hopper;

constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kBM = 128;            // rows of A a unit: 64 a warpgroup
constexpr int kSmemLimit = 232448;  // a CTA's shared memory
constexpr int kAlign = 1024;        // the swizzle atom's alignment
constexpr int kOneCta = 120 * 1024; // more than half an SM's: one CTA an SM
constexpr int kRsMaxSteps = 8;      // k steps of A and A + 1 a thread holds (RS)
constexpr int kWavesMax = 4;        // the most units the slice search looks at, in waves
constexpr int kSumThreads = 256;

// the most k steps an SS unit's shared memory holds: 128-byte K blocks of
// A, A + 1 and B^T rows
__host__ __device__ constexpr int ss_max_steps(int ni) {
  return 4 * ((kSmemLimit - kAlign) / ((2 * kBM + ni) * 128));
}

struct Plan {
  long long chunk_steps, chunks, slices, smem, units, scratch;
};
constexpr int kPlanWords = 6;

struct Probe {
  const void* a;
  const void* b;
  void* partial;  // (slices * chunks, m_tiles * kBM, n_tiles * NI)
  int M, N, K, b_pitch, reps;
  int m_tiles, n_tiles, chunks, chunk_steps, slices;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// kernels/cuda.py mma_probe_plan, line for line.
Plan make_plan(int M, int N, int K, int reps, int elem, int ni, int rs, int sms) {
  Plan p;
  const long long steps = static_cast<long long>(K) * elem / 32;
  const long long m_tiles = cdiv(M, kBM), n_tiles = cdiv(N, ni);
  const long long max_steps = rs ? kRsMaxSteps : ss_max_steps(ni);
  p.chunks = cdiv(steps, max_steps);
  p.chunk_steps = cdiv(steps, p.chunks);
  const long long bytes = rs ? static_cast<long long>(ni) * p.chunk_steps * 32
                             : static_cast<long long>(2 * kBM + ni) * 128 * cdiv(p.chunk_steps, 4);
  p.smem = kAlign + bytes > kOneCta ? kAlign + bytes : kOneCta;
  const long long base = m_tiles * n_tiles * p.chunks;
  p.slices = 1;
  if (reps > 1) {
    const long long lo = reps < cdiv(sms, base) ? reps : cdiv(sms, base);
    const long long cap = static_cast<long long>(kWavesMax) * sms / base;
    const long long hi = (reps < cap ? reps : cap) > lo ? (reps < cap ? reps : cap) : lo;
    // the fewest slices whose units fill their waves best: filled = units /
    // (waves * sms), compared as fractions
    long long best_units = 0, best_slots = 1;
    for (long long s = lo; s <= hi; ++s) {
      const long long units = base * s, slots = cdiv(units, sms) * sms;
      if (units * best_slots > best_units * slots) {
        p.slices = s;
        best_units = units;
        best_slots = slots;
      }
    }
  }
  p.units = base * p.slices;
  p.scratch = p.slices * p.chunks * m_tiles * kBM * n_tiles * ni;
  return p;
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
template <> struct Acc<__nv_bfloat16> { using type = float; using pair = float2; };
template <> struct Acc<int8_t> { using type = int; using pair = int2; };

// One k step of an SS product, chosen by the accumulator's type and size.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_ss_n64(d, da, db, 1);
}
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_ss_n128(d, da, db, 1);
}
__device__ __forceinline__ void mma_ss(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_ss_n256(d, da, db, 1);
}
__device__ __forceinline__ void mma_ss(int (&d)[64], uint64_t da, uint64_t db) {
  wgmma_ss_s8_n128(d, da, db);
}
__device__ __forceinline__ void mma_ss(int (&d)[128], uint64_t da, uint64_t db) {
  wgmma_ss_s8_n256(d, da, db);
}

// RS: the unit's k steps of P.V's form, A (or A + 1) from registers, B
// MN-major with lbo bytes from one 64-column half to the next.
__device__ __forceinline__ void rs_pass(float (&acc)[64], const uint32_t (&fa)[kRsMaxSteps][4],
                                        uint32_t b_at, uint32_t lbo, int steps) {
#pragma unroll
  for (int kk = 0; kk < kRsMaxSteps; ++kk) {
    if (kk < steps) wgmma_rs_n128(acc, fa[kk], wgmma_desc(b_at + kk * 2048, lbo, 1024));
  }
}

template <typename T, int NI, bool RS>
__global__ void __launch_bounds__(kThreads, 1) mma_probe(const Probe p) {
  using AccT = typename Acc<T>::type;
  constexpr int kE = sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);

  // the unit: n tile fastest, then m tile, K chunk, R slice
  int u = blockIdx.x;
  const int nt = u % p.n_tiles;
  u /= p.n_tiles;
  const int mt = u % p.m_tiles;
  u /= p.m_tiles;
  const int chunk = u % p.chunks;
  const int slice = u / p.chunks;
  const int m0 = mt * kBM, n0 = nt * NI;
  const int step0 = chunk * p.chunk_steps;
  const int steps = min(p.chunk_steps, p.K * kE / 32 - step0);
  const int r0 = static_cast<int>(static_cast<long long>(slice) * p.reps / p.slices);
  const int r1 = static_cast<int>(static_cast<long long>(slice + 1) * p.reps / p.slices);

  const int tid = threadIdx.x % 128;
  const int cw = threadIdx.x / 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const unsigned char* a = static_cast<const unsigned char*>(p.a);
  const unsigned char* b = static_cast<const unsigned char*>(p.b);
  const long long row_bytes = static_cast<long long>(p.K) * kE;  // of A and bT

  AccT acc[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) acc[i] = AccT(0);

  if constexpr (RS) {
    // B's chunk rows, MN-major: 64-column halves of chunk_steps * 16 rows
    const uint32_t lbo = p.chunk_steps * 16 * 128;
    const int pieces = NI / 8;  // 16 bytes (8 bf16) each
    for (int i = threadIdx.x; i < steps * 16 * pieces; i += kThreads) {
      const int r = i / pieces, c = i % pieces;
      const int col = n0 + 8 * c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col < p.b_pitch) {
        v = *reinterpret_cast<const uint4*>(
            b + (static_cast<long long>(step0 * 16 + r) * p.b_pitch + col) * 2);
      }
      *reinterpret_cast<uint4*>(smem + (c / 8) * lbo + r * 128 + (((c % 8) ^ (r & 7)) << 4)) = v;
    }
    // A and A + 1 as the A fragments of each k step: rows row (+ 8), K
    // elements 2 tg (+ 8) of the step, as hopper.h's layout
    uint32_t fa[kRsMaxSteps][4], fa1[kRsMaxSteps][4];
    const int row = m0 + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < kRsMaxSteps; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = row + 8 * (e & 1);
        const int k = (step0 + kk) * 16 + 2 * tg + 8 * (e >> 1);
        uint32_t x = 0u;
        if (kk < steps && m < p.M) {
          x = *reinterpret_cast<const uint32_t*>(a + m * row_bytes + k * 2);
        }
        fa[kk][e] = x;
        fa1[kk][e] = plus_one(x, T());
      }
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t b_base = smem_u32(smem);
    for (int i = r0; i < r1; ++i) {
      const uint32_t b_at = opaque(b_base);
      fence_regs(acc);
      wgmma_fence();
      if (i & 1) {
        rs_pass(acc, fa1, b_at, lbo, steps);
      } else {
        rs_pass(acc, fa, b_at, lbo, steps);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
    }
  } else {
    // A, A + 1 and B^T: blocks of 128 bytes of K, each rows x 128 bytes
    constexpr int kMaxSteps = ss_max_steps(NI);
    const int blocks = (steps + 3) / 4;
    const int a_block = kBM * 128, b_block = NI * 128;
    unsigned char* sA = smem;
    unsigned char* sA1 = smem + blocks * a_block;
    unsigned char* sB = smem + 2 * blocks * a_block;
    const int pieces = steps * 2;  // 16 bytes each
    for (int i = threadIdx.x; i < (kBM + NI) * pieces; i += kThreads) {
      const int r = i / pieces, c = i % pieces;
      const bool is_a = r < kBM;
      const int tr = is_a ? r : r - kBM;
      const int src_row = is_a ? m0 + tr : n0 + tr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src_row < (is_a ? p.M : p.N)) {
        v = *reinterpret_cast<const uint4*>((is_a ? a : b) + src_row * row_bytes + step0 * 32 +
                                            c * 16);
      }
      const int off = (c / 8) * (is_a ? a_block : b_block) + tr * 128 + (((c % 8) ^ (tr & 7)) << 4);
      if (is_a) {
        *reinterpret_cast<uint4*>(sA + off) = v;
        *reinterpret_cast<uint4*>(sA1 + off) = make_uint4(plus_one(v.x, T()), plus_one(v.y, T()),
                                                          plus_one(v.z, T()), plus_one(v.w, T()));
      } else {
        *reinterpret_cast<uint4*>(sB + off) = v;
      }
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t a_lo = smem_u32(sA) + cw * 64 * 128, a_hi = smem_u32(sA1) + cw * 64 * 128;
    const uint32_t b_base = smem_u32(sB);
    for (int i = r0; i < r1; ++i) {
      const uint32_t a_at = opaque((i & 1) ? a_hi : a_lo);
      const uint32_t b_at = opaque(b_base);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMaxSteps; ++kk) {
        if (kk < steps) {
          mma_ss(acc, wgmma_desc(a_at + (kk / 4) * a_block + (kk % 4) * 32, 16, 1024),
                 wgmma_desc(b_at + (kk / 4) * b_block + (kk % 4) * 32, 16, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the unit's partial: element 4 j + 2 i + c at row 16 warp + g + 8 i,
  // column 8 j + 2 tg + c of the warpgroup's 64 x NI block
  using Pair = typename Acc<T>::pair;
  const long long pitch = static_cast<long long>(p.n_tiles) * NI;
  AccT* part = static_cast<AccT*>(p.partial) +
               static_cast<long long>(slice * p.chunks + chunk) * p.m_tiles * kBM * pitch;
#pragma unroll
  for (int j = 0; j < NI / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long row = m0 + cw * 64 + warp * 16 + g + 8 * i;
      Pair v;
      v.x = acc[4 * j + 2 * i];
      v.y = acc[4 * j + 2 * i + 1];
      *reinterpret_cast<Pair*>(part + row * pitch + n0 + 8 * j + 2 * tg) = v;
    }
  }
}

// out[m, n] = the sum over the partials of partial[., m, n]: fp32 in partial
// order, int32 wrapping (unsigned arithmetic).
template <typename AccT>
__global__ void __launch_bounds__(kSumThreads) mma_probe_sum(const AccT* partial, AccT* out,
                                                             int parts, long long part_elems,
                                                             long long pitch, int M, int N) {
  const long long total = static_cast<long long>(M) * N;
  for (long long idx = blockIdx.x * static_cast<long long>(kSumThreads) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * kSumThreads) {
    const AccT* src = partial + (idx / N) * pitch + idx % N;
    if constexpr (std::is_same<AccT, float>::value) {
      float s = 0.f;
      for (int q = 0; q < parts; ++q) s += src[q * part_elems];
      out[idx] = s;
    } else {
      uint32_t s = 0u;
      for (int q = 0; q < parts; ++q) s += static_cast<uint32_t>(src[q * part_elems]);
      out[idx] = static_cast<AccT>(s);
    }
  }
}

template <typename T, int NI, bool RS>
cudaError_t launch(const Probe& p, const Plan& plan, void* out, int sms, cudaStream_t s) {
  using AccT = typename Acc<T>::type;
  cudaError_t err = cudaFuncSetAttribute(mma_probe<T, NI, RS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  mma_probe<T, NI, RS><<<static_cast<unsigned>(plan.units), kThreads, plan.smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(p.M) * p.N;
  const long long want = cdiv(total, kSumThreads);
  const int grid = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  const long long pitch = static_cast<long long>(p.n_tiles) * NI;
  mma_probe_sum<AccT><<<grid, kSumThreads, 0, s>>>(
      static_cast<const AccT*>(p.partial), static_cast<AccT*>(out),
      static_cast<int>(plan.slices * plan.chunks), static_cast<long long>(p.m_tiles) * kBM * pitch,
      pitch, p.M, p.N);
  return cudaGetLastError();
}

}  // namespace

// a (M, K); b: bT (N, K) for an SS form (b_pitch == K), b (K, b_pitch) for
// the RS form; partial: the plan's scratch accumulators; out (M, N): bf16 ->
// fp32 (int8 == 0) or int8 -> int32. form_n: the instruction's N (64, 128,
// 256); rs: A from registers (bf16 n128 only). plan: kernels/cuda.py
// mma_probe_plan's (chunk steps, chunks, slices, shared-memory bytes, units,
// scratch elements), which must be this device's. Returns a cudaError_t (0
// on success).
extern "C" int gen3c_mma_probe(const void* a, const void* b, void* partial, void* out, int M,
                               int N, int K, int b_pitch, int reps, int int8, int form_n, int rs,
                               const long long* plan, void* stream) {
  const bool ss_n = form_n == 64 || form_n == 128 || form_n == 256;
  const bool form_ok = int8 ? !rs && form_n != 64 && ss_n : (rs ? form_n == 128 : ss_n);
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || reps < 0 || !form_ok ||
      (rs ? (b_pitch < N || b_pitch % 8 != 0) : b_pitch != K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan want = make_plan(M, N, K, reps, int8 ? 1 : 2, form_n, rs, sms);
  const long long words[kPlanWords] = {want.chunk_steps, want.chunks, want.slices,
                                       want.smem,        want.units,  want.scratch};
  for (int i = 0; i < kPlanWords; ++i) {
    if (plan[i] != words[i]) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (want.units > INT_MAX || want.smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Probe p = {a, b, partial, M, N, K, b_pitch, reps,
             static_cast<int>(cdiv(M, kBM)), static_cast<int>(cdiv(N, form_n)),
             static_cast<int>(want.chunks), static_cast<int>(want.chunk_steps),
             static_cast<int>(want.slices)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) {
    return static_cast<int>(form_n == 256 ? launch<int8_t, 256, false>(p, want, out, sms, s)
                                          : launch<int8_t, 128, false>(p, want, out, sms, s));
  }
  if (rs) return static_cast<int>(launch<__nv_bfloat16, 128, true>(p, want, out, sms, s));
  switch (form_n) {
    case 64: return static_cast<int>(launch<__nv_bfloat16, 64, false>(p, want, out, sms, s));
    case 128: return static_cast<int>(launch<__nv_bfloat16, 128, false>(p, want, out, sms, s));
    default: return static_cast<int>(launch<__nv_bfloat16, 256, false>(p, want, out, sms, s));
  }
}
