// The split-fp32 tile product on Hopper's tensor cores: fp32 operands, fp32
// sums, products by mma.sync TF32. Every fp32 product of the fused CE
// (fused_ce.cu: ce_fwd_split_kernel and ce_dlogits_split_kernel, which
// share one logits routine, ce_dh_split_kernel, ce_dw_split_kernel) and
// both int8 products at M >= 2 (int8_matmul.cu: gemm_split_kernel,
// dx_split_kernel) run on it; f32_reduce_kernel, at the end, sums the
// partials of a split reduction.
//
// Why a split keeps fp32. One TF32 product rounds each operand to 11
// significant bits; JAX's fp32 step rounds none. Each fp32 element a is cut
// into big = rna_tf32(a) and small = rna_tf32(a - big) (a - big is exact
// in fp32), so big + small is a within 2^-22 |a|, and the three products
// small_a big_b + big_a small_b + big_a big_b, each exact in the tensor
// core, leave out only small_a small_b (below 2^-22 |a b|): CUTLASS's "fast
// fp32" (3xTF32). An operand exact in TF32 (int8 codes, |v| <= 127) has
// small = 0 and its term is skipped: 2 mma a k8-step against an int8
// weight, 3 in the CE. The split happens in registers at fragment load:
// shared memory holds one fp32 (or int8) tile a stage. A scaled operand
// (Scaled: the activation gradient's g times the weight's per-row scale)
// is multiplied in fp32 at fragment load, rounded once and never fused
// into the split's subtraction, so the value split is JAX's g * scale.
//
// The tensor core adds an mma's products into its accumulator without
// rounding to nearest (earlier tensor cores were measured to truncate), so
// a chain of mma's over a whole reduction drifts toward zero by up to an
// fp32 unit of the running sum at each mma. Each 32-wide k-step therefore
// sums into a step accumulator of its own (at most 12 mma), which one fp32
// add, rounded to nearest, adds to the tile's accumulator. Every sum is in
// a fixed order, so two calls give the same bits.
//
// One block of 256 threads (8 warps, 2 along m x 4 along n, each 64 x 32:
// 4 x 4 mma.m16n8k8 tiles) computes a 128 x 128 tile acc = A B^T over a
// range [k0, k1) of the reduction. Operands stream through a STAGES-deep
// cp.async ring of 32-wide k-steps, 16 bytes a copy along the memory row;
// a copy past `lim` rows or past k1 is zero-filled (a ragged one copies its
// bytes and zero-fills the rest). ROWS says how an operand lies in memory:
// ROWS true, its tile index i (m for A, n for B) is the memory row and k
// the column (A [M, K], B [N, K]): staged [i][k], rows of 32 + 4 floats;
// ROWS false, k is the memory row (A [K, M], B [K, N]): staged [k][i],
// rows of 128 + 8 floats. Either padding sends the eight row groups of a
// fragment load (lane g = lane / 4 at i = g, t = lane % 4 at k = t) to 32
// banks. int8 codes are staged as int8 and widened exactly at fragment
// load: [i][k] in rows of 32 + 16 bytes, or [k][i] in rows of 128 + 16
// bytes, which puts the four k-rows of a B fragment (k = t) on four bank
// pairs (the eight lanes of a row share one 8-byte word pair). A scaled
// operand is staged [i][k] with the step's 32 scale entries after its
// tile, and may copy VEC = 16, 8 or 4 bytes at a time, so that rows whose
// width is not a multiple of 4 floats need no padded copy. The memory rows
// must start aligned to their copies (16 bytes, or VEC; ld a multiple of 4
// floats or 16 codes, k0 of 32): the wrappers pad or pick VEC.
// acc[mt][nt][e] is tile row row_of(mt, e), column col_of(nt, e). About
// 190 registers a thread: one block an SM.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace simlingo {
namespace tc32 {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, THREADS = 256;
constexpr int WM = 64, WN = 32, MT = WM / 16, NT = WN / 8;     // a warp's tile, in mma tiles
constexpr int LD_ROWS = BK + 4;       // floats a row of an [i][k] stage
constexpr int LD_COLS = BM + 8;       // floats a row of a [k][i] stage
constexpr int LD_CODES = BK + 16;     // bytes a row of an int8 [i][k] stage
constexpr int LD_KCODES = BM + 16;    // bytes a row of an int8 [k][i] stage
static_assert(BM == BN, "one [k][i] row length serves both operands");

struct F32 {                // fp32 elements, split into big + small
  const float* p;
  long long ld;             // elements a memory row
};

struct I8 {                 // int8 codes, exact in TF32
  const int8_t* p;
  long long ld;
};

// fp32 elements times a per-column scale: (i, k) = p[i ld + k] s[k], rounded
// once in fp32, then split; copied VEC bytes at a time (ld a multiple of
// VEC / 4 floats)
template <int VEC>
struct Scaled {
  const float* p;
  long long ld;
  const float* s;
};

template <class Src>
constexpr bool exact = std::is_same_v<Src, I8>;

template <class Src>
struct scaled_copy { static constexpr int bytes = 0; };
template <int VEC>
struct scaled_copy<Scaled<VEC>> { static constexpr int bytes = VEC; };
template <class Src>
constexpr bool scaled = scaled_copy<Src>::bytes != 0;

// bytes of one stage of an operand
template <bool ROWS, class Src>
__host__ __device__ constexpr int stage_bytes() {
  static_assert(!scaled<Src> || ROWS, "a scaled operand is staged [i][k]");
  if constexpr (exact<Src>) return ROWS ? BM * LD_CODES : BK * LD_KCODES;
  else if constexpr (scaled<Src>) return BM * LD_ROWS * 4 + BK * 4;
  else return ROWS ? BM * LD_ROWS * 4 : BK * LD_COLS * 4;
}

// dynamic shared memory of the ring
template <bool A_ROWS, bool B_ROWS, class SA, class SB>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (stage_bytes<A_ROWS, SA>() + stage_bytes<B_ROWS, SB>());
}

// the tile row of accumulator (mt, e) and the tile column of (nt, e)
__device__ __forceinline__ int row_of(int mt, int e) {
  return (threadIdx.x >> 5 & 1) * WM + 16 * mt + (threadIdx.x >> 2 & 7) + 8 * (e >> 1);
}
__device__ __forceinline__ int col_of(int nt, int e) {
  return (threadIdx.x >> 6) * WN + 8 * nt + 2 * (threadIdx.x & 3) + (e & 1);
}

// cp.async of `bytes` (0..16) from gmem to 16-byte aligned smem; the rest
// of the 16 is zero-filled
__device__ __forceinline__ void copy16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(bytes) : "memory");
}

// the same for a VEC-byte copy (16, 8 or 4), both addresses VEC-aligned
template <int VEC>
__device__ __forceinline__ void copy_vec(void* smem, const void* gmem, int bytes) {
  if constexpr (VEC == 16) {
    copy16(smem, gmem, bytes);
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(s), "l"(gmem), "n"(VEC), "r"(bytes) : "memory");
  }
}

// One k-step [k, k + 32) of an operand's 128-row tile at i0 into a stage.
template <bool ROWS>
__device__ __forceinline__ void load_stage(const F32& src, unsigned char* stage, int i0, int lim,
                                           int k, int k1) {
  float* s = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int j = 0; j < BM * BK / 4 / THREADS; ++j) {
    const int c = threadIdx.x + j * THREADS;
    int i, kk, n;
    if constexpr (ROWS) {          // 128 rows of 8 chunks
      i = i0 + (c >> 3);
      kk = k + (c & 7) * 4;
      n = i < lim ? max(0, min(4, k1 - kk)) : 0;
    } else {                       // 32 k-rows of 32 chunks
      i = i0 + (c & 31) * 4;
      kk = k + (c >> 5);
      n = kk < k1 ? max(0, min(4, lim - i)) : 0;
    }
    const float* g = n > 0 ? src.p + (ROWS ? i * src.ld + kk : kk * src.ld + i) : src.p;
    float* d = ROWS ? s + (c >> 3) * LD_ROWS + (c & 7) * 4 : s + (c >> 5) * LD_COLS + (c & 31) * 4;
    copy16(d, g, 4 * n);
  }
}

template <bool ROWS>
__device__ __forceinline__ void load_stage(const I8& src, unsigned char* stage, int i0, int lim,
                                           int k, int k1) {
#pragma unroll
  for (int j = 0; j < BM * BK / 16 / THREADS; ++j) {
    const int c = threadIdx.x + j * THREADS;
    if constexpr (ROWS) {          // 128 rows of 2 chunks
      const int i = i0 + (c >> 1), kk = k + (c & 1) * 16;
      const int n = i < lim ? max(0, min(16, k1 - kk)) : 0;
      copy16(stage + (c >> 1) * LD_CODES + (c & 1) * 16, n > 0 ? src.p + i * src.ld + kk : src.p,
             n);
    } else {                       // 32 k-rows of 8 chunks
      const int kk = k + (c >> 3), i = i0 + (c & 7) * 16;
      const int n = kk < k1 ? max(0, min(16, lim - i)) : 0;
      copy16(stage + (c >> 3) * LD_KCODES + (c & 7) * 16, n > 0 ? src.p + kk * src.ld + i : src.p,
             n);
    }
  }
}

// A scaled operand's [i][k] tile, VEC bytes a copy, then the step's 32
// scale entries (k is a multiple of 32, so 16 bytes a copy)
template <bool ROWS, int VEC>
__device__ __forceinline__ void load_stage(const Scaled<VEC>& src, unsigned char* stage, int i0,
                                           int lim, int k, int k1) {
  static_assert(ROWS, "a scaled operand is staged [i][k]");
  constexpr int F = VEC / 4, CPR = BK / F;          // floats a copy, copies a row
  float* s = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int j = 0; j < BM * CPR / THREADS; ++j) {
    const int c = threadIdx.x + j * THREADS;
    const int r = c / CPR, kk = k + (c % CPR) * F, i = i0 + r;
    const int n = i < lim ? max(0, min(F, k1 - kk)) : 0;
    copy_vec<VEC>(s + r * LD_ROWS + (c % CPR) * F, n > 0 ? src.p + i * src.ld + kk : src.p,
                  4 * n);
  }
  if (threadIdx.x < BK / 4) {
    const int kk = k + 4 * threadIdx.x;
    const int n = max(0, min(4, k1 - kk));
    copy16(s + BM * LD_ROWS + 4 * threadIdx.x, n > 0 ? src.s + kk : src.s, 4 * n);
  }
}

// element (i, k) of a stage, widened to fp32
template <bool ROWS, class Src>
__device__ __forceinline__ float elem(const unsigned char* stage, int i, int k) {
  if constexpr (exact<Src>)
    return static_cast<float>(
        reinterpret_cast<const int8_t*>(stage)[ROWS ? i * LD_CODES + k : k * LD_KCODES + i]);
  else if constexpr (scaled<Src>)      // rounded once: never fused into the split
    return __fmul_rn(reinterpret_cast<const float*>(stage)[i * LD_ROWS + k],
                     reinterpret_cast<const float*>(stage)[BM * LD_ROWS + k]);
  else if constexpr (ROWS)
    return reinterpret_cast<const float*>(stage)[i * LD_ROWS + k];
  else
    return reinterpret_cast<const float*>(stage)[k * LD_COLS + i];
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small in TF32 (small 0 where x is exact: an int8 code)
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
  }
}

// D[16x8] += A[16x8] B[8x8], TF32 operands, fp32 accumulate. Fragments (PTX
// ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4: a0 (row g, k t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, col g), b1 (t + 4,
// g); d0, d1 (row g, cols 2t, 2t + 1), d2, d3 (row g + 8, the same).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += the products of one k-step's stages, through a step accumulator
template <bool A_ROWS, bool B_ROWS, class SA, class SB>
__device__ __forceinline__ void mma_step(const unsigned char* sa, const unsigned char* sb,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * WM, wn = (warp >> 1) * WN;
  float st[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split<exact<SA>>(elem<A_ROWS, SA>(sa, wm + 16 * mt + g + 8 * (r & 1), kk + t + 4 * (r >> 1)),
                         ab[mt][r], as[mt][r]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bb[2], bs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split<exact<SB>>(elem<B_ROWS, SB>(sb, wn + 8 * nt + g, kk + t + 4 * r), bb[r], bs[r]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {     // the small terms first, then big x big
        if constexpr (!exact<SA>) mma_tf32(st[mt][nt], as[mt], bb[0], bb[1]);
        if constexpr (!exact<SB>) mma_tf32(st[mt][nt], ab[mt], bs[0], bs[1]);
        mma_tf32(st[mt][nt], ab[mt], bb[0], bb[1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += st[mt][nt][e];
}

// acc = A[m0 .. m0 + 127, k0 .. k1) B[n0 .. n0 + 127, k0 .. k1)^T, rows of A
// past a_lim and of B past b_lim as 0, through the ring in `smem`
// (smem_bytes<A_ROWS, B_ROWS, SA, SB>() bytes, 16-byte aligned). Ends behind
// a barrier with no copy in flight: `smem` is free for an epilogue.
template <bool A_ROWS, bool B_ROWS, class SA, class SB>
__device__ __forceinline__ void tile(const SA& a, int a_lim, const SB& b, int b_lim, int m0,
                                     int n0, int k0, int k1, unsigned char* smem,
                                     float (&acc)[MT][NT][4]) {
  constexpr int A_BYTES = stage_bytes<A_ROWS, SA>(), B_BYTES = stage_bytes<B_ROWS, SB>();
  unsigned char* sa = smem;
  unsigned char* sb = smem + STAGES * A_BYTES;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int steps = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      load_stage<A_ROWS>(a, sa + s * A_BYTES, m0, a_lim, k0 + s * BK, k1);
      load_stage<B_ROWS>(b, sb + s * B_BYTES, n0, b_lim, k0 + s * BK, k1);
    }
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();     // step t has landed
    __syncthreads();                 // ... for every thread; step t - 1's stage is free
    const int next = t + STAGES - 1;
    if (next < steps) {
      const int s = next % STAGES;
      load_stage<A_ROWS>(a, sa + s * A_BYTES, m0, a_lim, k0 + next * BK, k1);
      load_stage<B_ROWS>(b, sb + s * B_BYTES, n0, b_lim, k0 + next * BK, k1);
    }
    cp_async_commit();
    const int s = t % STAGES;
    mma_step<A_ROWS, B_ROWS, SA, SB>(sa + s * A_BYTES, sb + s * B_BYTES, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// out[i] = sum over s = 0..S-1 of part[s count + i], in that order, times
// scale[i % cols] where scale is given: the split reductions' second pass.
template <typename ST>
__global__ void __launch_bounds__(256)
f32_reduce_kernel(const float* __restrict__ part, const ST* __restrict__ scale,
                  float* __restrict__ out, long long count, int cols, int S) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += stride) {
    float v = part[i];
    for (int s = 1; s < S; ++s) v += part[s * count + i];
    if (scale != nullptr) {
      if constexpr (sizeof(ST) == 2)
        v *= __bfloat162float(scale[i % cols]);
      else
        v *= scale[i % cols];
    }
    out[i] = v;
  }
}

}  // namespace tc32
}  // namespace simlingo
