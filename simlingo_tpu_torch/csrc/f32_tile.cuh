// The SIMT fp32 tile product of the fused CE's fp32 forward
// (ce_fwd_tile_f32_kernel) and the int8 activation gradient's fp32 build
// (dx_f32_kernel): fp32 operands, fp32 FMA products, fp32 sums. One TF32
// product would round each operand to 10 bits of mantissa, and JAX's fp32
// step rounds none (`core/device.fp32_products` keeps cuBLAS to fp32 too);
// the fp32 CE backward and int8 forward keep fp32 accuracy on the tensor
// cores by splitting each operand into two TF32 parts (f32_tc_tile.cuh).
//
// One block of 256 threads computes a 128 x 128 tile C += A B over a range
// [k0, k1) of the reduction, in 8-wide k-steps through two shared-memory
// stages (each step's global loads go to registers while the previous step
// is multiplied, then to the other stage: one barrier a step). Thread (ty =
// tid / 16, tx = tid % 16) owns rows 4 ty + r and 64 + 4 ty + r and columns
// 4 tx + c and 64 + 4 tx + c (r, c < 4): acc[i][j] is row row_of(i, ty),
// column row_of(j, tx). A step reads two float4 of A and two of B from
// shared memory for 64 FMAs; the 16 lanes of a half-warp read 16
// neighbouring float4 of B (no bank conflict) and one of A (a broadcast).
// Every accumulator sums its k in increasing order, so the bits do not
// change from run to run.
//
// An operand is read through a source functor src(r, c) = the element at
// row r, column c of its array in memory, widened to fp32 (F32, I8, or
// Scaled: fp32 times a per-column scale). ROWS says how the tile's index i
// (m for A, n for B) and k lie in memory: ROWS true, i is the memory row
// and k the column (A [M, K], B [N, K]); ROWS false, k is the memory row
// and i the column (A [K, M], B [K, N]). Elements with i >= lim or k >= k1
// are 0. Loads are 4 bytes a thread, so no row needs an alignment.
#pragma once

#include "common.cuh"

namespace simlingo {
namespace f32 {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;

struct F32 {
  const float* p;
  long long ld;
  __device__ __forceinline__ float operator()(long long r, long long c) const {
    return __ldg(p + r * ld + c);
  }
};

struct I8 {                  // int8 codes, exact in fp32
  const int8_t* p;
  long long ld;
  __device__ __forceinline__ float operator()(long long r, long long c) const {
    return static_cast<float>(__ldg(p + r * ld + c));
  }
};

struct Scaled {              // x[r, c] * s[c] in fp32, rounded once
  const float* p;
  long long ld;
  const float* s;
  __device__ __forceinline__ float operator()(long long r, long long c) const {
    return __ldg(p + r * ld + c) * __ldg(s + c);
  }
};

// the tile row (or column) that accumulator index i (< 8) of thread group t holds
__device__ __forceinline__ int row_of(int i, int t) { return (i >> 2) * 64 + 4 * t + (i & 3); }

// Four elements of the operand for the k-step at k: ROWS, thread t takes i =
// t % 128 and k + 4 (t / 128) + e; else k + t / 32 and i = t % 32 + 32 e.
template <bool ROWS, class Src>
__device__ __forceinline__ void fetch(const Src& src, int i0, int lim, int k, int k1,
                                      float (&r)[4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (ROWS) {
      const int i = i0 + (t & 127), kk = k + 4 * (t >> 7) + e;
      r[e] = i < lim && kk < k1 ? src(i, kk) : 0.f;
    } else {
      const int i = i0 + (t & 31) + 32 * e, kk = k + (t >> 5);
      r[e] = i < lim && kk < k1 ? src(kk, i) : 0.f;
    }
  }
}

// ... stored as the stage's [k][i] tile
template <bool ROWS>
__device__ __forceinline__ void stash(float (*S)[BM], const float (&r)[4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (ROWS)
      S[4 * (t >> 7) + e][t & 127] = r[e];
    else
      S[t >> 5][(t & 31) + 32 * e] = r[e];
  }
}

// acc += A[m0 .. m0 + 127, k0 .. k1) B[n0 .. n0 + 127, k0 .. k1)^T, rows of A
// past a_lim and of B past b_lim as 0. Ends behind a barrier.
template <bool A_ROWS, bool B_ROWS, class SA, class SB>
__device__ __forceinline__ void tile(const SA& a, int a_lim, const SB& b, int b_lim, int m0,
                                     int n0, int k0, int k1, float (&acc)[8][8]) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  float ra[4], rb[4];
  if (steps > 0) {
    fetch<A_ROWS>(a, m0, a_lim, k0, k1, ra);
    fetch<B_ROWS>(b, n0, b_lim, k0, k1, rb);
    stash<A_ROWS>(As[0], ra);
    stash<B_ROWS>(Bs[0], rb);
  }
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < steps;
    if (more) {
      fetch<A_ROWS>(a, m0, a_lim, k0 + (t + 1) * BK, k1, ra);
      fetch<B_ROWS>(b, n0, b_lim, k0 + (t + 1) * BK, k1, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {              // the other stage: last read in step t - 1, behind its barrier
      stash<A_ROWS>(As[cur ^ 1], ra);
      stash<B_ROWS>(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }
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

}  // namespace f32
}  // namespace simlingo
