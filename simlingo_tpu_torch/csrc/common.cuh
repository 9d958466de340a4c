// Shared device helpers for the hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace simlingo {

// D[16x8] += A[16x16] * B[16x8], bf16 operands, fp32 accumulate.
// Fragment layout (PTX ISA, mma.m16n8k16), g = lane / 4, t = lane % 4:
//   a0: (row g,   col 2t..2t+1)   a1: (row g+8, col 2t..2t+1)
//   a2: (row g,   col 2t+8..+9)   a3: (row g+8, col 2t+8..+9)
//   b0: (k 2t..2t+1, n g)         b1: (k 2t+8..+9, n g)
//   d0,d1: (row g, col 2t..2t+1)  d2,d3: (row g+8, col 2t..2t+1)
// The element with the lower index sits in the low 16 bits of a register.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte global -> shared copy that bypasses registers (Ampere+). With
// pred false nothing is read and the 16 shared bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(pred ? 16 : 0) : "memory");
}

// 4-byte variant (for rows that are only 4-byte aligned); zero-fills when
// pred is false.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(gmem), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Two 8x8 b16 matrices from shared memory, transposed: lanes 0-7 give the
// row addresses of matrix 0, lanes 8-15 those of matrix 1. Lane (g, t)
// receives rows 2t..2t+1 of column g -- with rows = k and columns = n, the
// B-fragment (b0, b1) of mma.m16n8k16 from a [k][n] row-major tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(s) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and lane (g, t) receives row g, columns 2t..2t+1
// of each. From a [m][k] row-major tile, lanes 0-15 on rows 0-15 at column
// 0 and lanes 16-31 on rows 0-15 at column 8 give the A-fragment a0..a3 of
// mma.m16n8k16.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

// The same, transposed: lane (g, t) receives rows 2t..2t+1 of column g.
// From a [k][n] row-major tile, lanes 0-15 on rows 0-15 at column n and
// lanes 16-31 on rows 0-15 at column n + 8 give the B-fragments of two n8
// tiles: (r0, r1) for columns n..n+7, (r2, r3) for n+8..n+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

// The inverse of ldmatrix_x4: four 8x8 b16 matrices to shared memory,
// lanes 8i..8i+7 giving the row addresses of matrix i and lane (g, t)
// holding row g, columns 2t..2t+1 of each. With the addresses of
// ldmatrix_x4 (lanes 0-15 on rows 0-15 at column 0, lanes 16-31 at column
// 8), an mma.m16n8k16 A-fragment -- or the accumulators of two n8 tiles
// packed to bf16 pairs -- lands as a row-major 16 x 16 tile.
__device__ __forceinline__ void stmatrix_x4(const uint32_t (&r)[4], void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(s), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace simlingo
