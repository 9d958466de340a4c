// Inverted dropout for Hopper (sm_90a): out = keep ? bf16(x * inv_keep) : 0.
//
// Replaces the Pallas TPU kernel simlingo_tpu/kernels/dropout.py:_kernel
// (:32, via _apply :48 / hw_dropout :126), the LoRA-input dropout of
// training. The TPU kernel draws the TPU's hardware bits per grid block;
// here the mask is a pure function of (seed, flat element index) through a
// hand-written Philox4x32-10 keyed by the seed's two 32-bit words, with
// counter = index / 4 and lane = index % 4. An element is kept iff its
// 32-bit draw is >= threshold = round(rate * 2^32). The backward runs the
// same kernel on the gradient with the same seed, so no mask is stored.
// kernels/dropout.py:dropout_plain computes the identical Philox in int64
// torch arithmetic: the two agree bit for bit.
//
// What bounds it: bytes -- one read and one write of 2 B per element (17.1
// MB for a [6,798,896] call, 93 MB for [6,798,4864]). Philox costs ~10
// integer multiply rounds per 4 elements, far below the ALU rate. Design:
// a grid-stride loop in which each thread moves 16 bytes (8 bf16) per
// iteration with one 128-bit load and one 128-bit store, drawing two
// Philox blocks (counters i/4 and i/4 + 1) for its 8 elements; the ragged
// tail (numel % 8) goes element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct U4 { uint32_t x, y, z, w; };

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ U4 draw(unsigned long long ctr, uint32_t k0, uint32_t k1) {
  return philox4x32_10(U4{static_cast<uint32_t>(ctr), static_cast<uint32_t>(ctr >> 32),
                          0u, 0u}, k0, k1);
}

__device__ __forceinline__ uint32_t lane_of(const U4& r, int lane) {
  return lane == 0 ? r.x : lane == 1 ? r.y : lane == 2 ? r.z : r.w;
}

__device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 x, uint32_t bits,
                                               uint32_t thresh, float inv_keep) {
  return bits >= thresh ? __float2bfloat16_rn(__bfloat162float(x) * inv_keep)
                        : __float2bfloat16_rn(0.f);
}

__global__ void __launch_bounds__(256)
dropout_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
               long long n, uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep) {
  const long long groups = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long gi = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       gi < groups; gi += stride) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[gi];
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
    const U4 r0 = draw(static_cast<unsigned long long>(gi) * 2, k0, k1);
    const U4 r1 = draw(static_cast<unsigned long long>(gi) * 2 + 1, k0, k1);
    const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    uint4 res;
    __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int j = 0; j < 8; ++j) ov[j] = apply(xv[j], bits[j], thresh, inv_keep);
    reinterpret_cast<uint4*>(out)[gi] = res;
  }
  // ragged tail: at most 7 elements, one thread each
  const long long tail = groups * 8;
  const long long i = tail + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const U4 r = draw(static_cast<unsigned long long>(i) >> 2, k0, k1);
    out[i] = apply(x[i], lane_of(r, static_cast<int>(i & 3)), thresh, inv_keep);
  }
}

}  // namespace

extern "C" int simlingo_dropout(const void* x, void* out, long long n, uint32_t k0,
                                uint32_t k1, uint32_t thresh, float inv_keep,
                                void* stream) {
  const int threads = 256;
  long long blocks = (n / 8 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;      // grid-stride: 16 blocks per SM
  dropout_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n,
      k0, k1, thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
}
