// Inverted dropout for Hopper (sm_90a): out = keep ? T(x * inv_keep) : 0,
// T = bf16, or fp32 for training at precision=fp32 (JAX's kernel works in
// its input's dtype, dropout.py:44).
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
// A rank of a multi-GPU step draws the one-process mask restricted to its
// block (dropout_block_kernel, entry simlingo_dropout_block): element i of
// the local [rows, cols] tensor takes the index base + i (mode 0: its
// batch rows start at flat index base), (row0 + i / cols) * width + col0
// + i % cols (mode 1, strided: its columns are a slice of a row-parallel
// linear's input), or, with local row r = i / cols, (row0 + (r / seg) *
// stride + r % seg) * width + col0 + i % cols (mode 2, segmented: under
// sequence parallelism a rank's rows are a slab of seg positions out of
// every stride of the one-process [B * T, cols] view). The wrapper keeps
// each thread's 8 elements at a multiple of 4 of the index (cols % 8,
// col0 % 4, width % 4 == 0 in modes 1 and 2; base % 4 == 0 in mode 0).
// dropout_kernel, the one-process layout, is a kernel of its own, so that
// its code, bits and time stay those it had before the blocks.
//
// What bounds it: bytes -- one read and one write of 2 B per element (17.1
// MB for a [6,798,896] call, 93 MB for [6,798,4864]; 4 B at fp32). Philox
// costs ~10 integer multiply rounds per 4 elements, far below the ALU
// rate. Design: a grid-stride loop in which each thread moves 8 elements
// per iteration (bf16: one 128-bit load and store; fp32: two), drawing two
// Philox blocks (counters i/4 and i/4 + 1) for its 8 elements; the ragged
// tail (numel % 8) goes element by element. Both element types are one
// template: an element's index, its draw and so its mask do not depend on
// the type, so the fp32 instance keeps exactly the bf16 instance's mask.

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

__device__ __forceinline__ float apply(float x, uint32_t bits, uint32_t thresh,
                                       float inv_keep) {
  return bits >= thresh ? x * inv_keep : 0.f;
}

// Eight elements of a thread, as loaded and stored: one 16-byte register
// quad of bf16, two of fp32.
template <typename T> struct Pack8;

template <> struct Pack8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, long long gi) {
    r = reinterpret_cast<const uint4*>(p)[gi];
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p, long long gi) const {
    reinterpret_cast<uint4*>(p)[gi] = r;
  }
  __device__ __forceinline__ __nv_bfloat16* v() { return reinterpret_cast<__nv_bfloat16*>(&r); }
};

template <> struct Pack8<float> {
  alignas(16) float f[8];
  __device__ __forceinline__ void load(const float* p, long long gi) {
    reinterpret_cast<float4*>(f)[0] = reinterpret_cast<const float4*>(p)[2 * gi];
    reinterpret_cast<float4*>(f)[1] = reinterpret_cast<const float4*>(p)[2 * gi + 1];
  }
  __device__ __forceinline__ void store(float* p, long long gi) const {
    reinterpret_cast<float4*>(p)[2 * gi] = reinterpret_cast<const float4*>(f)[0];
    reinterpret_cast<float4*>(p)[2 * gi + 1] = reinterpret_cast<const float4*>(f)[1];
  }
  __device__ __forceinline__ float* v() { return f; }
};

template <typename T>
__global__ void __launch_bounds__(256)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
               long long n, uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep) {
  const long long groups = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long gi = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       gi < groups; gi += stride) {
    Pack8<T> in, res;
    in.load(x, gi);
    const U4 r0 = draw(static_cast<unsigned long long>(gi) * 2, k0, k1);
    const U4 r1 = draw(static_cast<unsigned long long>(gi) * 2 + 1, k0, k1);
    const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const T* xv = in.v();
    T* ov = res.v();
#pragma unroll
    for (int j = 0; j < 8; ++j) ov[j] = apply(xv[j], bits[j], thresh, inv_keep);
    res.store(out, gi);
  }
  // ragged tail: at most 7 elements, one thread each
  const long long tail = groups * 8;
  const long long i = tail + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const U4 r = draw(static_cast<unsigned long long>(i) >> 2, k0, k1);
    out[i] = apply(x[i], lane_of(r, static_cast<int>(i & 3)), thresh, inv_keep);
  }
}

template <int kMode, typename T>
__global__ void __launch_bounds__(256)
dropout_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long n, uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep,
                     long long base, unsigned groups_per_row, long long col0,
                     long long width, unsigned seg, long long seg_stride) {
  const long long groups = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long gi = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       gi < groups; gi += stride) {
    Pack8<T> in, res;
    in.load(x, gi);
    const T* xv = in.v();
    unsigned long long idx;                 // the index of this thread's first element
    if (kMode == 1) {                       // base is row0 here
      const unsigned g = static_cast<unsigned>(gi);
      const unsigned r = g / groups_per_row;
      idx = static_cast<unsigned long long>(base + r) * width + col0
            + static_cast<unsigned long long>(g - r * groups_per_row) * 8;
    } else if (kMode == 2) {                // row0, and the row's segment
      const unsigned g = static_cast<unsigned>(gi);
      const unsigned r = g / groups_per_row;
      const unsigned q = r / seg;
      const long long row = base + static_cast<long long>(q) * seg_stride + (r - q * seg);
      idx = static_cast<unsigned long long>(row) * width + col0
            + static_cast<unsigned long long>(g - r * groups_per_row) * 8;
    } else {
      idx = static_cast<unsigned long long>(base) + static_cast<unsigned long long>(gi) * 8;
    }
    const U4 r0 = draw(idx >> 2, k0, k1);
    const U4 r1 = draw((idx >> 2) + 1, k0, k1);
    const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    T* ov = res.v();
#pragma unroll
    for (int j = 0; j < 8; ++j) ov[j] = apply(xv[j], bits[j], thresh, inv_keep);
    res.store(out, gi);
  }
  // ragged tail (mode 0 only: cols % 8 == 0 leaves none in the others)
  const long long i = groups * 8 + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (kMode == 0 && blockIdx.x == 0 && i < n) {
    const unsigned long long g = static_cast<unsigned long long>(base + i);
    const U4 r = draw(g >> 2, k0, k1);
    out[i] = apply(x[i], lane_of(r, static_cast<int>(g & 3)), thresh, inv_keep);
  }
}

long long grid_for(long long n, int threads) {
  long long blocks = (n / 8 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;      // grid-stride: 16 blocks per SM
  return blocks;
}

template <typename T>
int launch_block(const void* x, void* out, long long n, uint32_t k0, uint32_t k1,
                 uint32_t thresh, float inv_keep, long long cols, long long a, long long b,
                 long long c, int mode, long long seg, long long stride, cudaStream_t s) {
  const int threads = 256;
  const auto blocks = static_cast<unsigned>(grid_for(n, threads));
  const auto* xp = static_cast<const T*>(x);
  auto* op = static_cast<T*>(out);
  if (mode == 1 || mode == 2) {
    if (cols % 8 || n / 8 > 0xFFFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    const auto gpr = static_cast<unsigned>(cols / 8);
    if (mode == 1) {
      dropout_block_kernel<1, T><<<blocks, threads, 0, s>>>(
          xp, op, n, k0, k1, thresh, inv_keep, a, gpr, b, c, 0u, 0);
    } else {
      if (seg < 1 || seg > 0xFFFFFFFFLL || stride < seg)
        return static_cast<int>(cudaErrorInvalidValue);
      dropout_block_kernel<2, T><<<blocks, threads, 0, s>>>(
          xp, op, n, k0, k1, thresh, inv_keep, a, gpr, b, c, static_cast<unsigned>(seg),
          stride);
    }
  } else if (mode == 0) {
    dropout_block_kernel<0, T><<<blocks, threads, 0, s>>>(
        xp, op, n, k0, k1, thresh, inv_keep, a, 0u, 0, 0, 0u, 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block layouts: a, b, c are the flat base in mode 0 (b, c unused),
// row0, col0 and width in modes 1 and 2; seg and stride are mode 2's.
// fp32: x and out are fp32 (else bf16).
extern "C" int simlingo_dropout_block(const void* x, void* out, long long n, uint32_t k0,
                                      uint32_t k1, uint32_t thresh, float inv_keep,
                                      long long cols, long long a, long long b, long long c,
                                      int mode, long long seg, long long stride, int fp32,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return launch_block<float>(x, out, n, k0, k1, thresh, inv_keep, cols, a, b, c, mode, seg,
                               stride, s);
  return launch_block<__nv_bfloat16>(x, out, n, k0, k1, thresh, inv_keep, cols, a, b, c, mode,
                                     seg, stride, s);
}

// fp32: x and out are fp32 (else bf16).
extern "C" int simlingo_dropout(const void* x, void* out, long long n, uint32_t k0,
                                uint32_t k1, uint32_t thresh, float inv_keep, int fp32,
                                void* stream) {
  const int threads = 256;
  const auto blocks = static_cast<unsigned>(grid_for(n, threads));
  const auto s = static_cast<cudaStream_t>(stream);
  if (fp32)
    dropout_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, k0, k1, thresh, inv_keep);
  else
    dropout_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, k0, k1,
        thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
}
