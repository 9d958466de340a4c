// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of simlingo_tpu/kernels/layernorm.py:
// _ln_fwd_kernel (:54), _rms_fwd_kernel (:71), _ln_bwd_kernel (:84) and
// _rms_bwd_kernel (:110), reached through layernorm_fused (:138) and
// rmsnorm_fused (:212) when SIMLINGO_LN_IMPL=pallas. Contract: bf16 x and
// y (and dy, dx), a scale (and bias) in bf16 or fp32 upcast here, fp32
// statistics. The forward saves the per-row mean (LayerNorm) and rstd in
// fp32; the backward takes them and returns dx in bf16 and the parameter
// gradients summed over all rows in fp32, written in the scale's dtype.
//
// What bounds it: bytes. Forward: one read of x and one write of y (2 B
// an element); backward: reads of x and dy, one write of dx. At the ViT
// shape [12300, 1024] that is 50.4 MB forward (15.0 us at 3.35 TB/s) and
// 75.6 MB backward (22.6 us); the arithmetic is a few operations an
// element. The eager PyTorch version makes ~10 fp32 passes.
//
// Design: a group of TPR = 32 * WPR threads owns one row; each thread
// holds VPT vectors of 8 bf16 (16-byte loads, neighbouring threads on
// neighbouring addresses) in registers, so the row is read once. d = 896
// and 1024 take one warp a row (WPR 1, VPT 4), d = 4096 four warps a row,
// d = 128 half a warp. Variance is computed in two passes over the
// registers -- mean first, then the mean of (x - mean)^2 -- as both JAX
// paths do (E[x^2] - E[x]^2 would cancel at ViT activations). Row sums go
// through warp shuffles (and, for WPR > 1, shared memory in a fixed
// order). The backward keeps each thread's share of dscale / dbias in
// registers across the rows its group visits, sums the block's row groups
// in shared memory in a fixed order, and writes one fp32 row of partials
// per block ([gridDim, d]); col_reduce_kernel sums the partials in a
// fixed order. There are no atomics, so results do not change from run to
// run. A null partial pointer skips that gradient (a frozen scale).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = simlingo::pack_bf16x2(f[2 * i], f[2 * i + 1]);
  return r;
}

__device__ __forceinline__ void load8(const float* p, int c, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[2 * c];
  const float4 b = reinterpret_cast<const float4*>(p)[2 * c + 1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, int c, float (&f)[8]) {
  unpack8(reinterpret_cast<const uint4*>(p)[c], f);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sum of v over the TPR threads of a row group. For WPR > 1 every thread
// of the block must call it (it synchronises).
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (WPR == 1) {
    return v;
  } else {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = (warp / WPR) * WPR;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) s += red[first + w];
    __syncthreads();                       // red is reused by the next call
    return s;
  }
}

template <int VPT, int WPR, bool RMS, typename ST>
__global__ void __launch_bounds__(THREADS)
norm_fwd_kernel(const bf16* __restrict__ x, const ST* __restrict__ scale,
                const ST* __restrict__ bias, bf16* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                int n, int d, float eps) {
  constexpr int TPR = 32 * WPR, RPB = THREADS / TPR;
  __shared__ float red[THREADS / 32];
  const int grp = threadIdx.x / TPR, lr = threadIdx.x % TPR, nv = d >> 3;
  for (long long base = static_cast<long long>(blockIdx.x) * RPB; base < n;
       base += static_cast<long long>(gridDim.x) * RPB) {
    const long long row = base + grp;
    const bool live = row < n;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    float v[VPT][8];
    bool ok[VPT];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lr + k * TPR;
      ok[k] = live && c < nv;
      if (ok[k]) {
        unpack8(xr[c], v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[k][e];
    }
    float mean = 0.f;
    if constexpr (!RMS) mean = row_sum<WPR>(s, red) / static_cast<float>(d);
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (ok[k]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = v[k][e] - mean;
          q += t * t;
        }
      }
    const float var = row_sum<WPR>(q, red) / static_cast<float>(d);
    const float rstd = 1.f / sqrtf(var + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (!ok[k]) continue;
      const int c = lr + k * TPR;
      float sc[8], out[8];
      load8(scale, c, sc);
      if constexpr (RMS) {
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = v[k][e] * rstd * sc[e];
      } else {
        float bi[8];
        load8(bias, c, bi);
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = (v[k][e] - mean) * rstd * sc[e] + bi[e];
      }
      yr[c] = pack8(out);
    }
    if (live && lr == 0) {
      if constexpr (!RMS) mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <int VPT, int WPR, bool RMS, typename ST>
__global__ void __launch_bounds__(THREADS)
norm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const ST* __restrict__ scale, const float* __restrict__ mean_in,
                const float* __restrict__ rstd_in, bf16* __restrict__ dx,
                float* __restrict__ part_scale, float* __restrict__ part_bias,
                int n, int d) {
  constexpr int TPR = 32 * WPR, RPB = THREADS / TPR;
  extern __shared__ float colsum[];              // [2][d]: block sums
  __shared__ float red[THREADS / 32];
  const int grp = threadIdx.x / TPR, lr = threadIdx.x % TPR, nv = d >> 3;
  float acc_s[VPT][8], acc_b[VPT][8];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[k][e] = acc_b[k][e] = 0.f;

  for (long long base = static_cast<long long>(blockIdx.x) * RPB; base < n;
       base += static_cast<long long>(gridDim.x) * RPB) {
    const long long row = base + grp;
    const bool live = row < n;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * d);
    const float mean = (RMS || !live) ? 0.f : mean_in[row];
    const float rstd = live ? rstd_in[row] : 0.f;
    uint4 xs[VPT], ds[VPT];
    bool ok[VPT];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lr + k * TPR;
      ok[k] = live && c < nv;
      if (!ok[k]) continue;
      xs[k] = xr[c];
      ds[k] = dyr[c];
      float xv[8], dv[8], sc[8];
      unpack8(xs[k], xv);
      unpack8(ds[k], dv);
      load8(scale, c, sc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xv[e] - mean) * rstd;
        const float dxhat = dv[e] * sc[e];
        m1 += dxhat;
        m2 += dxhat * xhat;
        acc_s[k][e] += dv[e] * xhat;
        acc_b[k][e] += dv[e];
      }
    }
    if constexpr (!RMS) m1 = row_sum<WPR>(m1, red) / static_cast<float>(d);
    m2 = row_sum<WPR>(m2, red) / static_cast<float>(d);
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (!ok[k]) continue;
      const int c = lr + k * TPR;
      float xv[8], dv[8], sc[8], out[8];
      unpack8(xs[k], xv);
      unpack8(ds[k], dv);
      load8(scale, c, sc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xv[e] - mean) * rstd;
        const float dxhat = dv[e] * sc[e];
        out[e] = RMS ? rstd * (dxhat - xhat * m2) : rstd * (dxhat - m1 - xhat * m2);
      }
      dxr[c] = pack8(out);
    }
  }
  if (part_scale == nullptr && part_bias == nullptr) return;

  // the block's column sums: row groups add in order 0, 1, ... RPB-1
  float* cs = colsum;
  float* cb = colsum + d;
  for (int g = 0; g < RPB; ++g) {
    if (grp == g) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int c = lr + k * TPR;
        if (c >= nv) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = 8 * c + e;
          cs[col] = (g == 0 ? 0.f : cs[col]) + acc_s[k][e];
          cb[col] = (g == 0 ? 0.f : cb[col]) + acc_b[k][e];
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < d; col += THREADS) {
    if (part_scale != nullptr) part_scale[static_cast<long long>(blockIdx.x) * d + col] = cs[col];
    if (part_bias != nullptr) part_bias[static_cast<long long>(blockIdx.x) * d + col] = cb[col];
  }
}

// out[col] = sum over g of part[g][col], in order; 32 columns x 8 slices
// of g per block, the slices added in order. blockIdx.y picks the pair
// (part0, out0) or (part1, out1).
template <typename ST>
__global__ void __launch_bounds__(THREADS)
col_reduce_kernel(const float* __restrict__ part0, ST* __restrict__ out0,
                  const float* __restrict__ part1, ST* __restrict__ out1,
                  int G, int d) {
  __shared__ float s[8][33];
  const float* part = blockIdx.y == 0 ? part0 : part1;
  ST* out = blockIdx.y == 0 ? out0 : out1;
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (col < d)
    for (int g = slice; g < G; g += 8) a += part[static_cast<long long>(g) * d + col];
  s[slice][lane] = a;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += s[i][lane];
    store1(out + col, t);
  }
}

template <int VPT, int WPR, bool RMS, typename ST>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y,
               void* mean, void* rstd, int n, int d, float eps, cudaStream_t st) {
  constexpr int RPB = THREADS / (32 * WPR);
  long long blocks = (static_cast<long long>(n) + RPB - 1) / RPB;
  if (blocks > 132 * 64) blocks = 132 * 64;        // grid-stride beyond that
  norm_fwd_kernel<VPT, WPR, RMS, ST><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const ST*>(scale),
      static_cast<const ST*>(bias), static_cast<bf16*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int VPT, int WPR, bool RMS, typename ST>
int launch_bwd(const void* x, const void* dy, const void* scale, const void* mean,
               const void* rstd, void* dx, void* part_scale, void* part_bias,
               void* dscale, void* dbias, int n, int d, int grid, cudaStream_t st) {
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  auto kern = norm_bwd_kernel<VPT, WPR, RMS, ST>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const ST*>(scale), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<bf16*>(dx),
      static_cast<float*>(part_scale), static_cast<float*>(part_bias), n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || (part_scale == nullptr && part_bias == nullptr))
    return static_cast<int>(e);
  const dim3 rgrid((d + 31) / 32, part_bias != nullptr && part_scale != nullptr ? 2 : 1);
  // a single pair always goes in slot 0
  const float* p0 = static_cast<const float*>(part_scale != nullptr ? part_scale : part_bias);
  ST* o0 = static_cast<ST*>(part_scale != nullptr ? dscale : dbias);
  col_reduce_kernel<ST><<<rgrid, THREADS, 0, st>>>(
      p0, o0, static_cast<const float*>(part_bias), static_cast<ST*>(dbias), grid, d);
  return static_cast<int>(cudaGetLastError());
}

// (VPT, WPR) by row width: one warp a row up to d = 1024, then 2/4/8 warps.
#define SIMLINGO_NORM_DISPATCH(FN, RMS, ST, ...)                             \
  do {                                                                       \
    const int nv = d / 8;                                                    \
    if (nv <= 32) return FN<1, 1, RMS, ST>(__VA_ARGS__);                     \
    if (nv <= 64) return FN<2, 1, RMS, ST>(__VA_ARGS__);                     \
    if (nv <= 128) return FN<4, 1, RMS, ST>(__VA_ARGS__);                    \
    if (nv <= 256) return FN<4, 2, RMS, ST>(__VA_ARGS__);                    \
    if (nv <= 512) return FN<4, 4, RMS, ST>(__VA_ARGS__);                    \
    if (nv <= 1024) return FN<4, 8, RMS, ST>(__VA_ARGS__);                   \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  } while (0)

template <bool RMS, typename ST>
int fwd_by_width(const void* x, const void* scale, const void* bias, void* y,
                 void* mean, void* rstd, int n, int d, float eps, cudaStream_t st) {
  SIMLINGO_NORM_DISPATCH(launch_fwd, RMS, ST, x, scale, bias, y, mean, rstd, n, d, eps, st);
}

template <bool RMS, typename ST>
int bwd_by_width(const void* x, const void* dy, const void* scale, const void* mean,
                 const void* rstd, void* dx, void* ps, void* pb, void* dscale,
                 void* dbias, int n, int d, int grid, cudaStream_t st) {
  SIMLINGO_NORM_DISPATCH(launch_bwd, RMS, ST, x, dy, scale, mean, rstd, dx, ps, pb,
                         dscale, dbias, n, d, grid, st);
}

}  // namespace

// rms: 0 LayerNorm, 1 RMSNorm; scale_bf16: 1 if scale (and bias) are bf16,
// 0 if fp32. mean is ignored (may be null) for RMSNorm, bias likewise.
extern "C" int simlingo_norm_fwd(const void* x, const void* scale, const void* bias,
                                 void* y, void* mean, void* rstd, int n, int d,
                                 float eps, int rms, int scale_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rms) {
    if (scale_bf16) return fwd_by_width<true, bf16>(x, scale, bias, y, mean, rstd, n, d, eps, st);
    return fwd_by_width<true, float>(x, scale, bias, y, mean, rstd, n, d, eps, st);
  }
  if (scale_bf16) return fwd_by_width<false, bf16>(x, scale, bias, y, mean, rstd, n, d, eps, st);
  return fwd_by_width<false, float>(x, scale, bias, y, mean, rstd, n, d, eps, st);
}

// part_scale / part_bias: fp32 [grid, d] scratch, or null to skip that
// gradient (dscale / dbias are then not written). grid: the number of
// blocks, i.e. of partial rows.
extern "C" int simlingo_norm_bwd(const void* x, const void* dy, const void* scale,
                                 const void* mean, const void* rstd, void* dx,
                                 void* part_scale, void* part_bias, void* dscale,
                                 void* dbias, int n, int d, int grid, int rms,
                                 int scale_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rms) {
    if (scale_bf16)
      return bwd_by_width<true, bf16>(x, dy, scale, mean, rstd, dx, part_scale, nullptr,
                                      dscale, nullptr, n, d, grid, st);
    return bwd_by_width<true, float>(x, dy, scale, mean, rstd, dx, part_scale, nullptr,
                                     dscale, nullptr, n, d, grid, st);
  }
  if (scale_bf16)
    return bwd_by_width<false, bf16>(x, dy, scale, mean, rstd, dx, part_scale, part_bias,
                                     dscale, dbias, n, d, grid, st);
  return bwd_by_width<false, float>(x, dy, scale, mean, rstd, dx, part_scale, part_bias,
                                    dscale, dbias, n, d, grid, st);
}
