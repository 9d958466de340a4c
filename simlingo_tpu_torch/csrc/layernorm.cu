// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of simlingo_tpu/kernels/layernorm.py:
// _ln_fwd_kernel (:54), _rms_fwd_kernel (:71), _ln_bwd_kernel (:84) and
// _rms_bwd_kernel (:110), reached through layernorm_fused (:138) and
// rmsnorm_fused (:212) when SIMLINGO_LN_IMPL=pallas. Contract: bf16 x and
// y (and dy, dx), or fp32 ones for training at precision=fp32 (JAX's
// kernels work in x's dtype, :63, :76, :94, :118), a scale (and bias) in
// bf16 or fp32 upcast here, fp32 statistics. The forward saves the per-row mean (LayerNorm) and rstd in
// fp32; the backward takes them and returns dx in bf16 and the parameter
// gradients summed over all rows in fp32, written in the scale's dtype.
//
// What bounds it: bytes. Forward: one read of x and one write of y (2 B
// an element); backward: reads of x and dy, one write of dx. At the ViT
// shape [12300, 1024] that is 50.4 MB forward (15.0 us at 3.35 TB/s) and
// 75.6 MB backward (22.6 us); the arithmetic is a few operations an
// element. At the serving rows (1 to 640 rows of 896) a call moves at
// most 2.3 MB, and what bounds it is latency: the launch and the chain of
// dependent memory round trips of one row.
//
// Layout: a group of TPR = 32 * WPR threads owns one row; each thread
// holds VPT vectors of 8 bf16 (16-byte loads, neighbouring threads on
// neighbouring addresses), so the row is read once. The fp32 instances
// (XT = float) take vectors of 8 fp32 (two 16-byte loads) and twice the
// warps a row past d = 512, so that a thread holds the registers it holds
// at bf16 (`SIMLINGO_NORM_DISPATCH_F32`, kernels/layernorm.py
// `_norm_width`). d = 896 and 1024 take
// one warp a row (4 vectors a thread), d = 4096 four warps a row, d = 128
// half a warp. Variance is computed in two passes over the registers -- mean
// first, then the mean of (x - mean)^2 -- as both JAX paths do (E[x^2] -
// E[x]^2 would cancel at ViT activations). Row sums go through warp
// shuffles (and, for WPR > 1, shared memory in a fixed order).
//
// Forward (norm_fwd_kernel): blocks of blockDim.x / TPR rows. With EARLY,
// a thread loads its columns of the scale (and bias) once, in flight with
// its first x, instead of after each row's sums: one memory round trip
// less, at the cost of registers held through the sums. The plan
// (kernels/layernorm.py _norm_fwd_plan) takes EARLY and small blocks (one
// row group, at least 64 threads) where the rows are few for the card
// (the serving rows), and 256-thread blocks with the late scale at the
// training rows, where the registers decide how many rows a wave holds.
// Same arithmetic, in the same order, in every plan: the same bits.
//
// Backward (norm_bwd_kernel): a persistent grid (at most the co-resident
// blocks an SM, bwd_min_blocks) whose blocks walk the rows; each thread
// holds its columns of the scale in registers and starts the loads of the
// next row's x and dy before the current row's sums, so a warp keeps two rows' loads in
// flight (faster than twice the blocks without it, which is all the
// registers of the LayerNorm's 64 sums allow: PERF.md §6). With SUMS, each
// thread adds dy xhat (and dy) of its rows in fp32 registers; after its
// rows, each row group of the block stores its sums into its own slot of
// shared memory, and the block adds the slots in order g = 0, 1, ... and
// writes one fp32 partial row [G, d] (a grid of one block writes dscale /
// dbias itself). norm_colsum_kernel then sums the G partial rows: block b
// the columns [b d / G, (b + 1) d / G), over the rows in a fixed order. It
// is launched with programmatic dependent launch, so its launch overlaps
// the first kernel's tail (a grid barrier in one launch measured no
// faster). There are no atomics: results do not change from run to run.
// Without SUMS (a frozen scale) the kernel writes dx only: no partials, no
// second launch.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The geometry kernels/layernorm.py's plans assume; the wrapper refuses a
// library that reports another (simlingo_norm_geometry).
constexpr int THREADS = 256;             // the backward's block, the forward's largest
constexpr int BWD_BLOCKS_PER_SM = 2;     // co-resident backward blocks an SM
constexpr int BWD_WIDE_BLOCKS_PER_SM = 1;  // ... with sums at VPT 4
constexpr int FWD_BLOCKS_PER_SM = 64;    // the forward's grid cap an SM (grid-stride beyond)
constexpr int MAX_D = 8192;
constexpr int SUM_UNROLL = 8;            // partial rows loaded at once by the column sums

// The backward's occupancy, by instantiation (its __launch_bounds__): with
// sums at VPT 4 a thread holds 32 (RMSNorm) or 64 fp32 sums, two rows of x
// and dy and the scale, more than 128 registers.
// At fp32 a thread's rows take twice the registers: with sums, one block.
__host__ __device__ constexpr int bwd_min_blocks(int vpt, bool sums, bool fp32) {
  return (sums && (vpt == 4 || fp32)) ? BWD_WIDE_BLOCKS_PER_SM : BWD_BLOCKS_PER_SM;
}

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

// Eight consecutive values of the scale or bias, held as loaded (bf16:
// one 16-byte register quad; fp32: two).
template <typename ST> struct Vec8;

template <> struct Vec8<bf16> {
  uint4 r;
  __device__ __forceinline__ void load(const bf16* p, int c) {
    r = reinterpret_cast<const uint4*>(p)[c];
  }
  __device__ __forceinline__ void get(float (&f)[8]) const { unpack8(r, f); }
};

template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p, int c) {
    a = reinterpret_cast<const float4*>(p)[2 * c];
    b = reinterpret_cast<const float4*>(p)[2 * c + 1];
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Eight values of a row (x, dy) to fp32, and eight fp32 results out in
// the row's type (y, dx).
__device__ __forceinline__ void store8(bf16* p, int c, const float (&f)[8]) {
  reinterpret_cast<uint4*>(p)[c] = pack8(f);
}

__device__ __forceinline__ void store8(float* p, int c, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[2 * c] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[2 * c + 1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Eight values of the scale or bias straight into fp32 registers.
template <typename ST>
__device__ __forceinline__ void load8(const ST* p, int c, float (&f)[8]) {
  Vec8<ST> v;
  v.load(p, c);
  v.get(f);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sums of a and b over the TPR threads of a row group, each in the same
// order as a sum of its own. For WPR > 1 every thread of the block must
// call it (it synchronises).
template <int WPR, bool TWO>
__device__ __forceinline__ void row_sums(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    if constexpr (TWO) b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[warp] = a;
      if constexpr (TWO) red[THREADS / 32 + warp] = b;
    }
    __syncthreads();
    const int first = (warp / WPR) * WPR;
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) {
      s += red[first + w];
      if constexpr (TWO) t += red[THREADS / 32 + first + w];
    }
    __syncthreads();                       // red is reused by the next call
    a = s;
    if constexpr (TWO) b = t;
  }
}

template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
  float unused = 0.f;
  row_sums<WPR, false>(v, unused, red);
  return v;
}

// The forward's occupancy: without EARLY, at most the registers of the
// design before the plans (48 RMSNorm, 64 LayerNorm at VPT 4), so the
// LLM's 4788 training rows (599 blocks of 8) fit one wave of blocks; fp32
// rows (twice the registers a vector) at most 128.
__host__ __device__ constexpr int fwd_min_blocks(bool rms, bool early, bool fp32) {
  return early ? 1 : fp32 ? 2 : (rms ? 5 : 4);
}

template <int VPT, int WPR, bool RMS, bool EARLY, typename ST, typename XT>
__global__ void __launch_bounds__(THREADS, fwd_min_blocks(RMS, EARLY, sizeof(XT) == 4))
norm_fwd_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
                const ST* __restrict__ bias, XT* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                int n, int d, float eps) {
  constexpr int TPR = 32 * WPR;
  __shared__ float red[2 * (THREADS / 32)];
  const int rpb = blockDim.x / TPR;
  const int grp = threadIdx.x / TPR, lr = threadIdx.x % TPR, nv = d >> 3;
  // EARLY: the scale (and bias) loaded once, in flight with the first x;
  // else after each row's sums (fewer registers through the sums)
  Vec8<ST> sc[VPT], bi[VPT];
  if constexpr (EARLY) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lr + k * TPR;
      if (c < nv) {
        sc[k].load(scale, c);
        if constexpr (!RMS) bi[k].load(bias, c);
      }
    }
  }
  for (long long base = static_cast<long long>(blockIdx.x) * rpb; base < n;
       base += static_cast<long long>(gridDim.x) * rpb) {
    const long long row = base + grp;
    const bool live = row < n;
    float v[VPT][8];
    bool ok[VPT];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lr + k * TPR;
      ok[k] = live && c < nv;
      if (ok[k]) {
        load8(x + row * d, c, v[k]);
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
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (!ok[k]) continue;
      const int c = lr + k * TPR;
      float s8[8], out[8];
      if constexpr (EARLY) sc[k].get(s8); else load8(scale, c, s8);
      if constexpr (RMS) {
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = v[k][e] * rstd * s8[e];
      } else {
        float b8[8];
        if constexpr (EARLY) bi[k].get(b8); else load8(bias, c, b8);
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = (v[k][e] - mean) * rstd * s8[e] + b8[e];
      }
      store8(y + row * d, c, out);
    }
    if (live && lr == 0) {
      if constexpr (!RMS) mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// One row's operands of a thread, as loaded.
template <int VPT, typename XT>
struct RowIn {
  Vec8<XT> x[VPT], dy[VPT];
  float mean, rstd;
};

template <int VPT, int TPR, bool RMS, typename XT>
__device__ __forceinline__ void load_row(RowIn<VPT, XT>& r, const XT* __restrict__ x,
                                         const XT* __restrict__ dy,
                                         const float* __restrict__ mean_in,
                                         const float* __restrict__ rstd_in, long long row,
                                         int n, int d, int lr) {
  const bool live = row < n;
  const int nv = d >> 3;
  r.mean = (RMS || !live) ? 0.f : mean_in[row];
  r.rstd = live ? rstd_in[row] : 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = lr + k * TPR;
    if (live && c < nv) {
      r.x[k].load(x + row * d, c);
      r.dy[k].load(dy + row * d, c);
    }
  }
}

// out[col] = sum over g = 0..G-1 of part[g][col] (and the same for the
// bias) for this block's columns [b d / nb, (b + 1) d / nb), in a fixed
// order: the G rows cut into S slices, each summed in order g ascending,
// the slices added in order s = 0..S-1. red: 2 * THREADS floats of shared
// memory. Called by every thread of the block.
template <bool TWO, typename ST>
__device__ __forceinline__ void column_sums(const float* part_s, const float* part_b,
                                            ST* out_s, ST* out_b, int G, int d, int b,
                                            int nb, float* red) {
  const int c0 = static_cast<int>(static_cast<long long>(b) * d / nb);
  const int c1 = static_cast<int>(static_cast<long long>(b + 1) * d / nb);
  const int C = c1 - c0;
  if (C <= 0) return;
  const bool do_s = part_s != nullptr, do_b = TWO && part_b != nullptr;
  auto sum = [&](int col, int g0, int g1, float& a, float& z) {
    a = 0.f;
    z = 0.f;
    int g = g0;
    for (; g + SUM_UNROLL <= g1; g += SUM_UNROLL) {
      float va[SUM_UNROLL], vb[SUM_UNROLL];
#pragma unroll
      for (int u = 0; u < SUM_UNROLL; ++u) {
        const long long at = static_cast<long long>(g + u) * d + col;
        va[u] = do_s ? __ldcg(part_s + at) : 0.f;
        vb[u] = do_b ? __ldcg(part_b + at) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < SUM_UNROLL; ++u) {
        a += va[u];
        z += vb[u];
      }
    }
    for (; g < g1; ++g) {
      const long long at = static_cast<long long>(g) * d + col;
      if (do_s) a += __ldcg(part_s + at);
      if (do_b) z += __ldcg(part_b + at);
    }
  };
  if (C >= THREADS) {                      // one slice: a thread a column
    for (int col = c0 + threadIdx.x; col < c1; col += THREADS) {
      float a, z;
      sum(col, 0, G, a, z);
      if (do_s) store1(out_s + col, a);
      if (do_b) store1(out_b + col, z);
    }
    return;
  }
  const int S = THREADS / C, j = threadIdx.x % C, s = threadIdx.x / C;
  if (s < S) {
    float a, z;
    sum(c0 + j, static_cast<int>(static_cast<long long>(s) * G / S),
        static_cast<int>(static_cast<long long>(s + 1) * G / S), a, z);
    red[s * C + j] = a;
    red[THREADS + s * C + j] = z;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float a = red[threadIdx.x], z = red[THREADS + threadIdx.x];
    for (int t = 1; t < S; ++t) {
      a += red[t * C + threadIdx.x];
      z += red[THREADS + t * C + threadIdx.x];
    }
    if (do_s) store1(out_s + c0 + threadIdx.x, a);
    if (do_b) store1(out_b + c0 + threadIdx.x, z);
  }
}

template <int VPT, int WPR, bool RMS, bool SUMS, typename ST, typename XT>
__global__ void __launch_bounds__(THREADS, bwd_min_blocks(VPT, SUMS, sizeof(XT) == 4))
norm_bwd_kernel(const XT* __restrict__ x, const XT* __restrict__ dy,
                const ST* __restrict__ scale, const float* __restrict__ mean_in,
                const float* __restrict__ rstd_in, XT* __restrict__ dx,
                float* __restrict__ part_s, float* __restrict__ part_b,
                ST* __restrict__ out_s, ST* __restrict__ out_b, int n, int d) {
  constexpr int TPR = 32 * WPR, RPB = THREADS / TPR;
  constexpr int AS = SUMS ? VPT : 1, AB = SUMS && !RMS ? VPT : 1;
  extern __shared__ float4 smem4[];              // SUMS: [1 or 2][RPB][d] slots
  __shared__ float red[2 * (THREADS / 32)];
  const int grp = threadIdx.x / TPR, lr = threadIdx.x % TPR, nv = d >> 3;
  const long long stride = static_cast<long long>(gridDim.x) * RPB;
  Vec8<ST> sc[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (lr + k * TPR < nv) sc[k].load(scale, lr + k * TPR);
  float acc_s[AS][8], acc_b[AB][8];
#pragma unroll
  for (int k = 0; k < AS; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[k][e] = 0.f;
#pragma unroll
  for (int k = 0; k < AB; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_b[k][e] = 0.f;

  long long base = static_cast<long long>(blockIdx.x) * RPB;
  RowIn<VPT, XT> cur;
  load_row<VPT, TPR, RMS>(cur, x, dy, mean_in, rstd_in, base + grp, n, d, lr);
  for (; base < n; base += stride) {
    const long long row = base + grp;
    const bool live = row < n;
    RowIn<VPT, XT> nxt;                      // the next row's loads, in flight
    load_row<VPT, TPR, RMS>(nxt, x, dy, mean_in, rstd_in, row + stride, n, d, lr);
    const float mean = cur.mean, rstd = cur.rstd;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (!(live && lr + k * TPR < nv)) continue;
      float xv[8], dv[8], s8[8];
      cur.x[k].get(xv);
      cur.dy[k].get(dv);
      sc[k].get(s8);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xv[e] - mean) * rstd;
        const float dxhat = dv[e] * s8[e];
        m1 += dxhat;
        m2 += dxhat * xhat;
        if constexpr (SUMS) {
          acc_s[k][e] += dv[e] * xhat;
          if constexpr (!RMS) acc_b[k][e] += dv[e];
        }
      }
    }
    if constexpr (RMS) {
      m2 = row_sum<WPR>(m2, red) / static_cast<float>(d);
    } else {
      row_sums<WPR, true>(m1, m2, red);
      m1 /= static_cast<float>(d);
      m2 /= static_cast<float>(d);
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lr + k * TPR;
      if (!(live && c < nv)) continue;
      float xv[8], dv[8], s8[8], out[8];
      cur.x[k].get(xv);
      cur.dy[k].get(dv);
      sc[k].get(s8);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xv[e] - mean) * rstd;
        const float dxhat = dv[e] * s8[e];
        out[e] = RMS ? rstd * (dxhat - xhat * m2) : rstd * (dxhat - m1 - xhat * m2);
      }
      store8(dx + row * d, c, out);
    }
    cur = nxt;
  }
  if constexpr (SUMS) {
    // the block's column sums: each row group stores its sums into its
    // slot, then the slots are added in order g = 0, 1, ... RPB-1
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    float* slots = reinterpret_cast<float*>(smem4);
    float* bslots = slots + RPB * d;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lr + k * TPR;
      if (c >= nv) continue;
      float4* ps = reinterpret_cast<float4*>(slots + grp * d + 8 * c);
      ps[0] = make_float4(acc_s[k][0], acc_s[k][1], acc_s[k][2], acc_s[k][3]);
      ps[1] = make_float4(acc_s[k][4], acc_s[k][5], acc_s[k][6], acc_s[k][7]);
      if constexpr (!RMS) {
        float4* pb = reinterpret_cast<float4*>(bslots + grp * d + 8 * c);
        pb[0] = make_float4(acc_b[k][0], acc_b[k][1], acc_b[k][2], acc_b[k][3]);
        pb[1] = make_float4(acc_b[k][4], acc_b[k][5], acc_b[k][6], acc_b[k][7]);
      }
    }
    __syncthreads();
    const bool alone = gridDim.x == 1;       // the block's sums are the sums
    for (int col = threadIdx.x; col < d; col += THREADS) {
      const long long at = static_cast<long long>(blockIdx.x) * d + col;
      float a = slots[col];
#pragma unroll
      for (int g = 1; g < RPB; ++g) a += slots[g * d + col];
      if (part_s != nullptr) {
        if (alone) store1(out_s + col, a); else part_s[at] = a;
      }
      if constexpr (!RMS) {
        float z = bslots[col];
#pragma unroll
        for (int g = 1; g < RPB; ++g) z += bslots[g * d + col];
        if (part_b != nullptr) {
          if (alone) store1(out_b + col, z); else part_b[at] = z;
        }
      }
    }
  }
}

// The column sums as a launch of their own (programmatic dependent launch:
// it may start while norm_bwd_kernel drains, and waits for its results).
template <bool TWO, typename ST>
__global__ void __launch_bounds__(THREADS)
norm_colsum_kernel(const float* __restrict__ part_s, const float* __restrict__ part_b,
                   ST* __restrict__ out_s, ST* __restrict__ out_b, int G, int d) {
  __shared__ float red[2 * THREADS];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  column_sums<TWO, ST>(part_s, part_b, out_s, out_b, G, d, blockIdx.x, gridDim.x, red);
}

template <int VPT, int WPR, bool RMS, bool EARLY, typename ST, typename XT>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y,
               void* mean, void* rstd, int n, int d, float eps, int threads, int blocks,
               cudaStream_t st) {
  if (threads < 32 * WPR || threads % (32 * WPR) != 0 || threads > THREADS || blocks < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  norm_fwd_kernel<VPT, WPR, RMS, EARLY, ST, XT><<<blocks, threads, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale),
      static_cast<const ST*>(bias), static_cast<XT*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int VPT, int WPR, bool RMS, bool SUMS, typename ST, typename XT>
int launch_bwd(const void* x, const void* dy, const void* scale, const void* mean,
               const void* rstd, void* dx, void* ps, void* pb, void* dscale, void* dbias,
               int n, int d, int blocks, cudaStream_t st) {
  constexpr int RPB = THREADS / (32 * WPR);
  auto kern = norm_bwd_kernel<VPT, WPR, RMS, SUMS, ST, XT>;
  size_t smem = 0;
  if constexpr (SUMS) {
    smem = static_cast<size_t>(RMS ? 1 : 2) * RPB * d * sizeof(float);
    static size_t allowed = 48 * 1024;         // this instantiation's attribute
    if (smem > allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      allowed = smem;
    }
  }
  kern<<<blocks, THREADS, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const XT*>(dy),
      static_cast<const ST*>(scale), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<XT*>(dx), static_cast<float*>(ps),
      static_cast<float*>(pb), static_cast<ST*>(dscale), static_cast<ST*>(dbias), n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !SUMS || blocks == 1) return static_cast<int>(e);
  // the column sums over the blocks' partial rows: a launch of their own,
  // allowed to start while norm_bwd_kernel drains (programmatic dependent
  // launch; norm_colsum_kernel waits for its results)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, norm_colsum_kernel<!RMS, ST>, static_cast<const float*>(ps),
                         static_cast<const float*>(pb), static_cast<ST*>(dscale),
                         static_cast<ST*>(dbias), blocks, d);
  return static_cast<int>(e);
}

// (VPT, WPR) by row width: one warp a row up to d = 1024, then 2/4/8 warps.
// EXPR names them VPT_ and WPR_.
#define SIMLINGO_NORM_DISPATCH(EXPR)                                           \
  do {                                                                         \
    const int nv = d / 8;                                                      \
    if (nv <= 32) { constexpr int VPT_ = 1, WPR_ = 1; return EXPR; }           \
    if (nv <= 64) { constexpr int VPT_ = 2, WPR_ = 1; return EXPR; }           \
    if (nv <= 128) { constexpr int VPT_ = 4, WPR_ = 1; return EXPR; }          \
    if (nv <= 256) { constexpr int VPT_ = 4, WPR_ = 2; return EXPR; }          \
    if (nv <= 512) { constexpr int VPT_ = 4, WPR_ = 4; return EXPR; }          \
    if (nv <= 1024) { constexpr int VPT_ = 4, WPR_ = 8; return EXPR; }         \
    return static_cast<int>(cudaErrorInvalidValue);                            \
  } while (0)

// The same for fp32 rows: twice the warps a row for 512 < d <= 4096 (64 <
// nv <= 512), so a thread holds at most 2 vectors there.
#define SIMLINGO_NORM_DISPATCH_F32(EXPR)                                       \
  do {                                                                         \
    const int nv = d / 8;                                                      \
    if (nv <= 32) { constexpr int VPT_ = 1, WPR_ = 1; return EXPR; }           \
    if (nv <= 64) { constexpr int VPT_ = 2, WPR_ = 1; return EXPR; }           \
    if (nv <= 128) { constexpr int VPT_ = 2, WPR_ = 2; return EXPR; }          \
    if (nv <= 256) { constexpr int VPT_ = 2, WPR_ = 4; return EXPR; }          \
    if (nv <= 512) { constexpr int VPT_ = 2, WPR_ = 8; return EXPR; }          \
    if (nv <= 1024) { constexpr int VPT_ = 4, WPR_ = 8; return EXPR; }         \
    return static_cast<int>(cudaErrorInvalidValue);                            \
  } while (0)

template <bool RMS, bool EARLY, typename ST, typename XT>
int fwd_by_width(const void* x, const void* scale, const void* bias, void* y,
                 void* mean, void* rstd, int n, int d, float eps, int threads, int blocks,
                 cudaStream_t st) {
  if constexpr (sizeof(XT) == 4) {
    SIMLINGO_NORM_DISPATCH_F32((launch_fwd<VPT_, WPR_, RMS, EARLY, ST, XT>(
        x, scale, bias, y, mean, rstd, n, d, eps, threads, blocks, st)));
  } else {
    SIMLINGO_NORM_DISPATCH((launch_fwd<VPT_, WPR_, RMS, EARLY, ST, XT>(
        x, scale, bias, y, mean, rstd, n, d, eps, threads, blocks, st)));
  }
}

template <bool RMS, typename ST, typename XT>
int fwd_by_mode(const void* x, const void* scale, const void* bias, void* y, void* mean,
                void* rstd, int n, int d, float eps, int threads, int blocks, int early,
                cudaStream_t st) {
  if (early)
    return fwd_by_width<RMS, true, ST, XT>(x, scale, bias, y, mean, rstd, n, d, eps,
                                           threads, blocks, st);
  return fwd_by_width<RMS, false, ST, XT>(x, scale, bias, y, mean, rstd, n, d, eps, threads,
                                          blocks, st);
}

template <bool RMS, typename XT>
int fwd_by_scale(const void* x, const void* scale, const void* bias, void* y, void* mean,
                 void* rstd, int n, int d, float eps, int scale_bf16, int threads, int blocks,
                 int early, cudaStream_t st) {
  if (scale_bf16)
    return fwd_by_mode<RMS, bf16, XT>(x, scale, bias, y, mean, rstd, n, d, eps, threads,
                                      blocks, early, st);
  return fwd_by_mode<RMS, float, XT>(x, scale, bias, y, mean, rstd, n, d, eps, threads,
                                     blocks, early, st);
}

template <bool RMS, bool SUMS, typename ST, typename XT>
int bwd_by_width(const void* x, const void* dy, const void* scale, const void* mean,
                 const void* rstd, void* dx, void* ps, void* pb, void* dscale,
                 void* dbias, int n, int d, int blocks, cudaStream_t st) {
  if constexpr (sizeof(XT) == 4) {
    SIMLINGO_NORM_DISPATCH_F32((launch_bwd<VPT_, WPR_, RMS, SUMS, ST, XT>(
        x, dy, scale, mean, rstd, dx, ps, pb, dscale, dbias, n, d, blocks, st)));
  } else {
    SIMLINGO_NORM_DISPATCH((launch_bwd<VPT_, WPR_, RMS, SUMS, ST, XT>(
        x, dy, scale, mean, rstd, dx, ps, pb, dscale, dbias, n, d, blocks, st)));
  }
}

template <bool RMS, typename ST, typename XT>
int bwd_by_mode(const void* x, const void* dy, const void* scale, const void* mean,
                const void* rstd, void* dx, void* ps, void* pb, void* dscale, void* dbias,
                int n, int d, int blocks, cudaStream_t st) {
  if (ps != nullptr || pb != nullptr)
    return bwd_by_width<RMS, true, ST, XT>(x, dy, scale, mean, rstd, dx, ps, pb, dscale,
                                           dbias, n, d, blocks, st);
  return bwd_by_width<RMS, false, ST, XT>(x, dy, scale, mean, rstd, dx, ps, pb, dscale,
                                          dbias, n, d, blocks, st);
}

template <bool RMS, typename XT>
int bwd_by_scale(const void* x, const void* dy, const void* scale, const void* mean,
                 const void* rstd, void* dx, void* ps, void* pb, void* dscale, void* dbias,
                 int n, int d, int blocks, int scale_bf16, cudaStream_t st) {
  if (scale_bf16)
    return bwd_by_mode<RMS, bf16, XT>(x, dy, scale, mean, rstd, dx, ps, pb, dscale, dbias,
                                      n, d, blocks, st);
  return bwd_by_mode<RMS, float, XT>(x, dy, scale, mean, rstd, dx, ps, pb, dscale, dbias,
                                     n, d, blocks, st);
}

}  // namespace

// The geometry the plans of kernels/layernorm.py assume, in this order.
extern "C" int simlingo_norm_geometry(int* out) {
  const int g[5] = {THREADS, BWD_BLOCKS_PER_SM, BWD_WIDE_BLOCKS_PER_SM, FWD_BLOCKS_PER_SM,
                    MAX_D};
  for (int i = 0; i < 5; ++i) out[i] = g[i];
  return 0;
}

// rms: 0 LayerNorm, 1 RMSNorm; scale_bf16: 1 if scale (and bias) are bf16,
// 0 if fp32; x_fp32: 1 if x and y are fp32, 0 if bf16. mean is ignored
// (may be null) for RMSNorm, bias likewise. threads, blocks, early: the
// plan (_norm_fwd_plan): threads a multiple of the row group's 32 * WPR,
// at most THREADS.
extern "C" int simlingo_norm_fwd(const void* x, const void* scale, const void* bias,
                                 void* y, void* mean, void* rstd, int n, int d,
                                 float eps, int rms, int scale_bf16, int x_fp32, int threads,
                                 int blocks, int early, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
#define SIMLINGO_NORM_FWD(RMS_, XT_)                                                     \
  fwd_by_scale<RMS_, XT_>(x, scale, bias, y, mean, rstd, n, d, eps, scale_bf16, threads, \
                          blocks, early, st)
  if (x_fp32)
    return rms ? SIMLINGO_NORM_FWD(true, float) : SIMLINGO_NORM_FWD(false, float);
  return rms ? SIMLINGO_NORM_FWD(true, bf16) : SIMLINGO_NORM_FWD(false, bf16);
#undef SIMLINGO_NORM_FWD
}

// part_scale / part_bias: fp32 [blocks, d] scratch, or null to skip that
// gradient (dscale / dbias are then not written); both null: dx only.
// blocks: the plan (_norm_bwd_plan). With a gradient to sum and more than
// one block, norm_colsum_kernel follows; one block writes its sums itself.
// x_fp32: 1 if x, dy and dx are fp32, 0 if bf16.
extern "C" int simlingo_norm_bwd(const void* x, const void* dy, const void* scale,
                                 const void* mean, const void* rstd, void* dx,
                                 void* part_scale, void* part_bias, void* dscale,
                                 void* dbias, int n, int d, int blocks, int rms,
                                 int scale_bf16, int x_fp32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || d > MAX_D || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rms) {
    if (x_fp32)
      return bwd_by_scale<true, float>(x, dy, scale, mean, rstd, dx, part_scale, nullptr,
                                       dscale, nullptr, n, d, blocks, scale_bf16, st);
    return bwd_by_scale<true, bf16>(x, dy, scale, mean, rstd, dx, part_scale, nullptr,
                                    dscale, nullptr, n, d, blocks, scale_bf16, st);
  }
  if (x_fp32)
    return bwd_by_scale<false, float>(x, dy, scale, mean, rstd, dx, part_scale, part_bias,
                                      dscale, dbias, n, d, blocks, scale_bf16, st);
  return bwd_by_scale<false, bf16>(x, dy, scale, mean, rstd, dx, part_scale, part_bias,
                                   dscale, dbias, n, d, blocks, scale_bf16, st);
}
