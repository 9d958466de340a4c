// w8a16 matmul for Hopper (sm_90a): y[M,N] = (x[M,K] . w_q[N,K]^T) * scale[N]
// bf16 activations, int8 weights (per-output-channel scales), fp32
// accumulation, bf16 out.
//
// Replaces the Pallas TPU kernel _kernel of
// simlingo_tpu/kernels/quantized_matmul.py (:49, via _int8_matmul_impl
// :302), both orientations: the port stores every int8 weight as [N, K]
// (torch's [out, in]), so the linears and the tied [V, H] LM head share
// one layout.
//
// What bounds it: at decode sizes (M = 1, 16 and 30) the weight bytes --
// the whole point of int8 is to read half of bf16's; at prefill (M = 640)
// the tensor-core operations.
//
// Design:
//  * M = 1 (decode), gemv_kernel: one warp per output channel n. Each lane
//    streams 16 int8 weights per 16-byte load, dequantizes in registers, and
//    FMAs them against the activation row read through the read-only cache;
//    a warp shuffle reduces, and the scale is applied once per output.
//  * M > 1, gemm_kernel: BM x 64 output tiles (BM = 16 up to M = 48, else
//    64), 4 warps, mma.m16n8k16 with fp32 accumulators. K streams in steps
//    of 64 through a 3-stage cp.async ring; the weight tile stays int8 in
//    shared memory and each B-fragment is dequantized (exactly: |v| <= 127)
//    in registers when it is loaded. The scale is applied to the fp32
//    accumulators in the epilogue.
// K must be a multiple of 16 (the wrapper checks).
//
// The activation gradient, dx_kernel (simlingo_int8_matmul_dx):
//   dx[M,K] = bf16(g[M,N] * scale[N]) . w_q[N,K], fp32 sums, bf16 out.
// Replaces _int8_matmul_bwd (:81), which runs the same Pallas _kernel with
// transpose_rhs flipped and a ones scale. In the [N, K] layout the sum runs
// along the weight's rows, which gemv_kernel and gemm_kernel do not
// compute. What bounds it on the training path (M = 4788 rows) is the
// tensor-core operations; for the tied head (M = 192, N = 151674) the
// grid: 3 x 14 tiles each walk the whole vocabulary.
// Design: 64 x 64 output tiles, 4 warps of 32 x 32, mma.m16n8k16 with fp32
// accumulators. The reduction streams in steps of 64 weight rows through a
// 3-stage cp.async ring: g as bf16, the weight as raw int8, the 64 scales
// as fp32. Each A-fragment is scaled and rounded to bf16 as it is loaded
// (JAX's gs = (g.astype(f32) * scale).astype(g.dtype), :86), so g is read
// once and no scaled copy exists. A B-fragment pairs reduction rows
// (2t, 2t+1) at one output column: two byte loads from adjacent shared
// rows (row stride 80: the 4 rows a warp reads fall in 8 distinct banks),
// dequantized exactly in registers. The tail of the reduction is
// zero-filled on all three operands. g rows are copied 16 bytes at a time
// when N % 8 == 0 and g is 16-byte aligned, else 4 bytes at a time (the
// vocabulary, 151674, leaves rows 4-byte aligned only); N must be even.
// No atomics: every output is written once, in a fixed order.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using simlingo::ld32;

__global__ void __launch_bounds__(256)
gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, bf16* __restrict__ y, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * 8 + warp;
  if (n >= N) return;
  const int8_t* wr = w + (long long)n * K;
  float acc = 0.f;

#pragma unroll 2
  for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
    const int4 wv = __ldg(reinterpret_cast<const int4*>(wr + k0));
    const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
    const uint4* xp = reinterpret_cast<const uint4*>(x + k0);
    const uint4 xa = __ldg(xp), xb = __ldg(xp + 1);
    const uint32_t xu[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc = fmaf(__uint_as_float(xu[j] << 16), static_cast<float>(wb[2 * j]), acc);
      acc = fmaf(__uint_as_float(xu[j] & 0xffff0000u),
                 static_cast<float>(wb[2 * j + 1]), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) y[n] = __float2bfloat16(acc * scale[n]);
}

constexpr int BN = 64, BK = 64, STAGES = 3;
constexpr int LDA = BK + 8;     // bf16 row stride: conflict-free 32-bit fragment loads
constexpr int LDB = BK + 16;    // int8 row stride: conflict-free 16-bit fragment loads

// Two int8 codes (low byte first) -> a bf16x2 B-fragment register.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint16_t v) {
  return simlingo::pack_bf16x2(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                               static_cast<float>(static_cast<int8_t>(v >> 8)));
}

// BM x 64 output tile per block of 4 warps; each warp owns a
// (16*WMT) x (8*WNT) sub-tile. K streams through a STAGES-deep cp.async
// ring: the activation tile as bf16, the weight tile as raw int8 (half the
// shared-memory bytes), dequantized in registers as each B-fragment is
// loaded.
template <int BM, int WMT, int WNT>
__global__ void __launch_bounds__(128)
gemm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, bf16* __restrict__ y,
            int M, int N, int K) {
  constexpr int WARPS_N = BN / (8 * WNT);
  static_assert((BM / (16 * WMT)) * WARPS_N == 4, "4 warps per block");
  __shared__ __align__(16) bf16 As[STAGES][BM * LDA];      // [m][k]
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDB];    // [n][k] int8 codes
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp / WARPS_N) * 16 * WMT, wn = (warp % WARPS_N) * 8 * WNT;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / 8); c += 128) {         // 8 bf16 per chunk
      const int row = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const bool ok = m0 + row < M && k0 + kc < K;
      simlingo::cp_async16(&As[stage][row * LDA + kc],
                           ok ? x + (long long)(m0 + row) * K + k0 + kc : x, ok);
    }
    for (int c = tid; c < BN * (BK / 16); c += 128) {        // 16 int8 per chunk
      const int row = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const bool ok = n0 + row < N && k0 + kc < K;
      simlingo::cp_async16(&Bs[stage][row * LDB + kc],
                           ok ? w + (long long)(n0 + row) * K + k0 + kc : w, ok);
    }
  };

  float acc[WMT][WNT][4];
#pragma unroll
  for (int a = 0; a < WMT; ++a)
#pragma unroll
    for (int b = 0; b < WNT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    simlingo::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    simlingo::cp_async_wait<STAGES - 2>();     // tile kt has landed
    __syncthreads();                           // ... and stage kt-1 is free
    if (kt + STAGES - 1 < ktiles) load_tile((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    simlingo::cp_async_commit();
    const bf16* A = As[kt % STAGES];
    const int8_t* Bq = Bs[kt % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[WMT][4];
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) {
        const bf16* ap = A + (wm + mt * 16 + g) * LDA + ks * 16 + t4 * 2;
        a[mt][0] = ld32(ap);
        a[mt][1] = ld32(ap + 8 * LDA);
        a[mt][2] = ld32(ap + 8);
        a[mt][3] = ld32(ap + 8 * LDA + 8);
      }
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
        const int8_t* bp = Bq + (wn + nt * 8 + g) * LDB + ks * 16 + t4 * 2;
        const uint32_t b0 = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(bp));
        const uint32_t b1 = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(bp + 8));
#pragma unroll
        for (int mt = 0; mt < WMT; ++mt)
          simlingo::mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + half * 8;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn + nt * 8 + t4 * 2 + j;
          if (c < N)
            y[(long long)r * N + c] = __float2bfloat16(acc[mt][nt][half * 2 + j] * scale[c]);
        }
      }
}

template <int BM, int WMT, int WNT>
void launch_gemm(const bf16* x, const int8_t* w, const float* s, bf16* y,
                 int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<BM, WMT, WNT><<<grid, 128, 0, st>>>(x, w, s, y, M, N, K);
}

constexpr int DX_BM = 64;            // dx rows per block
constexpr int DX_BK = 64;            // dx columns (weight columns) per block
constexpr int DX_BR = 64;            // reduction step (weight rows)
constexpr int LDG = DX_BR + 8;       // bf16 row stride of the g tile
constexpr int LDW = DX_BK + 16;      // int8 row stride of the weight tile

// g (bf16x2, lower index low) * (s.x, s.y) in fp32, rounded to bf16x2.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float2 s) {
  return simlingo::pack_bf16x2(__uint_as_float(v << 16) * s.x,
                               __uint_as_float(v & 0xffff0000u) * s.y);
}

__device__ __forceinline__ uint32_t int8_pair_to_bf16x2(int8_t lo, int8_t hi) {
  return simlingo::pack_bf16x2(static_cast<float>(lo), static_cast<float>(hi));
}

// VEC: bytes per cp.async of a g row, 16 or 4.
template <int VEC>
__global__ void __launch_bounds__(128)
dx_kernel(const bf16* __restrict__ g, const int8_t* __restrict__ w,
          const float* __restrict__ scale, bf16* __restrict__ dx,
          int M, int N, int K) {
  __shared__ __align__(16) bf16 Gs[STAGES][DX_BM * LDG];     // [m][n]
  __shared__ __align__(16) int8_t Ws[STAGES][DX_BR * LDW];   // [n][k] int8 codes
  __shared__ __align__(16) float Ss[STAGES][DX_BR];          // scale[n]
  const int m0 = blockIdx.y * DX_BM, k0 = blockIdx.x * DX_BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;     // 2 x 2 warps

  auto load_tile = [&](int stage, int rt) {
    const int n0 = rt * DX_BR;
    constexpr int E = VEC / 2;                                // bf16 per copy
    for (int c = tid; c < DX_BM * (DX_BR / E); c += 128) {
      const int row = c / (DX_BR / E), nc = (c % (DX_BR / E)) * E;
      const bool ok = m0 + row < M && n0 + nc < N;
      const bf16* src = ok ? g + (long long)(m0 + row) * N + n0 + nc : g;
      if constexpr (VEC == 16)
        simlingo::cp_async16(&Gs[stage][row * LDG + nc], src, ok);
      else
        simlingo::cp_async4(&Gs[stage][row * LDG + nc], src, ok);
    }
    for (int c = tid; c < DX_BR * (DX_BK / 16); c += 128) {  // 16 int8 per chunk
      const int row = c / (DX_BK / 16), kc = (c % (DX_BK / 16)) * 16;
      const bool ok = n0 + row < N && k0 + kc < K;
      simlingo::cp_async16(&Ws[stage][row * LDW + kc],
                           ok ? w + (long long)(n0 + row) * K + k0 + kc : w, ok);
    }
    if (tid < DX_BR) {
      const bool ok = n0 + tid < N;
      simlingo::cp_async4(&Ss[stage][tid], ok ? scale + n0 + tid : scale, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  const int rtiles = (N + DX_BR - 1) / DX_BR;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < rtiles) load_tile(s, s);
    simlingo::cp_async_commit();
  }
  for (int rt = 0; rt < rtiles; ++rt) {
    simlingo::cp_async_wait<STAGES - 2>();     // step rt has landed
    __syncthreads();                           // ... and stage rt-1 is free
    if (rt + STAGES - 1 < rtiles) load_tile((rt + STAGES - 1) % STAGES, rt + STAGES - 1);
    simlingo::cp_async_commit();
    const bf16* G = Gs[rt % STAGES];
    const int8_t* Wq = Ws[rt % STAGES];
    const float* S = Ss[rt % STAGES];
#pragma unroll
    for (int ks = 0; ks < DX_BR / 16; ++ks) {
      const int r = ks * 16 + t4 * 2;          // this lane's reduction rows r, r+1, r+8, r+9
      const float2 s01 = *reinterpret_cast<const float2*>(S + r);
      const float2 s89 = *reinterpret_cast<const float2*>(S + r + 8);
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = G + (wm + mt * 16 + gq) * LDG + r;
        a[mt][0] = scale_bf16x2(ld32(ap), s01);
        a[mt][1] = scale_bf16x2(ld32(ap + 8 * LDG), s01);
        a[mt][2] = scale_bf16x2(ld32(ap + 8), s89);
        a[mt][3] = scale_bf16x2(ld32(ap + 8 * LDG + 8), s89);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* bp = Wq + r * LDW + wn + nt * 8 + gq;
        const uint32_t b0 = int8_pair_to_bf16x2(bp[0], bp[LDW]);
        const uint32_t b1 = int8_pair_to_bf16x2(bp[8 * LDW], bp[9 * LDW]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          simlingo::mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + gq + half * 8;
        const int col = k0 + wn + nt * 8 + t4 * 2;   // even; K is a multiple of 16
        if (row < M && col < K)
          *reinterpret_cast<__nv_bfloat162*>(dx + (long long)row * K + col) =
              __floats2bfloat162_rn(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
      }
}

}  // namespace

extern "C" int simlingo_int8_matmul(const void* x_, const void* w_,
                                    const void* s_, void* y_, int M, int N,
                                    int K, void* stream) {
  const auto* x = static_cast<const bf16*>(x_);
  const auto* w = static_cast<const int8_t*>(w_);
  const auto* s = static_cast<const float*>(s_);
  auto* y = static_cast<bf16*>(y_);
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 1) gemv_kernel<<<(N + 7) / 8, 256, 0, st>>>(x, w, s, y, N, K);
  else if (M <= 48) launch_gemm<16, 1, 2>(x, w, s, y, M, N, K, st);
  else launch_gemm<64, 2, 4>(x, w, s, y, M, N, K, st);
  return static_cast<int>(cudaGetLastError());
}

// dx[M,K] = bf16(g[M,N] * scale[N]) . w_q[N,K]. vec16: g rows may be copied
// 16 bytes at a time (N % 8 == 0, g 16-byte aligned), else 4 (N even, g
// 4-byte aligned). K % 16 == 0, w_q 16-byte aligned (the wrapper checks).
extern "C" int simlingo_int8_matmul_dx(const void* g_, const void* w_,
                                       const void* s_, void* dx_, int M, int N,
                                       int K, int vec16, void* stream) {
  const auto* g = static_cast<const bf16*>(g_);
  const auto* w = static_cast<const int8_t*>(w_);
  const auto* s = static_cast<const float*>(s_);
  auto* dx = static_cast<bf16*>(dx_);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + DX_BK - 1) / DX_BK, (M + DX_BM - 1) / DX_BM);
  if (vec16) dx_kernel<16><<<grid, 128, 0, st>>>(g, w, s, dx, M, N, K);
  else dx_kernel<4><<<grid, 128, 0, st>>>(g, w, s, dx, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
