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
