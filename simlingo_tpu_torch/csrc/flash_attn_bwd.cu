// Flash attention backward for Hopper (sm_90a): dQ, dK, dV from the saved
// output O and the forward's base-2 log-sum-exp. bf16 in and out, fp32
// accumulation; or, where a caller sums several of them (the ring of
// parallel/sequence.py adds one backward a key chunk), dQ, dK, dV stored
// as the fp32 accumulators (times the scale), unrounded: the same
// kernels instantiated with OutT = float, which differ only in their
// stores. The bf16 instances (OutT = bf16) are unchanged by that. fp32
// operands (training at precision=fp32) take the fp32 build below: the
// same launches, pairs and tiles, fp32 FMA products, an fp32 scratch.
//
// Replaces the Pallas TPU backward kernels of
// simlingo_tpu/kernels/flash_attention.py: _bwd_kernel_gqa (:382, the Qwen2
// LLM: GQA with dK/dV summed over the 7-head group inside the kernel),
// _bwd_kernel_pair (:869, the InternViT read from the flat [B,T,H*D]
// projections) and _bwd_kernel (:205, head-major MHA). It takes the
// forward kernel's conventions (flash_attn_fwd.cu): q/k/v are strided
// [B, L, H, D] views, query head h reads kv head h / (HQ / HK), causality
// is slot-order with q_offset, kv_valid is uint8 [B, S]. As there, the head
// dim D is a template parameter built at 16, 32, 64 and 128, and the
// wrapper zero-pads any other D <= 128 to the next of these (zero columns
// add nothing to q.k, dO.V or dO.O; the padded gradient columns are cut
// off). The tiles (64 query rows, 64 keys), the dS^T scratch and the pairs
// each kernel visits do not depend on D.
//
// Math (P recomputed, never stored): with s = q.k * scale * log2(e),
//   P = exp2(s - lse),  delta = rowsum(dO * O),  dP = dO V^T,
//   dS = P * (dP - delta),  dV = P^T dO,  dQ = scale dS K,  dK = scale dS^T Q.
// A row that sees no valid key has lse = -inf and contributes exactly 0
// (its lse is read as +inf, so P = 0): that is attention_reference's VJP.
//
// Three launches, no atomics, so results do not change from run to run:
//   1. prep: delta[b, h, t] = rowsum(dO * O) in fp32, 8 lanes a row;
//      with kv_valid, also live[b, kt] = whether 64-key tile kt holds a
//      valid key.
//   2. dK/dV: one block of 4 warps per (batch, kv head, 64-key tile), its
//      K and V tiles in shared memory; each warp owns 16 keys and holds
//      their dK, dV in fp32 registers (2 x D / 2 a thread: 128 at D = 128,
//      where S^T and dP^T are therefore computed 32 query rows at a time,
//      `QP`, so that the accumulators fit in 255 registers; at D <= 64 all
//      64 rows at once). The block loops over the group's
//      query heads and over the 64-row query tiles that can see its keys,
//      with Q, dO, lse and delta double-buffered in shared memory by
//      cp.async. It computes S^T = K Q^T and dP^T = V dO^T (K, V
//      A-fragments by ldmatrix), so P^T and dS^T sit in the accumulators in
//      exactly the A-fragment layout that dV += P^T dO and dK += dS^T Q
//      need (B-fragments by ldmatrix.trans, as the forward's P V). The bf16
//      dS^T fragment that dK takes is also written, once, to a scratch of
//      key-major 64 x 64 tiles, ds[B, HQ, n_kt, n_qt, 64 keys, 64 queries]
//      (stmatrix into a per-warp shared tile, then 512 contiguous bytes a
//      store instruction).
//   3. dQ: one block of 4 warps per (batch, query head, 64-row query
//      tile), a tiled product dQ = scale dS K over the key tiles: dS^T
//      tiles (8 KB contiguous each) and K tiles double-buffered by
//      cp.async, dS's A-fragments by ldmatrix.trans from the key-major
//      tile, K's B-fragments as the forward's V. It reads no Q, dO, V, lse
//      or delta and computes no exp2.
// A (query tile, key tile) pair is written by 2 and read by 3 exactly when
// pair_live() holds, so no uninitialised scratch reaches dQ; a key tile
// without a valid key is in no pair and its dK, dV are 0.
//
// What bounds it: tensor-core operations -- 5 products of 2*T*S*D each per
// head (S, dP, dV, dK in the dK/dV kernel, dS K in dQ), 2.5x the forward's
// 4*T*S*D -- and, by design, the scratch: dS is written and read once in
// bf16 (2 x 2*B*HQ*T*S bytes; 0.27 ms at 3.35 TB/s at the ViT's
// [12,1025,16,64], above its 0.13 ms operations bound); the dQ kernel is
// bound by reading it. No atomics either way; summing fp32 dQ partials in
// order would move 4x the bytes at D = 64. Where its grid fills 3 blocks an
// SM (the ViT: 3264 blocks), the dK/dV kernel is compiled for 3 resident
// blocks (at most 168 registers) instead of the 2 that its own register
// count allows; at D = 128 that cap would spill the accumulators, so D =
// 128 has only the uncapped build. The dK/dV grid of the LLM is small: 6 * 2 * 13 = 156 blocks
// on 132 SMs, each walking 7 heads x up to 13 query tiles serially;
// splitting the group across blocks (and reducing dK/dV afterwards) is the
// fix, left for a later change.

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BKV = 64;         // keys per tile
constexpr int LDS = BQ + 8;     // dS^T rows [key][query] in shared memory, padded
constexpr int MAX_DEVICES = 64;
constexpr int MAX_KEY_TILES = 8192;   // the dQ kernel's flags a key tile (the wrapper checks)

// The sizes that depend on the head dim D.
template <int D>
struct Dims {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "D: the built head dims");
  static constexpr int LDK = D + 8;        // padded smem rows: conflict-free fragment loads
  static constexpr int CH = D / 8;         // 16-byte chunks a row
  static constexpr int CH_LOG2 = D == 16 ? 1 : D == 32 ? 2 : D == 64 ? 3 : 4;
  // query rows of one S^T / dP^T register pass of the dK/dV kernel
  static constexpr int QP = D > 64 ? 32 : 64;
  // the capped dK/dV build (3 resident blocks) exists where it does not spill
  static constexpr int CAPPED = D <= 64 ? 3 : 0;
  // dK/dV dynamic shared memory: K, V; Q, dO double-buffered; a warp's dS^T
  // rows; lse and delta double-buffered
  static constexpr int DKDV_SMEM =
      (2 * BKV * LDK + 4 * BQ * LDK + 4 * 16 * LDS) * 2 + 4 * BQ * 4;
  // dQ: DQ_STAGES (dS^T tile, K tile) pairs, then a flag a key tile
  static constexpr int DQ_STAGE = BKV * LDS + BKV * LDK;     // bf16 elements a stage
  static_assert(BQ % QP == 0 && QP % 16 == 0, "whole passes of 16-row chunks");
};

using bf16 = __nv_bfloat16;
using simlingo::ld32;

__device__ __forceinline__ float lse_as_read(float lse) {
  // a row that sees no valid key (lse = -inf) must give P = 0
  return lse == -INFINITY ? INFINITY : lse;
}

// Whether the dK/dV kernel writes, and the dQ kernel reads, the dS^T tile of
// (query tile qt, key tile kt): its key tile holds a valid key and, if
// causal, its first key is visible to its last row (slot q_offset + row).
// Monotone: true for a suffix of qt and a prefix of kt.
__device__ __forceinline__ bool pair_live(bool key_tile_live, int qt, int kt,
                                          int T, int causal, int q_offset) {
  return key_tile_live &&
         (!causal || kt * BKV <= q_offset + min(qt * BQ + BQ - 1, T - 1));
}

// The prep kernels' blocks past the rows' (block i of them): one warp a
// key tile, live[b * n_kt + kt] = any valid key in [64 kt, 64 kt + 64).
__device__ __forceinline__ void flag_live_tiles(const uint8_t* __restrict__ kv_valid,
                                                uint8_t* __restrict__ live, int S, int n_kt,
                                                long long tiles, long long block) {
  const int lane = threadIdx.x & 31;
  const long long i = block * 8LL + (threadIdx.x >> 5);          // (b, kt)
  if (i >= tiles) return;
  const long long b = i / n_kt;
  const int k0 = static_cast<int>(i % n_kt) * BKV;
  const uint8_t* vr = kv_valid + b * S;
  const bool any = (k0 + lane < S && vr[k0 + lane]) ||
                   (k0 + 32 + lane < S && vr[k0 + 32 + lane]);
  const unsigned m = __ballot_sync(0xffffffffu, any);
  if (lane == 0) live[i] = m != 0u;
}

// Rows (b, t, h) first, 8 lanes a row with 16-byte loads: delta[b, h, t] =
// sum_d dO * O, with dO and O contiguous [B, T, HQ, D]. Then, with
// kv_valid, one warp a key tile: live[b * n_kt + kt] = any valid key in
// [64 kt, 64 kt + 64).
//
// The sum keeps the order of a warp a row with 4-byte loads (lane l the
// products of elements 2l, 2l + 1, then a butterfly over lanes 16, 8, 4, 2,
// 1), so delta -- and so dK -- keep their bits: lane p of a row holds that
// warp's lanes 4p .. 4p + 3 as w[0..3]; lanes 16, 8, 4 apart are lanes 4, 2,
// 1 apart here, and lanes 2, 1 apart are w[j ^ 2], w[j ^ 1] in the lane.
// At D = 128 a lane holds 16 elements, adding its second 8 to w[0..3] in
// place; at D = 32 and 16 it holds 4 and 2, in w[0..1] and w[0].
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                float* __restrict__ delta, const uint8_t* __restrict__ kv_valid,
                uint8_t* __restrict__ live, int T, int S, int HQ, int n_kt,
                long long rows, long long tiles) {
  const long long row_blocks = (rows + 31) / 32;
  if (blockIdx.x >= row_blocks) {
    flag_live_tiles(kv_valid, live, S, n_kt, tiles, blockIdx.x - row_blocks);
    return;
  }
  const long long w = blockIdx.x * 32LL + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  constexpr int PAIRS = D / 16;                    // bf16 pairs a lane
  if (w < rows) {
    // the lane's D / 8 elements, 16 bytes (or all of them) at a time
    constexpr int VEC = PAIRS < 4 ? PAIRS : 4;
    using Vec = typename std::conditional<VEC == 4, uint4,
                typename std::conditional<VEC == 2, uint2, uint32_t>::type>::type;
#pragma unroll
    for (int u = 0; u < PAIRS / VEC; ++u) {
      const Vec ov = reinterpret_cast<const Vec*>(o + w * D)[part * (PAIRS / VEC) + u];
      const Vec dv = reinterpret_cast<const Vec*>(dout + w * D)[part * (PAIRS / VEC) + u];
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = __bfloat162float(op[j].x) * __bfloat162float(dp[j].x) +
                        __bfloat162float(op[j].y) * __bfloat162float(dp[j].y);
        acc[j] = u == 0 ? t : acc[j] + t;
      }
    }
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
  if (part == 0 && w < rows) {
    const int h = static_cast<int>(w % HQ);
    const long long bt = w / HQ;
    const long long b = bt / T, t = bt % T;
    delta[(b * HQ + h) * T + t] = (acc[0] + acc[2]) + (acc[1] + acc[3]);
  }
}

// MIN_BLOCKS: resident blocks an SM that ptxas must fit (3 caps the
// registers at 168); 1 leaves the count to ptxas (2 blocks an SM).
template <int D, int MIN_BLOCKS, typename OutT>
__global__ void __launch_bounds__(128, MIN_BLOCKS)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                const uint8_t* __restrict__ live,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ ds,
                OutT* __restrict__ dk, OutT* __restrict__ dv,
                int T, int S, int HQ, int HK,
                long long sqb, long long sqt, long long sqh,
                long long skb, long long sks, long long skh,
                long long svb, long long svs, long long svh,
                int causal, int q_offset, float scale, float scale_log2) {
  constexpr int LDK = Dims<D>::LDK, CH = Dims<D>::CH, CH_LOG2 = Dims<D>::CH_LOG2;
  constexpr int QP = Dims<D>::QP;
  extern __shared__ __align__(16) bf16 kv_s[];
  bf16* Ks = kv_s;                                   // [key][d]
  bf16* Vs = Ks + BKV * LDK;                         // [key][d]
  bf16* Qs = Vs + BKV * LDK;                         // [2][query][d]
  bf16* dOs = Qs + 2 * BQ * LDK;                     // [2][query][d]
  bf16* dSs = dOs + 2 * BQ * LDK;                    // [4 warps][16 keys][LDS]: dS^T rows
  float* lse_s = reinterpret_cast<float*>(dSs + 4 * 16 * LDS);   // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                               // [2][BQ]

  const int kt = blockIdx.x, k0 = kt * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = HQ / HK;
  const int n_qt = (T + BQ - 1) / BQ, n_kt = (S + BKV - 1) / BKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g;              // this thread's keys: key0, key0+8
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = key0 + r * 8;
    key_ok[r] = s < S && (kv_valid == nullptr || kv_valid[(long long)b * S + s]);
  }
  const bool tile_live = live == nullptr || live[(long long)b * n_kt + kt];
  int qt_lo = 0;                                    // the first query tile that sees k0
  while (qt_lo < n_qt && !pair_live(tile_live, qt_lo, kt, T, causal, q_offset)) ++qt_lo;
  const int n_qtv = n_qt - qt_lo;
  const int n_it = group * n_qtv;

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;

  if (n_it > 0) {
    // the block's K and V rows to shared memory once (keys past S as 0); each
    // warp takes its A-fragments by ldmatrix where it needs them, so they
    // hold no registers across the loop
    for (int c = tid; c < BKV * CH; c += 128) {
      const int key = c >> CH_LOG2, dc = (c & (CH - 1)) * 8, s = k0 + key;
      const bool in = s < S;
      simlingo::cp_async16(&Ks[key * LDK + dc], in ? kb + s * sks + dc : kb, in);
      simlingo::cp_async16(&Vs[key * LDK + dc], in ? vb + s * svs + dc : vb, in);
    }

    // stage query tile `it`: (head, tile) = (hk * group + it / n_qtv, qt_lo + it % n_qtv)
    auto load_tile = [&](int stage, int it) {
      const int h = hk * group + it / n_qtv;
      const int q0 = (qt_lo + it % n_qtv) * BQ;
      const bf16* qb = q + b * sqb + h * sqh;
      const bf16* db = dout + ((long long)b * T * HQ + h) * D;
      for (int c = tid; c < BQ * CH; c += 128) {
        const int row = c >> CH_LOG2, dc = (c & (CH - 1)) * 8, t = q0 + row;
        const bool in = t < T;
        simlingo::cp_async16(&Qs[stage * BQ * LDK + row * LDK + dc],
                             in ? qb + t * sqt + dc : qb, in);
        simlingo::cp_async16(&dOs[stage * BQ * LDK + row * LDK + dc],
                             in ? db + (long long)t * HQ * D + dc : db, in);
      }
      if (tid < BQ) {
        const int t = q0 + tid;
        const long long i = ((long long)b * HQ + h) * T + t;
        lse_s[stage * BQ + tid] = t < T ? lse_as_read(lse[i]) : INFINITY;
        delta_s[stage * BQ + tid] = t < T ? delta[i] : 0.f;
      }
    };
    load_tile(0, 0);
    simlingo::cp_async_commit();

    bf16* stage_ds = dSs + warp * 16 * LDS;
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      const int h = hk * group + it / n_qtv;
      const int q0 = (qt_lo + it % n_qtv) * BQ;
      if (it + 1 < n_it) load_tile(st ^ 1, it + 1);
      simlingo::cp_async_commit();
      simlingo::cp_async_wait<1>();
      __syncthreads();
      const bf16* Qt = Qs + st * BQ * LDK;
      const bf16* dOt = dOs + st * BQ * LDK;
      const float* lse_t = lse_s + st * BQ;
      const float* delta_t = delta_s + st * BQ;

      // query rows [qp, qp + QP) a pass: all 64 at D <= 64
#pragma unroll
      for (int qp = 0; qp < BQ; qp += QP) {
        // S^T = K Q^T and dP^T = V dO^T over QP queries: QP / 8 n-tiles of 8
        float sc[QP / 8][4], dp[QP / 8][4];
#pragma unroll
        for (int nt = 0; nt < QP / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t kf[4], vf[4];
          const int kvo = (warp * 16 + (lane & 15)) * LDK + ks * 16 + (lane >> 4) * 8;
          simlingo::ldmatrix_x4(kf, &Ks[kvo]);
          simlingo::ldmatrix_x4(vf, &Vs[kvo]);
#pragma unroll
          for (int nt = 0; nt < QP / 8; ++nt) {
            const bf16* qp_ = &Qt[(qp + nt * 8 + g) * LDK + ks * 16 + t4 * 2];
            simlingo::mma_bf16_16816(sc[nt], kf, ld32(qp_), ld32(qp_ + 8));
            const bf16* dp_ = &dOt[(qp + nt * 8 + g) * LDK + ks * 16 + t4 * 2];
            simlingo::mma_bf16_16816(dp[nt], vf, ld32(dp_), ld32(dp_ + 8));
          }
        }
        // P^T and dS^T in place: row = key (g, g+8), column = query
#pragma unroll
        for (int nt = 0; nt < QP / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = qp + nt * 8 + t4 * 2 + (j & 1);
            const int key = key0 + (j >> 1) * 8;
            const bool ok = key_ok[j >> 1] && (!causal || key <= q0 + col + q_offset);
            const float p = ok ? exp2f(sc[nt][j] * scale_log2 - lse_t[col]) : 0.f;
            sc[nt][j] = p;
            dp[nt][j] = p * (dp[nt][j] - delta_t[col]);
          }
        // dV += P^T dO and dK += dS^T Q: n-tiles (2kk, 2kk+1) of the
        // accumulators are the A-fragment of queries qp + [16kk, 16kk+16)
#pragma unroll
        for (int kk = 0; kk < QP / 16; ++kk) {
          uint32_t pa[4], sa[4];
          pa[0] = simlingo::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
          pa[1] = simlingo::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
          pa[2] = simlingo::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[3] = simlingo::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
          sa[0] = simlingo::pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
          sa[1] = simlingo::pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
          sa[2] = simlingo::pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          sa[3] = simlingo::pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
          const int q16 = qp + kk * 16;
          // the same bf16 dS^T, keys [16 warp, +16) x queries [q16, +16), to the warp's tile
          simlingo::stmatrix_x4(sa, &stage_ds[(lane & 15) * LDS + q16 + (lane >> 4) * 8]);
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            uint32_t b0, b1;
            simlingo::ldmatrix_x2_trans(b0, b1, &dOt[(q16 + (lane & 15)) * LDK + dt * 8]);
            simlingo::mma_bf16_16816(dvacc[dt], pa, b0, b1);
            simlingo::ldmatrix_x2_trans(b0, b1, &Qt[(q16 + (lane & 15)) * LDK + dt * 8]);
            simlingo::mma_bf16_16816(dkacc[dt], sa, b0, b1);
          }
        }
      }
      // the warp's 16 rows of tile (kt, q0 / 64): 2 KB, contiguous
      __syncwarp();
      bf16* dsw = ds + ((((long long)b * HQ + h) * n_kt + kt) * n_qt + q0 / BQ) * (BKV * BQ) +
                  warp * 16 * BQ;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i, r = c >> 3, cc = (c & 7) * 8;
        *reinterpret_cast<uint4*>(dsw + c * 8) =
            *reinterpret_cast<const uint4*>(&stage_ds[r * LDS + cc]);
      }
      __syncthreads();                 // stage `st` (and the dS tile) is reused next iteration
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= S) continue;
    OutT* dkrow = dk + (((long long)b * S + key) * HK + hk) * D;
    OutT* dvrow = dv + (((long long)b * S + key) * HK + hk) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float2*>(dkrow + dt * 8 + t4 * 2) =
            make_float2(dkacc[dt][2 * r] * scale, dkacc[dt][2 * r + 1] * scale);
        *reinterpret_cast<float2*>(dvrow + dt * 8 + t4 * 2) =
            make_float2(dvacc[dt][2 * r], dvacc[dt][2 * r + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(dkrow + dt * 8 + t4 * 2) = simlingo::pack_bf16x2(
            dkacc[dt][2 * r] * scale, dkacc[dt][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvrow + dt * 8 + t4 * 2) = simlingo::pack_bf16x2(
            dvacc[dt][2 * r], dvacc[dt][2 * r + 1]);
      }
    }
  }
}

// dQ[b, t, h, :] = scale * sum_s dS[b, h, t, s] K[b, s, h / group, :] over the
// key tiles whose pair with this query tile is live. Dynamic shared memory:
// a ring of DQ_STAGES (dS^T tile, K tile) pairs, then n_kt key-tile flags
// (the loop is bound by reading the scratch; deeper rings were no faster).
constexpr int DQ_STAGES = 2;

template <int D, typename OutT>
__global__ void __launch_bounds__(128)
bwd_dq_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ k,
              const uint8_t* __restrict__ live, OutT* __restrict__ dq,
              int T, int S, int HQ, int HK, long long skb, long long sks, long long skh,
              int causal, int q_offset, float scale) {
  constexpr int LDK = Dims<D>::LDK, CH = Dims<D>::CH, CH_LOG2 = Dims<D>::CH_LOG2;
  constexpr int DQ_STAGE = Dims<D>::DQ_STAGE;
  extern __shared__ __align__(16) uint8_t dq_smem[];
  bf16* ring = reinterpret_cast<bf16*>(dq_smem);    // stage: [key][query] dS^T, [key][d] K
  uint8_t* live_s = dq_smem + DQ_STAGES * DQ_STAGE * 2;

  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HK);
  const int n_qt = (T + BQ - 1) / BQ, n_kt = (S + BKV - 1) / BKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // tile (kt, qt) of this (b, h) at dsb + kt * n_qt * 64 * 64
  const bf16* dsb = ds + (((long long)b * HQ + h) * n_kt * n_qt + qt) * (BKV * BQ);
  const bf16* kb = k + b * skb + hk * skh;

  for (int i = tid; i < n_kt; i += 128)
    live_s[i] = live == nullptr || live[(long long)b * n_kt + i];
  __syncthreads();
  auto next_tile = [&](int kt) {                    // the next live key tile after kt
    for (++kt; kt < n_kt; ++kt)
      if (pair_live(live_s[kt], qt, kt, T, causal, q_offset)) break;
    return kt;
  };

  float dqacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqacc[i][j] = 0.f;

  auto load_tile = [&](int stage, int kt) {
    bf16* dSs = ring + stage * DQ_STAGE;
    bf16* Ks = dSs + BKV * LDS;
    const int kv0 = kt * BKV;
    const bf16* tile = dsb + (long long)kt * n_qt * (BKV * BQ);
    for (int c = tid; c < BKV * (BQ / 8); c += 128)
      simlingo::cp_async16(&dSs[(c >> 3) * LDS + (c & 7) * 8], tile + c * 8, true);
    for (int c = tid; c < BKV * CH; c += 128) {
      const int key = c >> CH_LOG2, dc = (c & (CH - 1)) * 8, s = kv0 + key;
      const bool in = s < S;
      simlingo::cp_async16(&Ks[key * LDK + dc], in ? kb + s * sks + dc : kb, in);
    }
  };
  // prologue: the first DQ_STAGES - 1 live tiles, one commit group each
  int kt_load = next_tile(-1);
#pragma unroll
  for (int st = 0; st < DQ_STAGES - 1; ++st) {
    if (kt_load < n_kt) {
      load_tile(st, kt_load);
      kt_load = next_tile(kt_load);
    }
    simlingo::cp_async_commit();
  }

  int it = 0;
  for (int kt = next_tile(-1); kt < n_kt; kt = next_tile(kt), ++it) {
    simlingo::cp_async_wait<DQ_STAGES - 2>();       // tile `it` has landed
    __syncthreads();                                // ... for all; stage it - 1 is free
    if (kt_load < n_kt) {
      load_tile((it + DQ_STAGES - 1) % DQ_STAGES, kt_load);
      kt_load = next_tile(kt_load);
    }
    simlingo::cp_async_commit();
    const bf16* dSt = ring + (it % DQ_STAGES) * DQ_STAGE;
    const bf16* Kt = dSt + BKV * LDS;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // A = dS [16 rows of this warp][16 keys]: the key-major tile, transposed
      uint32_t a[4];
      simlingo::ldmatrix_x4_trans(
          a, &dSt[(ks * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS + warp * 16 +
                  ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bk[4];
        simlingo::ldmatrix_x4_trans(bk, &Kt[(ks * 16 + (lane & 15)) * LDK + dp * 16 +
                                            (lane >> 4) * 8]);
        simlingo::mma_bf16_16816(dqacc[2 * dp], a, bk[0], bk[1]);
        simlingo::mma_bf16_16816(dqacc[2 * dp + 1], a, bk[2], bk[3]);
      }
    }
  }

  if constexpr (std::is_same<OutT, float>::value) {
    // fp32: each thread stores its accumulator pairs, rows g and g + 8 of
    // the warp's 16, 8 bytes at a time
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + warp * 16 + g + r * 8;
      if (t >= T) continue;
      float* row = dq + (((long long)b * T + t) * HQ + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(row + n * 8 + t4 * 2) =
            make_float2(dqacc[n][2 * r] * scale, dqacc[n][2 * r + 1] * scale);
    }
    return;
  }
  // scale, round to bf16 and stage the warp's 16 rows x D through the ring
  // (once every warp is past its last tile) for 16-byte row stores
  __syncthreads();
  bf16* stage_dq = ring + warp * 16 * LDK;
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    uint32_t r[4];
    r[0] = simlingo::pack_bf16x2(dqacc[2 * p][0] * scale, dqacc[2 * p][1] * scale);
    r[1] = simlingo::pack_bf16x2(dqacc[2 * p][2] * scale, dqacc[2 * p][3] * scale);
    r[2] = simlingo::pack_bf16x2(dqacc[2 * p + 1][0] * scale, dqacc[2 * p + 1][1] * scale);
    r[3] = simlingo::pack_bf16x2(dqacc[2 * p + 1][2] * scale, dqacc[2 * p + 1][3] * scale);
    simlingo::stmatrix_x4(r, &stage_dq[(lane & 15) * LDK + p * 16 + (lane >> 4) * 8]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {               // 16 rows x CH chunks over 32 lanes
    const int c = lane + 32 * i, r = c >> CH_LOG2, cc = (c & (CH - 1)) * 8;
    const int t = q0 + warp * 16 + r;
    if (t < T)
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(dq) + (((long long)b * T + t) * HQ + h) * D + cc) =
          *reinterpret_cast<const uint4*>(&stage_dq[r * LDK + cc]);
  }
}

// ---------------------------------------------------------------------------
// the fp32 build (training at precision=fp32)
// ---------------------------------------------------------------------------
//
// JAX's backward keeps P and dS in the operand dtype (:262, :267), so at
// fp32 every product is an fp32 product: here fp32 FMAs (no TF32, no bf16
// rounding), with the same three launches, pairs and tile order as the
// bf16 build and an fp32 dS^T scratch (4 bytes an element: 909,115,392 B
// at the ViT's [12,1025,16,64], 232,587,264 B at the LLM's GQA shape).
// Gradients come out in fp32. No atomics: the same bits every call.
//
//   1. bwd_prep_f32_kernel: delta = rowsum(dO * O), 8 lanes a row, and the
//      key tiles' live flags (as the bf16 prep).
//   2. bwd_dkdv_f32_kernel: one block per (64-key tile, kv head, batch), NT
//      threads (128; 256 at D = 128). Thread (kg = tid / RG, rl = tid % RG)
//      owns keys 4 kg .. 4 kg + 3 and, of each 64-row query tile, rows rl +
//      RG j: S^T = K Q^T and dP^T = V dO^T as 4 x RPT register tiles (two
//      d loops, 16-byte shared loads; Q and dO rows D + 4 floats apart, so a
//      quarter-warp phase hits 8 distinct bank groups). P^T = exp2(s scale
//      log2(e) - lse) and dS^T = P^T (dP^T - delta) go to shared memory
//      (a key group's rows are read only by its own warp: __syncwarp); dV
//      += P^T dO and dK += dS^T Q then sum the 64 rows in order into each
//      thread's keys x columns VW rl + RG VW u + w, the accumulators in
//      registers across the group's heads and query tiles. Each warp also
//      copies its keys' dS^T rows to the scratch tile.
//   3. bwd_dq_f32_kernel: one block of 128 threads per (64-row query tile,
//      query head, batch): dQ = scale dS K over the live key tiles, the dS^T
//      tile and the K tile double-buffered by cp.async; thread (rg, kg)
//      owns rows 4 rg .. 4 rg + 3 and columns VW kg + 8 VW u + w.
//
// Each accumulator sums a tile (64 rows for dK / dV, 64 keys for dQ) from
// 0 and then adds it to its running sum: one running sum over the LLM's 7
// heads x 798 rows measured 4x the error against an fp64 reference (a numpy
// model of dV at 7 heads x 300 causal rows: 2.0e-5 against 4.7e-6 of
// rms(dV)).
//
// What bounds it: fp32 operations, 10 T S D a head (S, dP, dV, dK, dQ), at
// 67 TFLOP/s without tensor cores; the scratch (8 bytes an element over
// both passes) is far below that.
template <int D>
struct F32Dims {
  static constexpr int LD = D + 4;                 // fp32 rows of K, V, Q, dO
  static constexpr int LDP = BQ + 4;               // P^T / dS^T rows [key][query]
  static constexpr int NT = D > 64 ? 256 : 128;    // dK/dV threads
  static constexpr int RG = NT / 16;               // lanes of a key group
  static constexpr int RPT = BQ / RG;              // query rows a thread
  static constexpr int VW = D / RG >= 4 ? 4 : 2;   // dK / dV vector
  static constexpr int NU = D / (RG * VW);         // vectors a key a thread
  // dQ: 128 threads, 8 lanes a row group
  static constexpr int QVW = D >= 32 ? 4 : 2;
  static constexpr int QNU = D / (8 * QVW);
  // dK/dV: K, V, Q, dO rows; P^T and dS^T; lse and delta
  static constexpr int DKDV_SMEM = (4 * BKV * LD + 2 * BKV * LDP + 2 * BQ) * 4;
  // dQ: a stage is a dS^T tile [key][query] and a K tile [key][d]
  static constexpr int DQ_STAGE = BKV * BQ + BKV * LD;     // floats
  static_assert(RG * VW * NU == D && 8 * QVW * QNU == D, "the lanes cover a row");
};

template <int VW>
__device__ __forceinline__ void lds_f32(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int VW>
__device__ __forceinline__ void stg_f32(float* p, const float (&v)[VW], float scale) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(v[0] * scale, v[1] * scale, v[2] * scale, v[3] * scale);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0] * scale, v[1] * scale);
  }
}

// delta[b, h, t] = sum_d dO * O for contiguous fp32 [B, T, HQ, D] rows: 8
// lanes a row, lane p the elements [p D / 8, (p + 1) D / 8) in order, then
// a butterfly over lanes 4, 2, 1; and the live flags.
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_f32_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                    float* __restrict__ delta, const uint8_t* __restrict__ kv_valid,
                    uint8_t* __restrict__ live, int T, int S, int HQ, int n_kt,
                    long long rows, long long tiles) {
  const long long row_blocks = (rows + 31) / 32;
  if (blockIdx.x >= row_blocks) {
    flag_live_tiles(kv_valid, live, S, n_kt, tiles, blockIdx.x - row_blocks);
    return;
  }
  const long long w = blockIdx.x * 32LL + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  constexpr int PER = D / 8, VW = PER >= 4 ? 4 : 2;
  float acc = 0.f;
  if (w < rows) {
#pragma unroll
    for (int c = 0; c < PER; c += VW) {
      float a[VW], e[VW];
      lds_f32<VW>(o + w * D + part * PER + c, a);         // (a global load here)
      lds_f32<VW>(dout + w * D + part * PER + c, e);
#pragma unroll
      for (int j = 0; j < VW; ++j) acc = fmaf(a[j], e[j], acc);
    }
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0 && w < rows) {
    const int h = static_cast<int>(w % HQ);
    const long long bt = w / HQ;
    delta[((bt / T) * HQ + h) * T + bt % T] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(F32Dims<D>::NT)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                    const uint8_t* __restrict__ live,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ ds,
                    float* __restrict__ dk, float* __restrict__ dv,
                    int T, int S, int HQ, int HK,
                    long long sqb, long long sqt, long long sqh,
                    long long skb, long long sks, long long skh,
                    long long svb, long long svs, long long svh,
                    int causal, int q_offset, float scale, float scale_log2) {
  using Dm = F32Dims<D>;
  constexpr int LD = Dm::LD, LDP = Dm::LDP, NT = Dm::NT, RG = Dm::RG, RPT = Dm::RPT;
  constexpr int VW = Dm::VW, NU = Dm::NU;
  extern __shared__ __align__(16) float smem_f[];
  float* Ks = smem_f;                                // [key][d]
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;                         // [query][d]
  float* dOs = Qs + BQ * LD;
  float* PT = dOs + BQ * LD;                         // [key][query]
  float* dST = PT + BKV * LDP;
  float* lse_s = dST + BKV * LDP;                    // [query]
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x, k0 = kt * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = HQ / HK;
  const int n_qt = (T + BQ - 1) / BQ, n_kt = (S + BKV - 1) / BKV;
  const int tid = threadIdx.x, kg = tid / RG, rl = tid % RG, kl0 = 4 * kg;
  const float* kb = k + b * skb + hk * skh;
  const float* vb = v + b * svb + hk * svh;

  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + kl0 + i;
    key_ok[i] = s < S && (kv_valid == nullptr || kv_valid[(long long)b * S + s]);
  }
  const bool tile_live = live == nullptr || live[(long long)b * n_kt + kt];
  int qt_lo = 0;
  while (qt_lo < n_qt && !pair_live(tile_live, qt_lo, kt, T, causal, q_offset)) ++qt_lo;
  const int n_qtv = n_qt - qt_lo;
  const int n_it = group * n_qtv;

  float dkacc[4][D / RG], dvacc[4][D / RG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / RG; ++c) dkacc[i][c] = dvacc[i][c] = 0.f;

  if (n_it > 0) {
    for (int c = tid; c < BKV * (D / 4); c += NT) {        // keys past S as 0
      const int key = c / (D / 4), dc = (c % (D / 4)) * 4, s = k0 + key;
      const bool in = s < S;
      simlingo::cp_async16(&Ks[key * LD + dc], in ? kb + s * sks + dc : kb, in);
      simlingo::cp_async16(&Vs[key * LD + dc], in ? vb + s * svs + dc : vb, in);
    }
  }
  for (int it = 0; it < n_it; ++it) {
    const int h = hk * group + it / n_qtv;
    const int qt = qt_lo + it % n_qtv, q0 = qt * BQ;
    const float* qb = q + b * sqb + h * sqh;
    const float* db = dout + ((long long)b * T * HQ + h) * D;
    __syncthreads();                   // the previous tile's Q, dO, P^T, dS^T are read
    for (int c = tid; c < BQ * (D / 4); c += NT) {         // rows past T as 0
      const int row = c / (D / 4), dc = (c % (D / 4)) * 4, t = q0 + row;
      const bool in = t < T;
      simlingo::cp_async16(&Qs[row * LD + dc], in ? qb + t * sqt + dc : qb, in);
      simlingo::cp_async16(&dOs[row * LD + dc], in ? db + (long long)t * HQ * D + dc : db, in);
    }
    simlingo::cp_async_commit();
    if (tid < BQ) {
      const int t = q0 + tid;
      const long long i = ((long long)b * HQ + h) * T + t;
      lse_s[tid] = t < T ? lse_as_read(lse[i]) : INFINITY;
      delta_s[tid] = t < T ? delta[i] : 0.f;
    }
    simlingo::cp_async_wait<0>();
    __syncthreads();

    // S^T and dP^T over the thread's 4 keys x RPT rows, d in order
    float sc[4][RPT], dp[4][RPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float a[4][4], x[RPT][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds_f32<4>(&Ks[(kl0 + i) * LD + d], a[i]);
#pragma unroll
      for (int j = 0; j < RPT; ++j) lds_f32<4>(&Qs[(rl + RG * j) * LD + d], x[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(a[i][e], x[j][e], sc[i][j]);
    }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float a[4][4], x[RPT][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds_f32<4>(&Vs[(kl0 + i) * LD + d], a[i]);
#pragma unroll
      for (int j = 0; j < RPT; ++j) lds_f32<4>(&dOs[(rl + RG * j) * LD + d], x[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[i][j] = fmaf(a[i][e], x[j][e], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int row = rl + RG * j, key = k0 + kl0 + i;
        const bool ok = key_ok[i] && (!causal || key <= q0 + row + q_offset);
        const float p = ok ? exp2f(sc[i][j] * scale_log2 - lse_s[row]) : 0.f;
        PT[(kl0 + i) * LDP + row] = p;
        dST[(kl0 + i) * LDP + row] = p * (dp[i][j] - delta_s[row]);
      }
    __syncwarp();                      // the key group's rows are written

    // dV += P^T dO, dK += dS^T Q: the tile's 64 rows in order from 0, then
    // added to the running sums (see F32Dims)
    float tk[4][D / RG], tv[4][D / RG];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / RG; ++c) tk[i][c] = tv[i][c] = 0.f;
#pragma unroll 2
    for (int r = 0; r < BQ; r += 4) {
      float p4[4][4], s4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lds_f32<4>(&PT[(kl0 + i) * LDP + r], p4[i]);
        lds_f32<4>(&dST[(kl0 + i) * LDP + r], s4[i]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ov[NU][VW], qv[NU][VW];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          lds_f32<VW>(&dOs[(r + e) * LD + VW * rl + RG * VW * u], ov[u]);
          lds_f32<VW>(&Qs[(r + e) * LD + VW * rl + RG * VW * u], qv[u]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int w = 0; w < VW; ++w) {
              tv[i][u * VW + w] = fmaf(p4[i][e], ov[u][w], tv[i][u * VW + w]);
              tk[i][u * VW + w] = fmaf(s4[i][e], qv[u][w], tk[i][u * VW + w]);
            }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / RG; ++c) {
        dkacc[i][c] += tk[i][c];
        dvacc[i][c] += tv[i][c];
      }
    // the warp's keys of dS^T tile (kt, qt): [key][64 queries], contiguous
    {
      constexpr int KEYS_W = 32 / RG * 4;
      const int warp = tid >> 5, lane = tid & 31;
      float* dsw = ds + ((((long long)b * HQ + h) * n_kt + kt) * n_qt + qt) * (BKV * BQ) +
                   warp * KEYS_W * BQ;
#pragma unroll
      for (int c = lane; c < KEYS_W * (BQ / 4); c += 32) {
        const int key = c / (BQ / 4), cc = (c % (BQ / 4)) * 4;
        *reinterpret_cast<float4*>(dsw + key * BQ + cc) =
            *reinterpret_cast<const float4*>(&dST[(warp * KEYS_W + key) * LDP + cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + kl0 + i;
    if (key >= S) continue;
    float* dkrow = dk + (((long long)b * S + key) * HK + hk) * D;
    float* dvrow = dv + (((long long)b * S + key) * HK + hk) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float a[VW], e[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        a[w] = dkacc[i][u * VW + w];
        e[w] = dvacc[i][u * VW + w];
      }
      stg_f32<VW>(dkrow + VW * rl + RG * VW * u, a, scale);
      stg_f32<VW>(dvrow + VW * rl + RG * VW * u, e, 1.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128)
bwd_dq_f32_kernel(const float* __restrict__ ds, const float* __restrict__ k,
                  const uint8_t* __restrict__ live, float* __restrict__ dq,
                  int T, int S, int HQ, int HK, long long skb, long long sks, long long skh,
                  int causal, int q_offset, float scale) {
  using Dm = F32Dims<D>;
  constexpr int LD = Dm::LD, VW = Dm::QVW, NU = Dm::QNU, STAGE = Dm::DQ_STAGE;
  extern __shared__ __align__(16) float dq_smem_f[];
  float* ring = dq_smem_f;                            // stage: [key][query] dS^T, [key][d] K
  uint8_t* live_s = reinterpret_cast<uint8_t*>(ring + 2 * STAGE);

  const int qt = blockIdx.x, q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HK);
  const int n_qt = (T + BQ - 1) / BQ, n_kt = (S + BKV - 1) / BKV;
  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7, r0 = 4 * rg;
  const float* dsb = ds + (((long long)b * HQ + h) * n_kt * n_qt + qt) * (BKV * BQ);
  const float* kb = k + b * skb + hk * skh;

  for (int i = tid; i < n_kt; i += 128)
    live_s[i] = live == nullptr || live[(long long)b * n_kt + i];
  __syncthreads();
  auto next_tile = [&](int kt) {
    for (++kt; kt < n_kt; ++kt)
      if (pair_live(live_s[kt], qt, kt, T, causal, q_offset)) break;
    return kt;
  };
  auto load_tile = [&](int stage, int kt) {
    float* dSs = ring + stage * STAGE;
    float* Ks = dSs + BKV * BQ;
    const float* tile = dsb + (long long)kt * n_qt * (BKV * BQ);
    for (int c = tid; c < BKV * BQ / 4; c += 128)
      simlingo::cp_async16(&dSs[c * 4], tile + c * 4, true);
    for (int c = tid; c < BKV * (D / 4); c += 128) {
      const int key = c / (D / 4), dc = (c % (D / 4)) * 4, s = kt * BKV + key;
      const bool in = s < S;
      simlingo::cp_async16(&Ks[key * LD + dc], in ? kb + s * sks + dc : kb, in);
    }
  };

  float dqacc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dqacc[i][c] = 0.f;

  int kt = next_tile(-1);
  if (kt < n_kt) load_tile(0, kt);
  simlingo::cp_async_commit();
  for (int it = 0; kt < n_kt; ++it) {
    const int kt_next = next_tile(kt);
    __syncthreads();                                // stage it - 1 is free
    if (kt_next < n_kt) load_tile((it + 1) & 1, kt_next);
    simlingo::cp_async_commit();
    simlingo::cp_async_wait<1>();                   // tile `it` has landed
    __syncthreads();
    const float* dSt = ring + (it & 1) * STAGE;
    const float* Kt = dSt + BKV * BQ;
    float tq[4][D / 8];                             // the tile's 64 keys from 0
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) tq[i][c] = 0.f;
#pragma unroll 4
    for (int key = 0; key < BKV; ++key) {
      float d4[4], kv[NU][VW];
      lds_f32<4>(&dSt[key * BQ + r0], d4);
#pragma unroll
      for (int u = 0; u < NU; ++u) lds_f32<VW>(&Kt[key * LD + VW * kg + 8 * VW * u], kv[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int w = 0; w < VW; ++w)
            tq[i][u * VW + w] = fmaf(d4[i], kv[u][w], tq[i][u * VW + w]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) dqacc[i][c] += tq[i][c];
    kt = kt_next;
  }
  simlingo::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + r0 + i;
    if (t >= T) continue;
    float* row = dq + (((long long)b * T + t) * HQ + h) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float a[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) a[w] = dqacc[i][u * VW + w];
      stg_f32<VW>(row + VW * kg + 8 * VW * u, a, scale);
    }
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory, once a device.
cudaError_t raise_smem(const void* kernel, int bytes, std::atomic<bool>* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && raised[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES) raised[dev].store(true, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int D, typename OutT>
int launch(const void* q, const void* k, const void* v, const void* kv_valid,
           const void* o, const void* dout, const void* lse, void* delta, void* live,
           void* ds, void* dq, void* dk, void* dv, int B, int T, int S, int HQ, int HK,
           long long sqb, long long sqt, long long sqh,
           long long skb, long long sks, long long skh,
           long long svb, long long svs, long long svh,
           int causal, int q_offset, float scale, int dkdv_blocks, cudaStream_t st) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const int n_kt = (S + BKV - 1) / BKV, n_qt = (T + BQ - 1) / BQ;
  if (n_kt > MAX_KEY_TILES) return cudaErrorInvalidValue;
  const long long rows = (long long)B * T * HQ;
  const long long tiles = kv_valid != nullptr ? (long long)B * n_kt : 0;
  bwd_prep_kernel<D><<<static_cast<unsigned>((rows + 31) / 32 + (tiles + 7) / 8), 256, 0,
                       st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), static_cast<const uint8_t*>(kv_valid),
      static_cast<uint8_t*>(live), T, S, HQ, n_kt, rows, tiles);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const uint8_t* live_r = kv_valid != nullptr ? static_cast<const uint8_t*>(live) : nullptr;
  // the capped build where the caller asks for it and D has one
  const int capped = Dims<D>::CAPPED != 0 && dkdv_blocks == Dims<D>::CAPPED;
  if (dkdv_blocks != 1 && !capped) return cudaErrorInvalidValue;
  auto dkdv = capped ? bwd_dkdv_kernel<D, (Dims<D>::CAPPED ? Dims<D>::CAPPED : 1), OutT>
                     : bwd_dkdv_kernel<D, 1, OutT>;
  static std::atomic<bool> raised[2][MAX_DEVICES];
  cudaError_t e = raise_smem(reinterpret_cast<const void*>(dkdv), Dims<D>::DKDV_SMEM,
                             raised[capped]);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(n_kt, HK, B), 128, Dims<D>::DKDV_SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid), live_r,
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(ds), static_cast<OutT*>(dk),
      static_cast<OutT*>(dv), T, S, HQ, HK, sqb, sqt, sqh, skb, sks, skh,
      svb, svs, svh, causal, q_offset, scale, scale_log2);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  static std::atomic<bool> raised_dq[MAX_DEVICES];
  constexpr int dq_max = DQ_STAGES * Dims<D>::DQ_STAGE * 2 + MAX_KEY_TILES;
  e = raise_smem(reinterpret_cast<const void*>(bwd_dq_kernel<D, OutT>), dq_max, raised_dq);
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<D, OutT><<<dim3(n_qt, HQ, B), 128, DQ_STAGES * Dims<D>::DQ_STAGE * 2 + n_kt,
                           st>>>(
      static_cast<const bf16*>(ds), static_cast<const bf16*>(k), live_r,
      static_cast<OutT*>(dq), T, S, HQ, HK, skb, sks, skh, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* kv_valid,
               const void* o, const void* dout, const void* lse, void* delta, void* live,
               void* ds, void* dq, void* dk, void* dv, int B, int T, int S, int HQ, int HK,
               long long sqb, long long sqt, long long sqh,
               long long skb, long long sks, long long skh,
               long long svb, long long svs, long long svh,
               int causal, int q_offset, float scale, int dkdv_blocks, cudaStream_t st) {
  using Dm = F32Dims<D>;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int n_kt = (S + BKV - 1) / BKV, n_qt = (T + BQ - 1) / BQ;
  if (n_kt > MAX_KEY_TILES || dkdv_blocks != 1) return cudaErrorInvalidValue;
  const long long rows = (long long)B * T * HQ;
  const long long tiles = kv_valid != nullptr ? (long long)B * n_kt : 0;
  bwd_prep_f32_kernel<D><<<static_cast<unsigned>((rows + 31) / 32 + (tiles + 7) / 8), 256, 0,
                           st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<float*>(delta), static_cast<const uint8_t*>(kv_valid),
      static_cast<uint8_t*>(live), T, S, HQ, n_kt, rows, tiles);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const uint8_t* live_r = kv_valid != nullptr ? static_cast<const uint8_t*>(live) : nullptr;
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t e = raise_smem(reinterpret_cast<const void*>(bwd_dkdv_f32_kernel<D>),
                             Dm::DKDV_SMEM, raised);
  if (e != cudaSuccess) return e;
  bwd_dkdv_f32_kernel<D><<<dim3(n_kt, HK, B), Dm::NT, Dm::DKDV_SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_valid), live_r,
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(ds), static_cast<float*>(dk),
      static_cast<float*>(dv), T, S, HQ, HK, sqb, sqt, sqh, skb, sks, skh,
      svb, svs, svh, causal, q_offset, scale, scale_log2);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  static std::atomic<bool> raised_dq[MAX_DEVICES];
  constexpr int dq_max = 2 * Dm::DQ_STAGE * 4 + MAX_KEY_TILES;
  e = raise_smem(reinterpret_cast<const void*>(bwd_dq_f32_kernel<D>), dq_max, raised_dq);
  if (e != cudaSuccess) return e;
  bwd_dq_f32_kernel<D><<<dim3(n_qt, HQ, B), 128, 2 * Dm::DQ_STAGE * 4 + n_kt, st>>>(
      static_cast<const float*>(ds), static_cast<const float*>(k), live_r,
      static_cast<float*>(dq), T, S, HQ, HK, skb, sks, skh, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The constants the wrapper's plan (_bwd_plan) relies on, for head dim D
// and the operand type (fp32 != 0: the fp32 build): query rows and keys a
// tile, the resident dK/dV blocks an SM of the capped build (0: none; the
// fp32 build has none), the query rows of a dK/dV register pass and the
// dK/dV kernel's dynamic shared memory. Returns 0, or -1 for a D without
// an instance (the wrapper pads those).
extern "C" int simlingo_flash_attn_bwd_geometry(int head_dim, int fp32, int* out) {
  auto fill = [out, fp32](auto dims, auto f32) {
    using Dm = decltype(dims);
    using Fm = decltype(f32);
    out[0] = BQ;
    out[1] = BKV;
    out[2] = fp32 ? 0 : Dm::CAPPED;
    out[3] = fp32 ? BQ : Dm::QP;
    out[4] = fp32 ? Fm::DKDV_SMEM : Dm::DKDV_SMEM;
    return 0;
  };
  switch (head_dim) {
    case 16: return fill(Dims<16>{}, F32Dims<16>{});
    case 32: return fill(Dims<32>{}, F32Dims<32>{});
    case 64: return fill(Dims<64>{}, F32Dims<64>{});
    case 128: return fill(Dims<128>{}, F32Dims<128>{});
    default: return -1;
  }
}

// delta: fp32 scratch [B, HQ, T]; live: uint8 scratch [B, n_kt], null
// without kv_valid; ds: scratch [B, HQ, n_kt, n_qt, 64, 64] (n_kt, n_qt:
// S and T in tiles of 64), bf16, or fp32 with in_fp32; lse [B, HQ, T] from
// the forward; o, dout, dq contiguous [B, T, HQ, D]; dk, dv contiguous [B,
// S, HK, D]. All allocated by the caller. dkdv_blocks: 1, or the capped
// build's blocks; head_dim: 16, 32, 64 or 128 (else cudaErrorInvalidValue);
// in_fp32: 0 for bf16 q, k, v, o, dout, 1 for fp32 ones (the fp32 build,
// which writes fp32 dq / dk / dv: out_fp32 must be 1); out_fp32: 0 for
// bf16 dq / dk / dv, 1 for fp32 ones (for bf16 inputs: unrounded partials).
extern "C" int simlingo_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* o, const void* dout, const void* lse, void* delta, void* live,
    void* ds, void* dq, void* dk, void* dv, int B, int T, int S, int HQ, int HK,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    int causal, int q_offset, float scale, int dkdv_blocks, int head_dim, int out_fp32,
    int in_fp32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SIMLINGO_BWD_ARGS q, k, v, kv_valid, o, dout, lse, delta, live, ds, dq, dk, dv, B, T, S, \
    HQ, HK, sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, causal, q_offset, scale, dkdv_blocks, st
  if (out_fp32 != 0 && out_fp32 != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (in_fp32 != 0) {
    if (out_fp32 != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (head_dim) {
      case 16: return launch_f32<16>(SIMLINGO_BWD_ARGS);
      case 32: return launch_f32<32>(SIMLINGO_BWD_ARGS);
      case 64: return launch_f32<64>(SIMLINGO_BWD_ARGS);
      case 128: return launch_f32<128>(SIMLINGO_BWD_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (head_dim * 2 + out_fp32) {
    case 32: return launch<16, bf16>(SIMLINGO_BWD_ARGS);
    case 64: return launch<32, bf16>(SIMLINGO_BWD_ARGS);
    case 128: return launch<64, bf16>(SIMLINGO_BWD_ARGS);
    case 256: return launch<128, bf16>(SIMLINGO_BWD_ARGS);
    case 33: return launch<16, float>(SIMLINGO_BWD_ARGS);
    case 65: return launch<32, float>(SIMLINGO_BWD_ARGS);
    case 129: return launch<64, float>(SIMLINGO_BWD_ARGS);
    case 257: return launch<128, float>(SIMLINGO_BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIMLINGO_BWD_ARGS
}
