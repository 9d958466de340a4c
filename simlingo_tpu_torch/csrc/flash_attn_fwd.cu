// Flash attention forward for Hopper (sm_90a), bf16 in/out, fp32 softmax;
// and an fp32 build (fp32 in/out, fp32 FMA products) for training at
// precision=fp32, tiled path only (`flash_fwd_f32_kernel`, below).
//
// Replaces the Pallas TPU forward kernels of
// simlingo_tpu/kernels/flash_attention.py: _fwd_kernel_gqa (:308, the Qwen2
// LLM: GQA, slot-order causality with a dynamic q_offset, kv_valid mask),
// _fwd_kernel_pair (:786, the InternViT read from the flat [B,T,H*D]
// projection) and _fwd_kernel (:114, plain MHA). q/k/v come as strided
// [B, L, H, D] views, so ViT projections and the KV cache are read in
// place.
//
// The head dim D is a template parameter, built at D = 16, 32, 64 and 128
// (`HEAD_DIMS`): the CLIP tower and the LLMs use 64, SimLingo-Base's
// LLaMA variants past `tiny` 128, the test configurations 16 and 32. The
// wrapper zero-pads any other D <= 128 to the next of these. Tiles, rows a
// block and the loop's order are the same at every D: only the number of
// 16-wide d chunks of Q K^T, of 8-wide O accumulators and of 16-byte
// copies a row changes, so D = 64 keeps its bits.
//
// What bounds it: the ViT (T = S = 1025), prefill (T = 640, S = 770) and
// training calls are bound by tensor-core operations (4*T*S*D a head);
// decode, verify and the queries (T = 1 / 16 / 30) by reading the K/V cache
// and, far above that, by latency.
//
// Two kernels on one loop (`attend`), chosen by the wrapper's plan
// (kernels/flash_attention.py `_fwd_plan`); both are blocks of 4 warps of
// 16 query rows, each warp's Q in registers as mma.m16n8k16 A-fragments.
// K and V tiles of 64 keys stream through a 3-stage cp.async ring in
// dynamic shared memory (3 * 2 * 64 * (D + 8) * 2 bytes: 55 KB at D = 64,
// 3 blocks an SM at under 170 registers a thread; 102 KB at D = 128, 2
// blocks an SM); K's B-fragments come by ldmatrix.x4, V's by
// ldmatrix.x4.trans.
//
//  * flash_fwd_kernel (the tiled path: ViT, prefill, training): one block
//    per (64-row query tile, query head, batch).
//  * flash_fwd_split_kernel (the split path: small T x group): the query
//    heads of one GQA group are packed into the rows of one block, as
//    _fwd_kernel_gqa packs them (packed row r = (head in group r / T,
//    t = r % T), slot q_offset + t), so K/V of the group are read once
//    instead of once a head. The key range is cut into `splits` runs of
//    whole 64-key tiles, one block each; the blocks of one (row block, kv
//    head, batch) form one thread-block cluster. Each leaves its partial
//    (m, l, O) in fp32 in its shared memory, and after a cluster barrier
//    the blocks merge them over distributed shared memory in split order
//    0..n-1 -- no atomics, the same bits every call. The grid depends on S,
//    not on q_offset: splits past the last visible key do no work.
//
// Each row's arithmetic has a fixed order: 64-key softmax steps in
// ascending key order, each S accumulator summing its 16-wide d chunks in
// order, each O accumulator its 16-key chunks, then the epilogue; so the
// tiled path's bits do not depend on how the loop is scheduled (chip_smoke.py
// --parent holds them equal to another tree's). A tile that every row of a
// warp sees whole (no key past S, none invalid, none causally hidden)
// skips the per-element tests, and a warp whose rows all lie past T
// computes nothing; neither changes a bit. The scaled logits are rounded
// products (__fmul_rn), so the compiler cannot fuse them into the
// exponent. (Blocks of 128 rows -- 8 warps, or 32 rows a warp -- and a
// software-pipelined loop were measured slower: they need 149-255
// registers, so fewer warps an SM hide the softmax's latency. PERF.md.)
//
// Each kernel comes in two builds, `FEW` (`attend`): the plan takes the
// second where a row can see fewer than 64 keys by position (causal with
// q_offset < 63, or S < 64: `_fwd_remainder`). There a tile that is not
// whole, for a warp with a row whose weights sum to under L_FEW, adds P's
// bf16 remainder in a second product; every other tile keeps the one-pass
// loop's bits. The first build is the one-pass loop alone.
//
// Rows with no visible valid key return 0 and lse -inf; a split with no
// visible key for a row merges as nothing (m = -inf, l = 0).
//
// Training also asks for the base-2 log-sum-exp of each row's scaled
// logits (lse [B, HQ, T] fp32), which the backward (flash_attn_bwd.cu) uses
// to recompute P. Serving passes a null lse pointer.

#include <atomic>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using simlingo::ld32;

constexpr int BQ = 64;                   // rows a block: 4 warps of 16
constexpr int THREADS = 128;
constexpr int BKV = 64;                  // keys a tile
constexpr int STAGES = 3;                // depth of the cp.async ring
constexpr int MAX_CLUSTER = 8;           // splits: the portable cluster size
constexpr int MAX_DEVICES = 64;
constexpr float L_FEW = 64.f;            // see `attend`: weight sums below it take P's remainder

// The sizes that depend on the head dim D.
template <int D>
struct Dims {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "D: the built head dims");
  // (D + 8) * 2-byte rows: the 8 rows of an ldmatrix phase start 16 bytes
  // apart modulo 128, so they hit 32 distinct banks
  static constexpr int LDK = D + 8;
  static constexpr int CH = D / 8;                        // 16-byte chunks a row
  static constexpr int CH_LOG2 = D == 16 ? 1 : D == 32 ? 2 : D == 64 ? 3 : 4;
  static constexpr int STAGE_ELEMS = 2 * BKV * LDK;       // K [key][d], then V [key][d]
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;   // 55296 at D = 64
  static constexpr int LDO = D + 4;                       // fp32 partial rows (16-byte aligned)
  static_assert(BKV * CH % THREADS == 0, "whole copy rounds a tile");
  // the split path's partials (O, m, l) reuse the ring
  static_assert((BQ * LDO + 2 * BQ) * 4 <= RING_BYTES, "the partials fit the ring");
};

// One warp's view of the loop: the slots of a thread's two rows (g and g +
// 8 of the warp's 16), the first slot any live row of the warp has, and
// the tiles it computes.
struct WarpRows {
  int slot[2];
  int min_slot;
  int it_end;                            // tiles >= it_end: no products
};

// Attend the warp's rows to key tiles [it0, it1): K/V (and the validity of
// each key, one bit a key) stream through the ring; every warp of the
// block takes part in the copies and barriers, only tiles < w.it_end are
// computed. Updates the running max m_run, sum l_run (this thread's share)
// and the O accumulators. Ends behind a barrier with no copy in flight: the
// ring is free. FEW: see the P V step below.
template <int D, bool FEW>
__device__ __forceinline__ void attend(const bf16* __restrict__ kb, const bf16* __restrict__ vb,
                                       const uint8_t* __restrict__ valid_b,
                                       long long sks, long long svs, int S, int causal,
                                       int it0, int it1, const WarpRows& w,
                                       const uint32_t (&qf)[D / 16][4], float scale_log2,
                                       bf16* ring, uint32_t (*okw)[2],
                                       float (&oacc)[D / 8][4], float (&m_run)[2],
                                       float (&l_run)[2]) {
  constexpr int LDK = Dims<D>::LDK, CH = Dims<D>::CH, CH_LOG2 = Dims<D>::CH_LOG2;
  constexpr int STAGE_ELEMS = Dims<D>::STAGE_ELEMS;
  const int tid = threadIdx.x, lane = tid & 31, t4 = lane & 3;

  auto load = [&](int stage, int kv0) {
    bf16* Ks = ring + stage * STAGE_ELEMS;
    bf16* Vs = Ks + BKV * LDK;
#pragma unroll
    for (int i = 0; i < BKV * CH / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int key = c >> CH_LOG2, dc = (c & (CH - 1)) * 8, s = kv0 + key;
      const bool in = s < S;
      simlingo::cp_async16(&Ks[key * LDK + dc], in ? kb + s * sks + dc : kb, in);
      simlingo::cp_async16(&Vs[key * LDK + dc], in ? vb + s * svs + dc : vb, in);
    }
  };
  // warps 0 and 1 read the validity of key kv0 + tid as a tile's copies are
  // issued, and publish the tile's bits one tile later (no wait on the read)
  auto valid_byte = [&](int kv0) -> uint32_t {
    const int s = kv0 + tid;
    return (tid < BKV && s < S) ? (valid_b == nullptr ? 1u : valid_b[s]) : 0u;
  };
  auto publish = [&](int stage, uint32_t byte) {
    if (tid < BKV) {
      const uint32_t bits = __ballot_sync(0xffffffffu, byte != 0);
      if (lane == 0) okw[stage][tid >> 5] = bits;
    }
  };

  const int n = it1 - it0;
  static_assert(STAGES == 3, "the validity bits run one tile behind the copies");
  if (n > 0) load(0, it0 * BKV);
  simlingo::cp_async_commit();
  if (n > 1) load(1, (it0 + 1) * BKV);
  simlingo::cp_async_commit();
  const uint32_t first = valid_byte(it0 * BKV);
  uint32_t pending = valid_byte((it0 + 1) * BKV);         // tile i + 1's, in iteration i
  publish(0, first);
  for (int i = 0; i < n; ++i) {
    simlingo::cp_async_wait<STAGES - 2>();   // tile i has landed
    __syncthreads();                         // and every warp is done with tile i - 1's stage
    publish((i + 1) % STAGES, pending);
    if (i + 2 < n) {
      load((i + 2) % STAGES, (it0 + i + 2) * BKV);
      pending = valid_byte((it0 + i + 2) * BKV);
    }
    simlingo::cp_async_commit();
    const int it = it0 + i, kv0 = it * BKV, st = i % STAGES;
    if (it >= w.it_end) continue;
    const bf16* Kt = ring + st * STAGE_ELEMS;
    const bf16* Vt = Kt + BKV * LDK;

    // S = Q K^T for 64 keys: 8 n-tiles of 8 keys, each summing d chunks 0..D/16-1 in order
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15)
        uint32_t b[4];
        simlingo::ldmatrix_x4(b, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK +
                                     ks * 16 + ((lane >> 3) & 1) * 8);
        simlingo::mma_bf16_16816(sc[2 * np], qf[ks], b[0], b[1]);
        simlingo::mma_bf16_16816(sc[2 * np + 1], qf[ks], b[2], b[3]);
      }

    const uint32_t w0 = okw[st][0], w1 = okw[st][1];
    const bool whole = (w0 & w1) == 0xffffffffu && (!causal || kv0 + BKV - 1 <= w.min_slot);
    float mx[2] = {-INFINITY, -INFINITY};
    if (whole) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = __fmul_rn(sc[nt][j], scale_log2);
          sc[nt][j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = nt * 8 + t4 * 2 + (j & 1);
          const uint32_t word = nt < 4 ? w0 : w1;
          const bool ok = ((word >> (key & 31)) & 1u) &&
                          (!causal || kv0 + key <= w.slot[j >> 1]);
          const float x = ok ? __fmul_rn(sc[nt][j], scale_log2) : -INFINITY;
          sc[nt][j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // a row with nothing visible yet keeps m = -inf; exp2(-inf) = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(sc[nt][j] - m_use[j >> 1]);
        sc[nt][j] = p;
        rsum[j >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= alpha[0]; oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1]; oacc[dt][3] *= alpha[1];
    }

    // A row whose weights sum to under L_FEW (one that sees few keys)
    // carries the rounding of P to bf16 -- up to 2^-9 of a weight of up to
    // 1 -- into its output. A row with fewer than 64 visible keys sees only
    // tiles that are not whole; on such a tile, if a row of the warp has
    // weights summing to under L_FEW so far, P V runs on P and on P's
    // remainder, the bf16 of what that rounding dropped. Other tiles keep
    // the one pass below (a row where a few of many keys dominate is not
    // covered, nor one that a key mask leaves few keys: those keep the TPU
    // kernel's one-pass bf16 P).
    bool few = false;
    if (FEW && !whole) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        few |= l > 0.f && l < L_FEW;
      }
      few = __any_sync(0xffffffffu, few);
    }
    if (few) {                           // each accumulator: P, then the remainder, per 16 keys
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4], lo[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float* p = sc[2 * kk + (h >> 1)] + 2 * (h & 1);
          a[h] = simlingo::pack_bf16x2(p[0], p[1]);
          lo[h] = simlingo::pack_bf16x2(p[0] - __uint_as_float(a[h] << 16),
                                        p[1] - __uint_as_float(a[h] & 0xffff0000u));
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          simlingo::ldmatrix_x4_trans(b, Vt + (kk * 16 + (lane & 15)) * LDK + dp * 16 +
                                             (lane >> 4) * 8);
          simlingo::mma_bf16_16816(oacc[2 * dp], a, b[0], b[1]);
          simlingo::mma_bf16_16816(oacc[2 * dp + 1], a, b[2], b[3]);
          simlingo::mma_bf16_16816(oacc[2 * dp], lo, b[0], b[1]);
          simlingo::mma_bf16_16816(oacc[2 * dp + 1], lo, b[2], b[3]);
        }
      }
      continue;
    }
    // O += P V: the S accumulators of n-tiles (2kk, 2kk+1) are exactly the
    // A-fragment of keys [16kk, 16kk+16); each O accumulator sums kk in order
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = simlingo::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = simlingo::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = simlingo::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = simlingo::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];                   // d columns 16dp..16dp+7, then 16dp+8..16dp+15
        simlingo::ldmatrix_x4_trans(b, Vt + (kk * 16 + (lane & 15)) * LDK + dp * 16 +
                                           (lane >> 4) * 8);
        simlingo::mma_bf16_16816(oacc[2 * dp], a, b[0], b[1]);
        simlingo::mma_bf16_16816(oacc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
  simlingo::cp_async_wait<0>();
  __syncthreads();
}

// Q A-fragments of a thread's two rows (zero where a row is not live).
template <int D>
__device__ __forceinline__ void load_q(const bf16* q0, const bf16* q1, bool r0, bool r1,
                                       int t4, uint32_t (&qf)[D / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + t4 * 2;
    qf[ks][0] = r0 ? ld32(q0 + c) : 0u;
    qf[ks][1] = r1 ? ld32(q1 + c) : 0u;
    qf[ks][2] = r0 ? ld32(q0 + c + 8) : 0u;
    qf[ks][3] = r1 ? ld32(q1 + c + 8) : 0u;
  }
}

__device__ __forceinline__ int tiles_to(int keys) { return keys > 0 ? (keys + BKV - 1) / BKV : 0; }

template <int D>
__device__ __forceinline__ void zero_state(float (&oacc)[D / 8][4], float (&m_run)[2],
                                           float (&l_run)[2]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  m_run[0] = m_run[1] = -INFINITY;
  l_run[0] = l_run[1] = 0.f;
}

// ---------------------------------------------------------------------------
// the tiled path
// ---------------------------------------------------------------------------

// grid (row blocks, HQ, B)
template <int D, bool FEW>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int S, int HQ, int HK,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long sks, long long skh,
                 long long svb, long long svs, long long svh,
                 int causal, int q_offset, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t okw[STAGES][2];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = q0 + warp * 16;               // this warp's rows: wrow .. wrow + 15
  const int row0 = wrow + g;                     // this thread's rows: row0, row0 + 8
  const bf16* qb = q + b * sqb + h * sqh;

  uint32_t qf[D / 16][4];
  load_q<D>(qb + row0 * sqt, qb + (row0 + 8) * sqt, row0 < T, row0 + 8 < T, t4, qf);

  // the block walks the tiles its last row sees; a warp whose rows all lie
  // past T computes none
  const int ntiles = tiles_to(causal ? min(S, q_offset + min(q0 + BQ, T)) : S);
  WarpRows w;
  w.slot[0] = q_offset + row0;
  w.slot[1] = q_offset + row0 + 8;
  w.min_slot = q_offset + wrow;
  w.it_end = wrow < T ? ntiles : 0;

  float oacc[D / 8][4], m_run[2], l_run[2];
  zero_state<D>(oacc, m_run, l_run);
  attend<D, FEW>(k + b * skb + hk * skh, v + b * svb + hk * svh,
         kv_valid != nullptr ? kv_valid + (long long)b * S : nullptr,
         sks, svs, S, causal, 0, ntiles, w, qf, scale_log2,
         reinterpret_cast<bf16*>(smem_raw), okw, oacc, m_run, l_run);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;     // no visible key -> 0
    const int row = row0 + r * 8;
    if (row >= T) continue;
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * HQ + h) * T + row] = l > 0.f ? m_run[r] + log2f(l) : -INFINITY;
    bf16* orow = o + (((long long)b * T + row) * HQ + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t4 * 2) =
          simlingo::pack_bf16x2(oacc[dt][2 * r] * inv, oacc[dt][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// the split path
// ---------------------------------------------------------------------------

// grid (splits, row blocks, B * HK), cluster (splits, 1, 1): block x attends
// its packed rows to key tiles [x * tps, (x + 1) * tps).
template <int D, bool FEW>
__global__ void __launch_bounds__(THREADS)
flash_fwd_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       int T, int S, int HQ, int HK,
                       long long sqb, long long sqt, long long sqh,
                       long long skb, long long sks, long long skh,
                       long long svb, long long svs, long long svh,
                       int causal, int q_offset, float scale_log2, int tps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t okw[STAGES][2];
  constexpr int LDO = Dims<D>::LDO;

  const int G = HQ / HK, R = G * T;
  const int split = blockIdx.x, pr0 = blockIdx.y * BQ;
  const int hk = blockIdx.z % HK, b = blockIdx.z / HK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // this thread's packed rows pr0 + warp*16 + g (+8): head hk*G + r / T, t = r % T
  const bf16* qp[2];
  bool live[2];
  WarpRows w;
  int lo_t = 1 << 30, hi_t = -1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = pr0 + warp * 16 + g + r * 8;
    live[r] = pr < R;
    const int t = live[r] ? pr % T : 0, hg = live[r] ? pr / T : 0;
    qp[r] = q + b * sqb + t * sqt + (hk * G + hg) * sqh;
    w.slot[r] = q_offset + t;
    if (live[r]) {
      lo_t = min(lo_t, t);
      hi_t = max(hi_t, t);
    }
  }
  lo_t = __reduce_min_sync(0xffffffffu, lo_t);
  hi_t = __reduce_max_sync(0xffffffffu, hi_t);
  uint32_t qf[D / 16][4];
  load_q<D>(qp[0], qp[1], live[0], live[1], t4, qf);

  const int kv_end = causal ? min(S, q_offset + T) : S;    // the last slot of the group + 1
  const int it0 = split * tps, it1 = min(it0 + tps, tiles_to(kv_end));
  w.min_slot = q_offset + lo_t;
  w.it_end = hi_t >= 0 ? tiles_to(causal ? min(S, q_offset + hi_t + 1) : S) : 0;

  float oacc[D / 8][4], m_run[2], l_run[2];
  zero_state<D>(oacc, m_run, l_run);
  if (it0 < it1)
    attend<D, FEW>(k + b * skb + hk * skh, v + b * svb + hk * svh,
           kv_valid != nullptr ? kv_valid + (long long)b * S : nullptr,
           sks, svs, S, causal, it0, it1, w, qf, scale_log2,
           reinterpret_cast<bf16*>(smem_raw), okw, oacc, m_run, l_run);

  // the partial (m, l, O) of each row, in this block's shared memory
  float* Op = reinterpret_cast<float*>(smem_raw);             // [BQ][LDO]
  float* Pm = Op + BQ * LDO;
  float* Pl = Pm + BQ;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int lr = warp * 16 + g + r * 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(Op + lr * LDO + dt * 8 + t4 * 2) =
          make_float2(oacc[dt][2 * r], oacc[dt][2 * r + 1]);
    if (t4 == 0) {
      Pm[lr] = m_run[r];
      Pl[lr] = l;
    }
  }

  // merge over the cluster, split order 0..n-1; each (row, 8 columns) once
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(BQ, R - pr0);
  for (int i = rank * THREADS + tid; i < rows * (D / 8); i += n * THREADS) {
    const int lr = i / (D / 8), c = (i % (D / 8)) * 8;
    // every split's m and l at once (unrolled: the remote reads overlap)
    float ms[MAX_CLUSTER], ls[MAX_CLUSTER];
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s) {
      ms[s] = s < n ? *cluster.map_shared_rank(Pm + lr, s) : -INFINITY;
      ls[s] = s < n ? *cluster.map_shared_rank(Pl + lr, s) : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s) M = fmaxf(M, ms[s]);
    float L = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (M != -INFINITY)
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s) {
        if (s >= n || ms[s] == -INFINITY) continue;   // nothing visible in split s
        const float wt = exp2f(ms[s] - M);
        L += ls[s] * wt;
        const float4* p =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(Op + lr * LDO + c, s));
        const float4 a = p[0], e = p[1];
        acc[0] += a.x * wt; acc[1] += a.y * wt; acc[2] += a.z * wt; acc[3] += a.w * wt;
        acc[4] += e.x * wt; acc[5] += e.y * wt; acc[6] += e.z * wt; acc[7] += e.w * wt;
      }
    const float inv = L > 0.f ? 1.f / L : 0.f;     // no visible key -> 0
    const int pr = pr0 + lr, t = pr % T, h = hk * G + pr / T;
    *reinterpret_cast<uint4*>(o + (((long long)b * T + t) * HQ + h) * D + c) = make_uint4(
        simlingo::pack_bf16x2(acc[0] * inv, acc[1] * inv),
        simlingo::pack_bf16x2(acc[2] * inv, acc[3] * inv),
        simlingo::pack_bf16x2(acc[4] * inv, acc[5] * inv),
        simlingo::pack_bf16x2(acc[6] * inv, acc[7] * inv));
    if (lse != nullptr && c == 0)
      lse[((long long)b * HQ + h) * T + t] = L > 0.f ? M + log2f(L) : -INFINITY;
  }
  cluster.sync();                  // the partials live until every block has read them
}

// ---------------------------------------------------------------------------
// the fp32 build (training at precision=fp32): the tiled path only
// ---------------------------------------------------------------------------
//
// JAX trains at fp32 through the same Pallas kernels (`trainer.py:248`
// turns precision "fp32" into compute_dtype float32; the kernels keep
// their operands in the input dtype: q pre-scaled by scale * log2(e) and
// rounded to it, :128 / :317; P cast to it before P V, :262), so at fp32
// the logits and P V are fp32 products. Here they are fp32 FMAs (no TF32,
// no bf16 rounding). P has no bf16 remainder to add, so there is no FEW
// build at fp32, and the split path (serving's decode, bf16 only) has no
// fp32 build: the wrapper's plan sends every fp32 call here.
//
// One block of 128 threads per (64-row query tile, query head, batch), as
// the bf16 tiled path. Thread (rg = tid / 8, kg = tid % 8) owns rows 4 rg
// .. 4 rg + 3 of the block (so a warp owns 16 rows) and, of each 64-key
// tile, keys kg + 8 j (j < 8): its 4 x 8 logits are a register tile that
// reads 4 Q rows and 8 K rows, 16 bytes at a time, from shared memory for
// every 4 d (128 FMAs for 12 loads). Rows of D + 4 floats put the 8 lanes of
// a quarter-warp phase on 8 distinct 16-byte bank groups (the K rows kg + 8
// j are D + 4 floats apart; the Q rows are one address a phase). The row's
// max and sum over a tile's 64 keys go through shuffles over the 8 lanes of
// a row group. P goes through shared memory (a row group's rows are read
// only by its own warp: __syncwarp), and O += P V gives each thread its
// rows' columns VW kg + 8 VW u + w (u < NU, w < VW): the 8 lanes read 8
// neighbouring vectors of a V row. K and V tiles stream through a 2-stage
// cp.async ring. A tile's P V goes to a tile-local accumulator (64 keys
// summed from 0) that is then added to the rescaled running O: summing
// 1025 keys into one running accumulator measured twice the error against
// an fp64 reference (a numpy model of this loop at the ViT's 1025 keys:
// 5.8e-6 against 2.7e-6 of rms(O)). Each logit and each O accumulator sums
// in a fixed order (d ascending; keys ascending), so the bits do not change
// from run to run.
//
// What bounds it: fp32 operations, 4 T S D a head, at 67 TFLOP/s without
// tensor cores (the ViT's [12,1025,16,64] forward is 51.6 GFLOP, 0.77 ms);
// the shared-memory reads of the register tiles above come next.
constexpr int F32_STAGES = 2;
constexpr int F32_LDP = BKV + 4;         // P rows in shared memory

template <int D>
struct F32Dims {
  static constexpr int LD = D + 4;                        // fp32 rows of Q, K, V
  static constexpr int VW = D >= 32 ? 4 : 2;              // an O vector's floats
  static constexpr int NU = D / (8 * VW);                 // O vectors a row a thread
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int STAGE_FLOATS = 2 * BKV * LD;       // K [key][d], then V [key][d]
  // Q, the ring, P: 104,448 bytes at D = 64, 186,368 at D = 128
  static constexpr int SMEM_BYTES = (Q_FLOATS + F32_STAGES * STAGE_FLOATS + BQ * F32_LDP) * 4;
  static_assert(8 * VW * NU == D, "the 8 lanes of a row group cover the row");
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
__device__ __forceinline__ void stg_f32(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// grid (row blocks, HQ, B)
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                     float* __restrict__ o, float* __restrict__ lse,
                     int T, int S, int HQ, int HK,
                     long long sqb, long long sqt, long long sqh,
                     long long skb, long long sks, long long skh,
                     long long svb, long long svs, long long svh,
                     int causal, int q_offset, float scale_log2) {
  using Dm = F32Dims<D>;
  constexpr int LD = Dm::LD, VW = Dm::VW, NU = Dm::NU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* ring = Qs + Dm::Q_FLOATS;
  float* Ps = ring + F32_STAGES * Dm::STAGE_FLOATS;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HK);
  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7, r0 = 4 * rg;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + hk * skh;
  const float* vb = v + b * svb + hk * svh;
  const uint8_t* valid_b = kv_valid != nullptr ? kv_valid + (long long)b * S : nullptr;

  // Q scaled by scale * log2(e) in fp32, rows past T as 0
  for (int c = tid; c < BQ * D; c += THREADS) {
    const int r = c / D, d = c % D, t = q0 + r;
    Qs[r * LD + d] = t < T ? qb[t * sqt + d] * scale_log2 : 0.f;
  }
  // the block walks the tiles its last row sees; a warp computes those its
  // own last row sees (none where its rows all lie past T)
  const int ntiles = tiles_to(causal ? min(S, q_offset + min(q0 + BQ, T)) : S);
  const int wrow = q0 + (tid >> 5) * 16;
  const int it_end = wrow < T ? tiles_to(causal ? min(S, q_offset + min(wrow + 16, T)) : S) : 0;

  auto load = [&](int stage, int kv0) {
    float* Ks = ring + stage * Dm::STAGE_FLOATS;
    float* Vs = Ks + BKV * LD;
    for (int c = tid; c < BKV * (D / 4); c += THREADS) {
      const int key = c / (D / 4), dc = (c % (D / 4)) * 4, s = kv0 + key;
      const bool in = s < S;                       // keys past S: zero-filled
      simlingo::cp_async16(&Ks[key * LD + dc], in ? kb + s * sks + dc : kb, in);
      simlingo::cp_async16(&Vs[key * LD + dc], in ? vb + s * svs + dc : vb, in);
    }
  };

  float oacc[4][D / 8], m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) oacc[i][c] = 0.f;
  }
  if (ntiles > 0) load(0, 0);
  simlingo::cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    __syncthreads();                    // every warp is done with tile it - 1's stage
    if (it + 1 < ntiles) load((it + 1) % F32_STAGES, (it + 1) * BKV);
    simlingo::cp_async_commit();
    simlingo::cp_async_wait<1>();       // tile it has landed
    __syncthreads();
    if (it >= it_end) continue;
    const float* Kt = ring + (it % F32_STAGES) * Dm::STAGE_FLOATS;
    const float* Vt = Kt + BKV * LD;
    const int kv0 = it * BKV;

    // the 4 x 8 logits (base 2), each summing d = 0..D-1 in order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[4][4], kv[8][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds_f32<4>(&Qs[(r0 + i) * LD + d], qv[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) lds_f32<4>(&Kt[(kg + 8 * j) * LD + d], kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }
    bool key_ok[8];
    float a_tile[4];                    // each row's rescale of the running O
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kv0 + kg + 8 * j;
      key_ok[j] = key < S && (valid_b == nullptr || valid_b[key] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int slot = q_offset + q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = key_ok[j] && (!causal || kv0 + kg + 8 * j <= slot);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // nothing visible yet
      const float alpha = exp2f(m_run[i] - m_use);
      m_run[i] = m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        rsum += p;
        Ps[(r0 + i) * F32_LDP + kg + 8 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + rsum;
      a_tile[i] = alpha;
    }
    __syncwarp();                       // P of the warp's rows is written

    // O = alpha O + P V, the tile's 64 keys in ascending order from 0
    float tacc[4][D / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) tacc[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds_f32<4>(&Ps[(r0 + i) * F32_LDP + kk], pv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[NU][VW];
#pragma unroll
        for (int u = 0; u < NU; ++u) lds_f32<VW>(&Vt[(kk + e) * LD + VW * kg + 8 * VW * u], vv[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int w = 0; w < VW; ++w)
              tacc[i][u * VW + w] = fmaf(pv[i][e], vv[u][w], tacc[i][u * VW + w]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) oacc[i][c] = fmaf(oacc[i][c], a_tile[i], tacc[i][c]);
    __syncwarp();                       // P is rewritten by the next tile
  }
  simlingo::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + r0 + i;
    if (row >= T) continue;
    if (lse != nullptr && kg == 0)
      lse[((long long)b * HQ + h) * T + row] = l > 0.f ? m_run[i] + log2f(l) : -INFINITY;
    float* orow = o + (((long long)b * T + row) * HQ + h) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float out[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) out[w] = l > 0.f ? oacc[i][u * VW + w] / l : 0.f;
      stg_f32<VW>(orow + VW * kg + 8 * VW * u, out);
    }
  }
}

// The dynamic shared-memory limit is a per-device attribute of a kernel:
// set before its first launch on a device. A cluster size is asked of the
// occupancy calculator once; one that does not fit is refused
// (cudaErrorInvalidConfiguration), with no fallback.
cudaError_t prepare(const void* kernel, int smem_bytes, std::atomic<bool>* ready,
                    const cudaLaunchConfig_t* cfg) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && ready[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  if (cfg != nullptr) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  if (dev < MAX_DEVICES) ready[dev].store(true, std::memory_order_relaxed);
  return cudaSuccess;
}

// The launch's arguments, as the C entry point takes them.
struct Args {
  const bf16 *q, *k, *v;
  const uint8_t* valid;
  bf16* o;
  float* lse;
  int B, T, S, HQ, HK;
  long long sqb, sqt, sqh, skb, sks, skh, svb, svs, svh;
  int causal, q_offset;
  float scale_log2;
};

template <int D>
cudaError_t launch_tiled(const Args& a, bool few, cudaStream_t st) {
  static std::atomic<bool> ready[2][MAX_DEVICES];
  constexpr int smem = Dims<D>::RING_BYTES;
  const auto kernel = few ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kernel), smem, ready[few], nullptr);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((a.T + BQ - 1) / BQ, a.HQ, a.B), THREADS, smem, st>>>(
      a.q, a.k, a.v, a.valid, a.o, a.lse, a.T, a.S, a.HQ, a.HK, a.sqb, a.sqt, a.sqh,
      a.skb, a.sks, a.skh, a.svb, a.svs, a.svh, a.causal, a.q_offset, a.scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_split(const Args& a, int splits, int tps, bool few, cudaStream_t st) {
  static std::atomic<bool> ready[2][MAX_CLUSTER + 1][MAX_DEVICES];
  constexpr int smem = Dims<D>::RING_BYTES;
  // the splits must cover every key tile of S
  if (splits < 1 || splits > MAX_CLUSTER || tps < 1 || splits * tps < (a.S + BKV - 1) / BKV)
    return cudaErrorInvalidValue;
  const int rows = (a.HQ / a.HK) * a.T;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (rows + BQ - 1) / BQ, a.B * a.HK);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto kernel = few ? flash_fwd_split_kernel<D, true> : flash_fwd_split_kernel<D, false>;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kernel), smem, ready[few][splits], &cfg);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kernel, a.q, a.k, a.v, a.valid, a.o, a.lse, a.T, a.S, a.HQ,
                         a.HK, a.sqb, a.sqt, a.sqh, a.skb, a.sks, a.skh, a.svb, a.svs, a.svh,
                         a.causal, a.q_offset, a.scale_log2, tps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  static std::atomic<bool> ready[MAX_DEVICES];
  constexpr int smem = F32Dims<D>::SMEM_BYTES;
  cudaError_t e = prepare(reinterpret_cast<const void*>(flash_fwd_f32_kernel<D>), smem, ready,
                          nullptr);
  if (e != cudaSuccess) return e;
  flash_fwd_f32_kernel<D><<<dim3((a.T + BQ - 1) / BQ, a.HQ, a.B), THREADS, smem, st>>>(
      reinterpret_cast<const float*>(a.q), reinterpret_cast<const float*>(a.k),
      reinterpret_cast<const float*>(a.v), a.valid, reinterpret_cast<float*>(a.o), a.lse,
      a.T, a.S, a.HQ, a.HK, a.sqb, a.sqt, a.sqh, a.skb, a.sks, a.skh, a.svb, a.svs, a.svh,
      a.causal, a.q_offset, a.scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, int splits, int tps, bool few, bool fp32, cudaStream_t st) {
  if (fp32)        // the tiled path alone, no FEW build
    return splits == 0 && !few ? launch_f32<D>(a, st) : cudaErrorInvalidValue;
  return splits == 0 ? launch_tiled<D>(a, few, st) : launch_split<D>(a, splits, tps, few, st);
}

}  // namespace

// The constants the wrapper's plan (_fwd_plan) relies on, for head dim D
// and the operand type (fp32 != 0: the fp32 build): keys a tile, rows a
// block, the largest cluster of splits, and the dynamic shared memory a
// block. Returns 0, or -1 for a D without an instance (the wrapper pads
// those).
extern "C" int simlingo_flash_attn_fwd_geometry(int head_dim, int fp32, int* out) {
  int smem = 0;
  switch (head_dim) {
    case 16: smem = fp32 ? F32Dims<16>::SMEM_BYTES : Dims<16>::RING_BYTES; break;
    case 32: smem = fp32 ? F32Dims<32>::SMEM_BYTES : Dims<32>::RING_BYTES; break;
    case 64: smem = fp32 ? F32Dims<64>::SMEM_BYTES : Dims<64>::RING_BYTES; break;
    case 128: smem = fp32 ? F32Dims<128>::SMEM_BYTES : Dims<128>::RING_BYTES; break;
    default: return -1;
  }
  out[0] = BKV;
  out[1] = BQ;
  out[2] = MAX_CLUSTER;
  out[3] = smem;
  return 0;
}

// splits == 0: the tiled path; else the split path with `splits` blocks of
// `tps` key tiles a (row block, kv head, batch); few != 0: the FEW build;
// fp32 != 0: q, k, v and o are fp32 (the tiled path's fp32 build; splits
// and few must be 0); head_dim: 16, 32, 64 or 128 (else
// cudaErrorInvalidValue).
extern "C" int simlingo_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid, void* o,
    void* lse, int B, int T, int S, int HQ, int HK,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    int causal, int q_offset, float scale, int splits, int tps, int few, int fp32,
    int head_dim, void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid),
               static_cast<bf16*>(o), static_cast<float*>(lse), B, T, S, HQ, HK,
               sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, causal, q_offset,
               scale * 1.4426950408889634f};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: e = launch<16>(a, splits, tps, few != 0, fp32 != 0, st); break;
    case 32: e = launch<32>(a, splits, tps, few != 0, fp32 != 0, st); break;
    case 64: e = launch<64>(a, splits, tps, few != 0, fp32 != 0, st); break;
    case 128: e = launch<128>(a, splits, tps, few != 0, fp32 != 0, st); break;
    default: break;
  }
  return static_cast<int>(e);
}
