// Softmax cross-entropy over the tied LM head for Hopper (sm_90a), with no
// fp32 logits in device memory: forward and backward.
//
// Replaces the Pallas TPU kernels of simlingo_tpu/kernels/fused_ce.py:
// _fwd_kernel (:55, via _run_fwd :118) and _bwd_kernel (:85, via _run_bwd
// :138), reached through fused_ce (:178) when SIMLINGO_CE_IMPL is pallas
// or pallas_dw. h [N, H] bf16 rows against w [V, H] bf16 (the tied
// embedding), int64 labels [N]:
//   forward   ce = logz - gold, logz = logsumexp_v(h w^T), gold = the
//             label's logit (0 for a label outside [0, V));
//   backward  dlogits = bf16((exp(logit - logz) - onehot) g),
//             dh = dlogits w, and with compute_dw dW = dlogits^T h.
//
// What bounds it: operations. At the training shape (N = 960 = 6 x 160
// answer positions, H = 896, V = 151674) the forward is one [N, V, H]
// product, 2 N H V = 0.261 TFLOP (0.264 ms at 989 TFLOP/s); the backward
// recomputes the logits and does a second product for dh (0.528 ms), a
// third for dW (0.79 ms). w is 272 MB and does not fit the 50 MB L2; h
// (1.7 MB) does.
//
// The TPU kernel walks the vocabulary as a sequential grid and keeps the
// running max, sum, gold and dh resident across it. Blocks on the H100
// run in parallel in no order, so the sums across vocabulary tiles are
// second passes over per-block partials, in a fixed order (no atomics:
// results do not change from run to run).
//
// The logits tile, logits_tile: one block of 8 warps computes a 128 rows x
// 128 vocabulary columns tile of h w^T over K = H, both operands streamed
// through a 3-stage cp.async ring of 64-wide k-steps, fragments by
// ldmatrix.x4 (mma.sync m16n8k16, fp32 accumulate), 2 blocks an SM. Blocks
// run with the row tile (blockIdx.x) fastest, so the N/128 blocks that
// read one w tile run together and w comes from device memory about once.
//   forward   ce_fwd_tile_kernel: the epilogue writes the tile's row max
//             m_s and sum l_s (partials [V/128, N], 9 MB at the training
//             shape), and the one block that holds a row's label writes
//             its gold. ce_fwd_finalize_kernel:
//             logz = M + log sum_s l_s exp(m_s - M).
//   backward  a scratch and two tiled products. JAX rounds dlogits to w's
//             dtype before both of its products (:107, :114), so a bf16
//             dlogits written once keeps every rounding point:
//   1. ce_dlogits_kernel: the logits tile again, and its epilogue writes
//      dlogits = bf16((exp(s - logz) - onehot) g) to the scratch
//      dl [N, Vpad], Vpad = 128 ceil(V / 128), 0 in the columns past V.
//      Row-major, because both readers want rows of it: the dh product
//      reads 64-column steps of 128 rows (128 contiguous bytes a row, whole
//      cache lines) and the dW product 64-row steps of 128 columns. The
//      tile is staged in shared memory and stored 16 bytes a lane.
//   2. ce_dh_kernel: dh partials = dl w over the vocabulary cut into S
//      segments of whole 128-column steps; one block of 8 warps per (128 x
//      128 tile of [N, H], segment), the segment the grid's slowest axis,
//      so the tiles that share a segment's scratch and w rows run together
//      and find them in L2. A 3-stage cp.async ring of 64-wide k-steps; A
//      (dl) by ldmatrix.x4, B (w rows, [k][n]) by ldmatrix.x4.trans. fp32
//      partials [S, N, H]; ce_dh_reduce_kernel sums s = 0..S-1 in order and
//      rounds once. The wrapper's plan (_bwd_plan) takes the S whose blocks
//      fill their last wave of G_RESIDENT blocks an SM best (a segment's
//      tiles fit one wave): 14 at the training shape, 2.97 waves, measured
//      faster than one wave of 4 segments that leaves 40 SMs half busy.
//   3. ce_dw_kernel (compute_dw): dW = dl^T h, one block per (128
//      vocabulary rows, 128 columns of H) over K = N: it owns its dW tile
//      outright, as on the TPU -- no reduction. The same loop, A (dl,
//      stored [k][m]) by ldmatrix.x4.trans; the fp32 sums are rounded to
//      bf16, staged in shared memory and stored 16 bytes a lane.
//   The scratch costs its bytes: written and read once, 2 x 2 N Vpad (582
//   MB at the training shape, 0.174 ms at 3.35 TB/s), below the operations
//   bound. In practice every loop here runs near the mma.sync issue rate
//   (200-300 TFLOP/s); wider tiles that cut L2 traffic by a quarter (128 x
//   256 logits, 256 x 128 dh) measured no faster (PERF.md).
// Rows of w past V and of h past N are zero-filled by cp.async, never read
// (JAX zeroes w's pad rows: 0 * NaN would poison dh); columns past V are
// -inf in the max and the sum and 0 in dlogits. A tile whose columns are
// all past V keeps m = -inf, and the merge skips it (no exp(-inf + inf)).
//
// The fp32 build (precision=fp32: fp32 h and w). JAX's kernels work in their
// operands' dtype, so at fp32 the logits and both products are fp32 and
// dlogits is rounded to w's dtype, fp32: nothing is rounded below fp32.
// The same passes and grids as bf16's, each on the fp32 tile product of
// f32_tile.cuh (fp32 FMA, no tensor cores): ce_fwd_tile_f32_kernel writes
// the same (max, sum) partials, which ce_fwd_finalize_kernel merges as it
// does bf16's; ce_dlogits_f32_kernel writes an fp32 scratch dl [N, Vpad]
// (582.5 MB at the training shape), ce_dh_f32_kernel the fp32 segment
// partials of the wrapper's plan, f32_reduce_kernel sums them in order
// into an fp32 dh, ce_dw_f32_kernel dW = dl^T h. Any H: the loads are
// 4 bytes a thread. What bounds it: fp32 operations, 2 N H V a product
// (3.90 ms at 67 TFLOP/s at the training shape).

#include <atomic>

#include "common.cuh"
#include "f32_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_DEVICES = 16;

// ---------------------------------------------------------------------------
// the logits tile h w^T, shared by the forward and the dlogits pass
// ---------------------------------------------------------------------------

constexpr int FBM = 128, FBN = 128;  // logits tile: h rows x vocabulary columns
constexpr int FBK = 64;               // k-step
constexpr int F_STAGES = 3;           // depth of the cp.async ring
constexpr int FLD = FBK + 8;          // 144-byte rows: every ldmatrix phase hits 32 banks
constexpr int F_STAGE = (FBM + FBN) * FLD;           // bf16: A [FBM][FLD], B [FBN][FLD]
constexpr int F_SMEM = F_STAGES * F_STAGE * 2;       // 110592 bytes: 2 blocks an SM

// acc[mt][nt][e] += the logits of row m0 + wm * 32 + mt * 16 + g + 8 (e >> 1)
// and column v0 + wn * 64 + nt * 8 + 2 t4 + (e & 1), wm = warp & 3,
// wn = warp >> 2 (mma.m16n8k16 accumulator layout, g = lane / 4, t4 = lane
// % 4). h and w rows stream through a ring of 64-wide k-steps (zero past
// H, N and V); A-fragments by ldmatrix.x4 from the h tile, B-fragments by
// ldmatrix.x4 from the w tile ([n][k]: two n8 tiles a load). Each
// accumulator takes its 16-wide k-chunks in increasing order, whatever the
// k-step and ring depth, so the logits' bits do not depend on them. Ends
// behind a barrier with no copy in flight: `smem` is free for an epilogue.
__device__ __forceinline__ void logits_tile(const bf16* __restrict__ h,
                                            const bf16* __restrict__ w, int m0, int v0,
                                            int N, int H, int V, bf16* smem,
                                            float (&acc)[2][8][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;     // warp tile: 32 rows x 64 columns

  auto load = [&](int stage, int k) {
    bf16* As = smem + stage * F_STAGE;
    bf16* Bs = As + FBM * FLD;
#pragma unroll
    for (int i = 0; i < (FBM + FBN) * (FBK / 8) / 256; ++i) {
      const int c = tid + i * 256;
      const int r = c >> 3, kc = (c & 7) * 8;
      const bool kin = k + kc < H;                     // H % 32 == 0: whole chunks
      if (r < FBM) {
        const int m = m0 + r;
        const bool in = m < N && kin;
        simlingo::cp_async16(As + r * FLD + kc,
                             in ? h + static_cast<long long>(m) * H + k + kc : h, in);
      } else {
        const int v = v0 + r - FBM;
        const bool in = v < V && kin;
        simlingo::cp_async16(Bs + (r - FBM) * FLD + kc,
                             in ? w + static_cast<long long>(v) * H + k + kc : w, in);
      }
    }
  };

  const int steps = (H + FBK - 1) / FBK;
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < steps) load(s, s * FBK);
    simlingo::cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    simlingo::cp_async_wait<F_STAGES - 2>();         // step t has landed
    __syncthreads();                 // and every warp is done with step t - 1's stage
    if (t + F_STAGES - 1 < steps) load((t + F_STAGES - 1) % F_STAGES, (t + F_STAGES - 1) * FBK);
    simlingo::cp_async_commit();
    const bf16* As = smem + (t % F_STAGES) * F_STAGE;
    const bf16* Bs = As + FBM * FLD;
#pragma unroll
    for (int kk = 0; kk < FBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        simlingo::ldmatrix_x4(a[mt], As + (wm * 32 + mt * 16 + (lane & 15)) * FLD + kk * 16 +
                                         (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        uint32_t b[4];
        simlingo::ldmatrix_x4(b, Bs + (wn * 64 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * FLD +
                                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          simlingo::mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          simlingo::mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  simlingo::cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256, 2)
ce_fwd_tile_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                   const long long* __restrict__ labels, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ gold,
                   int N, int H, int V) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float red_m[2][FBM], red_l[2][FBM];
  const int m0 = blockIdx.x * FBM, v0 = blockIdx.y * FBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  float acc[2][8][4] = {};
  logits_tile(h, w, m0, v0, N, H, V, smem, acc);

  // epilogue: this warp's 64 columns of each of its rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int local = wm * 32 + mt * 16 + g + 8 * r, row = m0 + local;
      const long long lab = row < N ? labels[row] : -1;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + wn * 64 + nt * 8 + t4 * 2 + e;
          const float x = acc[mt][nt][2 * r + e];
          if (col < V) mx = fmaxf(mx, x);
          if (col == lab) gold[row] = x;             // one thread in the grid
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + wn * 64 + nt * 8 + t4 * 2 + e;
          if (col < V) s += expf(acc[mt][nt][2 * r + e] - mx);
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t4 == 0) {
        red_m[wn][local] = mx;
        red_l[wn][local] = s;
      }
    }
  __syncthreads();
  if (tid < FBM && m0 + tid < N) {
    const float ma = red_m[0][tid], mb = red_m[1][tid];
    const float M = fmaxf(ma, mb);
    float L = 0.f;
    if (ma != -INFINITY) L += red_l[0][tid] * expf(ma - M);
    if (mb != -INFINITY) L += red_l[1][tid] * expf(mb - M);
    const long long at = static_cast<long long>(blockIdx.y) * N + m0 + tid;
    part_m[at] = M;
    part_l[at] = L;
  }
}

__device__ __forceinline__ void merge(float& M, float& L, float m, float l) {
  if (m == -INFINITY) return;                  // an all-masked tile
  if (m > M) {
    L = L * expf(M - m) + l;                   // M = -inf: L is 0, exp gives 0
    M = m;
  } else {
    L += l * expf(m - M);
  }
}

// 32 rows x 8 slices of the vocabulary tiles per block; slices merged in order.
__global__ void __launch_bounds__(256)
ce_fwd_finalize_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                       const float* __restrict__ gold, const long long* __restrict__ labels,
                       float* __restrict__ logz, float* __restrict__ ce,
                       int N, int V, int nvt) {
  __shared__ float sm[8][32], sl[8][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int row = blockIdx.x * 32 + lane;
  float M = -INFINITY, L = 0.f;
  if (row < N)
    for (int j = slice; j < nvt; j += 8)
      merge(M, L, part_m[static_cast<long long>(j) * N + row],
            part_l[static_cast<long long>(j) * N + row]);
  sm[slice][lane] = M;
  sl[slice][lane] = L;
  __syncthreads();
  if (slice == 0 && row < N) {
#pragma unroll
    for (int i = 1; i < 8; ++i) merge(M, L, sm[i][lane], sl[i][lane]);
    const float lz = M + logf(L);
    const long long lab = labels[row];
    logz[row] = lz;
    ce[row] = lz - ((lab >= 0 && lab < V) ? gold[row] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// backward, 1: the dlogits scratch
// ---------------------------------------------------------------------------

constexpr int DLD = FBN + 8;          // staged dlogits rows: 272 bytes, conflict-free
static_assert(FBM * DLD <= F_STAGES * F_STAGE, "the staged tile fits the ring");

// dl[row, v0 .. v0 + 127] for the block's 128 rows (rows past N are not
// stored; columns past V are stored as 0).
__global__ void __launch_bounds__(256, 2)
ce_dlogits_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                  const long long* __restrict__ labels, const float* __restrict__ logz,
                  const float* __restrict__ gco, bf16* __restrict__ dl,
                  int N, int H, int V, int vpad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * FBM, v0 = blockIdx.y * FBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  float acc[2][8][4] = {};
  logits_tile(h, w, m0, v0, N, H, V, smem, acc);

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int local = wm * 32 + mt * 16 + g + 8 * r, row = m0 + local;
      const bool in = row < N;
      const float lz = in ? logz[row] : 0.f, gg = in ? gco[row] : 0.f;
      const long long lab = in ? labels[row] : -1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = wn * 64 + nt * 8 + t4 * 2, v = v0 + col;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(acc[mt][nt][2 * r + e] - lz);
          d[e] = (in && v + e < V) ? (p - (v + e == lab ? 1.f : 0.f)) * gg : 0.f;
        }
        *reinterpret_cast<uint32_t*>(smem + local * DLD + col) = simlingo::pack_bf16x2(d[0], d[1]);
      }
    }
  __syncthreads();
  for (int c = tid; c < FBM * (FBN / 8); c += 256) {
    const int r = c >> 4, cc = (c & 15) * 8;
    if (m0 + r < N)
      *reinterpret_cast<uint4*>(dl + static_cast<long long>(m0 + r) * vpad + v0 + cc) =
          *reinterpret_cast<const uint4*>(smem + r * DLD + cc);
  }
}

// ---------------------------------------------------------------------------
// backward, 2 and 3: the tiled products dh = dl w and dW = dl^T h
// ---------------------------------------------------------------------------

constexpr int VSTEP = 128;           // vocabulary columns a dlogits tile, a segment step
constexpr int GM = 128, GN = 128;    // product tile
constexpr int GK = 64;               // k-step
constexpr int G_STAGES = 3;          // depth of the cp.async ring
constexpr int G_THREADS = 256;       // 8 warps, 2 (m) x 4 (n), each 64 x 32
constexpr int G_RESIDENT = 2;        // blocks an SM: <= 128 registers a thread
// Shared memory, stage by stage: the A tile ([m][k], 144-byte rows, or
// [k][m], 272-byte rows) and the B tile ([k][n], 272-byte rows): every
// ldmatrix phase of 8 rows x 16 bytes hits 32 distinct banks.
constexpr int G_LDA = GK + 8, G_LDAT = GM + 8, G_LDB = GN + 8;
constexpr int G_A = GM * G_LDA > GK * G_LDAT ? GM * G_LDA : GK * G_LDAT;
constexpr int G_B = GK * G_LDB;
constexpr int G_SMEM = G_STAGES * (G_A + G_B) * 2;              // 107520 bytes
constexpr int G_LDO = GN + 8;        // the dW tile staged for its stores
static_assert(GM * G_LDO * 2 <= G_SMEM, "the dW tile fits the ring");
static_assert(VSTEP % GK == 0, "segments are whole k-steps");

// acc[i][j][e] += sum over k in [k0, k0 + steps GK) of A(m, k) B(k, n),
// m = m0 + wm + 16 i + g + 8 (e >> 1), n = n0 + wn + 8 j + 2 t4 + (e & 1),
// wm = (warp >> 2) 64, wn = (warp & 3) 32. B(k, n) = B[k ldb + n], zero for
// k >= b_klim or n >= b_nlim. A(m, k) = A[m lda + k], zero for m >= a_lim
// (AT false: dh, A = dl); or A[k lda + m], zero for k >= a_lim (AT true: dW,
// A = dl^T). Ends behind a barrier with no copy in flight: `smem` is free.
template <bool AT>
__device__ __forceinline__ void product_tile(const bf16* __restrict__ A, long long lda,
                                             int a_lim, const bf16* __restrict__ B, int ldb,
                                             int b_klim, int b_nlim, int m0, int n0, int k0,
                                             int steps, bf16* smem, float (&acc)[4][4][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  auto load = [&](int stage, int step) {
    const int k = k0 + step * GK;
    bf16* As = smem + stage * (G_A + G_B);
    bf16* Bs = As + G_A;
#pragma unroll
    for (int i = 0; i < GM * GK / (8 * G_THREADS); ++i) {
      const int c = tid + i * G_THREADS;
      if constexpr (!AT) {
        const int r = c >> 3, kc = (c & 7) * 8;
        const bool ok = m0 + r < a_lim;
        simlingo::cp_async16(As + r * G_LDA + kc,
                             ok ? A + (m0 + r) * lda + k + kc : A, ok);
      } else {
        const int r = c >> 4, mc = (c & 15) * 8;
        const bool ok = k + r < a_lim;
        simlingo::cp_async16(As + r * G_LDAT + mc,
                             ok ? A + (k + r) * lda + m0 + mc : A, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < GK * GN / (8 * G_THREADS); ++i) {
      const int c = tid + i * G_THREADS;
      const int r = c >> 4, nc = (c & 15) * 8;
      const bool ok = k + r < b_klim && n0 + nc < b_nlim;
      simlingo::cp_async16(Bs + r * G_LDB + nc,
                           ok ? B + static_cast<long long>(k + r) * ldb + n0 + nc : B, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    simlingo::cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    simlingo::cp_async_wait<G_STAGES - 2>();         // step t has landed
    __syncthreads();                 // and every warp is done with step t - 1's stage
    if (t + G_STAGES - 1 < steps) load((t + G_STAGES - 1) % G_STAGES, t + G_STAGES - 1);
    simlingo::cp_async_commit();
    const bf16* As = smem + (t % G_STAGES) * (G_A + G_B);
    const bf16* Bs = As + G_A;
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (!AT)
          simlingo::ldmatrix_x4(a[i], As + (wm + i * 16 + (lane & 15)) * G_LDA + kk * 16 +
                                          (lane >> 4) * 8);
        else      // [k][m]: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), ...
          simlingo::ldmatrix_x4_trans(
              a[i], As + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * G_LDAT + wm + i * 16 +
                        ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        simlingo::ldmatrix_x4_trans(b, Bs + (kk * 16 + (lane & 15)) * G_LDB + wn + j * 16 +
                                           (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          simlingo::mma_bf16_16816(acc[i][2 * j], a[i], b[0], b[1]);
          simlingo::mma_bf16_16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  simlingo::cp_async_wait<0>();
  __syncthreads();
}

// fp32 partial part[s] of the 128 x 128 tile (blockIdx.y, blockIdx.x) of dh
// over segment s = blockIdx.z: vocabulary columns [s seg, (s + 1) seg) of
// dl, seg = seg_steps VSTEP.
__global__ void __launch_bounds__(G_THREADS, G_RESIDENT)
ce_dh_kernel(const bf16* __restrict__ dl, const bf16* __restrict__ w,
             float* __restrict__ part, int N, int H, int V, int vpad, int seg_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM, s = blockIdx.z;
  const int k0 = s * seg_steps * VSTEP;
  const int steps = (min(vpad, k0 + seg_steps * VSTEP) - k0) / GK;
  float acc[4][4][4] = {};
  product_tile<false>(dl, vpad, N, w, H, V, H, m0, n0, k0, steps, smem, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + (lane >> 2) + 8 * half;
        const int col = n0 + wn + j * 8 + (lane & 3) * 2;
        if (row < N && col < H)
          *reinterpret_cast<float2*>(part + (static_cast<long long>(s) * N + row) * H + col) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
}

// dh = sum over s of part[s], in order; 4 elements a thread.
__global__ void __launch_bounds__(256)
ce_dh_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dh,
                    long long count, int S) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < count / 4; i += stride) {
    float4 a = reinterpret_cast<const float4*>(part)[i];
    for (int s = 1; s < S; ++s) {
      const float4 b = reinterpret_cast<const float4*>(part + s * count)[i];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    uint2 o;
    o.x = simlingo::pack_bf16x2(a.x, a.y);
    o.y = simlingo::pack_bf16x2(a.z, a.w);
    reinterpret_cast<uint2*>(dh)[i] = o;
  }
}

// dW rows [m0, m0 + 128) (vocabulary), columns [n0, n0 + 128) of H, over
// all N rows of dl and h; rounded to bf16.
__global__ void __launch_bounds__(G_THREADS, G_RESIDENT)
ce_dw_kernel(const bf16* __restrict__ dl, const bf16* __restrict__ h, bf16* __restrict__ dw,
             int N, int H, int V, int vpad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  float acc[4][4][4] = {};
  product_tile<true>(dl, vpad, N, h, H, N, H, m0, n0, 0, (N + GK - 1) / GK, smem, acc);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + i * 16 + (lane >> 2) + 8 * half, c = wn + j * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(smem + r * G_LDO + c) =
            simlingo::pack_bf16x2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
  __syncthreads();
  for (int c = tid; c < GM * (GN / 8); c += G_THREADS) {
    const int r = c >> 4, cc = (c & 15) * 8;
    if (m0 + r < V && n0 + cc < H)                     // H % 8 == 0: whole chunks
      *reinterpret_cast<uint4*>(dw + static_cast<long long>(m0 + r) * H + n0 + cc) =
          *reinterpret_cast<const uint4*>(smem + r * G_LDO + cc);
  }
}

// ---------------------------------------------------------------------------
// the fp32 build
// ---------------------------------------------------------------------------

using simlingo::f32::row_of;
static_assert(simlingo::f32::BM == FBM && simlingo::f32::BN == FBN && GM == FBM && GN == FBN,
              "the fp32 build's tiles are the bf16 grids' tiles");

// The logits tile h w^T of rows [m0, m0 + 128) and columns [v0, v0 + 128),
// fp32 (f32_tile.cuh: acc[i][j] is row m0 + row_of(i, ty), column v0 +
// row_of(j, tx)).
__device__ __forceinline__ void logits_tile_f32(const float* __restrict__ h,
                                                const float* __restrict__ w, int m0, int v0,
                                                int N, int H, int V, float (&acc)[8][8]) {
  simlingo::f32::tile<true, true>(simlingo::f32::F32{h, H}, N, simlingo::f32::F32{w, H}, V,
                                  m0, v0, 0, H, acc);
}

// The forward's partials, as ce_fwd_tile_kernel's: each row's max m_s and
// sum l_s = sum exp(logit - m_s) over the tile's columns below V (the 16
// lanes of a row group reduce by shuffles in a fixed order), and the gold
// logit from the one thread that holds the label's column.
__global__ void __launch_bounds__(simlingo::f32::THREADS, 2)
ce_fwd_tile_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                       const long long* __restrict__ labels, float* __restrict__ part_m,
                       float* __restrict__ part_l, float* __restrict__ gold,
                       int N, int H, int V) {
  const int m0 = blockIdx.x * FBM, v0 = blockIdx.y * FBN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][8];
  logits_tile_f32(h, w, m0, v0, N, H, V, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(i, ty);
    const long long lab = row < N ? labels[row] : -1;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v0 + row_of(j, tx);
      if (col < V) mx = fmaxf(mx, acc[i][j]);
      if (col == lab) gold[row] = acc[i][j];          // one thread in the grid
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v0 + row_of(j, tx) < V) l += expf(acc[i][j] - mx);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (tx == 0 && row < N) {
      const long long at = static_cast<long long>(blockIdx.y) * N + row;
      part_m[at] = mx;
      part_l[at] = l;
    }
  }
}

// dl[row, v0 .. v0 + 127] = (exp(logit - logz) - onehot) g in fp32 for the
// block's rows below N, 0 in the columns past V; 16 bytes a store.
__global__ void __launch_bounds__(simlingo::f32::THREADS, 2)
ce_dlogits_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                      const long long* __restrict__ labels, const float* __restrict__ logz,
                      const float* __restrict__ gco, float* __restrict__ dl,
                      int N, int H, int V, int vpad) {
  const int m0 = blockIdx.x * FBM, v0 = blockIdx.y * FBN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][8];
  logits_tile_f32(h, w, m0, v0, N, H, V, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(i, ty);
    if (row >= N) continue;
    const float lz = logz[row], gg = gco[row];
    const long long lab = labels[row];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int v = v0 + half * 64 + 4 * tx;
      float d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(acc[i][4 * half + c] - lz);
        d[c] = v + c < V ? (p - (v + c == lab ? 1.f : 0.f)) * gg : 0.f;
      }
      *reinterpret_cast<float4*>(dl + static_cast<long long>(row) * vpad + v) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
  }
}

// fp32 partial part[s] of the 128 x 128 tile (blockIdx.y, blockIdx.x) of dh
// over segment s = blockIdx.z (as ce_dh_kernel's); the columns of dl past V
// are 0 and w has no rows there, so the segment stops at V.
__global__ void __launch_bounds__(simlingo::f32::THREADS, 2)
ce_dh_f32_kernel(const float* __restrict__ dl, const float* __restrict__ w,
                 float* __restrict__ part, int N, int H, int V, int vpad, int seg_steps) {
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM, s = blockIdx.z;
  const int k0 = s * seg_steps * VSTEP;
  const int k1 = min(min(vpad, k0 + seg_steps * VSTEP), V);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][8];
  simlingo::f32::tile<true, false>(simlingo::f32::F32{dl, vpad}, N, simlingo::f32::F32{w, H}, H,
                                   m0, n0, k0, k1, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(i, ty);
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + row_of(j, tx);
      if (col < H) part[(static_cast<long long>(s) * N + row) * H + col] = acc[i][j];
    }
  }
}

// dW rows [m0, m0 + 128) (vocabulary), columns [n0, n0 + 128) of H, over
// all N rows of dl and h, fp32.
__global__ void __launch_bounds__(simlingo::f32::THREADS, 2)
ce_dw_f32_kernel(const float* __restrict__ dl, const float* __restrict__ h,
                 float* __restrict__ dw, int N, int H, int V, int vpad) {
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][8];
  simlingo::f32::tile<false, false>(simlingo::f32::F32{dl, vpad}, V, simlingo::f32::F32{h, H}, H,
                                    m0, n0, 0, N, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(i, ty);
    if (row >= V) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + row_of(j, tx);
      if (col < H) dw[static_cast<long long>(row) * H + col] = acc[i][j];
    }
  }
}

// The dynamic shared-memory limit above 48 KB is a per-device attribute of
// a kernel: raised at its first launch on each device.
cudaError_t raise_smem(const void* kernel, int bytes, std::atomic<bool>* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && raised[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) raised[dev].store(true, std::memory_order_relaxed);
  return e;
}

}  // namespace

// ce [N] and logz [N] fp32. Scratch: part_m, part_l [ceil(V/128), N] fp32,
// gold [N] fp32. bf16 h and w (H % 32 == 0), or with fp32 set fp32 h and w.
extern "C" int simlingo_fused_ce_fwd(const void* h, const void* w, const void* labels,
                                     void* part_m, void* part_l, void* gold, void* logz,
                                     void* ce, int N, int H, int V, int fp32, void* stream) {
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nvt = (V + FBN - 1) / FBN;
  const dim3 grid((N + FBM - 1) / FBM, nvt);
  if (fp32) {
    ce_fwd_tile_f32_kernel<<<grid, simlingo::f32::THREADS, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(w),
        static_cast<const long long*>(labels), static_cast<float*>(part_m),
        static_cast<float*>(part_l), static_cast<float*>(gold), N, H, V);
  } else {
    cudaError_t e = raise_smem(reinterpret_cast<const void*>(ce_fwd_tile_kernel), F_SMEM, raised);
    if (e != cudaSuccess) return static_cast<int>(e);
    ce_fwd_tile_kernel<<<grid, 256, F_SMEM, st>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w),
        static_cast<const long long*>(labels), static_cast<float*>(part_m),
        static_cast<float*>(part_l), static_cast<float*>(gold), N, H, V);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_fwd_finalize_kernel<<<(N + 31) / 32, 256, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(gold), static_cast<const long long*>(labels),
      static_cast<float*>(logz), static_cast<float*>(ce), N, V, nvt);
  return static_cast<int>(cudaGetLastError());
}

// The backward's geometry, which the wrapper's plan is made for: vocabulary
// columns a dlogits tile and a segment step, the product tile's rows and
// columns, its blocks an SM.
extern "C" void simlingo_fused_ce_bwd_geometry(int* out) {
  out[0] = VSTEP;
  out[1] = GM;
  out[2] = GN;
  out[3] = G_RESIDENT;
}

// The fp32 build's backward: the bf16 one's passes on fp32 h, w, dl, dh, dw.
static int fused_ce_bwd_f32(const float* h, const float* w, const long long* labels,
                            const float* logz, const float* g, float* dl, float* part, float* dh,
                            float* dw, int N, int H, int V, int vpad, int S, int seg_steps,
                            cudaStream_t st) {
  const int T = simlingo::f32::THREADS;
  ce_dlogits_f32_kernel<<<dim3((N + FBM - 1) / FBM, vpad / FBN), T, 0, st>>>(
      h, w, labels, logz, g, dl, N, H, V, vpad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_dh_f32_kernel<<<dim3((H + GN - 1) / GN, (N + GM - 1) / GM, S), T, 0, st>>>(
      dl, w, part, N, H, V, vpad, seg_steps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long count = static_cast<long long>(N) * H;
  long long blocks = (count + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  simlingo::f32::f32_reduce_kernel<float><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      part, nullptr, dh, count, H, S);
  e = cudaGetLastError();
  if (e != cudaSuccess || dw == nullptr) return static_cast<int>(e);
  ce_dw_f32_kernel<<<dim3((H + GN - 1) / GN, vpad / GM), T, 0, st>>>(dl, h, dw, N, H, V, vpad);
  return static_cast<int>(cudaGetLastError());
}

// dh [N, H]; dw [V, H] or null (no dW). Scratch: dl [N, Vpad], Vpad = 128
// ceil(V / 128); part [S, N, H] fp32, S segments of seg_steps 128-column
// steps each (the wrapper's plan: none empty). bf16 h, w, dl, dh and dw
// (H % 32 == 0, 16-byte aligned rows), or with fp32 set all fp32.
extern "C" int simlingo_fused_ce_bwd(const void* h, const void* w, const void* labels,
                                     const void* logz, const void* g, void* dl, void* part,
                                     void* dh, void* dw, int N, int H, int V, int S,
                                     int seg_steps, int fp32, void* stream) {
  static std::atomic<bool> dl_raised[MAX_DEVICES], dh_raised[MAX_DEVICES],
      dw_raised[MAX_DEVICES];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((!fp32 && H % 32 != 0) || S < 1 || seg_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpad = (V + VSTEP - 1) / VSTEP * VSTEP;
  if (fp32)
    return fused_ce_bwd_f32(static_cast<const float*>(h), static_cast<const float*>(w),
                            static_cast<const long long*>(labels),
                            static_cast<const float*>(logz), static_cast<const float*>(g),
                            static_cast<float*>(dl), static_cast<float*>(part),
                            static_cast<float*>(dh), static_cast<float*>(dw), N, H, V, vpad, S,
                            seg_steps, st);
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* dlp = static_cast<bf16*>(dl);
  cudaError_t e = raise_smem(reinterpret_cast<const void*>(ce_dlogits_kernel), F_SMEM, dl_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_dlogits_kernel<<<dim3((N + FBM - 1) / FBM, vpad / FBN), 256, F_SMEM, st>>>(
      hp, wp, static_cast<const long long*>(labels), static_cast<const float*>(logz),
      static_cast<const float*>(g), dlp, N, H, V, vpad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = raise_smem(reinterpret_cast<const void*>(ce_dh_kernel), G_SMEM, dh_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_dh_kernel<<<dim3((H + GN - 1) / GN, (N + GM - 1) / GM, S), G_THREADS, G_SMEM, st>>>(
      dlp, wp, static_cast<float*>(part), N, H, V, vpad, seg_steps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long count = static_cast<long long>(N) * H;
  long long blocks = (count / 4 + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  ce_dh_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dh), count, S);
  e = cudaGetLastError();
  if (e != cudaSuccess || dw == nullptr) return static_cast<int>(e);
  e = raise_smem(reinterpret_cast<const void*>(ce_dw_kernel), G_SMEM, dw_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_dw_kernel<<<dim3((H + GN - 1) / GN, vpad / GM), G_THREADS, G_SMEM, st>>>(
      dlp, hp, static_cast<bf16*>(dw), N, H, V, vpad);
  return static_cast<int>(cudaGetLastError());
}
