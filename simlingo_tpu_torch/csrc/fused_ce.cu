// Softmax cross-entropy over the tied LM head for Hopper (sm_90a), with no
// logits in device memory: forward and backward.
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
// results do not change from run to run):
//   forward   ce_fwd_tile_kernel: one block per (128 rows, 128 vocab
//             columns) tile, a plain K loop over H with both operands
//             double-buffered by cp.async (mma.sync m16n8k16, fp32
//             accumulate); the epilogue writes the tile's row max m_s and
//             sum l_s (partials [V/128, N], 9 MB at the training shape),
//             and the one block that holds a row's label writes its gold.
//             blockIdx.x (the row tile) runs fastest, so the N/128 blocks
//             that read one w tile run together and w comes from device
//             memory about once. ce_fwd_finalize_kernel:
//             logz = M + log sum_s l_s exp(m_s - M).
//   backward  ce_bwd_kernel<DW = false>: one block per (32 rows of h,
//             vocabulary segment). The rows stay in shared memory, the
//             segment's w tiles of 32 stream through a cp.async double
//             buffer, and per tile the block recomputes the logits, forms
//             dlogits in shared memory (bf16) and adds dlogits w_tile to
//             a [32, H] fp32 accumulator held in registers. The segments
//             are few (about #SM / (N / 32): 4 at the training shape), so
//             the partials [S, N, H] fp32 stay small (14 MB) and all
//             blocks run in one wave; blocks of one segment run together,
//             so w is read from device memory about once.
//             ce_dh_reduce_kernel sums the S partials in order.
//             ce_bwd_kernel<DW = true>: the same kernel with the roles
//             swapped -- one block per 32 vocabulary rows, h streaming --
//             owns its dW rows outright, as on the TPU: no reduction.
// Rows of w past V and of h past N are zero-filled, never read (JAX zeroes
// w's pad rows: 0 * NaN would poison dh); columns past V are -inf in the
// max and the sum and 0 in dlogits. A tile whose columns are all past V
// keeps m = -inf, and the merge skips it (no exp(-inf + inf)).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using simlingo::ld32;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 32;
constexpr int FLD = FBK + 8;          // padded rows: conflict-free fragment loads

__global__ void __launch_bounds__(256)
ce_fwd_tile_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                   const long long* __restrict__ labels, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ gold,
                   int N, int H, int V) {
  __shared__ __align__(16) bf16 As[2][FBM * FLD];
  __shared__ __align__(16) bf16 Bs[2][FBN * FLD];
  __shared__ float red_m[2][FBM], red_l[2][FBM];
  const int m0 = blockIdx.x * FBM, v0 = blockIdx.y * FBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;     // warp tile: 32 rows x 64 columns

  auto load = [&](int st, int k0) {
    for (int c = tid; c < (FBM + FBN) * (FBK / 8); c += 256) {
      const int r = c >> 2, kc = (c & 3) * 8;
      if (r < FBM) {
        const int m = m0 + r;
        const bool in = m < N;
        simlingo::cp_async16(&As[st][r * FLD + kc],
                             in ? h + static_cast<long long>(m) * H + k0 + kc : h, in);
      } else {
        const int v = v0 + r - FBM;
        const bool in = v < V;
        simlingo::cp_async16(&Bs[st][(r - FBM) * FLD + kc],
                             in ? w + static_cast<long long>(v) * H + k0 + kc : w, in);
      }
    }
  };

  float acc[2][8][4] = {};
  const int nk = H / FBK;
  load(0, 0);
  simlingo::cp_async_commit();
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    if (it + 1 < nk) load(st ^ 1, (it + 1) * FBK);      // overlaps this chunk
    simlingo::cp_async_commit();
    simlingo::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = &As[st][(wm * 32 + mt * 16 + g) * FLD + kk * 16 + t4 * 2];
        a[mt][0] = ld32(ap);
        a[mt][1] = ld32(ap + 8 * FLD);
        a[mt][2] = ld32(ap + 8);
        a[mt][3] = ld32(ap + 8 * FLD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* bp = &Bs[st][(wn * 64 + nt * 8 + g) * FLD + kk * 16 + t4 * 2];
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) simlingo::mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();                 // stage `st` is reloaded next iteration
  }

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
// backward
// ---------------------------------------------------------------------------

constexpr int BR = 32, BQ = 32;       // resident rows, streamed rows per tile
constexpr int LDP = BQ + 8;

// R: the block's 32 resident rows (h rows for dh, w rows for dW); Q: the
// streamed rows (w tiles of the segment for dh, all of h for dW). Per Q
// tile: S = R Q^T [32, 32] (warp w: the 16x8 tile (w & 1, w >> 1), four
// independent accumulators over K = H), dlogits into Ps, then
// acc[32, H] += Ps Q_tile (warp w: columns [w NT 8, (w + 1) NT 8)).
template <int NT, bool DW>
__global__ void __launch_bounds__(256)
ce_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const long long* __restrict__ labels, const float* __restrict__ logz,
              const float* __restrict__ gco, float* __restrict__ dh_part,
              bf16* __restrict__ dw, int N, int H, int V, int q_per_seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = H + 8;
  bf16* Rs = reinterpret_cast<bf16*>(smem_raw);          // [BR][LD]
  bf16* Qs = Rs + BR * LD;                               // [2][BQ][LD]
  bf16* Ps = Qs + 2 * BQ * LD;                           // [BR][LDP]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * BR;
  const int nR = DW ? V : N, nQ = DW ? N : V;
  const bf16* Rsrc = DW ? w : h;
  const bf16* Qsrc = DW ? h : w;
  const int ntq = (nQ + BQ - 1) / BQ;
  const int q_begin = DW ? 0 : blockIdx.y * q_per_seg;
  const int q_end = DW ? ntq : min(ntq, q_begin + q_per_seg);

  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int rows_total) {
    const int cpr = H / 8;                                 // 16-byte chunks a row
    for (int c = tid; c < 32 * cpr; c += 256) {
      const int r = c / cpr, kc = (c - r * cpr) * 8, gr = row0 + r;
      const bool in = gr < rows_total;
      simlingo::cp_async16(dst + r * LD + kc,
                           in ? src + static_cast<long long>(gr) * H + kc : src, in);
    }
  };
  load_rows(Rs, Rsrc, r0, nR);
  if (q_begin < q_end) load_rows(Qs, Qsrc, q_begin * BQ, nQ);
  simlingo::cp_async_commit();

  const int mt1 = warp & 1, nt1 = warp >> 1;             // this warp's S tile
  // dh: the S rows are h rows, fixed for the block
  float lz_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
  long long lab_r[2] = {-1, -1};
  if (!DW) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = r0 + mt1 * 16 + g + 8 * r;
      if (m < N) {
        lz_r[r] = logz[m];
        g_r[r] = gco[m];
        lab_r[r] = labels[m];
      }
    }
  }

  float acc[2][NT][4] = {};
  for (int it = q_begin; it < q_end; ++it) {
    const int st = (it - q_begin) & 1;
    if (it + 1 < q_end) load_rows(Qs + (st ^ 1) * BQ * LD, Qsrc, (it + 1) * BQ, nQ);
    simlingo::cp_async_commit();
    simlingo::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * LD;

    float s4[4][4] = {};
    const bf16* ap = Rs + (mt1 * 16 + g) * LD + t4 * 2;
    const bf16* bp = Qt + (nt1 * 8 + g) * LD + t4 * 2;
    for (int k = 0; k < H; k += 64) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = k + c * 16;
        const uint32_t a[4] = {ld32(ap + kk), ld32(ap + 8 * LD + kk), ld32(ap + kk + 8),
                               ld32(ap + 8 * LD + kk + 8)};
        simlingo::mma_bf16_16816(s4[c], a, ld32(bp + kk), ld32(bp + kk + 8));
      }
    }
    float dl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = (s4[0][j] + s4[1][j]) + (s4[2][j] + s4[3][j]);
      const int i = mt1 * 16 + g + 8 * (j >> 1);            // R index
      const int q = it * BQ + nt1 * 8 + t4 * 2 + (j & 1);    // Q index
      const int m = DW ? q : r0 + i, v = DW ? r0 + i : q;
      float lz = lz_r[j >> 1], gg = g_r[j >> 1];
      long long lab = lab_r[j >> 1];
      if (DW && m < N) {
        lz = logz[m];
        gg = gco[m];
        lab = labels[m];
      }
      const float p = expf(s - lz);
      dl[j] = (m < N && v < V) ? (p - (v == lab ? 1.f : 0.f)) * gg : 0.f;
    }
    bf16* pp = Ps + (mt1 * 16 + g) * LDP + nt1 * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(pp) = simlingo::pack_bf16x2(dl[0], dl[1]);
    *reinterpret_cast<uint32_t*>(pp + 8 * LDP) = simlingo::pack_bf16x2(dl[2], dl[3]);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* p = Ps + (mt * 16 + g) * LDP + kk * 16 + t4 * 2;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * LDP);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * LDP + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        simlingo::ldmatrix_x2_trans(
            b0, b1, Qt + (kk * 16 + (lane & 15)) * LD + (warp * NT + nt) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) simlingo::mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();                 // Ps and stage `st` are rewritten next
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + mt * 16 + g + 8 * r;
        const int col = (warp * NT + nt) * 8 + t4 * 2;
        const float x0 = acc[mt][nt][2 * r], x1 = acc[mt][nt][2 * r + 1];
        if (DW) {
          if (row < V)
            *reinterpret_cast<uint32_t*>(dw + static_cast<long long>(row) * H + col) =
                simlingo::pack_bf16x2(x0, x1);
        } else if (row < N) {
          *reinterpret_cast<float2*>(
              dh_part + (static_cast<long long>(blockIdx.y) * N + row) * H + col) =
              make_float2(x0, x1);
        }
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

template <int NT>
int launch_bwd(const void* h, const void* w, const void* labels, const void* logz,
               const void* g, void* part, void* dh, void* dw, int N, int H, int V,
               int S, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(3 * 32 * (H + 8) + BR * LDP) * sizeof(bf16);
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* wp = static_cast<const bf16*>(w);
  const long long* lp = static_cast<const long long*>(labels);
  const float* zp = static_cast<const float*>(logz);
  const float* gp = static_cast<const float*>(g);
  auto kdh = ce_bwd_kernel<NT, false>;
  cudaError_t e = cudaFuncSetAttribute(kdh, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntq = (V + BQ - 1) / BQ;
  const int q_per_seg = (ntq + S - 1) / S;
  kdh<<<dim3((N + BR - 1) / BR, S), 256, smem, st>>>(
      hp, wp, lp, zp, gp, static_cast<float*>(part), nullptr, N, H, V, q_per_seg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long count = static_cast<long long>(N) * H;
  long long blocks = (count / 4 + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  ce_dh_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dh), count, S);
  e = cudaGetLastError();
  if (e != cudaSuccess || dw == nullptr) return static_cast<int>(e);
  auto kdw = ce_bwd_kernel<NT, true>;
  e = cudaFuncSetAttribute(kdw, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kdw<<<dim3((V + BR - 1) / BR, 1), 256, smem, st>>>(
      hp, wp, lp, zp, gp, nullptr, static_cast<bf16*>(dw), N, H, V, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ce [N] and logz [N] fp32. Scratch: part_m, part_l [ceil(V/128), N] fp32,
// gold [N] fp32. Needs H % 32 == 0.
extern "C" int simlingo_fused_ce_fwd(const void* h, const void* w, const void* labels,
                                     void* part_m, void* part_l, void* gold, void* logz,
                                     void* ce, int N, int H, int V, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nvt = (V + FBN - 1) / FBN;
  ce_fwd_tile_kernel<<<dim3((N + FBM - 1) / FBM, nvt), 256, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const long long*>(labels), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(gold), N, H, V);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_fwd_finalize_kernel<<<(N + 31) / 32, 256, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(gold), static_cast<const long long*>(labels),
      static_cast<float*>(logz), static_cast<float*>(ce), N, V, nvt);
  return static_cast<int>(cudaGetLastError());
}

// dh [N, H] bf16; dw [V, H] bf16 or null (no dW). Scratch: part [S, N, H]
// fp32, S vocabulary segments. Needs H in {64, 128, 256, 512, 896}.
extern "C" int simlingo_fused_ce_bwd(const void* h, const void* w, const void* labels,
                                     const void* logz, const void* g, void* part,
                                     void* dh, void* dw, int N, int H, int V, int S,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return launch_bwd<1>(h, w, labels, logz, g, part, dh, dw, N, H, V, S, st);
    case 128: return launch_bwd<2>(h, w, labels, logz, g, part, dh, dw, N, H, V, S, st);
    case 256: return launch_bwd<4>(h, w, labels, logz, g, part, dh, dw, N, H, V, S, st);
    case 512: return launch_bwd<8>(h, w, labels, logz, g, part, dh, dw, N, H, V, S, st);
    case 896: return launch_bwd<14>(h, w, labels, logz, g, part, dh, dw, N, H, V, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
