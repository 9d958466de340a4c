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
// and the training rows (M = 4788) the tensor-core operations.
//
// Design:
//  * M = 1 (decode), gemv_kernel: the bytes, with little other work to hide
//    their latency. A warp owns R rows (2-8) and a slice of K at a time;
//    each lane issues its R 16-byte weight loads of the same 16 columns
//    (streaming: read once) before it uses any, and widens each code by a
//    byte permute and one fp32 subtraction (no I2F). The warps of a block
//    split K and sum in shared memory in warp order. The blocks walk the
//    row groups grid-stride, each lane holding its x chunk as fp32 for the
//    whole walk and the next group's loads in flight while it sums the
//    current one. The plan (R, warps, blocks) is the wrapper's,
//    `_gemv_plan`.
//  * 2 <= M <= 48 (verify, queries), gemm_kernel: 16 x 64 output tiles, 4
//    warps, mma.m16n8k16 with fp32 accumulators. K streams in steps of 64
//    through a 3-stage cp.async ring; the weight tile stays int8 in shared
//    memory and each B-fragment is dequantized (exactly: |v| <= 127) in
//    registers when it is loaded. Here the bound is the weight bytes.
//  * M > 48 (prefill, training), gemm64_kernel: dx_kernel's loop below
//    with the operands' roles as in y = x . w_q^T: 64 x 128 tiles of 4
//    warps, a 4-stage cp.async ring of 32 K-columns, the int8 tile
//    dequantized once a block into a bf16 [n][k] tile, A and B by
//    ldmatrix.x4 into mma.sync. Here the bound is the operations, and in
//    practice the instructions and shared-memory traffic that feed mma.sync.
//  * The grid. Where the output tiles alone do not fill the card (every
//    M <= 48 call but the head's, and the narrow linears at prefill) the
//    reduction is cut into S <= 8 segments of whole steps, gridDim.z = S,
//    and the S blocks of one output tile form one thread-block cluster
//    (1, 1, S). Each block leaves its fp32 partial tile in its own shared
//    memory; after a cluster barrier each block takes a slice of the tile's
//    rows, reads the S partials through distributed shared memory in the
//    order s = 0..S-1, applies the scale to the fp32 sum and stores bf16 --
//    one launch, no scratch in device memory, no atomics, the same bits on
//    every call. The plan (S and the segment length) is made by the Python
//    wrapper from simlingo_int8_matmul_geometry.
//  * The scale is read as the caller holds it, fp32 or bf16 (widened
//    exactly, as torch's .float() does), and multiplies the fp32 sum.
// K must be a multiple of 16 (the wrapper checks).
//
// The activation gradient, dx_kernel (simlingo_int8_matmul_dx):
//   dx[M,K] = bf16(g[M,N] * scale[N]) . w_q[N,K], fp32 sums, bf16 out.
// Replaces _int8_matmul_bwd (:81), which runs the same Pallas _kernel with
// transpose_rhs flipped and a ones scale. In the [N, K] layout the sum runs
// along the weight's rows, which gemv_kernel and gemm_kernel do not
// compute. What bounds it on the training path: at the linears (M = 4788
// rows) the tensor-core operations, and in practice the shared-memory
// traffic and instructions that feed mma.sync; at the tied head (M = 192,
// N = 151674) the bytes (136 MB of int8 weight, 58 MB of g), so the grid
// has to cover every SM while the tiles alone are 21.
// Design (chip_smoke.py phase 2 and PERF.md hold the numbers):
//  * The grid. 64 x 128 output tiles, and the reduction cut into S
//    segments of whole 32-row steps, S the grid's slowest axis. The
//    wrapper's plan: S = 1 where the tiles alone give two blocks an SM (at
//    every linear), else the largest S whose blocks fit in one wave of the
//    3 resident blocks an SM (the head: 21 x 18 = 378 blocks). The blocks
//    of one segment run together and share its g and weight rows in L2.
//    With S > 1 each block writes an fp32 partial [S, M, K] and
//    dx_reduce_kernel sums s = 0..S-1 in order and rounds once: no
//    atomics, so every call gives the same bits. 128 x 128 tiles of 8
//    warps measured slower at every shape: 266 tiles at the linears leave
//    2 blocks for a second wave, and 64 x 32 warp tiles read more shared
//    memory per product.
//  * The loop. 4 warps of 32 x 64. The reduction streams through a 4-stage
//    cp.async ring in 54784 bytes of dynamic shared memory: g as bf16, the
//    weight as raw int8, the 32 scales as fp32. One cooperative pass per
//    stage dequantizes the int8 tile exactly into a bf16 [n][k] tile (a
//    byte permute and one fp32 subtraction per code), once per block and
//    not once per warp that reads it, one step ahead of the products, which
//    read B by ldmatrix.x4.trans. A comes by ldmatrix.x4 from the g tile as
//    copied and is scaled in registers: g * scale in fp32, rounded to bf16
//    (JAX's gs = (g.astype(f32) * scale).astype(g.dtype), :86), the same
//    rounding as a pass in shared memory without its round trip through
//    it (the A operand of a later wgmma comes from registers too). One
//    barrier a step. The bf16 tile is staged through shared memory and
//    written 16 bytes a lane. The tail is zero-filled on all three
//    operands. g rows are copied 16 bytes at a time when N % 8 == 0 and g
//    is 16-byte aligned, else 4 bytes at a time (the vocabulary, 151674,
//    leaves rows 4-byte aligned only; one zero-padded copy of g with
//    16-byte copies measured slower, PERF.md); N must be even.
//  * The plan (S and the segment length) is made by the Python wrapper,
//    which reads this file's geometry from simlingo_int8_matmul_dx_geometry
//    and refuses a library whose geometry differs from its own.
//
// The fp32 build (fp32 x or g: training at precision=fp32, serving at
// compute_dtype float32). JAX's int8_matmul computes in x's dtype: at fp32
// the product of x and the widened codes is an fp32 sum, times the scale;
// its VJP's gs = (g * scale).astype(g.dtype) (:86) rounds nothing below
// fp32. So:
//  * M = 1: gemv_kernel with fp32 x and y (XT = float): it widened bf16 x
//    to fp32 already; only its loads and its store change. Bound by the
//    weight bytes, as bf16's.
//  * M >= 2, gemm_split_kernel: the split tile product of f32_tc_tile.cuh
//    (128 x 128 tiles, one block an SM): x cut into big + small in TF32 as
//    its fragments are loaded, the int8 codes staged as int8 and exact in
//    TF32, so two mma.sync products a k8-step keep fp32 accuracy on the
//    tensor cores; y = sum times the scale widened to fp32.
//  * dx_split_kernel: dx = (g * scale) w_q on the same tile. g comes
//    through the tile's scaled source: g * scale, an fp32 product rounded
//    once (JAX's gs), formed at fragment load and then split; the codes lie
//    k-major (the sum runs along w_q's rows) and are staged [k][i] as
//    int8. g's rows are copied 16 bytes at a time where N % 4 == 0, else 8
//    or 4 (the vocabulary, 151674, leaves rows 8-byte aligned; PERF.md has
//    the narrow copies against one zero-padded copy of g).
//  Both take the plan `_split_plan` (the gradient with its own (M, K, N)):
//  where the tiles alone give fewer than two waves, the reduction is cut
//  into the count of segments with the shortest critical path; each block
//  then writes an fp32 partial [S, M, cols] and f32_reduce_kernel sums s =
//  0..S-1 in order (and scales the forward's). What bounds both: the
//  operations of the cheaper fp32-accurate scheme, 2 M N K three times in
//  bf16 (the fp32 operand in three bf16 parts, the codes exact) at 989
//  TFLOP/s rather than twice in TF32 at 495 (0.127 ms at gate,up and down
//  and the 4788 training rows); at k,v the bytes.

#include <atomic>

#include <cooperative_groups.h>

#include "common.cuh"
#include "f32_tc_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using simlingo::ld32;

constexpr int MAX_DEVICES = 64;
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr int SMALL_M = 48;            // gemm_kernel takes 2 <= M <= 48
constexpr int SMALL_RESIDENT = 8;      // its blocks an SM: <= 64 registers a thread
// Blocks an SM that a split of the 64-row kernel aims at: 2 of the 3 it
// holds. Beyond 2 an SM more segments only added per-block cost (the
// forced-split sweep, chip_smoke.py --int8-sweep, in PERF.md).
constexpr int LARGE_FILL = 2;
// The GEMV: most warps a block (K slices), most rows a warp, and K columns
// a 16-byte load of codes. Its instantiations take 2, 4
// or 8 rows a warp.
constexpr int GEMV_MAX_WARPS = 16;
constexpr int GEMV_MAX_ROWS = 8;
constexpr int GEMV_CHUNK = 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// Four int8 codes (lowest byte first) -> four fp32 values, exactly. A byte
// permute makes each code c the fp32 2^23 + (c ^ 0x80) = 2^23 + 128 + c;
// subtracting 2^23 + 128 leaves c. One PRMT (integer pipe) and one FADD a
// code instead of an I2F, which runs at a quarter of their rate.
__device__ __forceinline__ void int8x4_to_f32x4(uint32_t q, float (&f)[4]) {
  const uint32_t u = q ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// R rows' 16-byte code chunks times 16 x values (fp32): acc[r] += the 16
// products of row r, in column order.
template <int R>
__device__ __forceinline__ void dot_chunk(const uint4 (&q)[R], const float (&xf)[16],
                                          float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t qw[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
      int8x4_to_f32x4(qw[i], f);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r] = fmaf(xf[4 * i + e], f[e], acc[r]);
    }
  }
}

// x[16 c .. 16 c + 15] widened to fp32 (bf16 is the top half of an fp32),
// or as it is (fp32).
__device__ __forceinline__ void load_x_chunk(const float* __restrict__ x, int c, float (&xf)[16]) {
  const float4* xp = reinterpret_cast<const float4*>(x) + 4 * c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = __ldg(xp + j);
    xf[4 * j] = v.x;
    xf[4 * j + 1] = v.y;
    xf[4 * j + 2] = v.z;
    xf[4 * j + 3] = v.w;
  }
}

__device__ __forceinline__ void store_out(bf16* y, float v) { *y = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* y, float v) { *y = v; }

__device__ __forceinline__ void load_x_chunk(const bf16* __restrict__ x, int c, float (&xf)[16]) {
  const uint4* xp = reinterpret_cast<const uint4*>(x) + 2 * c;
  const uint4 xa = __ldg(xp), xb = __ldg(xp + 1);
  const uint32_t xu[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xf[2 * j] = __uint_as_float(xu[j] << 16);
    xf[2 * j + 1] = __uint_as_float(xu[j] & 0xffff0000u);
  }
}

// Chunk c of the R rows from n0 (rows past N read row N - 1 and are never
// stored), streaming: the weights are read once.
template <int R>
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ w, int n0, int N, int K,
                                          int c, uint4 (&q)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    q[r] = __ldcs(reinterpret_cast<const uint4*>(
        w + static_cast<long long>(min(n0 + r, N - 1)) * K) + c);
}

// The GEMV (M = 1). A block of `warps` warps owns R consecutive weight rows
// (a row group) at a time and walks the row groups grid-stride. K is cut
// into P = warps slices of whole 16-column chunks, slice p = [p C / P,
// (p + 1) C / P) of the C = K / 16 chunks; warp p takes slice p, the same
// for every row group. Where each lane has at most one chunk of its slice
// (C <= 32 P: every path shape), it widens its 16 x values to fp32 once for
// the whole walk, and it issues the next row group's R 16-byte weight
// loads before it computes the current one's, so that they are in flight
// through the sums and barrier; else it loops over its chunks, loads
// first. The branch is taken from C and P, so every warp of the block
// takes the same one. (Two chunks a lane, half the warps, measured slower
// at every path shape.) Codes are widened by a byte permute. The warp sums
// by butterfly shuffles (every lane ends with the same bits) and the block
// sums its warps' partials in shared memory in warp order: no atomics, the
// same bits on every call. The fp32 sum times the widened scale is rounded
// once to bf16 (XT bf16) or stored as it is (XT float: x and y fp32).
template <int R, typename ST, typename XT>
__global__ void __launch_bounds__(GEMV_MAX_WARPS * 32)
gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
            const ST* __restrict__ scale, XT* __restrict__ y, int N, int K) {
  __shared__ float part[GEMV_MAX_WARPS][R];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = threadIdx.x;
  const int P = blockDim.x >> 5, C = K / GEMV_CHUNK;
  const int c0 = static_cast<unsigned>(warp * C) / P;   // warp * C < 2^31: K < 2^28, P <= 16
  const int c1 = static_cast<unsigned>((warp + 1) * C) / P;
  const int groups = (N + R - 1) / R;

  // the warp sums of group g's partials acc[] -> y[g R ..], in a fixed order
  auto finish = [&](int g, float (&acc)[R]) {
    const int n0 = g * R;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < R; ++r) part[warp][r] = acc[r];
    __syncthreads();
    if (t < R && n0 + t < N) {
      float sum = part[0][t];
      for (int i = 1; i < P; ++i) sum += part[i][t];
      store_out(y + n0 + t, sum * widen(scale[n0 + t]));
    }
    __syncthreads();                       // part is free for the next row group
  };

  if (C <= 32 * P) {                       // the longest slice, ceil(C / P) chunks, <= 32
    const int c = c0 + lane;
    const bool mine = c < c1;              // lanes past the slice add zeros
    uint4 next[R];                         // the first group's loads, then x's: both in flight
#pragma unroll
    for (int r = 0; r < R; ++r) next[r] = make_uint4(0u, 0u, 0u, 0u);
    int g = blockIdx.x;
    if (mine && g < groups) load_rows<R>(w, g * R, N, K, c, next);
    float xf[16];
    if (mine) {
      load_x_chunk(x, c, xf);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) xf[j] = 0.f;
    }
    for (; g < groups; g += gridDim.x) {
      uint4 q[R];
#pragma unroll
      for (int r = 0; r < R; ++r) q[r] = next[r];
      if (mine && g + gridDim.x < groups) load_rows<R>(w, (g + gridDim.x) * R, N, K, c, next);
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      dot_chunk<R>(q, xf, acc);
      finish(g, acc);
    }
    return;
  }
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int c = c0 + lane; c < c1; c += 32) {
      uint4 q[R];
      load_rows<R>(w, g * R, N, K, c, q);
      float xf[16];
      load_x_chunk(x, c, xf);
      dot_chunk<R>(q, xf, acc);
    }
    finish(g, acc);
  }
}

// Eight bf16 outputs of one row, columns gc..gc+7 (`left` = N - gc of them
// exist), packed lowest first: 16 bytes where N % 8 == 0, else bf16 pairs
// where N is even (rows 4-byte aligned), else one by one.
__device__ __forceinline__ void store_row8(bf16* __restrict__ out, int left, int N, uint4 v) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  if ((N & 7) == 0) {
    *reinterpret_cast<uint4*>(out) = v;
  } else if ((N & 1) == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (2 * j < left) *reinterpret_cast<uint32_t*>(out + 2 * j) = u[j];
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < left)
        out[j] = __ushort_as_bfloat16(static_cast<unsigned short>(u[j >> 1] >> (16 * (j & 1))));
  }
}

// Eight fp32 sums of one output row times their scales, each rounded once
// to bf16, and stored.
template <typename ST>
__device__ __forceinline__ void store_scaled8(bf16* __restrict__ out, const ST* __restrict__ sc,
                                              int left, int N, const float (&v)[8]) {
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = j < left ? v[j] * widen(sc[j]) : 0.f;
  store_row8(out, left, N, make_uint4(
      simlingo::pack_bf16x2(o[0], o[1]), simlingo::pack_bf16x2(o[2], o[3]),
      simlingo::pack_bf16x2(o[4], o[5]), simlingo::pack_bf16x2(o[6], o[7])));
}

// The split reduction's epilogue. Every block of the cluster holds
// the fp32 partial tile F [BM][LDF] of the same output tile, over its own
// reduction segment (cluster rank s = segment s). Block `rank` sums rows
// [rank * BM / S, (rank + 1) * BM / S) over s = 0..S-1 in that order,
// eight columns a thread, scales and stores them.
template <int BM, int BN, int LDF, int THREADS, typename ST>
__device__ __forceinline__ void cluster_epilogue(const float* F, const ST* __restrict__ scale,
                                                 bf16* __restrict__ y, int m0, int n0,
                                                 int M, int N, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                          // every partial tile of the cluster is in place
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lo = rank * BM / S, hi = (rank + 1) * BM / S;
  for (int c = tid; c < (hi - lo) * (BN / 8); c += THREADS) {
    const int r = lo + c / (BN / 8), col = (c % (BN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + col;
    if (gr >= M || gc >= N) continue;
    float v[8];
    for (int s = 0; s < S; ++s) {
      const float* src = F + r * LDF + col;
      const float4* p = reinterpret_cast<const float4*>(
          s == rank ? src : cluster.map_shared_rank(src, s));
      const float4 a = p[0], b = p[1];
      const float t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = s == 0 ? t[j] : v[j] + t[j];
    }
    store_scaled8(y + (long long)gr * N + gc, scale + gc, N - gc, N, v);
  }
  cluster.sync();                          // the partials live until every block has read them
}

// gemm_kernel's epilogue, on the block's fp32 accumulators
// acc[MT][NT][4] (the m16n8 fragments of the warp tile at rows wm, columns
// wn), once every warp is done with the ring `smem`. Unsplit (gridDim.z ==
// 1): the sums times their scales, rounded to bf16 in registers, staged as
// the bf16 tile [BM][BN + 8] and stored 16 bytes a lane. Split: the fp32
// partial tile [BM][BN + 8] goes to cluster_epilogue. (The padded rows keep
// the fragment stores free of bank conflicts.)
template <int BM, int BN, int THREADS, int MT, int NT, typename ST>
__device__ __forceinline__ void gemm_epilogue(unsigned char* smem, const float (&acc)[MT][NT][4],
                                              int wm, int wn, const ST* __restrict__ scale,
                                              bf16* __restrict__ y, int m0, int n0, int M, int N,
                                              int tid) {
  constexpr int LD = BN + 8;
  const int lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  if (gridDim.z == 1) {
    float sc[NT][2];                              // this lane's columns' scales
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + wn + nt * 8 + t2 + e;
        sc[nt][e] = c < N ? widen(scale[c]) : 0.f;
      }
    bf16* O = reinterpret_cast<bf16*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(O + (wm + mt * 16 + g + half * 8) * LD + wn + nt * 8 + t2) =
              simlingo::pack_bf16x2(acc[mt][nt][half * 2] * sc[nt][0],
                                    acc[mt][nt][half * 2 + 1] * sc[nt][1]);
    __syncthreads();
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
      if (m0 + r < M && n0 + col < N)
        store_row8(y + (long long)(m0 + r) * N + n0 + col, N - n0 - col, N,
                   *reinterpret_cast<const uint4*>(O + r * LD + col));
    }
    return;
  }
  float* F = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(F + (wm + mt * 16 + g + half * 8) * LD + wn + nt * 8 + t2) =
            make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
  cluster_epilogue<BM, BN, LD, THREADS>(F, scale, y, m0, n0, M, N, tid);
}

// Four int8 codes (lowest byte first) -> two bf16x2 words, exactly (bf16
// holds every |c| <= 127).
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t q) {
  float f[4];
  int8x4_to_f32x4(q, f);
  return make_uint2(simlingo::pack_bf16x2(f[0], f[1]), simlingo::pack_bf16x2(f[2], f[3]));
}

// gemm64_kernel's cooperative pass: a landed int8 tile [ROWS][COLS] (row
// stride LDS bytes) dequantized exactly into a bf16 tile [ROWS][LDD], 16
// codes a thread an iteration, consecutive threads on consecutive rows
// (48-byte reads, 80-byte writes: no bank conflicts).
template <int ROWS, int COLS, int LDS, int LDD, int THREADS>
__device__ __forceinline__ void dequant_rows(const int8_t* __restrict__ src, bf16* __restrict__ dst,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * COLS / (16 * THREADS); ++i) {
    const int c = tid + i * THREADS;
    const int row = c % ROWS, col = (c / ROWS) * 16;
    const uint4 q = *reinterpret_cast<const uint4*>(src + row * LDS + col);
    const uint2 a = int8x4_to_bf16x4(q.x), b = int8x4_to_bf16x4(q.y);
    const uint2 cc = int8x4_to_bf16x4(q.z), d = int8x4_to_bf16x4(q.w);
    uint4* o = reinterpret_cast<uint4*>(dst + row * LDD + col);
    o[0] = make_uint4(a.x, a.y, b.x, b.y);
    o[1] = make_uint4(cc.x, cc.y, d.x, d.y);
  }
}

constexpr int BM = 16, BN = 64, BK = 64, STAGES = 3;   // gemm_kernel
constexpr int LDA = BK + 8;     // bf16 row stride: conflict-free 32-bit fragment loads
constexpr int LDB = BK + 16;    // int8 row stride: conflict-free 16-bit fragment loads

// Two int8 codes (low byte first) -> a bf16x2 B-fragment register.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint16_t v) {
  return simlingo::pack_bf16x2(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                               static_cast<float>(static_cast<int8_t>(v >> 8)));
}

// 16 x 64 output tile per block of 4 warps; each warp owns a
// (16*WMT) x (8*WNT) = 16 x 16 sub-tile. The block's reduction segment, steps
// [z * seg_steps, ...) of BK, z = blockIdx.z, streams through a STAGES-deep
// cp.async ring: the activation tile as bf16, the weight tile as raw int8
// (half the shared-memory bytes), dequantized in registers as each
// B-fragment is loaded. The sums then go to gemm_epilogue.
template <typename ST>
__global__ void __launch_bounds__(128, SMALL_RESIDENT)
gemm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
            const ST* __restrict__ scale, bf16* __restrict__ y,
            int M, int N, int K, int seg_steps) {
  constexpr int WMT = 1, WNT = 2, WARPS_N = BN / (8 * WNT);
  static_assert((BM / (16 * WMT)) * WARPS_N == 4, "4 warps per block");
  static_assert(BM * (BN + 8) * 4 <= STAGES * BM * LDA * 2, "the partial tile fits the x ring");
  __shared__ __align__(16) bf16 As[STAGES][BM * LDA];      // [m][k]
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDB];    // [n][k] int8 codes
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp / WARPS_N) * 16 * WMT, wn = (warp % WARPS_N) * 8 * WNT;
  const int kt0 = blockIdx.z * seg_steps;
  const int ktiles = min((K + BK - 1) / BK - kt0, seg_steps);

  auto load_tile = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * BK;
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

  simlingo::cp_async_wait<0>();
  __syncthreads();                             // every warp is done with the ring
  gemm_epilogue<BM, BN, 128>(reinterpret_cast<unsigned char*>(&As[0][0]), acc, wm, wn,
                             scale, y, m0, n0, M, N, tid);
}

// The 64-row variant (M > 48): dx_kernel's loop with the operands' roles
// as in y = x . w_q^T. One 64 x 128 output tile of 4 warps (32 x 64 each);
// the reduction steps of 32 K-columns stream through a 4-stage cp.async
// ring in dynamic shared memory: x as bf16 [m][k], the weight as raw int8
// [n][k] in 48-byte rows. One cooperative pass a stage dequantizes the int8
// tile exactly into a bf16 [n][k] tile, once a block, one step ahead of the
// products; a thread a row, so that its 16-byte reads and writes are free
// of bank conflicts.
// A comes by ldmatrix.x4 from the x tile, B by non-transposed ldmatrix.x4
// from the bf16 [n][k] tile (rows = n, columns = k: each lane receives the
// (b0, b1) of two n8 tiles). Both tiles have 80-byte rows, so every
// ldmatrix phase of 8 rows x 16 bytes hits 32 banks. No scaling in the
// loop. Unsplit, the sums are scaled in registers and the bf16 tile is
// staged through shared memory, 16 bytes a lane to device memory; split,
// the partial tile goes to cluster_epilogue. (This epilogue is written out
// here rather than shared with gemm_kernel's: the shared form moved
// ptxas's schedule of the loop and cost 5-10 % at M = 4788, PERF.md.)
constexpr int T_BM = 64, T_BN = 128, T_BK = 32, T_STAGES = 4, T_THREADS = 128;
constexpr int LARGE_RESIDENT = 3;      // blocks an SM: <= 170 registers a thread
constexpr int T_LD = T_BK + 8;         // x and dequantized-weight row stride (bf16)
constexpr int T_LDW = T_BK + 16;       // int8 weight row stride (bytes)
constexpr int T_SX = T_STAGES * T_BM * T_LD * 2;
constexpr int T_SW = T_STAGES * T_BN * T_LDW;
constexpr int T_SMEM = T_SX + T_SW + 2 * T_BN * T_LD * 2;   // 65536 bytes
static_assert(T_BM * (T_BN + 8) * 4 <= T_SMEM, "the partial tile fits the ring");

template <typename ST>
__global__ void __launch_bounds__(T_THREADS, LARGE_RESIDENT)
gemm64_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
              const ST* __restrict__ scale, bf16* __restrict__ y,
              int M, int N, int K, int seg_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + T_SX);
  bf16* Bs = reinterpret_cast<bf16*>(smem + T_SX + T_SW);
  const int m0 = blockIdx.y * T_BM, n0 = blockIdx.x * T_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int kt0 = blockIdx.z * seg_steps;
  const int steps = min((K + T_BK - 1) / T_BK - kt0, seg_steps);

  auto load = [&](int stage, int step) {
    const int k0 = (kt0 + step) * T_BK;
#pragma unroll
    for (int i = 0; i < T_BM * T_BK / (8 * T_THREADS); ++i) {       // 8 bf16 a copy
      const int c = tid + i * T_THREADS;
      const int row = c / (T_BK / 8), kc = (c % (T_BK / 8)) * 8;
      const bool ok = m0 + row < M && k0 + kc < K;
      simlingo::cp_async16(Xs + (stage * T_BM + row) * T_LD + kc,
                           ok ? x + (long long)(m0 + row) * K + k0 + kc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < T_BN * T_BK / (16 * T_THREADS); ++i) {      // 16 codes a copy
      const int c = tid + i * T_THREADS;
      const int row = c / (T_BK / 16), kc = (c % (T_BK / 16)) * 16;
      const bool ok = n0 + row < N && k0 + kc < K;
      simlingo::cp_async16(Ws + (stage * T_BN + row) * T_LDW + kc,
                           ok ? w + (long long)(n0 + row) * K + k0 + kc : w, ok);
    }
  };
  // The cooperative pass: the landed int8 tile of `stage` dequantized into
  // the bf16 tile `buf`, a thread a row (48-byte reads, 80-byte writes: no
  // bank conflicts).
  auto dequant = [&](int stage, int buf) {
    dequant_rows<T_BN, T_BK, T_LDW, T_LD, T_THREADS>(Ws + stage * T_BN * T_LDW,
                                                     Bs + buf * T_BN * T_LD, tid);
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Step t + 1 is dequantized while step t is multiplied, behind one
  // barrier a step: its loads landed one iteration earlier.
#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    simlingo::cp_async_commit();
  }
  simlingo::cp_async_wait<T_STAGES - 2>();           // step 0 has landed
  __syncthreads();
  dequant(0, 0);
  for (int t = 0; t < steps; ++t) {
    simlingo::cp_async_wait<T_STAGES - 3>();         // step t + 1 has landed
    __syncthreads();            // step t is dequantized; step t - 1's buffers are free
    if (t + T_STAGES - 1 < steps) load((t + T_STAGES - 1) % T_STAGES, t + T_STAGES - 1);
    simlingo::cp_async_commit();
    const bool next = t + 1 < steps;
    const bf16* X = Xs + (t % T_STAGES) * T_BM * T_LD;
    const bf16* B = Bs + (t & 1) * T_BN * T_LD;
#pragma unroll
    for (int kk = 0; kk < T_BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        simlingo::ldmatrix_x4(a[i], X + (wm + i * 16 + (lane & 15)) * T_LD + kk * 16 + (lane >> 4) * 8);
      // B: lanes 0-7 / 8-15 address n rows 0-7 at k 0 / 8, lanes 16-31 the
      // same for n rows 8-15: (b[0], b[1]) of n8 tile 2j, (b[2], b[3]) of 2j + 1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        simlingo::ldmatrix_x4(b, B + (wn + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * T_LD
                                     + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          simlingo::mma_bf16_16816(acc[i][2 * j], a[i], b[0], b[1]);
          simlingo::mma_bf16_16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
      // after the step's last products are issued, so that the two overlap
      if (next && kk != 0) dequant((t + 1) % T_STAGES, (t + 1) & 1);
    }
  }

  simlingo::cp_async_wait<0>();
  __syncthreads();                                   // every warp is done with the ring
  if (gridDim.z == 1) {
    float sc[8][2];                                  // this lane's 16 columns' scales
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + wn + j * 8 + (lane & 3) * 2 + e;
        sc[j][e] = c < N ? widen(scale[c]) : 0.f;
      }
    bf16* O = reinterpret_cast<bf16*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm + i * 16 + (lane >> 2) + half * 8, c = wn + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<uint32_t*>(O + r * (T_BN + 8) + c) = simlingo::pack_bf16x2(
              acc[i][j][half * 2] * sc[j][0], acc[i][j][half * 2 + 1] * sc[j][1]);
        }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < T_BM * T_BN / (8 * T_THREADS); ++i) {
      const int c = tid + i * T_THREADS;
      const int r = c / (T_BN / 8), col = (c % (T_BN / 8)) * 8;
      if (m0 + r < M && n0 + col < N)
        store_row8(y + (long long)(m0 + r) * N + n0 + col, N - n0 - col, N,
                   *reinterpret_cast<const uint4*>(O + r * (T_BN + 8) + col));
    }
    return;
  }
  float* F = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + i * 16 + (lane >> 2) + half * 8, c = wn + j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(F + r * (T_BN + 8) + c) =
            make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
  cluster_epilogue<T_BM, T_BN, T_BN + 8, T_THREADS>(F, scale, y, m0, n0, M, N, tid);
}

// Launches `kernel` on `grid`, whose z extent S is the cluster: (1, 1, S).
// Before its first launch with a cluster size on a device, the kernel's
// dynamic shared-memory limit is raised where it needs more than 48 KB,
// and the occupancy calculator is asked whether one such cluster fits the
// card at all; a size that does not is refused (cudaErrorInvalidConfiguration),
// with no fallback to an unsplit launch.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...),
                             std::atomic<bool> (&ready)[MAX_DEVICES][MAX_CLUSTER + 1],
                             dim3 grid, int smem, cudaStream_t st, Args... args) {
  const int S = static_cast<int>(grid.z);
  if (S < 1 || S > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !ready[dev][S].load(std::memory_order_relaxed)) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) ready[dev][S].store(true, std::memory_order_relaxed);
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename ST>
cudaError_t launch_gemm(const bf16* x, const int8_t* w, const ST* s, bf16* y,
                        int M, int N, int K, int S, int seg_steps, cudaStream_t st) {
  static std::atomic<bool> ready[MAX_DEVICES][MAX_CLUSTER + 1];
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
  return launch_clustered(gemm_kernel<ST>, ready, grid, 0, st,
                          x, w, s, y, M, N, K, seg_steps);
}

template <typename ST>
cudaError_t launch_gemm64(const bf16* x, const int8_t* w, const ST* s, bf16* y,
                          int M, int N, int K, int S, int seg_steps, cudaStream_t st) {
  static std::atomic<bool> ready[MAX_DEVICES][MAX_CLUSTER + 1];
  const dim3 grid((N + T_BN - 1) / T_BN, (M + T_BM - 1) / T_BM, S);
  return launch_clustered(gemm64_kernel<ST>, ready, grid, T_SMEM, st,
                          x, w, s, y, M, N, K, seg_steps);
}

// The GEMV's plan: R rows a warp (2, 4 or 8), `warps` K slices a block
// (1..16) and `blocks` row-group blocks, which walk the row groups
// grid-stride. Anything else is refused.
template <typename ST, typename XT>
cudaError_t launch_gemv(const XT* x, const int8_t* w, const ST* s, XT* y, int N, int K,
                        int R, int warps, int blocks, cudaStream_t st) {
  if (warps < 1 || warps > GEMV_MAX_WARPS || blocks < 1 || N < 1 || K % GEMV_CHUNK != 0 ||
      K >= (1 << 28))
    return cudaErrorInvalidValue;
  switch (R) {
    case 2: gemv_kernel<2, ST, XT><<<blocks, warps * 32, 0, st>>>(x, w, s, y, N, K); break;
    case 4: gemv_kernel<4, ST, XT><<<blocks, warps * 32, 0, st>>>(x, w, s, y, N, K); break;
    case 8: gemv_kernel<8, ST, XT><<<blocks, warps * 32, 0, st>>>(x, w, s, y, N, K); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

constexpr int DX_BM = 64;            // dx rows per block
constexpr int DX_BN = 128;           // dx columns (weight columns) per block
constexpr int DX_BR = 32;            // reduction step: weight rows per stage
constexpr int DX_STAGES = 4;         // depth of the cp.async ring
constexpr int DX_THREADS = 128;      // 4 warps, 2 x 2, each 32 x 64
constexpr int DX_RESIDENT = 3;       // blocks an SM holds: <= 170 registers a thread
// Dynamic shared memory, stage by stage: the g tile [m][n] (bf16, 80-byte
// rows: every ldmatrix phase of 8 rows x 16 bytes hits 32 banks), the int8
// tile [n][k] as copied, the scales [n] (fp32); then two dequantized tiles
// [n][k] (bf16, 272-byte rows, the same for ldmatrix.trans).
constexpr int DX_LDG = DX_BR + 8, DX_LDB = DX_BN + 8;
constexpr int DX_SG = DX_STAGES * DX_BM * DX_LDG * 2;
constexpr int DX_SW = DX_STAGES * DX_BR * DX_BN;
constexpr int DX_SS = DX_STAGES * DX_BR * 4;
constexpr int DX_SMEM = DX_SG + DX_SW + DX_SS + 2 * DX_BR * DX_LDB * 2;   // 54784 bytes
static_assert(DX_BM * (DX_BN + 8) * 2 <= DX_SG, "the output tile fits the g ring");

// g (bf16x2, lower index low) * (s.x, s.y) in fp32, rounded to bf16x2.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float2 s) {
  return simlingo::pack_bf16x2(__uint_as_float(v << 16) * s.x,
                               __uint_as_float(v & 0xffff0000u) * s.y);
}

// One 64 x 128 tile of dx over reduction steps [z * seg_steps, ...) of 32
// weight rows, z = blockIdx.z. VEC: bytes per cp.async of a g row, 16 or 4.
// With part set, the fp32 sums go to part[z] and dx_reduce_kernel rounds
// them; else the tile is rounded to bf16 here. (ptxas schedules the loop
// well in the statement order below; equivalent rearrangements of it, such
// as scaling each A-fragment right after its own ldmatrix, measured slower.)
template <int VEC>
__global__ void __launch_bounds__(DX_THREADS, DX_RESIDENT)
dx_kernel(const bf16* __restrict__ g, const int8_t* __restrict__ w, const float* __restrict__ scale,
          float* __restrict__ part, bf16* __restrict__ dx, int M, int N, int K, int seg_steps) {
  constexpr int E = VEC / 2;                          // bf16 per g copy
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Gs = reinterpret_cast<bf16*>(smem);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + DX_SG);
  unsigned char* Ss = smem + DX_SG + DX_SW;           // fp32 scales
  bf16* Bs = reinterpret_cast<bf16*>(smem + DX_SG + DX_SW + DX_SS);
  const int m0 = blockIdx.y * DX_BM, k0 = blockIdx.x * DX_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int r0 = blockIdx.z * seg_steps;
  const int steps = min((N + DX_BR - 1) / DX_BR - r0, seg_steps);

  auto load = [&](int stage, int step) {
    const int n0 = (r0 + step) * DX_BR;
    bf16* G = Gs + stage * DX_BM * DX_LDG;
#pragma unroll
    for (int i = 0; i < DX_BM * DX_BR / (E * DX_THREADS); ++i) {
      const int c = tid + i * DX_THREADS;
      const int row = c / (DX_BR / E), nc = (c % (DX_BR / E)) * E;
      const bool ok = m0 + row < M && n0 + nc < N;
      const bf16* src = ok ? g + (long long)(m0 + row) * N + n0 + nc : g;
      if constexpr (VEC == 16) simlingo::cp_async16(G + row * DX_LDG + nc, src, ok);
      else simlingo::cp_async4(G + row * DX_LDG + nc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < DX_BR * DX_BN / (16 * DX_THREADS); ++i) {   // 16 codes a copy
      const int c = tid + i * DX_THREADS;
      const int row = c / (DX_BN / 16), col = (c % (DX_BN / 16)) * 16;
      const bool ok = n0 + row < N && k0 + col < K;
      simlingo::cp_async16(Ws + (stage * DX_BR + row) * DX_BN + col,
                           ok ? w + (long long)(n0 + row) * K + k0 + col : w, ok);
    }
    if (tid < DX_BR) {
      const bool ok = n0 + tid < N;
      simlingo::cp_async4(Ss + stage * DX_BR * 4 + tid * 4, ok ? scale + n0 + tid : scale, ok);
    }
  };
  // The cooperative pass: the landed int8 tile of `stage`, dequantized into
  // the bf16 tile `buf`.
  auto dequant = [&](int stage, int buf) {
#pragma unroll
    for (int i = 0; i < DX_BR * DX_BN / (16 * DX_THREADS); ++i) {
      const int c = tid + i * DX_THREADS;
      const int row = c / (DX_BN / 16), col = (c % (DX_BN / 16)) * 16;
      const uint4 q = *reinterpret_cast<const uint4*>(Ws + (stage * DX_BR + row) * DX_BN + col);
      const uint2 a = int8x4_to_bf16x4(q.x), b = int8x4_to_bf16x4(q.y);
      const uint2 cc = int8x4_to_bf16x4(q.z), d = int8x4_to_bf16x4(q.w);
      uint4* o = reinterpret_cast<uint4*>(Bs + (buf * DX_BR + row) * DX_LDB + col);
      o[0] = make_uint4(a.x, a.y, b.x, b.y);
      o[1] = make_uint4(cc.x, cc.y, d.x, d.y);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Step t + 1 is dequantized while step t is multiplied, behind one
  // barrier a step: its loads landed one iteration earlier.
#pragma unroll
  for (int s = 0; s < DX_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    simlingo::cp_async_commit();
  }
  simlingo::cp_async_wait<DX_STAGES - 2>();          // step 0 has landed
  __syncthreads();
  dequant(0, 0);
  for (int t = 0; t < steps; ++t) {
    simlingo::cp_async_wait<DX_STAGES - 3>();        // step t + 1 has landed
    __syncthreads();            // step t is dequantized; step t - 1's buffers are free
    if (t + DX_STAGES - 1 < steps) load((t + DX_STAGES - 1) % DX_STAGES, t + DX_STAGES - 1);
    simlingo::cp_async_commit();
    const bool next = t + 1 < steps;
    const bf16* G = Gs + (t % DX_STAGES) * DX_BM * DX_LDG;
    const bf16* B = Bs + (t & 1) * DX_BR * DX_LDB;
#pragma unroll
    for (int kk = 0; kk < DX_BR / 16; ++kk) {
      // A: the warp's 32 g rows by ldmatrix.x4, then g * scale in fp32
      // rounded to bf16 in registers (JAX's gs, :86); this lane holds
      // reduction columns c0, c0 + 1 and c0 + 8, c0 + 9 of every fragment
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        simlingo::ldmatrix_x4(a[i], G + (wm + i * 16 + (lane & 15)) * DX_LDG + kk * 16 + (lane >> 4) * 8);
      {
        const int c0 = kk * 16 + (lane & 3) * 2;
        const float* S = reinterpret_cast<const float*>(Ss + (t % DX_STAGES) * DX_BR * 4);
        const float2 s01 = *reinterpret_cast<const float2*>(S + c0);
        const float2 s89 = *reinterpret_cast<const float2*>(S + c0 + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = scale_bf16x2(a[i][0], s01); a[i][1] = scale_bf16x2(a[i][1], s01);
          a[i][2] = scale_bf16x2(a[i][2], s89); a[i][3] = scale_bf16x2(a[i][3], s89);
        }
      }
      // B: the warp's 64 columns by ldmatrix.x4.trans, two n8 tiles a load
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        simlingo::ldmatrix_x4_trans(b, B + (kk * 16 + (lane & 15)) * DX_LDB + wn + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          simlingo::mma_bf16_16816(acc[i][2 * j], a[i], b[0], b[1]);
          simlingo::mma_bf16_16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
      // after the step's last products are issued, so that the two overlap
      if (next) {
        if (kk != 0) dequant((t + 1) % DX_STAGES, (t + 1) & 1);
      }
    }
  }

  if (!part) {                  // bf16 out: staged in the g ring, 16 bytes a lane
    __syncthreads();                                   // every warp is done with the ring
    bf16* O = Gs;
    constexpr int LDO = DX_BN + 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm + i * 16 + (lane >> 2) + half * 8, c = wn + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<__nv_bfloat162*>(O + r * LDO + c) =
              __floats2bfloat162_rn(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DX_BM * DX_BN / (8 * DX_THREADS); ++i) {
      const int c = tid + i * DX_THREADS;
      const int r = c / (DX_BN / 8), col = (c % (DX_BN / 8)) * 8;
      if (m0 + r < M && k0 + col < K)                  // K % 16 == 0: whole chunks
        *reinterpret_cast<uint4*>(dx + (long long)(m0 + r) * K + k0 + col) =
            *reinterpret_cast<const uint4*>(O + r * LDO + col);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + (lane >> 2) + half * 8;
        const int col = k0 + wn + j * 8 + (lane & 3) * 2;   // even; K % 16 == 0
        if (row < M && col < K)     // fp32 partial: 8 bytes a lane, 32 a row segment
          *reinterpret_cast<float2*>(part + ((long long)blockIdx.z * M + row) * K + col) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
}

// dx = bf16(sum_s part[s]) over the S fp32 partials, s = 0..S-1 in order;
// four outputs a thread.
__global__ void __launch_bounds__(256)
dx_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dx,
                 long long count, int S) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= count / 4) return;
  float4 a = reinterpret_cast<const float4*>(part)[i];
  for (int s = 1; s < S; ++s) {
    const float4 b = reinterpret_cast<const float4*>(part + s * count)[i];
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  uint2 o;
  o.x = simlingo::pack_bf16x2(a.x, a.y);
  o.y = simlingo::pack_bf16x2(a.z, a.w);
  reinterpret_cast<uint2*>(dx)[i] = o;
}

template <int VEC>
cudaError_t launch_dx(const bf16* g, const int8_t* w, const float* s, float* part, bf16* dx,
                      int M, int N, int K, int seg_steps, int S, cudaStream_t st) {
  // The shared-memory limit above 48 KB is a per-device attribute of the
  // kernel: raised at its first launch on each device.
  static std::atomic<bool> raised[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !raised[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(dx_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) raised[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((K + DX_BN - 1) / DX_BN, (M + DX_BM - 1) / DX_BM, S);
  dx_kernel<VEC><<<grid, DX_THREADS, DX_SMEM, st>>>(g, w, s, part, dx, M, N, K, seg_steps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the fp32 build: M >= 2 and the activation gradient
// ---------------------------------------------------------------------------

constexpr int F32_SPLIT_MAX = 16;    // most reduction segments of the fp32 products

namespace tc = simlingo::tc32;
constexpr int SPLIT_SMEM = tc::smem_bytes<true, true, tc::F32, tc::I8>();   // 98304 bytes
template <int VEC>
constexpr int DX_SPLIT_SMEM = tc::smem_bytes<true, false, tc::Scaled<VEC>, tc::I8>();  // 92672

// The tile (blockIdx.y, blockIdx.x) of y = x w_q^T over K columns [z seg,
// (z + 1) seg), z = blockIdx.z, by the split tile (f32_tc_tile.cuh: x big +
// small in TF32, the codes exact, two mma.sync products a k8-step): with
// part set, the fp32 partial part[z]; else y = the sum times the widened
// scale.
template <typename ST>
__global__ void __launch_bounds__(tc::THREADS, 1)
gemm_split_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const ST* __restrict__ scale, float* __restrict__ part, float* __restrict__ y,
                  int M, int N, int K, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * tc::BN, m0 = blockIdx.y * tc::BM;
  const int z = blockIdx.z, k0 = z * seg, k1 = min(K, k0 + seg);
  float acc[tc::MT][tc::NT][4];
  tc::tile<true, true>(tc::F32{x, K}, M, tc::I8{w, K}, N, m0, n0, k0, k1, smem, acc);
#pragma unroll
  for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < tc::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + tc::row_of(mt, e), col = n0 + tc::col_of(nt, e);
        if (row >= M || col >= N) continue;
        if (part != nullptr)
          part[(static_cast<long long>(z) * M + row) * N + col] = acc[mt][nt][e];
        else
          y[static_cast<long long>(row) * N + col] = acc[mt][nt][e] * widen(scale[col]);
      }
}

// The tile (blockIdx.y, blockIdx.x) of dx = (g * scale) w_q over the weight
// rows [z seg, (z + 1) seg), z = blockIdx.z, by the split tile: g * scale
// rounded once in fp32 and split into big + small in TF32, the codes
// exact and staged k-major, two mma.sync products a k8-step. g's rows lie
// ldg floats apart and are copied VEC bytes at a time. With part set, the
// fp32 partial part[z]; else dx. 8 bytes a store (K % 16 == 0).
template <int VEC>
__global__ void __launch_bounds__(tc::THREADS, 1)
dx_split_kernel(const float* __restrict__ g, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ part, float* __restrict__ dx,
                int M, int N, int K, long long ldg, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * tc::BN, m0 = blockIdx.y * tc::BM;
  const int z = blockIdx.z, r0 = z * seg, r1 = min(N, r0 + seg);
  float acc[tc::MT][tc::NT][4];
  tc::tile<true, false>(tc::Scaled<VEC>{g, ldg, scale}, M, tc::I8{w, K}, K, m0, n0, r0, r1, smem,
                        acc);
  float* out = part != nullptr ? part + static_cast<long long>(z) * M * K : dx;
#pragma unroll
  for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + tc::row_of(mt, 2 * half);
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < tc::NT; ++nt) {
        const int col = n0 + tc::col_of(nt, 0);       // even
        if (col < K)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * K + col) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

// The shared-memory limit above 48 KB is a per-device attribute of a
// kernel: raised at its first launch on each device.
cudaError_t raise_smem(const void* kernel, int bytes, std::atomic<bool>* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && raised[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) raised[dev].store(true, std::memory_order_relaxed);
  return e;
}

// The split's second pass: out = sum_s part[s] (times the scale, where given).
template <typename ST>
cudaError_t reduce_f32(const float* part, const ST* scale, float* out, int rows, int cols, int S,
                       cudaStream_t st) {
  const long long count = static_cast<long long>(rows) * cols;
  long long blocks = (count + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  tc::f32_reduce_kernel<ST><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      part, scale, out, count, cols, S);
  return cudaGetLastError();
}

template <typename ST>
cudaError_t run_forward_f32(const float* x, const int8_t* w, const ST* s, float* part, float* y,
                            int M, int N, int K, int S, int seg, cudaStream_t st) {
  if (S < 1 || S > F32_SPLIT_MAX || seg < 1 || seg % tc::BK != 0 || K % 16 != 0 ||
      (S > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t e = raise_smem(reinterpret_cast<const void*>(gemm_split_kernel<ST>), SPLIT_SMEM,
                             raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM, S);
  gemm_split_kernel<ST><<<grid, tc::THREADS, SPLIT_SMEM, st>>>(
      x, w, s, S > 1 ? part : nullptr, y, M, N, K, seg);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  return reduce_f32<ST>(part, s, y, M, N, S, st);
}

template <int VEC>
cudaError_t run_dx_f32(const float* g, const int8_t* w, const float* s, float* part, float* dx,
                       int M, int N, int K, long long ldg, int S, int seg, cudaStream_t st) {
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t e = raise_smem(reinterpret_cast<const void*>(dx_split_kernel<VEC>),
                             DX_SPLIT_SMEM<VEC>, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((K + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM, S);
  dx_split_kernel<VEC><<<grid, tc::THREADS, DX_SPLIT_SMEM<VEC>, st>>>(
      g, w, s, S > 1 ? part : nullptr, dx, M, N, K, ldg, seg);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  return reduce_f32<float>(part, nullptr, dx, M, K, S, st);
}

template <typename ST>
cudaError_t run_forward(const bf16* x, const int8_t* w, const ST* s, bf16* y,
                        int M, int N, int K, int S, int seg_steps, cudaStream_t st) {
  if (M < 2) return cudaErrorInvalidValue;          // M = 1: simlingo_int8_gemv
  if (M <= SMALL_M) return launch_gemm<ST>(x, w, s, y, M, N, K, S, seg_steps, st);
  return launch_gemm64<ST>(x, w, s, y, M, N, K, S, seg_steps, st);
}

}  // namespace

// y[M,N] = bf16((x[M,K] . w_q[N,K]^T) * scale[N]); the scale fp32, or bf16
// with scale_bf16 set. M >= 2: the reduction in S segments of seg_steps
// steps each (the wrapper's plan, S <= 8; S = 1, seg_steps >= the steps of
// K: no split). M = 1 is refused: it takes simlingo_int8_gemv.
extern "C" int simlingo_int8_matmul(const void* x_, const void* w_, const void* s_,
                                    void* y_, int M, int N, int K, int scale_bf16,
                                    int S, int seg_steps, void* stream) {
  const auto* x = static_cast<const bf16*>(x_);
  const auto* w = static_cast<const int8_t*>(w_);
  auto* y = static_cast<bf16*>(y_);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      scale_bf16 ? run_forward(x, w, static_cast<const bf16*>(s_), y, M, N, K, S, seg_steps, st)
                 : run_forward(x, w, static_cast<const float*>(s_), y, M, N, K, S, seg_steps, st);
  return static_cast<int>(e);
}

// y[N] = bf16((x[K] . w_q[N,K]^T) * scale[N]), M = 1, on the wrapper's plan:
// R rows a warp, `warps` K slices a block, `blocks` row-group blocks (see
// gemv_kernel). K % 16 == 0, x and w_q 16-byte aligned (the wrapper
// checks).
extern "C" int simlingo_int8_gemv(const void* x_, const void* w_, const void* s_, void* y_,
                                  int N, int K, int scale_bf16, int x_fp32, int R, int warps,
                                  int blocks, void* stream) {
  const auto* w = static_cast<const int8_t*>(w_);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_fp32) {              // fp32 x and y
    const auto* x = static_cast<const float*>(x_);
    auto* y = static_cast<float*>(y_);
    e = scale_bf16 ? launch_gemv(x, w, static_cast<const bf16*>(s_), y, N, K, R, warps, blocks, st)
                   : launch_gemv(x, w, static_cast<const float*>(s_), y, N, K, R, warps, blocks, st);
  } else {
    const auto* x = static_cast<const bf16*>(x_);
    auto* y = static_cast<bf16*>(y_);
    e = scale_bf16 ? launch_gemv(x, w, static_cast<const bf16*>(s_), y, N, K, R, warps, blocks, st)
                   : launch_gemv(x, w, static_cast<const float*>(s_), y, N, K, R, warps, blocks, st);
  }
  return static_cast<int>(e);
}

// The fp32 build, M >= 2: y[M,N] = (x[M,K] . w_q[N,K]^T) * scale[N], x and y
// fp32, the scale fp32 or bf16 (scale_bf16), on the split tile. K % 16 ==
// 0, x and w_q 16-byte aligned (the wrapper pads and checks). S segments of
// seg K columns (the wrapper's plan, S <= 16, seg a multiple of 32): with S
// > 1 the blocks write fp32 partials to part [S, M, N], which
// f32_reduce_kernel sums.
extern "C" int simlingo_int8_matmul_f32(const void* x_, const void* w_, const void* s_,
                                        void* part_, void* y_, int M, int N, int K,
                                        int scale_bf16, int S, int seg, void* stream) {
  const auto* x = static_cast<const float*>(x_);
  const auto* w = static_cast<const int8_t*>(w_);
  auto* part = static_cast<float*>(part_);
  auto* y = static_cast<float*>(y_);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      scale_bf16
          ? run_forward_f32(x, w, static_cast<const bf16*>(s_), part, y, M, N, K, S, seg, st)
          : run_forward_f32(x, w, static_cast<const float*>(s_), part, y, M, N, K, S, seg, st);
  return static_cast<int>(e);
}

// The fp32 build of the activation gradient: dx[M,K] = (g[M,N] * scale[N])
// . w_q[N,K], g, the scale and dx fp32, on the split tile. g's rows lie ldg
// >= N floats apart and are copied vec bytes at a time (16, 8 or 4: ldg a
// multiple of vec / 4, g vec-aligned); the scale 16-byte aligned; K % 16
// == 0, w_q 16-byte aligned (the wrapper pads and checks). S segments of
// seg weight rows (the wrapper's plan, `_split_plan` with (M, K, N): S <=
// 16, seg a multiple of 32): with S > 1 the blocks write fp32 partials to
// part [S, M, K], which f32_reduce_kernel sums.
extern "C" int simlingo_int8_matmul_dx_f32(const void* g_, const void* w_, const void* s_,
                                           void* part_, void* dx_, int M, int N, int K,
                                           long long ldg, int vec, int S, int seg,
                                           void* stream) {
  const auto* g = static_cast<const float*>(g_);
  const auto* w = static_cast<const int8_t*>(w_);
  const auto* s = static_cast<const float*>(s_);
  auto* part = static_cast<float*>(part_);
  auto* dx = static_cast<float*>(dx_);
  auto st = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<uintptr_t>(g);
  if (S < 1 || S > F32_SPLIT_MAX || seg < 1 || seg % tc::BK != 0 || K % 16 != 0 || ldg < N ||
      (vec != 16 && vec != 8 && vec != 4) || ldg % (vec / 4) != 0 || addr % vec != 0 ||
      reinterpret_cast<uintptr_t>(s) % 16 != 0 || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      vec == 16 ? run_dx_f32<16>(g, w, s, part, dx, M, N, K, ldg, S, seg, st)
      : vec == 8 ? run_dx_f32<8>(g, w, s, part, dx, M, N, K, ldg, S, seg, st)
                 : run_dx_f32<4>(g, w, s, part, dx, M, N, K, ldg, S, seg, st);
  return static_cast<int>(e);
}

// The fp32 products' geometry, which the wrapper's plan (`_split_plan`) is
// made for: tile rows and columns, the reduction step, the most segments,
// blocks an SM, stages of the ring.
extern "C" void simlingo_int8_split_geometry(int* out) {
  out[0] = tc::BM;
  out[1] = tc::BN;
  out[2] = tc::BK;
  out[3] = F32_SPLIT_MAX;
  out[4] = 1;
  out[5] = tc::STAGES;
}

// The forward's geometry, which the wrapper's plan is made for: for the
// 16-row (gemm_kernel) and the 64-row (gemm64_kernel) variant each, output
// tile rows and columns, reduction step (K columns) and blocks an SM that a
// split fills; then the cluster cap and the largest M of the 16-row variant;
// then the GEMV's most warps a block, most rows a warp and K columns a load.
extern "C" void simlingo_int8_matmul_geometry(int* out) {
  const int g[13] = {BM, BN, BK, SMALL_RESIDENT, T_BM, T_BN, T_BK, LARGE_FILL,
                     MAX_CLUSTER, SMALL_M, GEMV_MAX_WARPS, GEMV_MAX_ROWS, GEMV_CHUNK};
  for (int i = 0; i < 13; ++i) out[i] = g[i];
}

// dx_kernel's geometry, which the wrapper's plan is made for: output tile
// rows and columns, weight rows a reduction step, resident blocks an SM.
extern "C" void simlingo_int8_matmul_dx_geometry(int* out) {
  out[0] = DX_BM;
  out[1] = DX_BN;
  out[2] = DX_BR;
  out[3] = DX_RESIDENT;
}

// dx[M,K] = bf16(g[M,N] * scale[N]) . w_q[N,K], g row-major [M, N]. vec16:
// g rows may be copied 16 bytes at a time (N % 8 == 0, g 16-byte aligned),
// else 4 (N even, g 4-byte aligned). K % 16 == 0, w_q 16-byte aligned (the
// wrapper checks). S segments of seg_steps reduction steps each: with S > 1
// the blocks write fp32 partials to part [S, M, K] and dx_reduce_kernel
// sums them; with S == 1 part may be null and is unused.
extern "C" int simlingo_int8_matmul_dx(const void* g_, const void* w_, const void* s_,
                                       void* part_, void* dx_, int M, int N, int K,
                                       int vec16, int S, int seg_steps, void* stream) {
  const auto* g = static_cast<const bf16*>(g_);
  const auto* w = static_cast<const int8_t*>(w_);
  const auto* s = static_cast<const float*>(s_);
  auto* part = S > 1 ? static_cast<float*>(part_) : nullptr;
  auto* dx = static_cast<bf16*>(dx_);
  auto st = static_cast<cudaStream_t>(stream);
  if (S > 1 && !part) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = vec16 ? launch_dx<16>(g, w, s, part, dx, M, N, K, seg_steps, S, st)
                              : launch_dx<4>(g, w, s, part, dx, M, N, K, seg_steps, S, st);
  if (e != cudaSuccess || S == 1) return static_cast<int>(e);
  const long long count = static_cast<long long>(M) * K;
  dx_reduce_kernel<<<static_cast<unsigned>((count / 4 + 255) / 256), 256, 0, st>>>(part, dx, count, S);
  return static_cast<int>(cudaGetLastError());
}
