// Flash attention backward for Hopper (sm_90a): dQ, dK, dV from the saved
// output O and the forward's base-2 log-sum-exp. bf16 in and out, fp32
// accumulation.
//
// Replaces the Pallas TPU backward kernels of
// simlingo_tpu/kernels/flash_attention.py: _bwd_kernel_gqa (:382, the Qwen2
// LLM: GQA with dK/dV summed over the 7-head group inside the kernel),
// _bwd_kernel_pair (:869, the InternViT read from the flat [B,T,H*D]
// projections) and _bwd_kernel (:205, head-major MHA). It takes the
// forward kernel's conventions (flash_attn_fwd.cu): q/k/v are strided
// [B, L, H, 64] views, query head h reads kv head h / (HQ / HK), causality
// is slot-order with q_offset, kv_valid is uint8 [B, S].
//
// Math (P recomputed, never stored): with s = q.k * scale * log2(e),
//   P = exp2(s - lse),  delta = rowsum(dO * O),  dP = dO V^T,
//   dS = P * (dP - delta),  dV = P^T dO,  dQ = scale dS K,  dK = scale dS^T Q.
// A row that sees no valid key has lse = -inf and contributes exactly 0
// (its lse is read as +inf, so P = 0): that is attention_reference's VJP.
//
// Three launches, no atomics, so results do not change from run to run:
//   1. prep: delta[b, h, t] = rowsum(dO * O) in fp32, one warp per row;
//   2. dK/dV: one block of 4 warps per (batch, kv head, 64-key tile); each
//      warp owns 16 keys, holds their K and V rows as mma A-fragments and
//      dK, dV in fp32 registers. The block loops over the group's query
//      heads and over the 64-row query tiles that can see its keys, with
//      Q, dO, lse and delta double-buffered in shared memory by cp.async.
//      It computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T sit in
//      the accumulators in exactly the A-fragment layout that dV += P^T dO
//      and dK += dS^T Q need (B-fragments by ldmatrix.trans, as the
//      forward's P V). Key tiles with no valid key write zeros at once.
//   3. dQ: one block per (batch, query head, 64-row query tile), the
//      forward's structure: Q and dO rows in registers, K and V tiles
//      double-buffered, dQ += dS K in fp32 registers.
//
// What bounds it: tensor-core operations -- 5 products of 2*T*S*D each per
// head (S and dP are computed twice, once in each kernel), 2.5x the
// forward's 4*T*S*D. The dK/dV grid of the LLM is small: 6 * 2 * 13 = 156
// blocks on 132 SMs, each walking 7 heads x up to 13 query tiles serially;
// splitting the group across blocks (and reducing dK/dV afterwards) is the
// fix, left for a later change.

#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int BQ = 64;          // query rows per tile
constexpr int BKV = 64;         // keys per tile
constexpr int LDK = D + 8;      // padded smem rows: conflict-free fragment loads

using bf16 = __nv_bfloat16;
using simlingo::ld32;

__device__ __forceinline__ float lse_as_read(float lse) {
  // a row that sees no valid key (lse = -inf) must give P = 0
  return lse == -INFINITY ? INFINITY : lse;
}

// delta[b, h, t] = sum_d dO * O; dO and O contiguous [B, T, HQ, D]
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                float* __restrict__ delta, int T, int HQ, long long rows) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);   // (b, t, h)
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat162 ov = reinterpret_cast<const __nv_bfloat162*>(o + row * D)[lane];
  const __nv_bfloat162 dv = reinterpret_cast<const __nv_bfloat162*>(dout + row * D)[lane];
  float acc = __bfloat162float(ov.x) * __bfloat162float(dv.x) +
              __bfloat162float(ov.y) * __bfloat162float(dv.y);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int h = static_cast<int>(row % HQ);
    const long long bt = row / HQ;
    const long long b = bt / T, t = bt % T;
    delta[(b * HQ + h) * T + t] = acc;
  }
}

__global__ void __launch_bounds__(128)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int T, int S, int HQ, int HK,
                long long sqb, long long sqt, long long sqh,
                long long skb, long long sks, long long skh,
                long long svb, long long svs, long long svh,
                int causal, int q_offset, float scale, float scale_log2) {
  __shared__ __align__(16) bf16 Qs[2][BQ * LDK];     // [query][d]
  __shared__ __align__(16) bf16 dOs[2][BQ * LDK];    // [query][d]
  __shared__ float lse_s[2][BQ];
  __shared__ float delta_s[2][BQ];

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = HQ / HK;
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
  // causal: the first query row that sees key k0 is k0 - q_offset
  const int row_lo = causal ? max(0, k0 - q_offset) : 0;
  const int qt_lo = row_lo / BQ;
  const int n_qt = row_lo < T ? (T + BQ - 1) / BQ - qt_lo : 0;
  const int any_key = __syncthreads_or(key_ok[0] || key_ok[1]);
  const int n_it = any_key ? group * n_qt : 0;

  float dkacc[8][4], dvacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;

  if (n_it > 0) {
    uint32_t kf[4][4], vf[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c = ks * 16 + t4 * 2;
      const bool r0 = key0 < S, r1 = key0 + 8 < S;
      kf[ks][0] = r0 ? ld32(kb + key0 * sks + c) : 0u;
      kf[ks][1] = r1 ? ld32(kb + (key0 + 8) * sks + c) : 0u;
      kf[ks][2] = r0 ? ld32(kb + key0 * sks + c + 8) : 0u;
      kf[ks][3] = r1 ? ld32(kb + (key0 + 8) * sks + c + 8) : 0u;
      vf[ks][0] = r0 ? ld32(vb + key0 * svs + c) : 0u;
      vf[ks][1] = r1 ? ld32(vb + (key0 + 8) * svs + c) : 0u;
      vf[ks][2] = r0 ? ld32(vb + key0 * svs + c + 8) : 0u;
      vf[ks][3] = r1 ? ld32(vb + (key0 + 8) * svs + c + 8) : 0u;
    }

    // stage query tile `it`: (head, tile) = (hk * group + it / n_qt, qt_lo + it % n_qt)
    auto load_tile = [&](int stage, int it) {
      const int h = hk * group + it / n_qt;
      const int q0 = (qt_lo + it % n_qt) * BQ;
      const bf16* qb = q + b * sqb + h * sqh;
      const bf16* db = dout + ((long long)b * T * HQ + h) * D;
      for (int c = tid; c < BQ * (D / 8); c += 128) {
        const int row = c >> 3, dc = (c & 7) * 8, t = q0 + row;
        const bool in = t < T;
        simlingo::cp_async16(&Qs[stage][row * LDK + dc], in ? qb + t * sqt + dc : qb, in);
        simlingo::cp_async16(&dOs[stage][row * LDK + dc],
                             in ? db + (long long)t * HQ * D + dc : db, in);
      }
      if (tid < BQ) {
        const int t = q0 + tid;
        const long long i = ((long long)b * HQ + h) * T + t;
        lse_s[stage][tid] = t < T ? lse_as_read(lse[i]) : INFINITY;
        delta_s[stage][tid] = t < T ? delta[i] : 0.f;
      }
    };
    load_tile(0, 0);
    simlingo::cp_async_commit();

    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      const int q0 = (qt_lo + it % n_qt) * BQ;
      if (it + 1 < n_it) load_tile(st ^ 1, it + 1);
      simlingo::cp_async_commit();
      simlingo::cp_async_wait<1>();
      __syncthreads();
      const bf16* Qt = Qs[st];
      const bf16* dOt = dOs[st];

      // S^T = K Q^T and dP^T = V dO^T over 64 queries: 8 n-tiles of 8
      float sc[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const bf16* qp = &Qt[(nt * 8 + g) * LDK + ks * 16 + t4 * 2];
          simlingo::mma_bf16_16816(sc[nt], kf[ks], ld32(qp), ld32(qp + 8));
          const bf16* dp_ = &dOt[(nt * 8 + g) * LDK + ks * 16 + t4 * 2];
          simlingo::mma_bf16_16816(dp[nt], vf[ks], ld32(dp_), ld32(dp_ + 8));
        }
      }
      // P^T and dS^T in place: row = key (g, g+8), column = query
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = nt * 8 + t4 * 2 + (j & 1);
          const int key = key0 + (j >> 1) * 8;
          const bool ok = key_ok[j >> 1] && (!causal || key <= q0 + col + q_offset);
          const float p = ok ? exp2f(sc[nt][j] * scale_log2 - lse_s[st][col]) : 0.f;
          sc[nt][j] = p;
          dp[nt][j] = p * (dp[nt][j] - delta_s[st][col]);
        }
      // dV += P^T dO and dK += dS^T Q: n-tiles (2kk, 2kk+1) of the
      // accumulators are the A-fragment of queries [16kk, 16kk+16)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = simlingo::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = simlingo::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = simlingo::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = simlingo::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        sa[0] = simlingo::pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        sa[1] = simlingo::pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        sa[2] = simlingo::pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        sa[3] = simlingo::pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          uint32_t b0, b1;
          simlingo::ldmatrix_x2_trans(b0, b1, &dOt[(kk * 16 + (lane & 15)) * LDK + dt * 8]);
          simlingo::mma_bf16_16816(dvacc[dt], pa, b0, b1);
          simlingo::ldmatrix_x2_trans(b0, b1, &Qt[(kk * 16 + (lane & 15)) * LDK + dt * 8]);
          simlingo::mma_bf16_16816(dkacc[dt], sa, b0, b1);
        }
      }
      __syncthreads();                 // stage `st` is reloaded next iteration
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= S) continue;
    bf16* dkrow = dk + (((long long)b * S + key) * HK + hk) * D;
    bf16* dvrow = dv + (((long long)b * S + key) * HK + hk) * D;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dkrow + dt * 8 + t4 * 2) = simlingo::pack_bf16x2(
          dkacc[dt][2 * r] * scale, dkacc[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvrow + dt * 8 + t4 * 2) = simlingo::pack_bf16x2(
          dvacc[dt][2 * r], dvacc[dt][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(128)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq,
              int T, int S, int HQ, int HK,
              long long sqb, long long sqt, long long sqh,
              long long skb, long long sks, long long skh,
              long long svb, long long svs, long long svh,
              int causal, int q_offset, float scale, float scale_log2) {
  __shared__ __align__(16) bf16 Ks[2][BKV * LDK];   // [key][d]
  __shared__ __align__(16) bf16 Vs[2][BKV * LDK];   // [key][d]
  __shared__ uint8_t key_ok[2][BKV];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;              // this thread's rows: row0, row0+8
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* db = dout + ((long long)b * T * HQ + h) * D;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;
  const long long dstride = (long long)HQ * D;

  uint32_t qf[4][4], df[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + t4 * 2;
    const bool r0 = row0 < T, r1 = row0 + 8 < T;
    qf[ks][0] = r0 ? ld32(qb + row0 * sqt + c) : 0u;
    qf[ks][1] = r1 ? ld32(qb + (row0 + 8) * sqt + c) : 0u;
    qf[ks][2] = r0 ? ld32(qb + row0 * sqt + c + 8) : 0u;
    qf[ks][3] = r1 ? ld32(qb + (row0 + 8) * sqt + c + 8) : 0u;
    df[ks][0] = r0 ? ld32(db + row0 * dstride + c) : 0u;
    df[ks][1] = r1 ? ld32(db + (row0 + 8) * dstride + c) : 0u;
    df[ks][2] = r0 ? ld32(db + row0 * dstride + c + 8) : 0u;
    df[ks][3] = r1 ? ld32(db + (row0 + 8) * dstride + c + 8) : 0u;
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const long long i = ((long long)b * HQ + h) * T + row;
    lse_r[r] = row < T ? lse_as_read(lse[i]) : INFINITY;
    delta_r[r] = row < T ? delta[i] : 0.f;
  }

  int kv_end = S;
  if (causal) {
    const int last_row = min(q0 + BQ, T) - 1;
    kv_end = min(S, q_offset + last_row + 1);
  }
  const int ntiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  const int qslot[2] = {q_offset + row0, q_offset + row0 + 8};

  float dqacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqacc[i][j] = 0.f;

  auto load_tile = [&](int stage, int kv0) {
    for (int c = tid; c < BKV * (D / 8); c += 128) {
      const int key = c >> 3, dc = (c & 7) * 8, s = kv0 + key;
      const bool in = s < S;
      simlingo::cp_async16(&Ks[stage][key * LDK + dc], in ? kb + s * sks + dc : kb, in);
      simlingo::cp_async16(&Vs[stage][key * LDK + dc], in ? vb + s * svs + dc : vb, in);
    }
    if (tid < BKV) {
      const int s = kv0 + tid;
      key_ok[stage][tid] = (s < S) && (kv_valid == nullptr || kv_valid[(long long)b * S + s]);
    }
  };
  if (ntiles > 0) load_tile(0, 0);
  simlingo::cp_async_commit();

  for (int it = 0; it < ntiles; ++it) {
    const int kv0 = it * BKV, st = it & 1;
    if (it + 1 < ntiles) load_tile(st ^ 1, kv0 + BKV);
    simlingo::cp_async_commit();
    simlingo::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks[st];
    const bf16* Vt = Vs[st];
    const uint8_t* ok_t = key_ok[st];

    // S = Q K^T and dP = dO V^T for 64 keys: 8 n-tiles of 8 keys
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bf16* kp = &Kt[(nt * 8 + g) * LDK + ks * 16 + t4 * 2];
        simlingo::mma_bf16_16816(sc[nt], qf[ks], ld32(kp), ld32(kp + 8));
        const bf16* vp = &Vt[(nt * 8 + g) * LDK + ks * 16 + t4 * 2];
        simlingo::mma_bf16_16816(dp[nt], df[ks], ld32(vp), ld32(vp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = nt * 8 + t4 * 2 + (j & 1);
        const bool ok = ok_t[key] && (!causal || kv0 + key <= qslot[j >> 1]);
        const float p = ok ? exp2f(sc[nt][j] * scale_log2 - lse_r[j >> 1]) : 0.f;
        dp[nt][j] = p * (dp[nt][j] - delta_r[j >> 1]);
      }
    // dQ += dS K: n-tiles (2kk, 2kk+1) of dS are the A-fragment of keys
    // [16kk, 16kk+16); K^T's B-fragments come from the row-major K tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = simlingo::pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
      a[1] = simlingo::pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
      a[2] = simlingo::pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      a[3] = simlingo::pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t b0, b1;
        simlingo::ldmatrix_x2_trans(b0, b1, &Kt[(kk * 16 + (lane & 15)) * LDK + dt * 8]);
        simlingo::mma_bf16_16816(dqacc[dt], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    bf16* drow = dq + (((long long)b * T + row) * HQ + h) * D;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<uint32_t*>(drow + dt * 8 + t4 * 2) = simlingo::pack_bf16x2(
          dqacc[dt][2 * r] * scale, dqacc[dt][2 * r + 1] * scale);
  }
}

}  // namespace

// delta: fp32 scratch [B, HQ, T] allocated by the caller; lse [B, HQ, T]
// from the forward; o, dout, dq contiguous [B, T, HQ, 64]; dk, dv
// contiguous [B, S, HK, 64].
extern "C" int simlingo_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* o, const void* dout, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int B, int T, int S, int HQ, int HK,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    int causal, int q_offset, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const long long rows = (long long)B * T * HQ;
  bwd_prep_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), T, HQ, rows);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dkdv_kernel<<<dim3((S + BKV - 1) / BKV, HK, B), 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, S, HQ, HK, sqb, sqt, sqh, skb, sks, skh,
      svb, svs, svh, causal, q_offset, scale, scale_log2);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dq_kernel<<<dim3((T + BQ - 1) / BQ, HQ, B), 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      T, S, HQ, HK, sqb, sqt, sqh, skb, sks, skh, svb, svs, svh,
      causal, q_offset, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
