// Flash attention forward for Hopper (sm_90a), bf16 in/out, fp32 softmax.
//
// Replaces the Pallas TPU forward kernels of
// simlingo_tpu/kernels/flash_attention.py: _fwd_kernel_gqa (:308, the Qwen2
// LLM: GQA, slot-order causality with a dynamic q_offset, kv_valid mask),
// _fwd_kernel_pair (:786, the InternViT read from the flat [B,T,H*D]
// projection) and _fwd_kernel (:114, plain MHA). One kernel serves them all:
// q/k/v come as strided [B, L, H, 64] views, so ViT projections and the KV
// cache are read in place.
//
// What bounds it: the prefill (T=640, S=770) and ViT (T=S=1025) calls are
// bound by tensor-core operations (4*T*S*D per head); decode (T=1..30) by
// reading the K/V cache bytes and by launch latency.
//
// Design (no TMA / wgmma yet): one block of 4 warps per (batch, query
// head, 64-row query tile); each warp owns 16 query rows. Q lives in
// registers as mma.m16n8k16 A-fragments. K and V tiles of 64 keys are
// double-buffered in shared memory with cp.async, so the next tile loads
// while this one is multiplied; P*V's B-fragments come from the row-major V
// tile through ldmatrix.trans. S = Q K^T and O += P V run on the tensor
// cores, and the online softmax (base 2, fp32) works on the S accumulators
// in registers. Rows with no visible valid key return 0 (the Pallas kernel
// left finite garbage there). Causal blocks stop at the last key tile their
// rows see.
//
// Training also asks for the base-2 log-sum-exp of each row's scaled
// logits (lse [B, HQ, T] fp32; -inf for a row that sees no valid key),
// which the backward (flash_attn_bwd.cu) uses to recompute P. Serving
// passes a null lse pointer and the kernel's work is unchanged.

#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // keys per shared-memory tile
constexpr int LDK = D + 8;      // padded rows: conflict-free fragment loads

using bf16 = __nv_bfloat16;
using simlingo::ld32;

__global__ void __launch_bounds__(128)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int S, int HQ, int HK,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long sks, long long skh,
                 long long svb, long long svs, long long svh,
                 int causal, int q_offset, float scale_log2) {
  __shared__ __align__(16) bf16 Ks[2][BKV * LDK];   // [key][d]
  __shared__ __align__(16) bf16 Vs[2][BKV * LDK];   // [key][d]
  __shared__ uint8_t key_ok[2][BKV];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;           // this thread's rows: row0, row0+8
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + t4 * 2;
    const bool r0 = row0 < T, r1 = row0 + 8 < T;
    qf[ks][0] = r0 ? ld32(qb + row0 * sqt + c) : 0u;
    qf[ks][1] = r1 ? ld32(qb + (row0 + 8) * sqt + c) : 0u;
    qf[ks][2] = r0 ? ld32(qb + row0 * sqt + c + 8) : 0u;
    qf[ks][3] = r1 ? ld32(qb + (row0 + 8) * sqt + c + 8) : 0u;
  }

  int kv_end = S;
  if (causal) {
    const int last_row = min(q0 + BQ, T) - 1;
    kv_end = min(S, q_offset + last_row + 1);
  }
  const int ntiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  const int qslot[2] = {q_offset + row0, q_offset + row0 + 8};

  float oacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // stage a tile of 64 keys: K and V by cp.async (zero-filled past S),
  // key validity by plain loads
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
    if (it + 1 < ntiles) load_tile(st ^ 1, kv0 + BKV);   // overlaps this tile
    simlingo::cp_async_commit();
    simlingo::cp_async_wait<1>();                          // tile `it` landed
    __syncthreads();
    const bf16* Kt = Ks[st];
    const bf16* Vt = Vs[st];
    const uint8_t* ok_t = key_ok[st];

    // S = Q K^T for 64 keys: 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bf16* kp = &Kt[(nt * 8 + g) * LDK + ks * 16 + t4 * 2];
        simlingo::mma_bf16_16816(sc[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = nt * 8 + t4 * 2 + (j & 1);
        const bool ok = ok_t[key] && (!causal || kv0 + key <= qslot[j >> 1]);
        const float x = ok ? sc[nt][j] * scale_log2 : -INFINITY;
        sc[nt][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
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
    for (int dt = 0; dt < 8; ++dt) {
      oacc[dt][0] *= alpha[0]; oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1]; oacc[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles (2kk, 2kk+1) are exactly the
    // A-fragment of keys [16kk, 16kk+16)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = simlingo::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = simlingo::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = simlingo::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = simlingo::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t b0, b1;
        simlingo::ldmatrix_x2_trans(
            b0, b1, &Vt[(kk * 16 + (lane & 15)) * LDK + dt * 8]);
        simlingo::mma_bf16_16816(oacc[dt], a, b0, b1);
      }
    }
    __syncthreads();                 // stage `st` is reloaded next iteration
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;             // no visible key -> 0
    const int row = row0 + r * 8;
    if (lse != nullptr && t4 == 0 && row < T)
      lse[((long long)b * HQ + h) * T + row] =
          l > 0.f ? m_run[r] + log2f(l) : -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    bf16* orow = o + (((long long)b * T + row) * HQ + h) * D;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const uint32_t val = simlingo::pack_bf16x2(oacc[dt][2 * r] * inv[r],
                                                 oacc[dt][2 * r + 1] * inv[r]);
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t4 * 2) = val;
    }
  }
}

}  // namespace

extern "C" int simlingo_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid, void* o,
    void* lse, int B, int T, int S, int HQ, int HK,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    int causal, int q_offset, float scale, void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, HQ, B);
  flash_fwd_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<bf16*>(o), static_cast<float*>(lse), T, S, HQ, HK, sqb, sqt, sqh, skb, sks, skh,
      svb, svs, svh, causal, q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
