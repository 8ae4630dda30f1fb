// Fused flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_fused_kernel` launched by
// `_flash_backward_fused` (ray_tpu/ops/attention.py:302, pallas_call
// at :489).
//
// What it computes, from one S/P per tile (q2 pre-scaled by
// scale*log2(e), lse in the log2 domain, delta = rowsum(out * do)):
//   P  = exp2(q2 k^T - lse)                 (masked entries 0)
//   dv = P^T do
//   dS = P * (do v^T - delta)               rounded to bf16
//   dk = (dS^T q2) * ln2                    (ln2 * log2e == 1)
//   dq = (dS k) * scale                     accumulated in f32
// Masks: KV columns >= kv_len, q rows >= q_len, and if causal
// column > row (top-left aligned).
//
// Bound on an H100 SXM: operations. Five products of 2*d FLOP per
// unmasked (q, kv) pair: at the training shape (bh 64, t = tk = 4096,
// d 128, causal) 6.87e11 FLOP, 0.69 ms at 989 TFLOP/s bf16; the bytes
// (q2, k, v, do, dk, dv in bf16, dq in f32, lse and delta) are 0.54 GB,
// 0.16 ms at 3.35 TB/s.
//
// Design: one block of 4 warps per (bh, 64-row KV tile), K and V
// resident in shared memory, dk and dv accumulated in f32 registers
// (each warp owns 16 KV rows). The block loops over q tiles from the
// causal start; this loop replaces the TPU's sequential grid axis. The
// TPU accumulates dq through an aliased HBM buffer revisited in grid
// order; blocks on the GPU run in no order, so each block adds its
// tile's dq into an f32 [bh, t, d] buffer with atomicAdd (the wrapper
// zeroes it). dS^T goes through shared memory once so each warp can
// form 16 rows of dS k. KV tiles are scheduled heaviest first (the
// lowest tiles see the most q tiles under the causal mask).
// Later work: wgmma, TMA-fed rings, and a dq pass that needs no atomics.
#include "flash_common.cuh"

namespace rtt {

template <int D>
struct BwdSmem {
  static constexpr int LD = Pitch<D>::value;
  static constexpr int LDS = BLOCK + 8;  // pitch of the dS^T tile
  static constexpr int bytes =
      4 * BLOCK * LD * 2 + BLOCK * LDS * 2 + 2 * BLOCK * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int t, int tk, int kv_len, int q_len,
                 int causal, float scale) {
  constexpr int LD = BwdSmem<D>::LD;
  constexpr int LDS = BwdSmem<D>::LDS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BLOCK * LD;
  bf16* sQ = sV + BLOCK * LD;
  bf16* sO = sQ + BLOCK * LD;  // the do tile
  bf16* sS = sO + BLOCK * LD;  // dS^T [kv][q]
  float* sL = reinterpret_cast<float*>(sS + BLOCK * LDS);
  float* sD = sL + BLOCK;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int k0 = kt * BLOCK;
  const int r0 = warp * 16 + g;  // this thread's first KV row in the tile
  const int kv_row0 = k0 + r0;
  const int kv_row1 = kv_row0 + 8;
  const size_t kv_off = (static_cast<size_t>(bh) * tk + k0) * D;

  load_tile<D>(sK, k + kv_off);
  load_tile<D>(sV, v + kv_off);

  float dK[D / 8][4], dV[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dK[dt][0] = dK[dt][1] = dK[dt][2] = dK[dt][3] = 0.f;
    dV[dt][0] = dV[dt][1] = dV[dt][2] = dV[dt][3] = 0.f;
  }

  const int nq = (q_len + BLOCK - 1) / BLOCK;
  for (int i = causal ? kt : 0; i < nq; ++i) {
    const int q0 = i * BLOCK;
    const size_t q_off = (static_cast<size_t>(bh) * t + q0) * D;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<D>(sQ, q2 + q_off);
    load_tile<D>(sO, dout + q_off);
    if (threadIdx.x < BLOCK) {
      sL[threadIdx.x] = lse[static_cast<size_t>(bh) * t + q0 + threadIdx.x];
      sD[threadIdx.x] = delta[static_cast<size_t>(bh) * t + q0 + threadIdx.x];
    }
    __syncthreads();

    // S^T = K Q2^T: [16 kv, 64 q] per warp.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ld_a_frag(a, sK, LD, r0, kk * 16, c);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* qb = sQ + (nt * 8 + g) * LD + kk * 16 + 2 * c;
        mma_bf16(s[nt], a, ld_pair(qb), ld_pair(qb + 8));
      }
    }

    // P^T = exp2(S^T - lse[q]), zero where masked.
    const bool masked = k0 + BLOCK > kv_len || q0 + BLOCK > q_len ||
                        (causal && k0 + BLOCK - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * c + (e & 1);
        float p = exp2f(s[nt][e] - sL[qc]);
        if (masked) {
          const int kv_row = e < 2 ? kv_row0 : kv_row1;
          const int q_row = q0 + qc;
          if (kv_row >= kv_len || q_row >= q_len || (causal && q_row < kv_row))
            p = 0.f;
        }
        s[nt][e] = p;
      }
    }

    // dV += P^T do  (contraction over the 64 q rows).
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* ob = sO + (kk * 16 + 2 * c) * LD + dt * 8 + g;
        mma_bf16(dV[dt], pa, ld_col_pair(ob, LD), ld_col_pair(ob + 8 * LD, LD));
      }
    }

    // dP^T = V do^T, then dS^T = P^T * (dP^T - delta[q]).
    float dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ld_a_frag(a, sV, LD, r0, kk * 16, c);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* ob = sO + (nt * 8 + g) * LD + kk * 16 + 2 * c;
        mma_bf16(dp[nt], a, ld_pair(ob), ld_pair(ob + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] *= dp[nt][e] - sD[nt * 8 + 2 * c + (e & 1)];
    }

    // dK += dS^T q2, with dS rounded to bf16; dS^T also goes to shared
    // memory for the dq product.
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      *reinterpret_cast<uint32_t*>(sS + r0 * LDS + kk * 16 + 2 * c) = da[0];
      *reinterpret_cast<uint32_t*>(sS + (r0 + 8) * LDS + kk * 16 + 2 * c) = da[1];
      *reinterpret_cast<uint32_t*>(sS + r0 * LDS + kk * 16 + 8 + 2 * c) = da[2];
      *reinterpret_cast<uint32_t*>(sS + (r0 + 8) * LDS + kk * 16 + 8 + 2 * c) = da[3];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* qb = sQ + (kk * 16 + 2 * c) * LD + dt * 8 + g;
        mma_bf16(dK[dt], da, ld_col_pair(qb, LD), ld_col_pair(qb + 8 * LD, LD));
      }
    }
    __syncthreads();  // the whole dS^T tile is in shared memory

    // dq[q rows of this warp] += (dS k) * scale, contraction over the
    // 64 KV rows of the block; A = dS = (dS^T)^T read column-wise.
    const int qr = warp * 16 + g;
    uint32_t sa[BLOCK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      const bf16* sb = sS + (kk * 16 + 2 * c) * LDS + qr;
      sa[kk][0] = ld_col_pair(sb, LDS);
      sa[kk][1] = ld_col_pair(sb + 8, LDS);
      sa[kk][2] = ld_col_pair(sb + 8 * LDS, LDS);
      sa[kk][3] = ld_col_pair(sb + 8 * LDS + 8, LDS);
    }
    float* dq_row = dq + q_off + static_cast<size_t>(qr) * D + 2 * c;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BLOCK / 16; ++kk) {
        const bf16* kb = sK + (kk * 16 + 2 * c) * LD + dt * 8 + g;
        mma_bf16(acc, sa[kk], ld_col_pair(kb, LD), ld_col_pair(kb + 8 * LD, LD));
      }
      atomicAdd(dq_row + dt * 8, acc[0] * scale);
      atomicAdd(dq_row + dt * 8 + 1, acc[1] * scale);
      atomicAdd(dq_row + 8 * D + dt * 8, acc[2] * scale);
      atomicAdd(dq_row + 8 * D + dt * 8 + 1, acc[3] * scale);
    }
  }

  bf16* dk_row = dk + kv_off + static_cast<size_t>(r0) * D + 2 * c;
  bf16* dv_row = dv + kv_off + static_cast<size_t>(r0) * D + 2 * c;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(dk_row + dt * 8) =
        pack_bf16(dK[dt][0] * LN2, dK[dt][1] * LN2);
    *reinterpret_cast<uint32_t*>(dk_row + 8 * D + dt * 8) =
        pack_bf16(dK[dt][2] * LN2, dK[dt][3] * LN2);
    *reinterpret_cast<uint32_t*>(dv_row + dt * 8) =
        pack_bf16(dV[dt][0], dV[dt][1]);
    *reinterpret_cast<uint32_t*>(dv_row + 8 * D + dt * 8) =
        pack_bf16(dV[dt][2], dV[dt][3]);
  }
}

template <int D>
static cudaError_t launch_bwd(const void* q2, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv,
                              int bh, int t, int tk, int kv_len, int q_len,
                              int causal, float scale, cudaStream_t stream) {
  const int bytes = BwdSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, tk / BLOCK);
  flash_bwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q2), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      t, tk, kv_len, q_len, causal, scale);
  return cudaGetLastError();
}

}  // namespace rtt

// q2, k, v, dout, dk, dv: bf16; lse, delta [bh, t] and dq [bh, t, d]: f32,
// dq zeroed by the caller; all contiguous; t and tk multiples of 64;
// d in {64, 128}. Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_bwd_bf16(const void* q2, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  void* dk, void* dv, int bh, int t, int tk,
                                  int d, int kv_len, int q_len, int causal,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t % rtt::BLOCK || tk % rtt::BLOCK || q_len <= 0 || q_len > t ||
      kv_len <= 0 || kv_len > tk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return rtt::launch_bwd<64>(q2, k, v, dout, lse, delta, dq, dk, dv, bh, t,
                               tk, kv_len, q_len, causal, scale, s);
  if (d == 128)
    return rtt::launch_bwd<128>(q2, k, v, dout, lse, delta, dq, dk, dv, bh, t,
                                tk, kv_len, q_len, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
