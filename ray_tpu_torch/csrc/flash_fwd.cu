// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_flash_forward`
// (ray_tpu/ops/attention.py:136, pallas_call at :265).
//
// What it computes: for q2 [bh, t, d] already scaled by scale*log2(e),
// and k, v [bh, tk, d], out = softmax2(q2 k^T) v and the log2-domain
// lse = m + log2(l) per row (l == 0 -> 1), with KV columns >= kv_len
// masked and, if causal, columns > row (top-left aligned) masked.
//
// Bound on an H100 SXM: operations. At the training shape (bh 64,
// t = tk = 4096, d 128, causal) the two products need
// 4*d*bh*t*(t+1)/2 = 2.75e11 FLOP, 0.28 ms at 989 TFLOP/s bf16, while
// q, k, v and out are 268 MB, 0.08 ms at 3.35 TB/s.
//
// Design: one block of 4 warps per (bh, 64-row q tile); the loop over
// KV tiles inside the block takes the place of the TPU's sequential
// grid axis, and stops at the causal diagonal and at kv_len, so no
// fully masked tile is loaded. K and V tiles are staged in shared
// memory; S = Q2 K^T and P V run on the tensor cores (mma.sync bf16,
// f32 accumulate). The online-softmax state (running max m, sum l and
// the [16, d] accumulator) stays in f32 registers, and P goes from the
// S accumulator to the A fragment of P V without leaving registers.
// q tiles are scheduled heaviest first so the causal tail stays short.
// Later work: wgmma with TMA-fed multi-stage shared-memory rings.
#include "flash_common.cuh"

namespace rtt {

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int t, int tk, int kv_len,
                 int causal) {
  constexpr int LD = Pitch<D>::value;
  __shared__ __align__(16) bf16 sK[BLOCK * LD];
  __shared__ __align__(16) bf16 sV[BLOCK * LD];

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int q0 = qt * BLOCK;
  const int r0 = warp * 16 + g;  // this thread's first row in the tile
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  const size_t q_off = (static_cast<size_t>(bh) * t + q0) * D;
  const size_t kv_off = static_cast<size_t>(bh) * tk * D;

  // The q tile goes to registers once, staged through sK.
  load_tile<D>(sK, q2 + q_off);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ld_a_frag(qf[kk], sK, LD, r0, kk * 16, c);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int n_kv = (kv_len + BLOCK - 1) / BLOCK;
  if (causal) n_kv = min(n_kv, qt + 1);
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<D>(sK, k + kv_off + static_cast<size_t>(j) * BLOCK * D);
    load_tile<D>(sV, v + kv_off + static_cast<size_t>(j) * BLOCK * D);
    __syncthreads();

    // S = Q2 K^T: [16, 64] per warp as 8 tiles of 8 columns.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kb = sK + (nt * 8 + g) * LD + kk * 16 + 2 * c;
        mma_bf16(s[nt], qf[kk], ld_pair(kb), ld_pair(kb + 8));
      }
    }

    const int c0 = j * BLOCK;
    if (c0 + BLOCK > kv_len || (causal && c0 + BLOCK - 1 > q0)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nt * 8 + 2 * c + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= kv_len || (causal && row < col)) s[nt][e] = MASK_VALUE;
        }
      }
    }

    // Online softmax in the log2 domain. The 4 threads of a group
    // share two rows; their maxima meet through two shuffles.
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m[0] - mx0);
    const float alpha1 = exp2f(m[1] - mx1);
    m[0] = mx0;
    m[1] = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l[0] = alpha0 * l[0] + sum0;
    l[1] = alpha1 * l[1] + sum1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += P V, with P rounded to bf16 as the A operand.
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* vb = sV + (kk * 16 + 2 * c) * LD + dt * 8 + g;
        mma_bf16(acc[dt], pa, ld_col_pair(vb, LD), ld_col_pair(vb + 8 * LD, LD));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  const float l0 = l[0] == 0.f ? 1.f : l[0];
  const float l1 = l[1] == 0.f ? 1.f : l[1];
  bf16* o = out + q_off + static_cast<size_t>(r0) * D + 2 * c;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o + dt * 8) =
        pack_bf16(acc[dt][0] / l0, acc[dt][1] / l0);
    *reinterpret_cast<uint32_t*>(o + 8 * D + dt * 8) =
        pack_bf16(acc[dt][2] / l1, acc[dt][3] / l1);
  }
  if (c == 0) {
    lse[static_cast<size_t>(bh) * t + row0] = m[0] + log2f(l0);
    lse[static_cast<size_t>(bh) * t + row1] = m[1] + log2f(l1);
  }
}

template <int D>
static cudaError_t launch_fwd(const void* q2, const void* k, const void* v,
                              void* out, void* lse, int bh, int t, int tk,
                              int kv_len, int causal, cudaStream_t stream) {
  dim3 grid(bh, t / BLOCK);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q2), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), t, tk, kv_len, causal);
  return cudaGetLastError();
}

}  // namespace rtt

// q2, k, v, out: bf16, contiguous; t and tk multiples of 64; d in {64, 128}.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_fwd_bf16(const void* q2, const void* k,
                                  const void* v, void* out, void* lse, int bh,
                                  int t, int tk, int d, int kv_len, int causal,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t % rtt::BLOCK || tk % rtt::BLOCK || t <= 0 || kv_len <= 0 || kv_len > tk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return rtt::launch_fwd<64>(q2, k, v, out, lse, bh, t, tk, kv_len, causal, s);
  if (d == 128)
    return rtt::launch_fwd<128>(q2, k, v, out, lse, bh, t, tk, kv_len, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
