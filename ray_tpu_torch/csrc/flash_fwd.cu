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
// Design (hopper.cuh has the primitives and the tile layout):
//   - One block per (128-row q tile, bh) of three warpgroups. Warpgroup 2
//     is the producer: one thread issues every TMA load, and the group
//     gives its registers away (setmaxnreg 24). Warpgroups 0 and 1 are
//     consumers of 64 q rows each (setmaxnreg 240).
//   - Shared memory: the Q tile stays resident; K and V tiles of 128 rows
//     sit in a 2-stage ring (160 KB at d 128). Each stage has a "full"
//     mbarrier for K and one for V, completed by the TMA's transaction
//     bytes, and an "empty" mbarrier the two consumers arrive on when
//     they are done with it. So the next tile's loads run under this
//     tile's products.
//   - S = Q2 K^T is an SS wgmma (m64n128k16, K as the K-major B operand);
//     masks apply only on diagonal and kv_len-edge tiles; the online
//     softmax runs in f32 registers with exp2f and quad shuffles; P is
//     rounded to bf16 in registers and is the A operand of the RS wgmma
//     O += P V (m64n{d}k16), V read as an MN-major (transposed) B operand.
//   - Partial tiles: TMA fills rows past t or tk with zeros, kv_len masks
//     the columns, and stores of rows past t are skipped, so t and tk
//     need only be multiples of 64.
//   - Blocks of one bh run together (q tiles fastest, heaviest first):
//     the K/V of the few heads in flight stay in L2.
// What still holds it back: each consumer waits for S before its
// softmax and for O before its next S, so its tensor cores idle during
// its own softmax (the other consumer's products fill part of that gap);
// the 128-wide K tile is reloaded by every q tile of the head. Running a
// consumer's softmax of S_j under its own P_{j-1} V_{j-1}
// (FlashAttention-3's intra-warpgroup overlap) writes registers while a
// wgmma is in flight; written that way, ptxas (C7513) serialised every
// wgmma of the kernel, which then ran slower than this schedule.
#include "hopper.cuh"

namespace rtt {
namespace fwd {

constexpr int BM = 128;  // q rows of a block
constexpr int BN = 128;  // KV rows of a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;  // warpgroups, 64 q rows each
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;

template <int D>
struct Smem {
  static constexpr int q_bytes = BM * D * 2;
  static constexpr int kv_bytes = BN * D * 2;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + STAGES * kv_bytes;
  static constexpr int bar_off = v_off + STAGES * kv_bytes;
  static constexpr int bytes = bar_off + 64 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ out, float* __restrict__ lse, int t,
                 int kv_len, int causal) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  int n_kv = (kv_len + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + BM - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMERS) {
    // ---- producer ----------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x % WG_THREADS == 0) {
      mbar_arrive_expect_tx(q_full, S::q_bytes);
      for (int h = 0; h < D / BOX_COLS; ++h)
        tma_load_3d(smem + h * BM * BOX_ROW_BYTES, &tm_q, q_full,
                    h * BOX_COLS, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        unsigned char* sk = smem + S::k_off + s * S::kv_bytes;
        unsigned char* sv = smem + S::v_off + s * S::kv_bytes;
        mbar_arrive_expect_tx(&k_full[s], S::kv_bytes);
        for (int h = 0; h < D / BOX_COLS; ++h)
          tma_load_3d(sk + h * BN * BOX_ROW_BYTES, &tm_k, &k_full[s],
                      h * BOX_COLS, j * BN, bh);
        mbar_arrive_expect_tx(&v_full[s], S::kv_bytes);
        for (int h = 0; h < D / BOX_COLS; ++h)
          tma_load_3d(sv + h * BN * BOX_ROW_BYTES, &tm_v, &v_full[s],
                      h * BOX_COLS, j * BN, bh);
      }
    }
  } else {
    // ---- consumers: 64 q rows each -----------------------------------
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32;
    const int g = (tid % 32) >> 2;
    const int c = tid & 3;
    const int wq0 = q0 + wg * 64;           // this warpgroup's first row
    const int row0 = wq0 + warp * 16 + g;   // this thread's rows: row0, +8
    const uint32_t q_tile = smem_u32(smem) + wg * 64 * BOX_ROW_BYTES;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      const uint32_t phase = (j / STAGES) & 1;
      const uint32_t k_tile = smem_u32(smem + S::k_off + s * S::kv_bytes);
      const uint32_t v_tile = smem_u32(smem + S::v_off + s * S::kv_bytes);

      // S = Q2 K^T: [64, 128] per warpgroup.
      float sc[BN / 2];
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0, 0>(sc, kmajor_desc(q_tile, BM, k),
                       kmajor_desc(k_tile, BN, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      const int c0 = j * BN;
      if (c0 + BN > kv_len || (causal && c0 + BN - 1 > wq0)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = c0 + 8 * (i >> 2) + 2 * c + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (col >= kv_len || (causal && row < col)) sc[i] = MASK_VALUE;
        }
      }

      // Online softmax in the log2 domain. The 4 threads of a quad
      // share two rows; their maxima and sums meet through shuffles.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = exp2f(m0 - mx0);
      const float alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        sc[4 * nt] = exp2f(sc[4 * nt] - mx0);
        sc[4 * nt + 1] = exp2f(sc[4 * nt + 1] - mx0);
        sc[4 * nt + 2] = exp2f(sc[4 * nt + 2] - mx1);
        sc[4 * nt + 3] = exp2f(sc[4 * nt + 3] - mx1);
        sum0 += sc[4 * nt] + sc[4 * nt + 1];
        sum1 += sc[4 * nt + 2] + sc[4 * nt + 3];
      }
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[4 * nt] *= alpha0;
        o[4 * nt + 1] *= alpha0;
        o[4 * nt + 2] *= alpha1;
        o[4 * nt + 3] *= alpha1;
      }
      // P rounded to bf16: the A fragments of the 16-column slices.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[k][r] = pack_bf16(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1]);
      }

      // O += P V, V read transposed (MN-major) from its swizzled boxes.
      mbar_wait(&v_full[s], phase);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BN / 16; ++k)
        wgmma_rs<1>(o, pa[k], mnmajor_desc(v_tile, BN, k), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      if (tid == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const size_t base = (static_cast<size_t>(bh) * t + row0) * D + 2 * c;
    if (row0 < t) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + base + 8 * nt) =
            pack_bf16(o[4 * nt] * inv0, o[4 * nt + 1] * inv0);
      if (c == 0) lse[static_cast<size_t>(bh) * t + row0] = m0 + log2f(l0 == 0.f ? 1.f : l0);
    }
    if (row0 + 8 < t) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + base + 8 * D + 8 * nt) =
            pack_bf16(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1);
      if (c == 0) lse[static_cast<size_t>(bh) * t + row0 + 8] = m1 + log2f(l1 == 0.f ? 1.f : l1);
    }
  }
}

template <int D>
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          void* out, void* lse, int bh, int t, int tk,
                          int kv_len, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_tile_map(&tm_q, q2, D, t, bh, BM);
  if (err == cudaSuccess) err = make_tile_map(&tm_k, k, D, tk, bh, BN);
  if (err == cudaSuccess) err = make_tile_map(&tm_v, v, D, tk, bh, BN);
  if (err != cudaSuccess) return err;
  const int bytes = Smem<D>::bytes;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BM - 1) / BM, bh);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), static_cast<float*>(lse), t,
      kv_len, causal);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace rtt

// q2, k, v, out: bf16, contiguous, 16-byte aligned; t and tk multiples of
// 64; d in {64, 128}. Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_fwd_bf16(const void* q2, const void* k,
                                  const void* v, void* out, void* lse, int bh,
                                  int t, int tk, int d, int kv_len, int causal,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t % 64 || tk % 64 || t <= 0 || kv_len <= 0 || kv_len > tk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return rtt::fwd::launch<64>(q2, k, v, out, lse, bh, t, tk, kv_len, causal, s);
  if (d == 128)
    return rtt::fwd::launch<128>(q2, k, v, out, lse, bh, t, tk, kv_len, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
