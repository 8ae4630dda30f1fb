// Flash-attention forward for every (dtype, head_dim) that the wgmma
// kernel of flash_fwd.cu (bf16, d 64 or 128) does not take: bf16, f16 and
// f32 inputs at any head_dim (the op pads a head_dim with zero columns to
// the next multiple of 32; the scale is the true d's).
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_flash_forward`
// (ray_tpu/ops/attention.py:136, pallas_call at :265) for those inputs. The
// TPU kernel takes any dtype and head_dim: its BlockSpecs carry the whole d.
//
// What it computes, as flash_fwd.cu: for q2 [bh, t, d] already scaled by
// scale*log2(e), and k, v [bh, tk, d], out = softmax2(q2 k^T) v in the
// input dtype and the log2-domain lse = m + log2(l) per row (l == 0 -> 1),
// f32 [bh, t]; KV columns >= kv_len masked and, if causal, columns > row
// (top-left aligned). P is rounded to the input dtype before P.V, as the
// plain version does; in f32 it stays f32 (no TF32 anywhere).
//
// Bound on an H100 SXM: operations (4*d FLOP per unmasked pair), at 989
// TFLOP/s for bf16/f16 and 67 TFLOP/s for f32 (kept in f32: no TF32). At
// Gemma-2B's shape (bh 16 x 4096 x d 256, causal) that is 0.139 ms; the
// bytes (q, k, v, out, lse) are 0.04 ms at 3.35 TB/s.
//
// Three kernels:
//   - bf16/f16, d <= 256 (`flash_fwd_wgmma_kernel`), built as
//     flash_fwd.cu is (hopper.cuh has the primitives and the tile layout):
//     one block per (128-row q tile, bh) of three warpgroups. Warpgroup 2
//     is the producer: one thread issues every TMA load (setmaxnreg 24).
//     Warpgroups 0 and 1 consume 64 q rows each (setmaxnreg 240: 240 *
//     256 + 24 * 128 = 64,512 of the SM's 65,536 registers). The Q tile
//     stays resident; K and V tiles of 80 rows come through a 2-stage
//     mbarrier ring, the next tile's loads in flight under this tile's
//     products (225 KB of shared memory at d 256: Q 64 KB, the ring 160
//     KB; 80 rows is the most that fits, and measured 12% faster than
//     64). A row of d columns arrives as d/64 boxes of 64 columns (128
//     bytes, 128-byte swizzle); at d = 96, 160 or 224 the last box
//     overhangs the row and TMA fills it with zeros, so the kernel runs
//     at d rounded up to 64 and stores only the true columns. S = Q2 K^T
//     is an SS wgmma (m64n80k16); the online softmax runs on its f32
//     accumulators (quad shuffles for row max and sum); P, rounded to T,
//     stays in registers as the A operand of O += P V, an RS wgmma with
//     N = d (m64n256k16 at d 256, V read transposed across its boxes;
//     four m64n64 products measured 3% slower). O is d/2 f32 a thread
//     (128 registers at d 256), S 40, P 20. The KV tile that
//     holds no unmasked column of a consumer's rows (the causal
//     diagonal's other half, rows past t) is only released by it. The
//     causal q tiles run heaviest first across all heads (bh fastest),
//     so the grid's last wave holds the lightest tiles: 14% faster at
//     bh 16 x 4096 than heaviest first within each head, head by head.
//   - f32, d <= 256 (`flash_fwd_simt_kernel`): CUDA-core FMA, one block of
//     256 threads per (64-row q tile, bh). Q stays in shared memory as
//     f32; K and V tiles of 32 rows are loaded in turn, rows padded by one
//     float. Four threads share a q row (d/4 output columns each in
//     registers, S columns lane + 4u); P goes through shared memory within
//     a warp. 140 KB of shared memory at d 256.
//   - every dtype, d > 256 (`flash_fwd_wide_kernel`): a simple kernel,
//     since no model the repo names has such a head_dim. The output is
//     split by columns: one block per (64-row q tile, bh, chunk of at
//     most 256 output columns). Each block forms S = Q2 K^T over all of
//     d, streaming 32-column slices of Q and K through shared memory in
//     the same order in every chunk, so every chunk's S, P and lse are
//     the same to the bit; then it adds P V for its own columns only (V's
//     chunk in shared memory) and writes its own columns of out; chunk 0
//     writes lse. CUDA-core FMA in f32, P rounded to T as above; 54 KB of
//     shared memory at any d.
// The kernels skip causal KV tiles past the q tile's last row and tiles
// past kv_len; t and tk are multiples of 64.
// What still holds the wgmma kernel back: each consumer waits for S
// before its softmax and for O before its next S (flash_fwd.cu's
// schedule); S's SS wgmma reads both operands from shared memory at
// m64n80, near the SM's shared-memory rate. Issuing S_j ahead of
// P_{j-1} V_{j-1} (FlashAttention-3's overlap within a warpgroup) made
// ptxas insert warpgroup waits, and the kernel 12% slower.
#include <cmath>
#include <cstddef>
#include <type_traits>

#include "flash_any.cuh"

namespace rtt {
namespace any {
namespace fwd {

constexpr int THREADS = 256;         // the f32 kernel's block
constexpr int BQ = 64;               // q rows of its block
constexpr int BK = 32;               // KV rows of its tile
constexpr int TPR = THREADS / BQ;    // threads of one q row

template <int D>
struct Smem {
  static constexpr int LD = D + 1;   // padded row, in floats
  static constexpr int PLD = BK + 1;
  static constexpr int q = 0;
  static constexpr int k = q + BQ * LD;
  static constexpr int v = k + BK * LD;
  static constexpr int p = v + BK * LD;
  static constexpr int bytes = (p + BQ * PLD) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_simt_kernel(const T* __restrict__ q2, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int t, int tk, int kv_len,
                     int causal) {
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* sq = smem + S::q;
  float* sk = smem + S::k;
  float* sv = smem + S::v;
  float* sp = smem + S::p;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int row = q0 + r;
  const size_t q_off = (static_cast<size_t>(bh) * t + q0) * D;
  const size_t kv_off = static_cast<size_t>(bh) * tk * D;

  for (int e = tid; e < BQ * D; e += THREADS)
    sq[(e / D) * S::LD + e % D] = to_f(q2[q_off + e]);

  float o[D / TPR];
#pragma unroll
  for (int i = 0; i < D / TPR; ++i) o[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const int kv_end = causal ? min(kv_len, q0 + BQ) : kv_len;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // the last tile's K, V and P are read
    const size_t at = kv_off + static_cast<size_t>(j0) * D;
    for (int e = tid; e < BK * D; e += THREADS) {
      const int s_at = (e / D) * S::LD + e % D;
      sk[s_at] = to_f(k[at + e]);
      sv[s_at] = to_f(v[at + e]);
    }
    __syncthreads();

    float s[BK / TPR];
#pragma unroll
    for (int u = 0; u < BK / TPR; ++u) s[u] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qv = sq[r * S::LD + c];
#pragma unroll
      for (int u = 0; u < BK / TPR; ++u)
        s[u] = fmaf(qv, sk[(lane + TPR * u) * S::LD + c], s[u]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < BK / TPR; ++u) {
      const int col = j0 + lane + TPR * u;
      if (col >= kv_len || (causal && col > row)) s[u] = MASK_VALUE;
      tile_max = fmaxf(tile_max, s[u]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int u = 0; u < BK / TPR; ++u) {
      const float p = exp2f(s[u] - m_new);
      row_sum += p;
      sp[r * S::PLD + lane + TPR * u] = round_to<T>(p);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
    l = l * alpha + row_sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < D / TPR; ++i) o[i] *= alpha;
    __syncwarp();  // a row's P is written and read by its own four threads
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float p = sp[r * S::PLD + j];
#pragma unroll
      for (int i = 0; i < D / TPR; ++i)
        o[i] = fmaf(p, sv[j * S::LD + lane + TPR * i], o[i]);
    }
  }

  const float l_safe = l == 0.f ? 1.f : l;
  T* o_row = out + q_off + static_cast<size_t>(r) * D;
#pragma unroll
  for (int i = 0; i < D / TPR; ++i)
    o_row[lane + TPR * i] = from_f<T>(o[i] / l_safe);
  if (lane == 0) lse[static_cast<size_t>(bh) * t + row] = m + log2f(l_safe);
}

// ---------------------------------------------------------------------------
// bf16/f16 at d <= 256: wgmma on a TMA ring
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;  // q rows of a block
constexpr int BN = 80;   // KV rows of a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;  // warpgroups, 64 q rows each
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;

// D is d rounded up to a multiple of 64 (whole boxes).
template <int D>
struct Smem {
  static constexpr int q_bytes = BM * D * 2;
  static constexpr int kv_bytes = BN * D * 2;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + STAGES * kv_bytes;
  static constexpr int bar_off = v_off + STAGES * kv_bytes;
  static constexpr int bytes = bar_off + 64 + 1024;  // + alignment slack
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       T* __restrict__ out, float* __restrict__ lse, int t,
                       int d, int kv_len, int causal) {
  using S = Smem<D>;
  constexpr int NB = D / BOX_COLS;  // 64-column boxes of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  // q tiles heaviest first over all heads: bh runs fastest. The grid is
  // (q tiles, bh); its blocks are taken in linear order.
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % gridDim.y;
  const int q0 = (gridDim.x - 1 - lin / gridDim.y) * BM;
  int n_kv = (kv_len + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + BM, t) - 1) / BN + 1);

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
      for (int h = 0; h < NB; ++h)
        tma_load_3d(smem + h * BM * BOX_ROW_BYTES, &tm_q, q_full,
                    h * BOX_COLS, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        unsigned char* sk = smem + S::k_off + s * S::kv_bytes;
        unsigned char* sv = smem + S::v_off + s * S::kv_bytes;
        mbar_arrive_expect_tx(&k_full[s], S::kv_bytes);
        for (int h = 0; h < NB; ++h)
          tma_load_3d(sk + h * BN * BOX_ROW_BYTES, &tm_k, &k_full[s],
                      h * BOX_COLS, j * BN, bh);
        mbar_arrive_expect_tx(&v_full[s], S::kv_bytes);
        for (int h = 0; h < NB; ++h)
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
    // The KV tiles holding an unmasked column of this warpgroup's rows;
    // it only releases the others, after they have landed (so that its
    // release counts towards their stage's turn, not an earlier one).
    int my_kv = wq0 < t ? n_kv : 0;
    if (causal && wq0 < t) my_kv = min(n_kv, (min(wq0 + 64, t) - 1) / BN + 1);

    float o[D / 2];  // box h's accumulator at o[32h .. 32h + 31]
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

    if (my_kv > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      const uint32_t phase = (j / STAGES) & 1;
      if (j >= my_kv) {
        mbar_wait(&v_full[s], phase);
        if (tid == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t k_tile = smem_u32(smem + S::k_off + s * S::kv_bytes);
      const uint32_t v_tile = smem_u32(smem + S::v_off + s * S::kv_bytes);

      // S = Q2 K^T: [64, 80] per warpgroup.
      float sc[BN / 2];
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0, 0, T>(sc, kmajor_desc(q_tile, BM, k),
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
      for (int h = 0; h < NB; ++h) {
#pragma unroll
        for (int nt = 0; nt < BOX_COLS / 8; ++nt) {
          o[32 * h + 4 * nt] *= alpha0;
          o[32 * h + 4 * nt + 1] *= alpha0;
          o[32 * h + 4 * nt + 2] *= alpha1;
          o[32 * h + 4 * nt + 3] *= alpha1;
        }
      }
      // P rounded to T: the A fragments of the 16-column slices.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[k][r] = pack2<T>(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1]);
      }

      // O += P V, N = D (the boxes of V, read transposed).
      mbar_wait(&v_full[s], phase);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BN / 16; ++k)
        wgmma_rs<1, T>(o, pa[k], mnmajor_desc(v_tile, BN, k), 1);
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
    const float safe0 = l0 == 0.f ? 1.f : l0;
    const float safe1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / safe0, inv1 = 1.f / safe1;
    T* row_out = out + (static_cast<size_t>(bh) * t + row0) * d + 2 * c;
#pragma unroll
    for (int h = 0; h < NB; ++h) {
#pragma unroll
      for (int nt = 0; nt < BOX_COLS / 8; ++nt) {
        const int col = h * BOX_COLS + 8 * nt;  // + 2c, within one box
        if (col >= d) continue;
        if (row0 < t)
          *reinterpret_cast<uint32_t*>(row_out + col) =
              pack2<T>(o[32 * h + 4 * nt] * inv0, o[32 * h + 4 * nt + 1] * inv0);
        if (row0 + 8 < t)
          *reinterpret_cast<uint32_t*>(row_out + 8 * d + col) =
              pack2<T>(o[32 * h + 4 * nt + 2] * inv1, o[32 * h + 4 * nt + 3] * inv1);
      }
    }
    if (c == 0) {
      if (row0 < t) lse[static_cast<size_t>(bh) * t + row0] = m0 + log2f(safe0);
      if (row0 + 8 < t)
        lse[static_cast<size_t>(bh) * t + row0 + 8] = m1 + log2f(safe1);
    }
  }
}

template <typename T, int D>
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          void* out, void* lse, int bh, int t, int tk, int d,
                          int kv_len, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_tile_map(&tm_q, q2, d, t, bh, BM, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_k, k, d, tk, bh, BN, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_v, v, d, tk, bh, BN, tma_type<T>());
  if (err != cudaSuccess) return err;
  const int bytes = Smem<D>::bytes;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BM - 1) / BM, bh);
  flash_fwd_wgmma_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), static_cast<float*>(lse), t, d,
      kv_len, causal);
  return cudaGetLastError();
}

// d a multiple of 32 up to 256, run at d rounded up to 64.
template <typename T>
static cudaError_t launch_d(const void* q2, const void* k, const void* v,
                            void* out, void* lse, int bh, int t, int tk, int d,
                            int kv_len, int causal, cudaStream_t s) {
  switch ((d + BOX_COLS - 1) / BOX_COLS) {
    case 1:
      return launch<T, 64>(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal, s);
    case 2:
      return launch<T, 128>(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal, s);
    case 3:
      return launch<T, 192>(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal, s);
    case 4:
      return launch<T, 256>(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// every dtype at d > 256: the output split by columns
// ---------------------------------------------------------------------------

namespace wide {

constexpr int THREADS = 256;
constexpr int BQ = 64;               // q rows of a block
constexpr int BK = 32;               // KV rows of a tile
constexpr int SL = 32;               // columns of a slice of Q and K
constexpr int DC = 256;              // output columns of a block (a chunk)
constexpr int TPR = THREADS / BQ;    // threads of one q row
constexpr int SQ = 0;                              // [BQ][SL + 1]
constexpr int SK = SQ + BQ * (SL + 1);             // [BK][SL + 1]
constexpr int SV = SK + BK * (SL + 1);             // [BK][DC + 1]
constexpr int SP = SV + BK * (DC + 1);             // [BQ][BK + 1]
constexpr int BYTES = (SP + BQ * (BK + 1)) * 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q2, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int t, int tk, int d,
                      int kv_len, int causal) {
  extern __shared__ float smem[];
  float* sq = smem + SQ;
  float* sk = smem + SK;
  float* sv = smem + SV;
  float* sp = smem + SP;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * DC;        // this block's output columns:
  const int cw = min(DC, d - c0);        // [c0, c0 + cw)
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int row = q0 + r;
  const size_t q_at = (static_cast<size_t>(bh) * t + q0) * d;
  const size_t kv_at = static_cast<size_t>(bh) * tk * d;

  float o[DC / TPR];
#pragma unroll
  for (int i = 0; i < DC / TPR; ++i) o[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const int kv_end = causal ? min(kv_len, q0 + BQ) : kv_len;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    // S over all of d, slice by slice in column order (every chunk's
    // block sums in the same order, so their S agree to the bit).
    float s[BK / TPR];
#pragma unroll
    for (int u = 0; u < BK / TPR; ++u) s[u] = 0.f;
    for (int d0 = 0; d0 < d; d0 += SL) {
      __syncthreads();  // the last slice (and the last tile's V, P) read
      for (int e = tid; e < BQ * SL; e += THREADS)
        sq[(e / SL) * (SL + 1) + e % SL] =
            to_f(q2[q_at + static_cast<size_t>(e / SL) * d + d0 + e % SL]);
      for (int e = tid; e < BK * SL; e += THREADS)
        sk[(e / SL) * (SL + 1) + e % SL] = to_f(
            k[kv_at + static_cast<size_t>(j0 + e / SL) * d + d0 + e % SL]);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < SL; ++c) {
        const float qv = sq[r * (SL + 1) + c];
#pragma unroll
        for (int u = 0; u < BK / TPR; ++u)
          s[u] = fmaf(qv, sk[(lane + TPR * u) * (SL + 1) + c], s[u]);
      }
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < BK / TPR; ++u) {
      const int col = j0 + lane + TPR * u;
      if (col >= kv_len || (causal && col > row)) s[u] = MASK_VALUE;
      tile_max = fmaxf(tile_max, s[u]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int u = 0; u < BK / TPR; ++u) {
      const float p = exp2f(s[u] - m_new);
      row_sum += p;
      sp[r * (BK + 1) + lane + TPR * u] = round_to<T>(p);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
    l = l * alpha + row_sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DC / TPR; ++i) o[i] *= alpha;
    // This chunk's columns of V (the slices' barriers passed since the
    // last tile's V was read).
    for (int e = tid; e < BK * cw; e += THREADS)
      sv[(e / cw) * (DC + 1) + e % cw] =
          to_f(v[kv_at + static_cast<size_t>(j0 + e / cw) * d + c0 + e % cw]);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float p = sp[r * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < DC / TPR; ++i)
        if (lane + TPR * i < cw)
          o[i] = fmaf(p, sv[j * (DC + 1) + lane + TPR * i], o[i]);
    }
  }

  const float l_safe = l == 0.f ? 1.f : l;
  T* o_row = out + q_at + static_cast<size_t>(r) * d + c0;
#pragma unroll
  for (int i = 0; i < DC / TPR; ++i)
    if (lane + TPR * i < cw) o_row[lane + TPR * i] = from_f<T>(o[i] / l_safe);
  if (blockIdx.z == 0 && lane == 0)
    lse[static_cast<size_t>(bh) * t + row] = m + log2f(l_safe);
}

template <typename T>
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          void* out, void* lse, int bh, int t, int tk, int d,
                          int kv_len, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(t / BQ, bh, (d + DC - 1) / DC);
  flash_fwd_wide_kernel<T><<<grid, THREADS, BYTES, stream>>>(
      static_cast<const T*>(q2), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      t, tk, d, kv_len, causal);
  return cudaGetLastError();
}

}  // namespace wide

template <int D>
static cudaError_t launch_simt(const void* q2, const void* k, const void* v,
                               void* out, void* lse, int bh, int t, int tk,
                               int kv_len, int causal, cudaStream_t stream) {
  const int bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(t / BQ, bh);
  flash_fwd_simt_kernel<float, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q2), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), t, tk, kv_len, causal);
  return cudaGetLastError();
}

static cudaError_t launch_simt_d(const void* q2, const void* k, const void* v,
                                 void* out, void* lse, int bh, int t, int tk,
                                 int d, int kv_len, int causal,
                                 cudaStream_t s) {
  switch (d) {
#define RTT_FWD_ANY_D(D) \
  case D:                \
    return launch_simt<D>(q2, k, v, out, lse, bh, t, tk, kv_len, causal, s);
    RTT_FWD_ANY_D(32)
    RTT_FWD_ANY_D(64)
    RTT_FWD_ANY_D(96)
    RTT_FWD_ANY_D(128)
    RTT_FWD_ANY_D(160)
    RTT_FWD_ANY_D(192)
    RTT_FWD_ANY_D(224)
    RTT_FWD_ANY_D(256)
#undef RTT_FWD_ANY_D
  }
  return cudaErrorInvalidValue;
}

}  // namespace fwd
}  // namespace any
}  // namespace rtt

// dtype: 0 f32, 1 bf16, 2 f16 (q2, k, v, out); lse f32 [bh, t]. All
// contiguous and 16-byte aligned; t and tk multiples of 64; d a multiple
// of 32 up to 256; 0 < kv_len <= tk. f32 runs on the CUDA cores, bf16 and
// f16 on wgmma. Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_fwd_any(int dtype, const void* q2, const void* k,
                                 const void* v, void* out, void* lse, int bh,
                                 int t, int tk, int d, int kv_len, int causal,
                                 void* stream) {
  using namespace rtt::any::fwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || t % 64 || tk % 64 || kv_len <= 0 || kv_len > tk ||
      d <= 0 || d % 32 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_simt_d(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal,
                           s);
    case 1:
      return wg::launch_d<__nv_bfloat16>(q2, k, v, out, lse, bh, t, tk, d,
                                         kv_len, causal, s);
    case 2:
      return wg::launch_d<__half>(q2, k, v, out, lse, bh, t, tk, d, kv_len,
                                  causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for any d that is a multiple of 32 (the op takes it for d >
// 256), every dtype on the column-split kernel.
extern "C" int rtt_flash_fwd_wide(int dtype, const void* q2, const void* k,
                                  const void* v, void* out, void* lse, int bh,
                                  int t, int tk, int d, int kv_len, int causal,
                                  void* stream) {
  using namespace rtt::any::fwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || t % 64 || tk % 64 || kv_len <= 0 || kv_len > tk ||
      d <= 0 || d % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return wide::launch<float>(q2, k, v, out, lse, bh, t, tk, d, kv_len,
                                 causal, s);
    case 1:
      return wide::launch<__nv_bfloat16>(q2, k, v, out, lse, bh, t, tk, d,
                                         kv_len, causal, s);
    case 2:
      return wide::launch<__half>(q2, k, v, out, lse, bh, t, tk, d, kv_len,
                                  causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
