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
// plain version does; in f32 it stays f32.
//
// f32 on the tensor cores, in three-term TF32. Each f32 operand x is split
// as x = hi + lo, hi = tf32(x) and lo = tf32(x - hi) (rounded to nearest,
// ties away, as cvt.rna.tf32.f32 rounds, by an integer add and mask:
// faster than the cvt, kernel_ablation.py's cvt_split, and equal bit for
// bit; the subtraction exact in f32), and a product a*b is formed as
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b into the same f32 accumulators
// (lo*lo, about 2^-22 of a*b, dropped): what PyTorch's f32 attention does
// on sm80 and later (CUTLASS's OpMultiplyAddFastF32). Each product keeps
// about 21 of f32's 24 bits. The tensor cores' own f32 sums are not
// rounded to nearest, so no accumulator chain on them is longer than 8
// contraction steps of 8 (`chain_steps`; 3 * BN / 8 products in P V):
// each chain is added to the running sum by an f32 add on the CUDA cores
// (chip_smoke.py holds S alone at d 256, as the kernel chains it and in
// one chain over d, to the plain f32 product on the card). Over the sums
// of S and P V the output lies about 1e-7 of
// max|out| from the plain f32 version, inside the f32 bar of 1e-5, where
// one TF32 term lies about 3e-4 outside it (emulated on the CPU by
// tests/test_torch_ops.py::TestThreeTermTf32PlainVersion).
//
// Bound on an H100 SXM: operations (4*d FLOP per unmasked pair), at 989
// TFLOP/s for bf16/f16; f32's at the lesser of 67 TFLOP/s (CUDA cores) and
// three TF32 terms at 495 TFLOP/s (12*d FLOP per pair at 495: 0.41x the
// CUDA cores' time). At Gemma-2B's shape (bh 16 x 4096 x d 256,
// causal) the bf16 bound is 0.139 ms; the bytes (q, k, v, out, lse) are
// 0.04 ms at 3.35 TB/s.
//
// Four kernels:
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
//   - f32, d <= 256 (`flash_fwd_tf32_kernel`): S = Q2 K^T and O += P V on
//     wgmma (m64nNk8 TF32, A from registers) in three-term TF32. wgmma
//     takes TF32 only K-major, so P V reads V^T, and its shared-memory
//     operand must hold TF32 values: a converter warpgroup splits each K
//     and V tile once into hi and lo copies (V transposed) in 32-column
//     boxes of 128 bytes under the 128-byte swizzle, writing each
//     contraction step's 16-byte chunks whole, and hands each tile over on
//     an mbarrier (one buffer each: K_{j+1} is written under softmax and P
//     V_j, V_{j+1} under S_{j+1}). The consumer warpgroups, of 64 q rows,
//     split Q2 per k-step into registers from its f32 copy: Q's split
//     copies would not fit beside K's and V's (128 KB for 128 rows at d
//     128). Two consumers and 64-row KV tiles up to d 128 (setmaxnreg 216,
//     the converter 64; 197 KB of shared memory), 32-row KV tiles above,
//     one consumer above d 192 (195 KB at d 256). Within each 8-wide
//     contraction step the index is permuted (the A fragment's k = c and
//     c + 4 hold columns 2c and 2c + 1, and the converter stores K's and
//     V^T's slots in that order), so P's A fragment is S's accumulator as
//     it stands and Q's pairs are 8-byte loads. O is d/2 f32 a thread, in
//     chunks of 64 columns, each P V chunk one chain.
//   - bf16/f16, d > 256 (`flash_fwd_wide_wgmma_kernel`): the 16-bit
//     kernel's design with the output split by columns: one block per
//     (128-row q tile, bh, chunk of at most 256 output columns), so O
//     stays 128 f32 registers a consumer thread at any d. Each block forms
//     S = Q2 K^T over all of d, 64-column box by box in column order (an
//     SS wgmma m64n64k16 per 16 columns), the same products in the same
//     order in every chunk, so every chunk's S, P and lse agree to the
//     bit; then one RS wgmma P V over its chunk's columns (N = 64 to 256);
//     chunk 0 writes lse. K's boxes (8 KB at 64 rows) stream through a
//     4-slot ring, V's chunk through 2 stages (32 KB each); Q stays
//     resident up to d 512 (128 KB; 225 KB in all), and above it each Q
//     box comes through the ring beside its K box. S is made once per
//     chunk: at d 512 that is 1.5x the products of one block holding all
//     of O, which its registers cannot.
//   - f32, d > 256 (`flash_fwd_wide_tf32_kernel`): the f32 kernel's
//     three-term TF32 on wgmma with the output split by columns as above:
//     one block per (64-row q tile, bh, chunk of at most 256 output
//     columns) of two warpgroups. The converter splits K in boxes of 32 KV
//     rows by 64 columns (hi and lo, 16 KB) into a ring of 2, loading each
//     box one ahead, and V^T's chunk once a KV tile (64 KB); Q2 stays
//     resident in shared memory up to d 512 (129 KB; above, the consumer
//     reads its Q2 rows from L2). The
//     consumer forms S over all of d, one chain of 8 k-steps a box (Q2
//     split into registers per k-step, as the f32 kernel), in column
//     order, the same in every chunk (so the chunks' S, P and lse agree
//     to the bit), each chain added into S in f32; then O += P V on
//     m64n128k8 (m64n64k8 for a last 64 columns), 128 columns a chain. O
//     is 128 f32 registers a thread, 251 in all. Bound: three TF32 terms'
//     operations, 0.104 ms at bh 16 x 1024 x 512 causal, 0.156 counting S
//     once per chunk.
// The kernels skip causal KV tiles past the q tile's last row and tiles
// past kv_len; t and tk are multiples of 64. The "wide" kernels' causal q
// tiles run heaviest first across all heads, a tile's chunks side by side
// (they read the same K); the f32 one head by head was 17% slower.
// What still holds the wgmma kernel back: each consumer waits for S
// before its softmax and for O before its next S (flash_fwd.cu's
// schedule); S's SS wgmma reads both operands from shared memory at
// m64n80, near the SM's shared-memory rate. Issuing S_j ahead of
// P_{j-1} V_{j-1} (FlashAttention-3's overlap within a warpgroup) made
// ptxas insert warpgroup waits, and the kernel 12% slower.
// What holds the f32 "wide" kernel back: its one consumer warpgroup's
// serial work. Each chain splits Q2, issues 24 wgmma of N 32 and waits;
// the products are a small share of its time (kernel_ablation.py's
// wide_s_one_term), the converter's splits a few percent
// (wide_convert_once). Splitting the next
// chain's Q2 under this one's products (two register sets) spilled and
// was slower; two chains in flight, slower still (ptxas serialised
// them, C7514); two consumers of 64 rows would need Q2 out of shared
// memory (264 KB for 128 rows at d 512), and reading it from L2 was
// slower (wide_q_global).
#include <cmath>
#include <cstddef>
#include <type_traits>

#include "flash_any.cuh"

namespace rtt {
namespace any {
namespace fwd {

// ---------------------------------------------------------------------------
// f32 at d <= 256: three-term TF32 on wgmma
// ---------------------------------------------------------------------------

namespace tf32 {

// k-steps (8 columns each) of one tensor-core accumulator chain in S:
// the tensor cores do not round their f32 sums to nearest, so a long
// chain drifts; each chain of 3 * 8 products is added into the running
// sum by an f32 add (round to nearest) instead.
template <int D>
__host__ __device__ constexpr int chain_steps() {
  return (D / 8) % 8 == 0 ? 8 : 4;
}

// The split copies of K and V leave room for 64-row KV tiles up to d 128,
// 32-row ones above, and above d 192 for one consumer.
template <int D>
struct Cfg {
  static constexpr int CONSUMERS = D <= 192 ? 2 : 1;  // warpgroups of 64 rows
  static constexpr int BM = 64 * CONSUMERS;           // q rows of a block
  static constexpr int BN = D <= 128 ? 64 : 32;       // KV rows of a tile
  static constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;
  static constexpr int KC = chain_steps<D>();  // S's k-steps a chain
  static constexpr int LDQ = D + 8;            // Q's rows, floats
  // Bytes: Q (f32, padded rows), then K's hi and lo copies, then V^T's,
  // each split copy BN x D floats in 32-column boxes of 128 bytes.
  static constexpr int q_bytes = BM * LDQ * 4;
  static constexpr int split_bytes = BN * D * 4;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + 2 * split_bytes;
  static constexpr int bar_off = v_off + 2 * split_bytes;
  static constexpr int bytes = bar_off + 64 + 1024;  // + alignment slack
};

// The converter's stores. Within each 8-wide contraction step the A
// fragments' k = c and c + 4 hold columns 2c and 2c + 1 (the order of S's
// accumulator and of Q's 8-byte loads), so a K-major B tile holds a
// step's columns 0, 2, 4, 6 in its first 16-byte chunk and 1, 3, 5, 7 in
// its second. Both chunks of a step are written whole: hi and lo of four
// values each.
template <bool CVT = false>
__device__ __forceinline__ void split4(float a, float b, float c, float d,
                                       uint4& hi, uint4& lo) {
  split_tf32<CVT>(a, hi.x, lo.x);
  split_tf32<CVT>(b, hi.y, lo.y);
  split_tf32<CVT>(c, hi.z, lo.z);
  split_tf32<CVT>(d, hi.w, lo.w);
}

// Byte offset of row r's 16-byte chunk holding contraction step s (8
// columns from 8s) in a K-major TF32 tile of `rows` rows: 32-column boxes
// of rows x 128 bytes under the 128-byte swizzle (hopper.cuh's layout with
// 4-byte elements: a step of 8 is 32 bytes, as bf16's 16). `half` 0 holds
// the step's even columns, 1 its odd ones.
__device__ __forceinline__ int step_chunk(int r, int s, int half, int rows) {
  return (s >> 2) * rows * BOX_ROW_BYTES + r * BOX_ROW_BYTES +
         ((((2 * s) & 7) + half) ^ (r & 7)) * 16;
}

// K [rows x D] (pitch D) split into K-major hi and lo copies at dst and
// dst + split_bytes, by the converter warpgroup: a thread takes a row's 8
// columns of one step at a time, 8 rows by 4 steps a warp, so that each
// 16-byte store meets one thread a bank group. CVT: split by the cvt
// instruction (the check's reference).
template <int D, bool CVT = false>
__device__ __forceinline__ void split_k(unsigned char* dst, int split_bytes,
                                        const float* __restrict__ src,
                                        int rows, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  for (int rb = warp; rb < rows / 8; rb += WG_THREADS / 32) {
    const int r = rb * 8 + (lane & 7);
    const float* row = src + static_cast<size_t>(r) * D;
#pragma unroll
    for (int s = lane >> 3; s < D / 8; s += 4) {
      const float4 a = *reinterpret_cast<const float4*>(row + 8 * s);
      const float4 b = *reinterpret_cast<const float4*>(row + 8 * s + 4);
      uint4 hi, lo;
      split4<CVT>(a.x, a.z, b.x, b.z, hi, lo);
      int at = step_chunk(r, s, 0, rows);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      *reinterpret_cast<uint4*>(dst + split_bytes + at) = lo;
      split4<CVT>(a.y, a.w, b.y, b.w, hi, lo);
      at = step_chunk(r, s, 1, rows);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      *reinterpret_cast<uint4*>(dst + split_bytes + at) = lo;
    }
  }
}

// V [rows x D] (pitch D) split into K-major copies of V^T [D x rows]: a
// thread takes one step's 8 rows of 4 columns, so each of its columns'
// chunks is written whole.
template <int D>
__device__ __forceinline__ void split_vt(unsigned char* dst, int split_bytes,
                                         const float* __restrict__ src,
                                         int rows, int tid) {
  for (int i = tid; i < rows / 8 * (D / 4); i += WG_THREADS) {
    const int s = i % (rows / 8), n4 = i / (rows / 8);
    float4 x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(8 * s + j) * D + 4 * n4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * n4 + e;
      const auto col = [&](int j) {
        return e == 0 ? x[j].x : e == 1 ? x[j].y : e == 2 ? x[j].z : x[j].w;
      };
      uint4 hi, lo;
      split4(col(0), col(2), col(4), col(6), hi, lo);
      int at = step_chunk(n, s, 0, D);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      *reinterpret_cast<uint4*>(dst + split_bytes + at) = lo;
      split4(col(1), col(3), col(5), col(7), hi, lo);
      at = step_chunk(n, s, 1, D);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      *reinterpret_cast<uint4*>(dst + split_bytes + at) = lo;
    }
  }
}

// S [64 x BN] = a warpgroup's 64 rows of Q2 times K^T, three-term TF32:
// Q2 split per k-step into registers (the A operand; `qa` points at this
// thread's Q2[g][2c], pitch LDA), K's split copies at k_hi and k_lo as B.
// Chains of KC k-steps, each added into S in f32 (ONE_CHAIN: all of d in
// one chain, the check's comparison); CVT splits by the cvt instruction.
template <int D, int BN, int LDA, int KC, bool ONE_CHAIN = false,
          bool CVT = false>
__device__ __forceinline__ void scores(const float* qa, uint32_t k_hi,
                                       uint32_t k_lo, float (&sc)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < D / 8; k0 += KC) {
    uint32_t a_hi[KC][4], a_lo[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float2 top = *reinterpret_cast<const float2*>(qa + 8 * (k0 + kk));
      const float2 bot =
          *reinterpret_cast<const float2*>(qa + 8 * LDA + 8 * (k0 + kk));
      split_tf32<CVT>(top.x, a_hi[kk][0], a_lo[kk][0]);
      split_tf32<CVT>(bot.x, a_hi[kk][1], a_lo[kk][1]);
      split_tf32<CVT>(top.y, a_hi[kk][2], a_lo[kk][2]);
      split_tf32<CVT>(bot.y, a_hi[kk][3], a_lo[kk][3]);
    }
    float part[BN / 2];
    float (&acc)[BN / 2] = ONE_CHAIN ? sc : part;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int ks = k0 + kk;
      wgmma_tf32(acc, a_lo[kk], kmajor_desc(k_hi, BN, ks),
                 ONE_CHAIN || kk > 0);
      wgmma_tf32(acc, a_hi[kk], kmajor_desc(k_lo, BN, ks), 1);
      wgmma_tf32(acc, a_hi[kk], kmajor_desc(k_hi, BN, ks), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (!ONE_CHAIN) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] += part[i];
    }
  }
}

// O[64 x N] chunk += P V: N = 32 or 64 columns of V^T from row n0,
// three terms a k-step, one chain.
template <int D, int BN, int N>
__device__ __forceinline__ void pv_chunk(float (&o)[N / 2],
                                         const uint32_t (&p_hi)[BN / 8][4],
                                         const uint32_t (&p_lo)[BN / 8][4],
                                         uint32_t v_hi, uint32_t v_lo,
                                         int n0) {
  float part[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    const int at = n0 * BOX_ROW_BYTES;
    wgmma_tf32(part, p_lo[kk], kmajor_desc(v_hi + at, D, kk), kk > 0);
    wgmma_tf32(part, p_hi[kk], kmajor_desc(v_lo + at, D, kk), 1);
    wgmma_tf32(part, p_hi[kk], kmajor_desc(v_hi + at, D, kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] += part[i];
}

template <int D>
__device__ __forceinline__ void consume(
    const unsigned char* smem, uint64_t* q_full, uint64_t* k_full,
    uint64_t* k_empty, uint64_t* v_full, uint64_t* v_empty, int wg,
    float* __restrict__ out, float* __restrict__ lse, int bh, int q0, int t,
    int n_kv, int kv_len, int causal) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  constexpr int KC = C::KC;
  constexpr int N64 = D / 64;          // O's chunks of 64 columns
  constexpr int N32 = D % 64 ? 1 : 0;  // and one of 32
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int c = tid & 3;
  const int wq0 = q0 + wg * 64;          // this warpgroup's first row
  const int row0 = wq0 + warp * 16 + g;  // this thread's rows: row0, +8
  int my_kv = wq0 < t ? n_kv : 0;
  if (causal && wq0 < t) my_kv = min(n_kv, (min(wq0 + 64, t) - 1) / BN + 1);
  const float* qa = reinterpret_cast<const float*>(smem) +
                    (wg * 64 + warp * 16 + g) * C::LDQ + 2 * c;
  const uint32_t k_hi = smem_u32(smem + C::k_off);
  const uint32_t k_lo = k_hi + C::split_bytes;
  const uint32_t v_hi = smem_u32(smem + C::v_off);
  const uint32_t v_lo = v_hi + C::split_bytes;

  float o[N64 ? N64 : 1][32];
  float o32[16];
#pragma unroll
  for (int h = 0; h < N64; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o32[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;

  if (my_kv > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const uint32_t phase = j & 1;
    if (j >= my_kv) {
      mbar_wait(k_full, phase);
      if (tid == 0) mbar_arrive(k_empty);
      mbar_wait(v_full, phase);
      if (tid == 0) mbar_arrive(v_empty);
      continue;
    }

    float sc[BN / 2];
    mbar_wait(k_full, phase);
    scores<D, BN, C::LDQ, KC>(qa, k_hi, k_lo, sc);
    if (tid == 0) mbar_arrive(k_empty);

    const int c0 = j * BN;
    if (c0 + BN > kv_len || (causal && c0 + BN - 1 > wq0)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = c0 + 8 * (i >> 2) + 2 * c + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= kv_len || (causal && row < col)) sc[i] = MASK_VALUE;
      }
    }
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
    for (int h = 0; h < N64; ++h) {
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        o[h][i] *= alpha0;
        o[h][i + 1] *= alpha0;
        o[h][i + 2] *= alpha1;
        o[h][i + 3] *= alpha1;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      o32[i] *= alpha0;
      o32[i + 1] *= alpha0;
      o32[i + 2] *= alpha1;
      o32[i + 3] *= alpha1;
    }
    // P split in place: the accumulator's columns 2c and 2c + 1 are the A
    // fragment's k = c and c + 4.
    uint32_t p_hi[BN / 8][4], p_lo[BN / 8][4];
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      split_tf32(sc[4 * kk], p_hi[kk][0], p_lo[kk][0]);
      split_tf32(sc[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
      split_tf32(sc[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
      split_tf32(sc[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
    }

    // O += P V, 64 columns a chain (V^T's rows).
    mbar_wait(v_full, phase);
#pragma unroll
    for (int h = 0; h < N64; ++h)
      pv_chunk<D, BN, 64>(o[h], p_hi, p_lo, v_hi, v_lo, 64 * h);
    if constexpr (N32 != 0)
      pv_chunk<D, BN, 32>(o32, p_hi, p_lo, v_hi, v_lo, 64 * N64);
    if (tid == 0) mbar_arrive(v_empty);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (row0 >= t) return;  // rows past t: no output (t is a multiple of 64)
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  float* r0 = out + (static_cast<size_t>(bh) * t + row0) * D + 2 * c;
#pragma unroll
  for (int i = 0; i < N64 * 32 + N32 * 16; i += 4) {
    const float* a = i < N64 * 32 ? &o[i / 32][i % 32] : &o32[i - N64 * 32];
    const int col = 8 * (i / 4);  // + 2c: 64 columns a chunk of 32
    *reinterpret_cast<float2*>(r0 + col) =
        make_float2(a[0] / safe0, a[1] / safe0);
    *reinterpret_cast<float2*>(r0 + 8 * D + col) =
        make_float2(a[2] / safe1, a[3] / safe1);
  }
  if (c == 0) {
    lse[static_cast<size_t>(bh) * t + row0] = m0 + log2f(safe0);
    lse[static_cast<size_t>(bh) * t + row0 + 8] = m1 + log2f(safe1);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q2,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int t, int tk, int kv_len,
                        int causal) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_tf32[];
  unsigned char* smem = align_1024(smem_tf32);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = bars + 2;
  uint64_t* v_full = bars + 3;
  uint64_t* v_empty = bars + 4;

  // q tiles heaviest first over all heads, as the 16-bit kernel.
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % gridDim.y;
  const int q0 = (gridDim.x - 1 - lin / gridDim.y) * C::BM;
  const int kv_end = causal ? min(kv_len, min(q0 + C::BM, t)) : kv_len;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, WG_THREADS);
    mbar_init(k_full, WG_THREADS);
    mbar_init(v_full, WG_THREADS);
    mbar_init(k_empty, C::CONSUMERS);
    mbar_init(v_empty, C::CONSUMERS);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == C::CONSUMERS) {
    // ---- converter: Q as it is, K and V as TF32 split copies -----------
    // Two consumers take the registers it gives up (216 * 256 + 64 * 128
    // <= 168 * 384: an increase the block's own decrease does not cover
    // never returns).
    if constexpr (C::CONSUMERS == 2) setmaxnreg_dec<64>();
    const int tid = threadIdx.x % WG_THREADS;
    float* sq = reinterpret_cast<float*>(smem);
    const float* qg = q2 + (static_cast<size_t>(bh) * t + q0) * D;
    const int q_rows = min(C::BM, t - q0);
    for (int e = tid; e < q_rows * (D / 4); e += WG_THREADS) {
      const int r = e / (D / 4), c4 = e % (D / 4);
      *reinterpret_cast<float4*>(sq + r * C::LDQ + 4 * c4) =
          *reinterpret_cast<const float4*>(qg + static_cast<size_t>(r) * D +
                                           4 * c4);
    }
    mbar_arrive(q_full);
    const float* kg = k + static_cast<size_t>(bh) * tk * D;
    const float* vg = v + static_cast<size_t>(bh) * tk * D;
    for (int j = 0; j < n_kv; ++j) {
      const uint32_t parity = (j & 1) ^ 1;
      mbar_wait(k_empty, parity);
      split_k<D>(smem + C::k_off, C::split_bytes,
                 kg + static_cast<size_t>(j) * BN * D, BN, tid);
      fence_proxy_async();
      mbar_arrive(k_full);
      mbar_wait(v_empty, parity);
      split_vt<D>(smem + C::v_off, C::split_bytes,
                  vg + static_cast<size_t>(j) * BN * D, BN, tid);
      fence_proxy_async();
      mbar_arrive(v_full);
    }
  } else {
    // ---- consumers: 64 q rows each -------------------------------------
    if constexpr (C::CONSUMERS == 2) setmaxnreg_inc<216>();
    consume<D>(smem, q_full, k_full, k_empty, v_full, v_empty, wg, out, lse,
               bh, q0, t, n_kv, kv_len, causal);
  }
}

template <int D>
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          void* out, void* lse, int bh, int t, int tk,
                          int kv_len, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + C::BM - 1) / C::BM, bh);
  flash_fwd_tf32_kernel<D><<<grid, C::THREADS, C::bytes, stream>>>(
      static_cast<const float*>(q2), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), t, tk, kv_len, causal);
  return cudaGetLastError();
}

static cudaError_t launch_d(const void* q2, const void* k, const void* v,
                            void* out, void* lse, int bh, int t, int tk, int d,
                            int kv_len, int causal, cudaStream_t s) {
  switch (d) {
#define RTT_FWD_TF32_D(D) \
  case D:                 \
    return launch<D>(q2, k, v, out, lse, bh, t, tk, kv_len, causal, s);
    RTT_FWD_TF32_D(32)
    RTT_FWD_TF32_D(64)
    RTT_FWD_TF32_D(96)
    RTT_FWD_TF32_D(128)
    RTT_FWD_TF32_D(160)
    RTT_FWD_TF32_D(192)
    RTT_FWD_TF32_D(224)
    RTT_FWD_TF32_D(256)
#undef RTT_FWD_TF32_D
  }
  return cudaErrorInvalidValue;
}

// S = Q2 K^T alone at d 256 (the longest sum), by the kernel's own code:
// one warpgroup splits a 64-row K tile into smem (split_k), then forms
// its 64 q rows' S (scores) from Q2 read in global memory. A check of the
// split on the card, no part of the op.
template <bool ONE_CHAIN, bool CVT>
__global__ void __launch_bounds__(WG_THREADS, 1)
scores_tf32x3_kernel(const float* __restrict__ q2, const float* __restrict__ k,
                     float* __restrict__ s, int t, int tk) {
  constexpr int D = 256, BN = 64, SPLIT = BN * D * 4;
  extern __shared__ unsigned char smem_scores[];
  unsigned char* smem = align_1024(smem_scores);
  const int bh = blockIdx.z, r0 = blockIdx.x * 64, n0 = blockIdx.y * BN;
  split_k<D, CVT>(smem, SPLIT, k + (static_cast<size_t>(bh) * tk + n0) * D,
                  BN, threadIdx.x);
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int c = threadIdx.x & 3;
  const int row = r0 + warp * 16 + g;
  float sc[BN / 2];
  scores<D, BN, D, chain_steps<D>(), ONE_CHAIN, CVT>(
      q2 + (static_cast<size_t>(bh) * t + row) * D + 2 * c, smem_u32(smem),
      smem_u32(smem) + SPLIT, sc);
  float* out = s + (static_cast<size_t>(bh) * t + row) * tk + n0 + 2 * c;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    out[8 * ((i >> 1) & 1) * tk + 8 * (i >> 2) + (i & 1)] = sc[i];
}

constexpr int SCORES_SMEM = 2 * 64 * 256 * 4 + 1024;

}  // namespace tf32

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
// f32 at d > 256: three-term TF32 on wgmma, the output split by columns
// ---------------------------------------------------------------------------

namespace wide_tf32 {

constexpr int BM = 64;    // q rows of a block: one consumer warpgroup
constexpr int BN = 32;    // KV rows of a tile
constexpr int DC = 256;   // output columns of a block (a chunk)
constexpr int KB = 64;    // columns of a K box: one chain of 8 k-steps
constexpr int SLOTS = 2;  // the ring of split K boxes
constexpr int THREADS = 2 * WG_THREADS;  // the consumer, then the converter
constexpr int K_SPLIT = BN * KB * 4;     // one copy (hi or lo) of a K box
constexpr int V_SPLIT = DC * BN * 4;     // one copy of V^T's chunk
constexpr int SMEM_MAX = 232448;         // what a block may use

// Shared memory for head_dim d: [Q2 (f32, rows padded by 4 floats) if it
// fits] [SLOTS split K boxes: hi, lo] [V^T's chunk: hi, lo] [barriers].
// Q2 stays resident up to d 512 (129 KB); above, the consumer reads its
// Q2 rows from global memory (L2) at every KV tile.
struct Layout {
  bool q_resident;
  int ldq;  // Q2's row pitch in floats where the consumer reads it
  int k_off, v_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int d) {
  Layout L;
  const int q_bytes = BM * (d + 4) * 4;  // a multiple of 1024 (d % 4 == 0)
  const int rest = SLOTS * 2 * K_SPLIT + 2 * V_SPLIT + 64 + 1024;
  L.q_resident = q_bytes + rest <= SMEM_MAX;
  L.ldq = L.q_resident ? d + 4 : d;
  L.k_off = L.q_resident ? q_bytes : 0;
  L.v_off = L.k_off + SLOTS * 2 * K_SPLIT;
  L.bar_off = L.v_off + 2 * V_SPLIT;
  L.bytes = L.bar_off + 64 + 1024;  // + alignment slack
  return L;
}

// The converter's share of a K box (BN rows, `steps` k-steps of 8 columns
// from `src`, row pitch d), as tf32::split_k takes it: row 8 * warp +
// lane % 8, steps lane / 8 and lane / 8 + 4. Loaded before the converter
// waits for the box's slot, so the loads are in flight meanwhile.
struct KBox {
  float4 x[4];
};

__device__ __forceinline__ void load_k_box(KBox& kb, const float* src, int d,
                                           int steps, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const float* row = src + static_cast<size_t>(warp * 8 + (lane & 7)) * d +
                     8 * (lane >> 3);
  kb.x[0] = *reinterpret_cast<const float4*>(row);
  kb.x[1] = *reinterpret_cast<const float4*>(row + 4);
  if (steps == 8) {
    kb.x[2] = *reinterpret_cast<const float4*>(row + 32);
    kb.x[3] = *reinterpret_cast<const float4*>(row + 36);
  }
}

// The box split into K-major hi and lo copies at dst and dst + K_SPLIT, in
// tf32::split_k's layout (32-column sub-boxes under the 128-byte swizzle,
// each step's even and odd columns in one whole 16-byte chunk each). A
// box of 4 steps (d an odd multiple of 32) gets zeros in steps 4-7, so
// that every chain is 8 steps and their products are zero (wgmma in a
// branch made ptxas serialise them all: C7520).
__device__ __forceinline__ void store_k_box(unsigned char* dst,
                                            const KBox& kb, int steps,
                                            int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int r = warp * 8 + (lane & 7);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int s = (lane >> 3) + 4 * m;
    uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
    if (m == 1 && steps != 8) {  // a 32-column last box: zeros past d
      const int at = tf32::step_chunk(r, s, 0, BN);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      *reinterpret_cast<uint4*>(dst + K_SPLIT + at) = lo;
      const int at1 = tf32::step_chunk(r, s, 1, BN);
      *reinterpret_cast<uint4*>(dst + at1) = hi;
      *reinterpret_cast<uint4*>(dst + K_SPLIT + at1) = lo;
      break;
    }
    const float4 a = kb.x[2 * m], b = kb.x[2 * m + 1];
    tf32::split4(a.x, a.z, b.x, b.z, hi, lo);
    int at = tf32::step_chunk(r, s, 0, BN);
    *reinterpret_cast<uint4*>(dst + at) = hi;
    *reinterpret_cast<uint4*>(dst + K_SPLIT + at) = lo;
    tf32::split4(a.y, a.w, b.y, b.w, hi, lo);
    at = tf32::step_chunk(r, s, 1, BN);
    *reinterpret_cast<uint4*>(dst + at) = hi;
    *reinterpret_cast<uint4*>(dst + K_SPLIT + at) = lo;
  }
}

// V's tile [BN x cw] (from `src`, row pitch d) split into K-major hi and
// lo copies of V^T [cw x BN], as tf32::split_vt lays them out: a thread
// takes one step's 8 rows of 4 columns (at most two such items), all
// loaded first. Rows of V^T from cw up to the next multiple of 64 keep
// what they held: they reach only O's columns past cw, never stored.
struct VItems {
  float4 x[2][8];
};

__device__ __forceinline__ void load_v(VItems& vi, const float* src, int d,
                                       int cw, int tid) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * WG_THREADS;
    if (i >= cw) break;
    const int s = i % (BN / 8), n4 = i / (BN / 8);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      vi.x[u][j] = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(8 * s + j) * d + 4 * n4);
  }
}

__device__ __forceinline__ void store_vt(unsigned char* dst, const VItems& vi,
                                         int cw, int tid) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * WG_THREADS;
    if (i >= cw) break;
    const int s = i % (BN / 8), n4 = i / (BN / 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * n4 + e;
      const auto col = [&](int j) {
        const float4& x = vi.x[u][j];
        return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
      };
      uint4 hi, lo;
      tf32::split4(col(0), col(2), col(4), col(6), hi, lo);
      int at = tf32::step_chunk(n, s, 0, DC);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      *reinterpret_cast<uint4*>(dst + V_SPLIT + at) = lo;
      tf32::split4(col(1), col(3), col(5), col(7), hi, lo);
      at = tf32::step_chunk(n, s, 1, DC);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      *reinterpret_cast<uint4*>(dst + V_SPLIT + at) = lo;
    }
  }
}

// Pins each register of `x` at this point of the program: a wgmma's A
// operands computed before its fence stay there (left to itself, ptxas
// moved the split between the wgmmas and injected a warpgroup.arrive
// before each: C7519).
template <int R, int C>
__device__ __forceinline__ void pin(uint32_t (&x)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) asm volatile("" : "+r"(x[r][c]));
  }
}

// S [64 x BN] += this box's chain: Q2's columns from step k0 split into
// registers per k-step (the A operand; `qa` points at this thread's
// Q2[g][2c], pitch lda, in shared or global memory; past step `ksteps` =
// d / 8 the last step's again, which meet the zeros of a short box), before
// waiting on `full` for the box's split copies at k_hi and k_lo (B); KB /
// 8 k-steps of three terms in one tensor-core chain, added into S by an
// f32 add.
__device__ __forceinline__ void box_chain(const float* qa, int lda, int k0,
                                          int ksteps, uint64_t* full,
                                          uint32_t parity, uint32_t k_hi,
                                          uint32_t k_lo, float (&sc)[BN / 2]) {
  constexpr int KC = KB / 8;
  uint32_t a_hi[KC][4], a_lo[KC][4];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const int ks = min(k0 + kk, ksteps - 1);
    const float2 top = *reinterpret_cast<const float2*>(qa + 8 * ks);
    const float2 bot = *reinterpret_cast<const float2*>(qa + 8 * lda + 8 * ks);
    split_tf32(top.x, a_hi[kk][0], a_lo[kk][0]);
    split_tf32(bot.x, a_hi[kk][1], a_lo[kk][1]);
    split_tf32(top.y, a_hi[kk][2], a_lo[kk][2]);
    split_tf32(bot.y, a_hi[kk][3], a_lo[kk][3]);
  }
  pin(a_hi);
  pin(a_lo);
  mbar_wait(full, parity);  // the box's split copies are in place
  float part[BN / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    wgmma_tf32(part, a_lo[kk], kmajor_desc(k_hi, BN, kk), kk > 0);
    wgmma_tf32(part, a_hi[kk], kmajor_desc(k_lo, BN, kk), 1);
    wgmma_tf32(part, a_hi[kk], kmajor_desc(k_hi, BN, kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] += part[i];
}

// The consumer warpgroup: its 64 q rows against every KV tile, NC pieces
// of 64 output columns from c0 (the last may run past cw).
template <int NC>
__device__ __forceinline__ void consume(
    const unsigned char* smem, const Layout& L, const float* __restrict__ q2,
    uint64_t* q_full, uint64_t* full, uint64_t* empty, uint64_t* v_full,
    uint64_t* v_empty, float* __restrict__ out, float* __restrict__ lse,
    int bh, int q0, int c0, int cw, int t, int d, int nb, int n_kv,
    int kv_len, int causal) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int c = tid & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, +8
  const float* qa =
      L.q_resident
          ? reinterpret_cast<const float*>(smem) + (warp * 16 + g) * L.ldq +
                2 * c
          : q2 + (static_cast<size_t>(bh) * t + row0) * d + 2 * c;
  const uint32_t v_hi = smem_u32(smem + L.v_off);
  const uint32_t v_lo = v_hi + V_SPLIT;

  float o[NC][32];
#pragma unroll
  for (int h = 0; h < NC; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;

  if (L.q_resident && n_kv > 0) mbar_wait(q_full, 0);
  int i = 0;  // boxes through the ring so far
  for (int j = 0; j < n_kv; ++j) {
    // S = Q2 K^T over all of d, box by box in column order: every chunk's
    // block makes the same chains in the same order.
    float sc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
    for (int h = 0; h < nb; ++h, ++i) {
      const int s = i % SLOTS;
      const uint32_t k_hi = smem_u32(smem + L.k_off + s * 2 * K_SPLIT);
      box_chain(qa, L.ldq, 8 * h, d / 8, &full[s], (i / SLOTS) & 1, k_hi,
                k_hi + K_SPLIT, sc);
      if (tid == 0) mbar_arrive(&empty[s]);
    }

    const int kv0 = j * BN;
    if (kv0 + BN > kv_len || (causal && kv0 + BN - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int col = kv0 + 8 * (e >> 2) + 2 * c + (e & 1);
        const int row = row0 + 8 * ((e >> 1) & 1);
        if (col >= kv_len || (causal && row < col)) sc[e] = MASK_VALUE;
      }
    }
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
    for (int h = 0; h < NC; ++h) {
#pragma unroll
      for (int e = 0; e < 32; e += 4) {
        o[h][e] *= alpha0;
        o[h][e + 1] *= alpha0;
        o[h][e + 2] *= alpha1;
        o[h][e + 3] *= alpha1;
      }
    }
    // P split in place: the accumulator's columns 2c and 2c + 1 are the A
    // fragment's k = c and c + 4.
    uint32_t p_hi[BN / 8][4], p_lo[BN / 8][4];
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      split_tf32(sc[4 * kk], p_hi[kk][0], p_lo[kk][0]);
      split_tf32(sc[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
      split_tf32(sc[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
      split_tf32(sc[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
    }
    pin(p_hi);
    pin(p_lo);

    // O += P V for this chunk's columns, 128 a chain (V^T's rows), the
    // last 64 alone where NC is odd.
    mbar_wait(v_full, j & 1);
#pragma unroll
    for (int h = 0; h < NC; h += 2) {
      if (h + 1 < NC) {
        const uint32_t at = 64 * h * BOX_ROW_BYTES;
        float part[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          wgmma_tf32(part, p_lo[kk], kmajor_desc(v_hi + at, DC, kk), kk > 0);
          wgmma_tf32(part, p_hi[kk], kmajor_desc(v_lo + at, DC, kk), 1);
          wgmma_tf32(part, p_hi[kk], kmajor_desc(v_hi + at, DC, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(part);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          o[h][e] += part[e];
          o[h + 1][e] += part[32 + e];
        }
      } else {
        tf32::pv_chunk<DC, BN, 64>(o[h], p_hi, p_lo, v_hi, v_lo, 64 * h);
      }
    }
    if (tid == 0) mbar_arrive(v_empty);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  float* r0 = out + (static_cast<size_t>(bh) * t + row0) * d + c0 + 2 * c;
#pragma unroll
  for (int h = 0; h < NC; ++h) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 64 * h + 8 * nt;  // + 2c
      if (col >= cw) continue;
      *reinterpret_cast<float2*>(r0 + col) =
          make_float2(o[h][4 * nt] / safe0, o[h][4 * nt + 1] / safe0);
      *reinterpret_cast<float2*>(r0 + 8 * static_cast<size_t>(d) + col) =
          make_float2(o[h][4 * nt + 2] / safe1, o[h][4 * nt + 3] / safe1);
    }
  }
  if (c0 == 0 && c == 0) {  // chunk 0 writes lse
    lse[static_cast<size_t>(bh) * t + row0] = m0 + log2f(safe0);
    lse[static_cast<size_t>(bh) * t + row0 + 8] = m1 + log2f(safe1);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide_tf32_kernel(const float* __restrict__ q2,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           int t, int tk, int d, int kv_len, int causal) {
  const Layout L = layout(d);
  extern __shared__ unsigned char smem_wide_tf32[];
  unsigned char* smem = align_1024(smem_wide_tf32);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + SLOTS;
  uint64_t* v_full = empty + SLOTS;
  uint64_t* v_empty = v_full + 1;

  // Blocks in linear order: a q tile's chunks side by side (they read
  // the same K boxes), the q tiles heaviest first across all heads, so
  // that the grid's last wave holds the lightest (head by head, the
  // heaviest tiles of the last heads started late: 17% slower on an
  // H100 at bh 16 x 1024 x 512, causal).
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rest = lin / gridDim.z;
  const int bh = rest % gridDim.y;
  const int q0 = (gridDim.x - 1 - rest / gridDim.y) * BM;
  const int c0 = lin % gridDim.z * DC;  // this block's output columns:
  const int cw = min(DC, d - c0);       // [c0, c0 + cw)
  const int nb = (d + KB - 1) / KB;  // K boxes of a row (the last may be
                                     // 32 columns)
  const int kv_end = causal ? min(kv_len, q0 + BM) : kv_len;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, WG_THREADS);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], WG_THREADS);
      mbar_init(&empty[s], 1);
    }
    mbar_init(v_full, WG_THREADS);
    mbar_init(v_empty, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's role, broadcast so that the compiler sees it uniform
  // (a wgmma in a branch it cannot prove uniform is serialised: C7520).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  if (wg == 1) {
    // ---- converter: Q2 as it is, K boxes and V^T's chunk split ----------
    const int tid = threadIdx.x - WG_THREADS;
    if (L.q_resident) {
      float* sq = reinterpret_cast<float*>(smem);
      const float* qg = q2 + (static_cast<size_t>(bh) * t + q0) * d;
      for (int e = tid; e < BM * (d / 4); e += WG_THREADS) {
        const int r = e / (d / 4), c4 = e % (d / 4);
        *reinterpret_cast<float4*>(sq + r * L.ldq + 4 * c4) =
            *reinterpret_cast<const float4*>(qg + static_cast<size_t>(r) * d +
                                             4 * c4);
      }
      mbar_arrive(q_full);
    }
    // Each box's loads are issued one box ahead, and V's tile with the
    // tile's first box, so that they are in flight while the converter
    // waits and stores.
    const float* kg = k + static_cast<size_t>(bh) * tk * d;
    const float* vg = v + static_cast<size_t>(bh) * tk * d + c0;
    const auto box_steps = [&](int h) { return min(8, (d - KB * h) / 8); };
    KBox cur, next;
    if (n_kv > 0) load_k_box(cur, kg, d, box_steps(0), tid);
    int i = 0;
    for (int j = 0; j < n_kv; ++j) {
      VItems vi;
      for (int h = 0; h < nb; ++h, ++i) {
        const int nh = h + 1 < nb ? h + 1 : 0;
        const int nj = h + 1 < nb ? j : j + 1;
        if (nj < n_kv)
          load_k_box(next, kg + static_cast<size_t>(nj) * BN * d + KB * nh,
                     d, box_steps(nh), tid);
        if (h == 0)
          load_v(vi, vg + static_cast<size_t>(j) * BN * d, d, cw, tid);
        const int s = i % SLOTS;
        mbar_wait(&empty[s], ((i / SLOTS) & 1) ^ 1);
        store_k_box(smem + L.k_off + s * 2 * K_SPLIT, cur, box_steps(h), tid);
        fence_proxy_async();
        mbar_arrive(&full[s]);
        cur = next;
      }
      mbar_wait(v_empty, (j & 1) ^ 1);
      store_vt(smem + L.v_off, vi, cw, tid);
      fence_proxy_async();
      mbar_arrive(v_full);
    }
  } else {
    // ---- the consumer: 64 q rows ----------------------------------------
#define RTT_WIDE_TF32_CONSUME(NC)                                          \
  case NC:                                                                 \
    consume<NC>(smem, L, q2, q_full, full, empty, v_full, v_empty, out,    \
                lse, bh, q0, c0, cw, t, d, nb, n_kv, kv_len, causal);      \
    break;
    switch ((cw + 63) / 64) {
      RTT_WIDE_TF32_CONSUME(1)
      RTT_WIDE_TF32_CONSUME(2)
      RTT_WIDE_TF32_CONSUME(3)
      RTT_WIDE_TF32_CONSUME(4)
    }
#undef RTT_WIDE_TF32_CONSUME
  }
}

static cudaError_t launch(const void* q2, const void* k, const void* v,
                          void* out, void* lse, int bh, int t, int tk, int d,
                          int kv_len, int causal, cudaStream_t stream) {
  const int bytes = layout(d).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(t / BM, bh, (d + DC - 1) / DC);
  flash_fwd_wide_tf32_kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q2), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), t, tk, d, kv_len, causal);
  return cudaGetLastError();
}

}  // namespace wide_tf32

// ---------------------------------------------------------------------------
// bf16/f16 at d > 256: wgmma on a TMA ring, the output split by columns
// ---------------------------------------------------------------------------

namespace wide_wg {

constexpr int BM = 128;           // q rows of a block
constexpr int BN = 64;            // KV rows of a tile
constexpr int DC = 256;           // output columns of a block (a chunk)
constexpr int SLOTS = 4;          // the K-box ring
constexpr int CONSUMERS = 2;      // warpgroups, 64 q rows each
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;
constexpr int Q_BOX = BM * BOX_ROW_BYTES;        // 16 KB
constexpr int K_BOX = BN * BOX_ROW_BYTES;        // 8 KB
constexpr int V_STAGE = DC / BOX_COLS * K_BOX;   // 32 KB
// Q stays resident up to this many 64-column boxes (d <= 512: 128 KB);
// above, each Q box comes through the ring beside its K box.
constexpr int Q_RESIDENT_BOXES = 8;

// Shared memory for `nb` boxes of a row: [resident Q] [SLOTS slots: K box
// (+ Q box)] [2 V stages] [barriers]. Every box starts on 1024 bytes.
struct Layout {
  bool q_resident;
  int slot_bytes, slots_off, v_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int nb) {
  Layout L;
  L.q_resident = nb <= Q_RESIDENT_BOXES;
  L.slot_bytes = L.q_resident ? K_BOX : K_BOX + Q_BOX;
  L.slots_off = L.q_resident ? nb * Q_BOX : 0;
  L.v_off = L.slots_off + SLOTS * L.slot_bytes;
  L.bar_off = L.v_off + 2 * V_STAGE;
  L.bytes = L.bar_off + 128 + 1024;  // + alignment slack
  return L;
}

// One consumer warpgroup's 64 q rows against every KV tile, NC boxes of
// output columns from c0.
template <typename T, int NC>
__device__ __forceinline__ void consume(
    unsigned char* smem, const Layout& L, uint64_t* q_full, uint64_t* full,
    uint64_t* empty, uint64_t* v_full, uint64_t* v_empty, int wg,
    T* __restrict__ out, float* __restrict__ lse, int bh, int q0, int c0,
    int t, int d, int nb, int n_kv, int kv_len, int causal) {
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int c = tid & 3;
  const int wq0 = q0 + wg * 64;          // this warpgroup's first row
  const int row0 = wq0 + warp * 16 + g;  // this thread's rows: row0, +8
  // The KV tiles holding an unmasked column of this warpgroup's rows; it
  // only releases the others' boxes, after they have landed.
  int my_kv = wq0 < t ? n_kv : 0;
  if (causal && wq0 < t) my_kv = min(n_kv, (min(wq0 + 64, t) - 1) / BN + 1);

  float o[NC * 32];  // box h's accumulator at o[32h .. 32h + 31]
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;

  if (L.q_resident && my_kv > 0) mbar_wait(q_full, 0);
  int i = 0;  // boxes through the ring so far
  for (int j = 0; j < n_kv; ++j) {
    const int vs = j & 1;
    const uint32_t v_phase = (j >> 1) & 1;
    if (j >= my_kv) {
      for (int h = 0; h < nb; ++h, ++i) {
        mbar_wait(&full[i % SLOTS], (i / SLOTS) & 1);
        if (tid == 0) mbar_arrive(&empty[i % SLOTS]);
      }
      mbar_wait(&v_full[vs], v_phase);
      if (tid == 0) mbar_arrive(&v_empty[vs]);
      continue;
    }

    // S = Q2 K^T over all of d, box by box in column order: every chunk's
    // block makes the same products in the same order.
    float sc[BN / 2];
    for (int h = 0; h < nb; ++h, ++i) {
      const int s = i % SLOTS;
      const uint32_t slot = smem_u32(smem + L.slots_off + s * L.slot_bytes);
      const uint32_t q_box =
          (L.q_resident ? smem_u32(smem) + h * Q_BOX : slot + K_BOX) +
          wg * 64 * BOX_ROW_BYTES;
      mbar_wait(&full[s], (i / SLOTS) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BOX_COLS / 16; ++k)
        wgmma_ss<0, 0, T>(sc, kmajor_desc(q_box, BM, k),
                          kmajor_desc(slot, BN, k), h > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      if (tid == 0) mbar_arrive(&empty[s]);
    }

    const int kv0 = j * BN;
    if (kv0 + BN > kv_len || (causal && kv0 + BN - 1 > wq0)) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int col = kv0 + 8 * (e >> 2) + 2 * c + (e & 1);
        const int row = row0 + 8 * ((e >> 1) & 1);
        if (col >= kv_len || (causal && row < col)) sc[e] = MASK_VALUE;
      }
    }

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
    for (int e = 0; e < NC * 32; e += 4) {
      o[e] *= alpha0;
      o[e + 1] *= alpha0;
      o[e + 2] *= alpha1;
      o[e + 3] *= alpha1;
    }
    // P rounded to T: the A fragments of the 16-column slices.
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int k = 0; k < BN / 16; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[k][r] = pack2<T>(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1]);
    }

    // O += P V for this chunk's columns (N = 64 NC, V read transposed).
    mbar_wait(&v_full[vs], v_phase);
    const uint32_t v_tile = smem_u32(smem + L.v_off + vs * V_STAGE);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BN / 16; ++k)
      wgmma_rs<1, T>(o, pa[k], mnmajor_desc(v_tile, BN, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    if (tid == 0) mbar_arrive(&v_empty[vs]);
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
  for (int h = 0; h < NC; ++h) {
#pragma unroll
    for (int nt = 0; nt < BOX_COLS / 8; ++nt) {
      const int col = c0 + h * BOX_COLS + 8 * nt;  // + 2c, within one box
      if (col >= d) continue;
      if (row0 < t)
        *reinterpret_cast<uint32_t*>(row_out + col) =
            pack2<T>(o[32 * h + 4 * nt] * inv0, o[32 * h + 4 * nt + 1] * inv0);
      if (row0 + 8 < t)
        *reinterpret_cast<uint32_t*>(row_out + 8 * d + col) = pack2<T>(
            o[32 * h + 4 * nt + 2] * inv1, o[32 * h + 4 * nt + 3] * inv1);
    }
  }
  if (c0 == 0 && c == 0) {  // chunk 0 writes lse
    if (row0 < t) lse[static_cast<size_t>(bh) * t + row0] = m0 + log2f(safe0);
    if (row0 + 8 < t)
      lse[static_cast<size_t>(bh) * t + row0 + 8] = m1 + log2f(safe1);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            T* __restrict__ out, float* __restrict__ lse,
                            int t, int d, int kv_len, int causal) {
  const int nb = (d + BOX_COLS - 1) / BOX_COLS;  // 64-column boxes of a row
  const Layout L = layout(nb);
  extern __shared__ unsigned char smem_wide[];
  unsigned char* smem = align_1024(smem_wide);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + SLOTS;
  uint64_t* v_full = empty + SLOTS;
  uint64_t* v_empty = v_full + 2;

  // q tiles heaviest first over all heads (bh fastest); chunks outermost.
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % gridDim.y;
  const int q0 = (gridDim.x - 1 - lin / gridDim.y) * BM;
  const int c0 = blockIdx.z * DC;                        // this block's
  const int nc = min(DC, nb * BOX_COLS - c0) / BOX_COLS; // V boxes (1-4)
  int n_kv = (kv_len + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + BM, t) - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x % WG_THREADS == 0) {
      if (L.q_resident) {
        mbar_arrive_expect_tx(q_full, nb * Q_BOX);
        for (int h = 0; h < nb; ++h)
          tma_load_3d(smem + h * Q_BOX, &tm_q, q_full, h * BOX_COLS, q0, bh);
      }
      int i = 0;
      for (int j = 0; j < n_kv; ++j) {
        for (int h = 0; h < nb; ++h, ++i) {
          const int s = i % SLOTS;
          mbar_wait(&empty[s], ((i / SLOTS) & 1) ^ 1);
          unsigned char* slot = smem + L.slots_off + s * L.slot_bytes;
          mbar_arrive_expect_tx(&full[s], L.slot_bytes);
          tma_load_3d(slot, &tm_k, &full[s], h * BOX_COLS, j * BN, bh);
          if (!L.q_resident)
            tma_load_3d(slot + K_BOX, &tm_q, &full[s], h * BOX_COLS, q0, bh);
        }
        const int vs = j & 1;
        mbar_wait(&v_empty[vs], ((j >> 1) & 1) ^ 1);
        unsigned char* sv = smem + L.v_off + vs * V_STAGE;
        mbar_arrive_expect_tx(&v_full[vs], nc * K_BOX);
        for (int h = 0; h < nc; ++h)
          tma_load_3d(sv + h * K_BOX, &tm_v, &v_full[vs], c0 + h * BOX_COLS,
                      j * BN, bh);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    setmaxnreg_inc<240>();
#define RTT_WIDE_CONSUME(NC)                                                 \
  case NC:                                                                   \
    consume<T, NC>(smem, L, q_full, full, empty, v_full, v_empty, wg, out,   \
                   lse, bh, q0, c0, t, d, nb, n_kv, kv_len, causal);         \
    break;
    switch (nc) {
      RTT_WIDE_CONSUME(1)
      RTT_WIDE_CONSUME(2)
      RTT_WIDE_CONSUME(3)
      RTT_WIDE_CONSUME(4)
    }
#undef RTT_WIDE_CONSUME
  }
}

template <typename T>
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
  const int nb = (d + BOX_COLS - 1) / BOX_COLS;
  const int bytes = layout(nb).bytes;
  err = cudaFuncSetAttribute(flash_fwd_wide_wgmma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BM - 1) / BM, bh, (nb * BOX_COLS + DC - 1) / DC);
  flash_fwd_wide_wgmma_kernel<T><<<grid, THREADS, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), static_cast<float*>(lse), t, d,
      kv_len, causal);
  return cudaGetLastError();
}

}  // namespace wide_wg

}  // namespace fwd
}  // namespace any
}  // namespace rtt

// dtype: 0 f32, 1 bf16, 2 f16 (q2, k, v, out); lse f32 [bh, t]. All
// contiguous and 16-byte aligned; t and tk multiples of 64; d a multiple
// of 32 up to 256; 0 < kv_len <= tk. Every dtype runs on wgmma, f32 in
// three-term TF32. Returns the CUDA error of the launch (0 on success).
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
      return tf32::launch_d(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal,
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
// 256): bf16 and f16 on the column-split wgmma kernel, f32 on the
// column-split three-term TF32 kernel.
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
      return wide_tf32::launch(q2, k, v, out, lse, bh, t, tk, d, kv_len,
                               causal, s);
    case 1:
      return wide_wg::launch<__nv_bfloat16>(q2, k, v, out, lse, bh, t, tk, d,
                                            kv_len, causal, s);
    case 2:
      return wide_wg::launch<__half>(q2, k, v, out, lse, bh, t, tk, d,
                                     kv_len, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// S = q2 k^T [bh, t, tk] f32 by the f32 kernel's three-term TF32 product
// (q2, k f32 [bh, t or tk, 256]; t and tk multiples of 64): mode 0 as the
// kernel makes it, 1 in one tensor-core chain over all of d, 2 with the
// split rounded by cvt.rna.tf32.f32 (equal to mode 0 bit for bit). A check
// of the split on the card, which the op never calls.
extern "C" int rtt_scores_tf32x3(const void* q2, const void* k, void* s,
                                 int bh, int t, int tk, int d, int mode,
                                 void* stream) {
  using namespace rtt::any::fwd::tf32;
  if (bh <= 0 || t <= 0 || t % 64 || tk <= 0 || tk % 64 || d != 256 ||
      mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mode == 0   ? scores_tf32x3_kernel<false, false>
                : mode == 1 ? scores_tf32x3_kernel<true, false>
                            : scores_tf32x3_kernel<false, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SCORES_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(t / 64, tk / 64, bh), rtt::WG_THREADS, SCORES_SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q2), static_cast<const float*>(k),
      static_cast<float*>(s), t, tk);
  return static_cast<int>(cudaGetLastError());
}
