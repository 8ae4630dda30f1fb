// Flash-attention backward for every (dtype, head_dim) that the wgmma
// kernels of flash_bwd.cu (bf16, d 64 or 128) do not take: bf16, f16 and
// f32 inputs at any head_dim (the op pads a head_dim with zero columns to
// the next multiple of 32, which leaves every gradient's true columns
// unchanged).
//
// Replaces the TPU kernel `_bwd_fused_kernel` launched by
// `_flash_backward_fused` (ray_tpu/ops/attention.py:302, pallas_call at
// :489) for those inputs. The op is three launches, as flash_bwd.cu's:
//   flash_bwd_any_pre_kernel: delta = rowsum(out * do) in f32; dq_acc = 0
//   main kernel:              P  = exp2(q2 k^T - lse)       (masked entries 0)
//                             dv = P^T do                   (P rounded to T)
//                             dS = P * (do v^T - delta)     rounded to T
//                             dk = (dS^T q2) * ln2
//                             dq_acc += dS k                (f32 reductions)
//   dq kernel:                dq = dq_acc * scale           in T
// Masks: KV columns >= kv_len, q rows >= q_len, and if causal column > row
// (top-left aligned). dk, dv and dq come out in the input dtype, as the
// reference's (attention.py:514-515). In f32 everything stays f32.
//
// Bound on an H100 SXM: operations (five products of 2*d FLOP per unmasked
// pair), at 989 TFLOP/s for bf16/f16; for f32 at the lesser of 67 TFLOP/s
// (CUDA cores) and three TF32 terms at 495 TFLOP/s. At Gemma-2B's shape
// (bh 16 x 4096 x d 256, causal) the bf16 bound is 0.348 ms; the bytes
// (q2, k, v, out, do, lse and the three gradients) 0.09 ms at 3.35 TB/s.
//
// Three main kernels, every one on the tensor cores:
//   - bf16/f16, d <= 256 (`flash_bwd_wgmma_kernel`; hopper.cuh has the
//     primitives and the tile layout): one block per (64-row KV tile, bh)
//     of three warpgroups. Warpgroup 2 is the producer: one thread issues
//     every TMA load (setmaxnreg 24). K and V stay resident; Q2 and dO
//     tiles of 64 rows, with their lse and delta rows (bulk copies), come
//     through a 2-stage mbarrier ring. Warpgroups 0 and 1 (setmaxnreg 240)
//     split dK and dV by 64-column boxes (at d 256 two boxes each: dK and
//     dV 64 f32 registers each a thread; d columns of both in one
//     warpgroup would be 256), and each product is made once:
//       warpgroup 0: S^T = K Q2^T (SS wgmma m64n64k16), P^T;
//       warpgroup 1: dP^T = V dO^T, and dS^T = P^T (dP^T - delta) from
//                    P^T in f32, which warpgroup 0 hands over through
//                    shared memory in its accumulator order;
//       both, from P^T and dS^T in T, written once to shared memory in
//       the swizzled layout: dQ_tile = dS K, dV += P^T dO and dK += dS^T
//       Q2 on their own boxes, one SS wgmma of N = 64 * boxes each
//       (m64n128k16 at d 256; dO, Q2, dS^T and K read transposed). Five
//       products for the five the work needs (the old mma.sync kernel
//       made S^T and dP^T twice at d > 128: seven).
//     The handovers are three named barriers a q tile: both warpgroups
//     done with the last tile's P^T, dS^T (1); P^T in place (2); dS^T in
//     place (3). dQ_tile's product is committed first, and while dV's
//     and dK's run it is added to an f32 accumulator from registers by
//     16-byte vector reductions (red.global.add.v4.f32, 16 per thread a
//     tile at d 256) into dq_acc laid out in the accumulator's register
//     order per (bh, 64-row q tile, 64-column box), as flash_bwd.cu does;
//     the dq kernel undoes the order. At d = 96, 160, 224 TMA fills the
//     overhanging box with zeros and only the true columns are stored.
//     Shared memory at d 256 (226 KB of the 227 KB a block may use): K
//     and V 64 KB, the Q2/dO ring 128 KB, P^T and dS^T 16 KB, P^T in f32
//     16 KB, lse and delta 1 KB.
//   - bf16/f16, d > 256 (`flash_bwd_wide_wgmma_kernel`): the kernel above
//     with the gradients split by columns, one block per (64-row KV tile,
//     bh, chunk of at most 256 columns = 4 boxes), so that dK and dV stay
//     64 f32 registers a consumer thread at any d. Each block forms S^T
//     and dP^T over all of d, box by box in column order (four m64n64k16
//     a box, one wgmma group), the same products in the same order in
//     every chunk, so the chunks' P and dS agree to the bit. Only the
//     chunk's own boxes stay: K's (loaded once, for S^T and dQ) and the q
//     tile's Q2 and dO boxes (for S^T, dP^T and then dK, dV), which the
//     producer loads straight into their places once the last tile's
//     products have read them (an mbarrier the consumers arrive on). Every
//     other box column (K, Q2, V, dO: 32 KB) and every V box come through
//     a 3-stage ring; a tile's lse and delta arrive with its first box, by
//     the tile's parity. Then each consumer warpgroup runs the d <= 256
//     kernel's tile step (`tile_grads`: P^T and dS^T, the handovers, dV,
//     dK and dQ_tile on its own boxes of the chunk, dq_acc in the same
//     order), except that dQ_tile is made one box at a time (with the
//     ring's bookkeeping live beside dK, dV and a two-box dQ_tile the
//     consumers spilled 800 B and ptxas serialised their wgmma, C7512;
//     2.1x slower) and that the products' shared-memory addresses come
//     from a base made opaque at each q tile (their wgmma descriptors,
//     held across the loop as invariants, still spilled 16 B). Blocks
//     heaviest KV tile first across all heads, a tile's chunks side by
//     side. 226 KB of shared memory at any d: the chunk's K, Q2 and dO
//     96 KB, the ring 96 KB, P^T and dS^T 16 KB, P^T in f32 16 KB. S^T and
//     dP^T are made once per chunk: at d 512, 1.4x the products of the
//     unsplit work (the split bound 0.061 ms at bh 16 x 1024 x 512 causal,
//     0.043 unsplit).
//   - f32 at every d (`flash_bwd_wide_tf32_kernel`): the same split by
//     columns, the five products in three-term TF32 (as the f32 forward)
//     on mma.sync m16n8k8. wgmma takes TF32 only K-major from shared
//     memory, and dV, dK and dQ contract over rows: their transposed split
//     copies would not fit; mma.sync fragments load from an f32 tile in
//     either orientation, and each warp splits them as loaded (the
//     forward's permuted order: k = c and c + 4 hold columns 2c and 2c +
//     1, so a K-major pair is one 8-byte load). One block per (32-row KV
//     tile, bh, chunk) of 8 warps, KV tiles heaviest first across all
//     heads (head by head was 8% slower), a tile's chunks side by side.
//     32-column slices of K, V and the 64-row q tile's Q2 and dO come
//     through a 2-stage cp.async ring, the tile's lse and delta with its
//     first slice; warps 0-3 form S^T and 4-7 dP^T over all of d, one
//     tensor-core chain a slice added in f32, in column order in every
//     chunk; the chunk's columns of Q2 and dO are copied out of the ring
//     as they pass. P^T and dS^T go through shared memory; then each warp
//     owns 8 * NT of the chunk's columns (NT 4 wherever a chunk is 256
//     wide; at d <= 128 NT 2 or 1, so that the 8 warps share the one
//     narrow chunk: at d 32 1.48x faster than 32 columns a warp, at d 128
//     1.03x): dV += P^T dO_c and dK += dS^T Q2_c (one chain a q tile, in
//     registers), and dQ_c = dS K_c (K_c's fragments held in registers)
//     added into dq_acc by red.global.add.v4.f32 once a lane pair has
//     swapped halves. 219 KB of shared memory, 247 registers at NT 4.
//     Bound: 0.261 ms at bh 16 x 1024 x 512 causal, 0.365 counting S^T
//     and dP^T once per chunk; at d <= 256 one chunk: S^T and dP^T once.
// What still holds the wgmma kernels back: within a q tile the warpgroups
// wait on each other twice (P^T, then dS^T), so their elementwise steps
// do not overlap the other's products; the SS products at m64n64 read
// both operands from shared memory; dq's reductions (64 KB of L2 traffic
// a q tile at d 256) double with the 64-row KV tile. The "wide" one also
// streams every box column of K, V, Q2 and dO but its chunk's through
// the ring again for every q tile, and waits for each box's products.
// What holds the f32 kernel back: mma.sync's TF32 rate (its three terms,
// kernel_ablation.py's bwd_one_term), 8 warps to hide the latency of
// each fragment's load, split and products, the stream of slices
// reloaded for every q tile (bwd_no_stream) and dq's reductions
// (bwd_no_dq); above d 256, S^T and dP^T are made once per 256-column
// chunk (1.4x the products at d 512).
#include <cmath>
#include <cstddef>

#include "flash_any.cuh"

namespace rtt {
namespace any {

constexpr int THREADS = 256;

namespace bwd {

// ---------------------------------------------------------------------------
// bf16/f16 at d <= 256: wgmma on a TMA ring
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BN = 64;  // KV rows of a block
constexpr int BM = 64;  // q rows of a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;  // warpgroups, each on its own dK/dV boxes
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;
constexpr int DQ_CHUNK = 64 * 64;  // f32 of dq_acc's (q tile, box) chunk
constexpr int CONSUMER_THREADS = CONSUMERS * WG_THREADS;
// Named barriers between the two consumers (0 is __syncthreads's).
constexpr int BAR_FREE = 1;   // the last tile's P^T, dS^T are read
constexpr int BAR_P = 2;      // P^T is in place
constexpr int BAR_DS = 3;     // dS^T is in place

// D is d rounded up to a multiple of 64 (whole boxes). At D 256: 64 KB
// of K and V, 128 KB of Q2/dO ring, 32 KB of P^T and dS^T, 1 KB of
// lse/delta rows: 231,488 bytes with the barriers and alignment slack,
// of the 232,448 a block may use.
template <int D>
struct Smem {
  static constexpr int kv_bytes = BN * D * 2;
  static constexpr int q_bytes = BM * D * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = kv_bytes;
  static constexpr int q_off = 2 * kv_bytes;                  // [STAGES]
  static constexpr int o_off = q_off + STAGES * q_bytes;      // [STAGES]
  static constexpr int pt_off = o_off + STAGES * q_bytes;     // P^T [BN][BM]
  static constexpr int ds_off = pt_off + BN * BM * 2;         // dS^T
  static constexpr int x_off = ds_off + BN * BM * 2;          // P^T, f32
  static constexpr int lse_off = x_off + BN * BM * 4;         // [STAGES][BM]
  static constexpr int delta_off = lse_off + STAGES * BM * 4;  // [STAGES][BM]
  static constexpr int bar_off = delta_off + STAGES * BM * 4;
  static constexpr int bytes = bar_off + 64 + 1024;  // + alignment slack
};

// The A fragments of a 64 x 64 accumulator's four 16-column slices (rows
// kv, columns q), rounded to T, written to a swizzled box of 64 rows as
// TMA would have placed them: row r's 16-byte chunk j at chunk j ^ (r %
// 8). Thread (warp, g, c) owns rows 16 * warp + g (+ 8), columns 2c (+1)
// of each 8-column chunk.
__device__ __forceinline__ void store_box(unsigned char* box,
                                          const uint32_t (&fr)[4][4],
                                          int warp, int g, int c) {
  unsigned char* row = box + (warp * 16 + g) * BOX_ROW_BYTES + 4 * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the two 8-column halves of slice k
      unsigned char* p = row + (((2 * k + h) ^ g) << 4);
      *reinterpret_cast<uint32_t*>(p) = fr[k][2 * h];
      *reinterpret_cast<uint32_t*>(p + 8 * BOX_ROW_BYTES) = fr[k][2 * h + 1];
    }
  }
}

// The rest of one q tile (q rows from q0) for a consumer warpgroup, once
// its product over d is in `st`: W 0 holds S^T and makes P^T =
// exp2(S^T - lse[q]), zero where masked; W 1 holds dP^T and makes dS^T =
// P^T (dP^T - delta[q]) from P^T in f32, which W 0 hands over in its
// accumulator order through `xch`. Both write theirs rounded to T into a
// swizzled box (`pt`, `ds`). Then on this warpgroup's MYB boxes of 64
// gradient columns, whose K, Q2 and dO rows start at k_box, q_box and
// o_box (boxes of 64 rows, one after the other): dQ_tile = dS K, added
// into dq_acc at `dq_dst` (box h at h * DQ_CHUNK) while dV += P^T dO and
// dK += dS^T Q2 run; SPLIT_DQ: dQ_tile one box at a time (32 registers a
// thread, not 64, for a caller with more of its own live), the second
// box's product after the first's reductions. The handovers are three
// named barriers a q tile: both warpgroups done with the last tile's P^T,
// dS^T (BAR_FREE); P^T in place (BAR_P); dS^T in place (BAR_DS).
template <typename T, int MYB, int W, int NA, bool SPLIT_DQ = false>
__device__ __forceinline__ void tile_grads(
    float (&st)[BM / 2], float (&dK)[NA * 32], float (&dV)[NA * 32],
    unsigned char* pt, unsigned char* ds, float* xch, uint32_t k_box,
    uint32_t q_box, uint32_t o_box, const float* lse_s, const float* delta_s,
    float* dq_dst, int k0, int q0, int kv_len, int q_len, int causal) {
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int c = tid & 3;
  const int r0 = warp * 16 + g;  // this thread's KV rows: r0, r0 + 8
  const uint32_t pt_tile = smem_u32(pt);
  const uint32_t ds_tile = smem_u32(ds);
  uint32_t fr[BM / 16][4];  // P^T (W 0) or dS^T (W 1) in T
  if constexpr (W == 0) {
    const bool masked = k0 + BN - 1 >= kv_len || q0 + BM > q_len ||
                        (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) {
      const int qc = 8 * (e >> 2) + 2 * c + (e & 1);
      float p = exp2f(st[e] - lse_s[qc]);
      if (masked) {
        const int kv_row = k0 + r0 + 8 * ((e >> 1) & 1);
        const int q_row = q0 + qc;
        if (kv_row >= kv_len || q_row >= q_len ||
            (causal && q_row < kv_row))
          p = 0.f;
      }
      st[e] = p;
    }
    named_barrier(BAR_FREE, CONSUMER_THREADS);
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) xch[e * WG_THREADS] = st[e];
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        fr[k][r] = pack2<T>(st[8 * k + 2 * r], st[8 * k + 2 * r + 1]);
    store_box(pt, fr, warp, g, c);
    fence_proxy_async();
    named_barrier_arrive(BAR_P, CONSUMER_THREADS);
    named_barrier(BAR_DS, CONSUMER_THREADS);
  } else {
    named_barrier(BAR_FREE, CONSUMER_THREADS);
    named_barrier(BAR_P, CONSUMER_THREADS);
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) {
      const int qc = 8 * (e >> 2) + 2 * c + (e & 1);
      st[e] = xch[e * WG_THREADS] * (st[e] - delta_s[qc]);
    }
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        fr[k][r] = pack2<T>(st[8 * k + 2 * r], st[8 * k + 2 * r + 1]);
    store_box(ds, fr, warp, g, c);
    fence_proxy_async();
    named_barrier_arrive(BAR_DS, CONSUMER_THREADS);
  }

  // On this warpgroup's boxes: dV += P^T dO, dK += dS^T Q2 (A K-major
  // from the P^T / dS^T box, B read transposed), and dQ_tile = dS K (A
  // = (dS^T)^T and B = K, both read transposed; the contraction runs
  // over the block's 64 KV rows).
  if constexpr (MYB > 0) {
    constexpr int DQB = SPLIT_DQ ? 1 : MYB;  // boxes of one dQ product
    float dq[DQB * 32];
    fence_operands(dV);
    fence_operands(dK);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BN / 16; ++k)
      wgmma_ss<1, 1, T>(dq, mnmajor_desc(ds_tile, BN, k),
                        mnmajor_desc(k_box, BN, k), k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)
      wgmma_ss<0, 1, T>(dV, kmajor_desc(pt_tile, BN, k),
                        mnmajor_desc(o_box, BM, k), 1);
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)
      wgmma_ss<0, 1, T>(dK, kmajor_desc(ds_tile, BN, k),
                        mnmajor_desc(q_box, BM, k), 1);
    wgmma_commit();
    // dQ_tile is done (its group was committed first): added into dq_acc
    // while dV's and dK's products run. dq_acc is in the accumulator's
    // register order: float4 r of thread tid at (r * 128 + tid) * 4 of the
    // (bh, q tile, box) chunk, so each warp's reduction covers 512
    // contiguous bytes.
    wgmma_wait<1>();
#pragma unroll
    for (int h0 = 0; h0 < MYB; h0 += DQB) {
      if (h0 > 0) {  // SPLIT_DQ: the next box's dQ_tile
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BN / 16; ++k)
          wgmma_ss<1, 1, T>(
              dq, mnmajor_desc(ds_tile, BN, k),
              mnmajor_desc(k_box + h0 * BN * BOX_ROW_BYTES, BN, k), k > 0);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_operands(dq);
#pragma unroll
      for (int h = 0; h < DQB; ++h) {
        float* dst = dq_dst + (h0 + h) * DQ_CHUNK + tid * 4;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          red_add_v4(dst + r * WG_THREADS * 4, dq[32 * h + 4 * r],
                     dq[32 * h + 4 * r + 1], dq[32 * h + 4 * r + 2],
                     dq[32 * h + 4 * r + 3]);
      }
    }
    wgmma_wait<0>();
    fence_operands(dV);
    fence_operands(dK);
  }
}

// dk = dK * ln2 and dv = dV in T on this warpgroup's MYB boxes of
// columns from col0 (the true columns, below d) of the block's 64 KV rows
// from k0.
template <typename T, int MYB, int NA>
__device__ __forceinline__ void store_grads(const float (&dK)[NA * 32],
                                            const float (&dV)[NA * 32],
                                            T* __restrict__ dk,
                                            T* __restrict__ dv, int bh,
                                            int tk, int d, int k0, int col0) {
  const int tid = threadIdx.x % WG_THREADS;
  const int r0 = (tid / 32) * 16 + ((tid % 32) >> 2);
  const size_t base =
      (static_cast<size_t>(bh) * tk + k0 + r0) * d + 2 * (tid & 3);
#pragma unroll
  for (int h = 0; h < MYB; ++h) {
#pragma unroll
    for (int nt = 0; nt < BOX_COLS / 8; ++nt) {
      const int col = col0 + h * BOX_COLS + 8 * nt;  // + 2c, in one box
      if (col >= d) continue;
      *reinterpret_cast<uint32_t*>(dk + base + col) =
          pack2<T>(dK[32 * h + 4 * nt] * LN2, dK[32 * h + 4 * nt + 1] * LN2);
      *reinterpret_cast<uint32_t*>(dv + base + col) =
          pack2<T>(dV[32 * h + 4 * nt], dV[32 * h + 4 * nt + 1]);
      *reinterpret_cast<uint32_t*>(dk + base + 8 * d + col) =
          pack2<T>(dK[32 * h + 4 * nt + 2] * LN2, dK[32 * h + 4 * nt + 3] * LN2);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * d + col) =
          pack2<T>(dV[32 * h + 4 * nt + 2], dV[32 * h + 4 * nt + 3]);
    }
  }
}

// One consumer warpgroup's loop. W 0 forms S^T, W 1 dP^T, each over all
// of d from the resident K or V and the ring's Q2 or dO tile; then
// `tile_grads` on its own boxes of dK, dV and dQ.
template <typename T, int D, int W>
__device__ __forceinline__ void consumer(
    unsigned char* smem, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv,
    int bh, int t, int tk, int d, int k0, int i0, int i1, int kv_len,
    int q_len, int causal) {
  using S = Smem<D>;
  constexpr int NB = D / BOX_COLS;
  constexpr int NB0 = (NB + 1) / 2;
  constexpr int MYB = W == 0 ? NB0 : NB - NB0;  // this warpgroup's boxes
  constexpr int BOX0 = W == 0 ? 0 : NB0;
  constexpr int NA = MYB > 0 ? MYB : 1;
  const int tid = threadIdx.x % WG_THREADS;
  const uint32_t k_tile = smem_u32(smem + S::k_off);
  const uint32_t v_tile = smem_u32(smem + S::v_off);
  float* xch = reinterpret_cast<float*>(smem + S::x_off) + tid;
  const float* s_lse = reinterpret_cast<const float*>(smem + S::lse_off);
  const float* s_delta = reinterpret_cast<const float*>(smem + S::delta_off);
  const int n_qt = t / BM;

  // dK and dV over this warpgroup's boxes: one m64n{64 * MYB}
  // accumulator each, box h's 32 registers at [32h, 32h + 32).
  float dK[NA * 32], dV[NA * 32];
#pragma unroll
  for (int i = 0; i < NA * 32; ++i) dK[i] = dV[i] = 0.f;

  if (i0 < i1) mbar_wait(kv_full, 0);
  for (int i = i0; i < i1; ++i) {
    const int n = i - i0;
    const int s = n % STAGES;
    const uint32_t q_tile = smem_u32(smem + S::q_off + s * S::q_bytes);
    const uint32_t o_tile = smem_u32(smem + S::o_off + s * S::q_bytes);
    mbar_wait(&full[s], (n / STAGES) & 1);

    // W 0: S^T = K Q2^T; W 1: dP^T = V dO^T. [64 kv, 64 q] each.
    float st[BM / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss<0, 0, T>(st, kmajor_desc(W == 0 ? k_tile : v_tile, BN, k),
                        kmajor_desc(W == 0 ? q_tile : o_tile, BM, k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);

    tile_grads<T, MYB, W, NA>(
        st, dK, dV, smem + S::pt_off, smem + S::ds_off, xch,
        k_tile + BOX0 * BN * BOX_ROW_BYTES, q_tile + BOX0 * BM * BOX_ROW_BYTES,
        o_tile + BOX0 * BM * BOX_ROW_BYTES, s_lse + s * BM, s_delta + s * BM,
        dq_acc + ((static_cast<size_t>(bh) * n_qt + i) * NB + BOX0) * DQ_CHUNK,
        k0, i * BM, kv_len, q_len, causal);
    if (tid == 0) mbar_arrive(&empty[s]);
  }
  store_grads<T, MYB, NA>(dK, dV, dk, dv, bh, tk, d, k0, BOX0 * BOX_COLS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq_acc, T* __restrict__ dk,
                       T* __restrict__ dv, int t, int tk, int d, int kv_len,
                       int q_len, int causal) {
  using S = Smem<D>;
  constexpr int NB = D / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + S::lse_off);
  float* s_delta = reinterpret_cast<float*>(smem + S::delta_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int k0 = kt * BN;
  const int n_q = (q_len + BM - 1) / BM;
  // q tiles [i0, i1): from the causal start; none for a KV tile wholly
  // past kv_len.
  const int i0 = causal ? k0 / BM : 0;
  const int i1 = k0 < kv_len ? n_q : i0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMERS) {
    // ---- producer ----------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x % WG_THREADS == 0 && i0 < i1) {
      mbar_arrive_expect_tx(kv_full, 2 * S::kv_bytes);
      for (int h = 0; h < NB; ++h) {
        tma_load_3d(smem + S::k_off + h * BN * BOX_ROW_BYTES, &tm_k, kv_full,
                    h * BOX_COLS, k0, bh);
        tma_load_3d(smem + S::v_off + h * BN * BOX_ROW_BYTES, &tm_v, kv_full,
                    h * BOX_COLS, k0, bh);
      }
      for (int i = i0; i < i1; ++i) {
        const int n = i - i0;
        const int s = n % STAGES;
        mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        unsigned char* sq = smem + S::q_off + s * S::q_bytes;
        unsigned char* so = smem + S::o_off + s * S::q_bytes;
        mbar_arrive_expect_tx(&full[s], 2 * S::q_bytes + 2 * BM * 4);
        for (int h = 0; h < NB; ++h) {
          tma_load_3d(sq + h * BM * BOX_ROW_BYTES, &tm_q, &full[s],
                      h * BOX_COLS, i * BM, bh);
          tma_load_3d(so + h * BM * BOX_ROW_BYTES, &tm_do, &full[s],
                      h * BOX_COLS, i * BM, bh);
        }
        const size_t row = static_cast<size_t>(bh) * t + i * BM;
        bulk_load(s_lse + s * BM, lse + row, BM * 4, &full[s]);
        bulk_load(s_delta + s * BM, delta + row, BM * 4, &full[s]);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    setmaxnreg_inc<240>();
    if (wg == 0)
      consumer<T, D, 0>(smem, kv_full, full, empty, dq_acc, dk, dv, bh, t, tk,
                        d, k0, i0, i1, kv_len, q_len, causal);
    else
      consumer<T, D, 1>(smem, kv_full, full, empty, dq_acc, dk, dv, bh, t, tk,
                        d, k0, i0, i1, kv_len, q_len, causal);
  }
}

template <typename T, int D>
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dq_acc, void* dk, void* dv, int bh, int t,
                          int tk, int d, int kv_len, int q_len, int causal,
                          cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = make_tile_map(&tm_q, q2, d, t, bh, BM, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_do, dout, d, t, bh, BM, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_k, k, d, tk, bh, BN, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_v, v, d, tk, bh, BN, tma_type<T>());
  if (err != cudaSuccess) return err;
  const int bytes = Smem<D>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(tk / BN, bh);
  flash_bwd_wgmma_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc),
      static_cast<T*>(dk), static_cast<T*>(dv), t, tk, d, kv_len, q_len,
      causal);
  return cudaGetLastError();
}

// d a multiple of 32 up to 256, run at d rounded up to 64.
template <typename T>
static cudaError_t launch_d(const void* q2, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq_acc, void* dk,
                            void* dv, int bh, int t, int tk, int d, int kv_len,
                            int q_len, int causal, cudaStream_t s) {
  switch ((d + BOX_COLS - 1) / BOX_COLS) {
#define RTT_BWD_WG_D(N, D)                                                    \
  case N:                                                                     \
    return launch<T, D>(q2, k, v, dout, lse, delta, dq_acc, dk, dv, bh, t, \
                        tk, d, kv_len, q_len, causal, s);
    RTT_BWD_WG_D(1, 64)
    RTT_BWD_WG_D(2, 128)
    RTT_BWD_WG_D(3, 192)
    RTT_BWD_WG_D(4, 256)
#undef RTT_BWD_WG_D
  }
  return cudaErrorInvalidValue;
}

// dq = dq_acc * scale in T, undoing dq_acc's order: chunk (bh, q tile,
// box) holds float4 r of accumulator thread tid at (r * 128 + tid) * 4,
// i.e. rows 16 * (tid / 32) + (tid % 32) / 4 (+ 8), columns 8r + 2 * (tid
// % 4) (+ 1) of the box. Columns past d (an overhanging box) are dropped.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_any_dq_ordered_kernel(const float* __restrict__ dq_acc,
                                T* __restrict__ dq, int t, int d, int nb,
                                size_t n_float4, float scale) {
  const size_t f = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (f >= n_float4) return;
  const size_t chunk = f / (DQ_CHUNK / 4);
  const int within = static_cast<int>(f % (DQ_CHUNK / 4));
  const int r = within / WG_THREADS;
  const int tid = within % WG_THREADS;
  const int box = static_cast<int>(chunk % nb);
  const size_t tile = chunk / nb;  // bh * (t / 64) + q tile
  const int n_qt = t / BM;
  const size_t bh = tile / n_qt;
  const int qt = static_cast<int>(tile % n_qt);
  const int row = qt * BM + 16 * (tid / 32) + (tid % 32) / 4;
  const int col = box * BOX_COLS + 8 * r + 2 * (tid % 4);
  if (col >= d) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[f];
  T* p = dq + (bh * t + row) * d + col;
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(a.x * scale, a.y * scale);
  *reinterpret_cast<uint32_t*>(p + 8 * static_cast<size_t>(d)) =
      pack2<T>(a.z * scale, a.w * scale);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16/f16 at d > 256: wgmma on a TMA ring, the gradients split by columns
// ---------------------------------------------------------------------------

namespace wide_wg {

using wg::BM;
using wg::BN;
using wg::CONSUMERS;
using wg::DQ_CHUNK;
using wg::THREADS;

constexpr int DC = 256;                 // gradient columns of a block
constexpr int NCB = DC / BOX_COLS;      // boxes of a whole chunk
constexpr int STAGES = 3;               // the ring of box columns
constexpr int BOX = BM * BOX_ROW_BYTES;  // 8 KB: 64 rows of one box
static_assert(BM == BN, "K, V, Q2 and dO boxes share one size");
// Shared memory: the chunk's boxes of K, Q2 and dO ([NCB] each), a ring
// of STAGES stages of one box column each (K, Q2, V, dO), P^T and dS^T
// in T, P^T in f32, the lse and delta of two q tiles, the barriers:
// 231,552 bytes with the alignment slack, of the 232,448 a block may use.
constexpr int KC_OFF = 0;
constexpr int QC_OFF = KC_OFF + NCB * BOX;
constexpr int OC_OFF = QC_OFF + NCB * BOX;
constexpr int RING_OFF = OC_OFF + NCB * BOX;
constexpr int STAGE = 4 * BOX;          // K, Q2, V, dO at 0, 1, 2, 3 boxes
constexpr int PT_OFF = RING_OFF + STAGES * STAGE;
constexpr int DS_OFF = PT_OFF + BN * BM * 2;
constexpr int X_OFF = DS_OFF + BN * BM * 2;
constexpr int STATS_OFF = X_OFF + BN * BM * 4;  // [2 tiles][lse, delta][BM]
constexpr int BAR_OFF = STATS_OFF + 2 * 2 * BM * 4;
constexpr int BYTES = BAR_OFF + 128 + 1024;     // + alignment slack

// One consumer warpgroup's loop over the q tiles, for a chunk of NC boxes
// (its first box hc0 of the row's nb). W 0 forms S^T = K Q2^T, W 1 dP^T
// = V dO^T, each over all nb boxes in column order (the chunk's own K,
// Q2 and dO boxes from where they stay, the others from the ring), one
// wgmma group a box; then `tile_grads` on its own boxes of the chunk.
template <typename T, int NC, int W>
__device__ __forceinline__ void consumer(
    unsigned char* smem, float* __restrict__ dq_acc, T* __restrict__ dk,
    T* __restrict__ dv, int bh, int t, int tk, int d, int nb, int hc0,
    int k0, int i0, int i1, int kv_len, int q_len, int causal) {
  constexpr int NC0 = (NC + 1) / 2;
  constexpr int MYB = W == 0 ? NC0 : NC - NC0;  // this warpgroup's boxes
  constexpr int BOX0 = W == 0 ? 0 : NC0;
  constexpr int NA = MYB > 0 ? MYB : 1;
  const int tid = threadIdx.x % WG_THREADS;
  // dq_acc's (bh, q tile, box) chunks of this warpgroup's first box: q
  // tile i's at i * nb chunks further.
  float* dq_blk =
      dq_acc + (static_cast<size_t>(bh) * (t / BM) * nb + hc0 + BOX0) *
                   DQ_CHUNK;

  float dK[NA * 32], dV[NA * 32];
#pragma unroll
  for (int i = 0; i < NA * 32; ++i) dK[i] = dV[i] = 0.f;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;
  const uint32_t kc = smem_u32(smem + KC_OFF);
  const uint32_t qc = smem_u32(smem + QC_OFF);
  const uint32_t oc = smem_u32(smem + OC_OFF);
  const uint32_t ring = smem_u32(smem + RING_OFF);
  const float* stats = reinterpret_cast<const float*>(smem + STATS_OFF);
  if (i0 < i1) mbar_wait(bars, 0);
  int s = 0;  // the ring's stage, and its phase, counted
  uint32_t phase = 0;
  for (int i = i0; i < i1; ++i) {
    // The products' shared-memory addresses from a base the compiler
    // cannot see through at each q tile: it then forms their wgmma
    // descriptors where they are used, instead of holding the
    // loop-invariant ones (64 bits each) beside dK and dV, which spilled.
    unsigned char* sm = smem;
    asm volatile("" : "+l"(sm));
    const float* lse_s = stats + ((i - i0) & 1) * 2 * BM;
    float st[BM / 2];
    for (int h = 0; h < nb; ++h) {
      const uint32_t stage = ring + s * STAGE;
      const int hc = h - hc0;
      const bool own = hc >= 0 && hc < NC;  // a box of this chunk
      const uint32_t a_box = W == 0 ? (own ? kc + hc * BOX : stage)
                                    : stage + 2 * BOX;
      const uint32_t b_box = own ? (W == 0 ? qc : oc) + hc * BOX
                                 : stage + (W == 0 ? 1 : 3) * BOX;
      mbar_wait(&full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BOX_COLS / 16; ++k)
        wgmma_ss<0, 0, T>(st, kmajor_desc(a_box, BN, k),
                          kmajor_desc(b_box, BM, k), h > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(st);
      if (tid == 0) mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }

    wg::tile_grads<T, MYB, W, NA, true>(
        st, dK, dV, sm + PT_OFF, sm + DS_OFF,
        reinterpret_cast<float*>(sm + X_OFF) + tid,
        smem_u32(sm + KC_OFF) + BOX0 * BOX, smem_u32(sm + QC_OFF) + BOX0 * BOX,
        smem_u32(sm + OC_OFF) + BOX0 * BOX, lse_s, lse_s + BM,
        dq_blk + static_cast<size_t>(i) * nb * DQ_CHUNK, k0, i * BM, kv_len,
        q_len, causal);
    if (tid == 0) mbar_arrive(bars + 1);  // Q2's and dO's chunk read
  }
  wg::store_grads<T, MYB, NA>(dK, dV, dk, dv, bh, tk, d, k0,
                              (hc0 + BOX0) * BOX_COLS);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq_acc, T* __restrict__ dk,
                            T* __restrict__ dv, int t, int tk, int d,
                            int kv_len, int q_len, int causal) {
  extern __shared__ unsigned char smem_wide_bwd[];
  unsigned char* smem = align_1024(smem_wide_bwd);
  float* stats = reinterpret_cast<float*>(smem + STATS_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* kc_full = bars;
  uint64_t* chunk_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;

  // Blocks in linear order: a KV tile's chunks side by side (they stream
  // the same boxes), the KV tiles heaviest first (the causal diagonal's)
  // across all heads.
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rest = lin / gridDim.z;
  const int bh = rest % gridDim.y;
  const int k0 = rest / gridDim.y * BN;
  const int nb = (d + BOX_COLS - 1) / BOX_COLS;  // 64-column boxes of a row
  const int hc0 = lin % gridDim.z * NCB;         // this chunk's first box
  const int nc = min(NCB, nb - hc0);             // and its boxes (1-4)
  const int n_q = (q_len + BM - 1) / BM;
  // q tiles [i0, i1): from the causal start; none for a KV tile wholly
  // past kv_len.
  const int i0 = causal ? k0 / BM : 0;
  const int i1 = k0 < kv_len ? n_q : i0;

  if (threadIdx.x == 0) {
    mbar_init(kc_full, 1);
    mbar_init(chunk_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----------------------
    setmaxnreg_dec<24>();
    // It runs on 24 registers: the stage and its phase are counted, not
    // divided out.
    if (threadIdx.x % WG_THREADS == 0 && i0 < i1) {
      mbar_arrive_expect_tx(kc_full, nc * BOX);
      for (int h = 0; h < nc; ++h)
        tma_load_3d(smem + KC_OFF + h * BOX, &tm_k, kc_full,
                    (hc0 + h) * BOX_COLS, k0, bh);
      const float* lse_row = lse + static_cast<size_t>(bh) * t;
      const float* delta_row = delta + static_cast<size_t>(bh) * t;
      int s = 0;
      uint32_t phase = 0;
      for (int i = i0; i < i1; ++i) {
        for (int h = 0; h < nb; ++h) {
          const int hc = h - hc0;
          const bool own =
              static_cast<unsigned>(hc) < static_cast<unsigned>(nc);
          unsigned char* stage = smem + RING_OFF + s * STAGE;
          mbar_wait(&empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&full[s], (own ? 3 : 4) * BOX +
                                              (h == 0 ? 2 * BM * 4 : 0));
          tma_load_3d(stage + 2 * BOX, &tm_v, &full[s], h * BOX_COLS, k0, bh);
          if (own) {
            // The chunk's Q2 and dO boxes of the last q tile are read
            // until its dK and dV products are done.
            if (hc == 0) mbar_wait(chunk_empty, ((i - i0) & 1) ^ 1);
            tma_load_3d(smem + QC_OFF + hc * BOX, &tm_q, &full[s],
                        h * BOX_COLS, i * BM, bh);
            tma_load_3d(smem + OC_OFF + hc * BOX, &tm_do, &full[s],
                        h * BOX_COLS, i * BM, bh);
          } else {
            tma_load_3d(stage, &tm_k, &full[s], h * BOX_COLS, k0, bh);
            tma_load_3d(stage + BOX, &tm_q, &full[s], h * BOX_COLS, i * BM,
                        bh);
            tma_load_3d(stage + 3 * BOX, &tm_do, &full[s], h * BOX_COLS,
                        i * BM, bh);
          }
          if (h == 0) {
            // The tile's lse and delta, by its parity: the ring is
            // shallower than a tile's boxes, so the tile two back is done
            // with its own.
            float* st = stats + ((i - i0) & 1) * 2 * BM;
            bulk_load(st, lse_row + i * BM, BM * 4, &full[s]);
            bulk_load(st + BM, delta_row + i * BM, BM * 4, &full[s]);
          }
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    setmaxnreg_inc<240>();
#define RTT_BWD_WIDE_CONSUME(NC)                                          \
  case NC:                                                                \
    if (wg == 0)                                                          \
      consumer<T, NC, 0>(smem, dq_acc, dk, dv, bh, t, tk, d, nb, hc0, k0, \
                         i0, i1, kv_len, q_len, causal);                  \
    else                                                                  \
      consumer<T, NC, 1>(smem, dq_acc, dk, dv, bh, t, tk, d, nb, hc0, k0, \
                         i0, i1, kv_len, q_len, causal);                  \
    break;
    switch (nc) {
      RTT_BWD_WIDE_CONSUME(1)
      RTT_BWD_WIDE_CONSUME(2)
      RTT_BWD_WIDE_CONSUME(3)
      RTT_BWD_WIDE_CONSUME(4)
    }
#undef RTT_BWD_WIDE_CONSUME
  }
}

template <typename T>
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dq_acc, void* dk, void* dv, int bh, int t,
                          int tk, int d, int kv_len, int q_len, int causal,
                          cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = make_tile_map(&tm_q, q2, d, t, bh, BM, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_do, dout, d, t, bh, BM, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_k, k, d, tk, bh, BN, tma_type<T>());
  if (err == cudaSuccess)
    err = make_tile_map(&tm_v, v, d, tk, bh, BN, tma_type<T>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_wide_wgmma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BYTES);
  if (err != cudaSuccess) return err;
  const int nb = (d + BOX_COLS - 1) / BOX_COLS;
  dim3 grid(tk / BN, bh, (nb + NCB - 1) / NCB);
  flash_bwd_wide_wgmma_kernel<T><<<grid, THREADS, BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc),
      static_cast<T*>(dk), static_cast<T*>(dv), t, tk, d, kv_len, q_len,
      causal);
  return cudaGetLastError();
}

}  // namespace wide_wg

// ---------------------------------------------------------------------------
// f32 at d > 256: three-term TF32 on mma.sync, the gradients split by columns
// ---------------------------------------------------------------------------

namespace wide_tf32 {

constexpr int BK = 32;        // KV rows of a block
constexpr int BQ = 64;        // q rows of a tile
constexpr int SL = 32;        // columns of a streamed slice: one chain
constexpr int DC = 256;       // gradient columns of a block (a chunk)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// Row pitches in floats. A K-major fragment pair (columns 2c, 2c + 1 of
// rows g and g + 8) is one 8-byte load, free of bank conflicts at a pitch
// of 8 mod 32; a column pair of an N-major B fragment (rows 2c and 2c + 1
// at column g) two 4-byte loads, free of them at 4 mod 32.
constexpr int LDS = SL + 8;   // slices of K, V, Q2, dO
constexpr int LDC = DC + 4;   // Q2's and dO's chunk columns
constexpr int LDP = BQ + 8;   // P^T, dS^T [kv][q]
constexpr int LDD = BK + 8;   // dS [q][kv]
// Shared memory, in floats: a 2-stage ring of slices (K, V: BK rows; Q2,
// dO: BQ rows; SL columns each), the q tile's chunk columns of Q2 and dO
// (copied out of the ring as their slices pass), P^T, dS^T, dS, and the
// lse and delta of two q tiles (the next one's arrive with its first
// slice, while this one's are still read): 219 KB.
constexpr int ROWS = 2 * BK + 2 * BQ;  // rows of a stage: K, V, Q2, dO
constexpr int STAGE = ROWS * LDS;
constexpr int S_QC = 2 * STAGE;
constexpr int S_OC = S_QC + BQ * LDC;
constexpr int S_PT = S_OC + BQ * LDC;
constexpr int S_DST = S_PT + BK * LDP;
constexpr int S_DS = S_DST + BK * LDP;
constexpr int S_STATS = S_DS + BQ * LDD;  // [2 tiles][lse, delta][BQ]
constexpr int BYTES = (S_STATS + 4 * BQ) * 4;

// One slice (columns d0 .. d0 + SL) of the KV tile's K and V rows and the
// q tile's Q2 and dO rows into a stage, 16 bytes a cp.async; with the
// first slice (d0 0) the tile's lse and delta into `stats`.
__device__ __forceinline__ void load_slice(
    float* stage, float* stats, const float* __restrict__ q2,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, size_t kv_at, size_t q_row, int d,
    int d0) {
  static_assert(BK * (SL / 4) == THREADS && BQ == 2 * BK,
                "a thread copies one 16-byte chunk of 32 rows of each");
  // Thread x copies chunk x % 8 of row x / 8 of K and V, and of rows x / 8
  // and x / 8 + 32 of Q2 and dO.
  const int r = threadIdx.x / (SL / 4);
  const int col = d0 + 4 * (threadIdx.x % (SL / 4));
  const size_t kv_src = kv_at + static_cast<size_t>(r) * d + col;
  const size_t q_src = (q_row + r) * d + col;
  const size_t q_src2 = q_src + static_cast<size_t>(BK) * d;
  float* dst = stage + r * LDS + 4 * (threadIdx.x % (SL / 4));
  cp_async16(dst, k + kv_src);
  cp_async16(dst + BK * LDS, v + kv_src);
  cp_async16(dst + 2 * BK * LDS, q2 + q_src);
  cp_async16(dst + 3 * BK * LDS, q2 + q_src2);
  cp_async16(dst + 4 * BK * LDS, dout + q_src);
  cp_async16(dst + 5 * BK * LDS, dout + q_src2);
  if (d0 == 0 && threadIdx.x < BQ / 2) {
    const int x = threadIdx.x;  // 16 floats of lse, then 16 of delta
    const float* src = x < BQ / 4 ? lse + q_row + 4 * x
                                  : delta + q_row + 4 * (x - BQ / 4);
    cp_async16(stats + 4 * x, src);
  }
}

// The A fragment of rows m0 .. m0 + 15 at k-step ks of a K-major f32 tile
// (pitch ld), split: k = c and c + 4 hold columns 2c and 2c + 1 of the
// step (the permuted order every operand of a product shares).
__device__ __forceinline__ void frag_a(const float* tile, int ld, int m0,
                                       int ks, int g, int c,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 top =
      *reinterpret_cast<const float2*>(tile + (m0 + g) * ld + 8 * ks + 2 * c);
  const float2 bot = *reinterpret_cast<const float2*>(
      tile + (m0 + g + 8) * ld + 8 * ks + 2 * c);
  split_tf32(top.x, hi[0], lo[0]);
  split_tf32(bot.x, hi[1], lo[1]);
  split_tf32(top.y, hi[2], lo[2]);
  split_tf32(bot.y, hi[3], lo[3]);
}

// Two f32 values of a B fragment (k = c, c + 4), split.
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split_tf32(b0, hi[0], lo[0]);
  split_tf32(b1, hi[1], lo[1]);
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&x)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[m][n][e] = 0.f;
    }
  }
}

template <int M, int N>
__device__ __forceinline__ void add(float (&x)[M][N][4],
                                    const float (&y)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[m][n][e] += y[m][n][e];
    }
  }
}

// Warp w's product over one q tile for its 8 * NT gradient columns from
// n0: part [2 m-tiles of KV rows][NT n-tiles] = X^T[kv][q] (tile x,
// K-major, pitch LDP) times Y[q][n] (the chunk tile y, N-major), BQ / 8
// k-steps.
template <int NT>
__device__ __forceinline__ void kv_product(const float* x, const float* y,
                                           int n0, int g, int c,
                                           float (&part)[2][NT][4]) {
  zero(part);
#pragma unroll 2
  for (int ks = 0; ks < BQ / 8; ++ks) {
    uint32_t a_hi[2][4], a_lo[2][4], b_hi[NT][2], b_lo[NT][2];
    frag_a(x, LDP, 0, ks, g, c, a_hi[0], a_lo[0]);
    frag_a(x, LDP, 16, ks, g, c, a_hi[1], a_lo[1]);
    const float* yr = y + (8 * ks + 2 * c) * LDC + n0 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      split_b(yr[8 * nt], yr[LDC + 8 * nt], b_hi[nt], b_lo[nt]);
    mma_tf32x3(part, a_hi, a_lo, b_hi, b_lo);
  }
}

// NT: n-tiles of 8 gradient columns a warp owns (1, 2 or 4; 4 wherever a
// chunk is 256 columns wide), so that the 8 warps share a narrow chunk.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wide_tf32_kernel(const float* __restrict__ q2,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc, float* __restrict__ dk,
                           float* __restrict__ dv, int t, int tk, int d,
                           int kv_len, int q_len, int causal) {
  extern __shared__ float smem_bwd_tf32[];
  float* smem = smem_bwd_tf32;
  float* s_qc = smem + S_QC;
  float* s_oc = smem + S_OC;
  float* s_pt = smem + S_PT;
  float* s_dst = smem + S_DST;
  float* s_ds = smem + S_DS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;

  // Blocks in linear order: a KV tile's chunks side by side (they read
  // the same slices), the KV tiles heaviest first (the causal diagonal's)
  // across all heads, so that the grid's last wave holds the lightest
  // (head by head: 8% slower on an H100 at bh 16 x 1024 x 512, causal).
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rest = lin / gridDim.z;
  const int bh = rest % gridDim.y;
  const int j0 = rest / gridDim.y * BK;
  const int c0 = lin % gridDim.z * DC;  // this block's gradient columns:
  const int cw = min(DC, d - c0);       // [c0, c0 + cw)
  const int n0 = 8 * NT * warp;    // warp's columns of the chunk, if < cw
  const bool cols = n0 < cw;
  const size_t kv_at = (static_cast<size_t>(bh) * tk + j0) * d;
  const size_t q_base = static_cast<size_t>(bh) * t;

  // K's chunk columns as this warp's B fragments of dQ = dS K_c: k-step ks
  // (KV rows 8ks + 2c, + 1), n-tile nt (column n0 + 8nt + g); f32, split
  // at each use.
  float kc[BK / 8][NT][2];
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* p =
          k + kv_at + static_cast<size_t>(8 * ks + 2 * c) * d + c0 + n0 +
          8 * nt + g;
      kc[ks][nt][0] = cols ? p[0] : 0.f;
      kc[ks][nt][1] = cols ? p[d] : 0.f;
    }
  }
  float dk_acc[2][NT][4], dv_acc[2][NT][4];
  zero(dk_acc);
  zero(dv_acc);

  // S^T (warps 0-3) and dP^T (warps 4-7) [BK x BQ]: warp quarter wq holds
  // KV rows 16 (wq & 1) .. + 15 by q columns 32 (wq >> 1) .. + 31.
  const bool is_s = warp < 4;
  const int wq = warp & 3;
  const int am = (is_s ? 0 : BK) + 16 * (wq & 1);           // A's stage row
  const int bn = (is_s ? 2 * BK : 2 * BK + BQ) + 32 * (wq >> 1);  // B's
  const int ns = d / SL;                                    // slices a tile
  const int s_lo = c0 / SL, s_hi = (c0 + cw) / SL;  // the chunk's slices
  const int i_start = causal ? j0 / BQ * BQ : 0;
  const int i_end = j0 < kv_len ? q_len : 0;
  const int n_tiles = i_end > i_start ? (i_end - i_start + BQ - 1) / BQ : 0;
  const int total = n_tiles * ns;
  float acc[1][4][4];
  float* s_stats = smem + S_STATS;

  if (total > 0) {
    load_slice(smem, s_stats, q2, k, v, dout, lse, delta, kv_at,
               q_base + i_start, d, 0);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    const int ti = it / ns, sl = it % ns;
    const int i0 = i_start + ti * BQ;
    if (sl == 0) zero(acc);
    // The next slice (of this tile or the next) into the other stage.
    if (it + 1 < total) {
      const int nx = it + 1;
      load_slice(smem + (nx & 1) * STAGE, s_stats + (nx / ns & 1) * 2 * BQ,
                 q2, k, v, dout, lse, delta, kv_at,
                 q_base + i_start + nx / ns * BQ, d, nx % ns * SL);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* st = smem + (it & 1) * STAGE;
    // One chain: this slice's 4 k-steps of three terms, added into S^T or
    // dP^T in f32 (the same slices in the same order in every chunk).
    {
      float part[1][4][4];
      zero(part);
#pragma unroll
      for (int ks = 0; ks < SL / 8; ++ks) {
        uint32_t a_hi[1][4], a_lo[1][4], b_hi[4][2], b_lo[4][2];
        frag_a(st, LDS, am, ks, g, c, a_hi[0], a_lo[0]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 b = *reinterpret_cast<const float2*>(
              st + (bn + 8 * nt + g) * LDS + 8 * ks + 2 * c);
          split_b(b.x, b.y, b_hi[nt], b_lo[nt]);
        }
        mma_tf32x3(part, a_hi, a_lo, b_hi, b_lo);
      }
      add(acc, part);
    }
    // A slice of the chunk's columns: Q2's and dO's rows kept for dK, dV.
    if (sl >= s_lo && sl < s_hi) {
      const int col = (sl - s_lo) * SL;
      for (int e = tid; e < 2 * BQ * (SL / 4); e += THREADS) {
        const int r = e / (SL / 4), ch = e % (SL / 4);  // r: Q2 then dO
        float* dst = (r < BQ ? s_qc + r * LDC : s_oc + (r - BQ) * LDC) +
                     col + 4 * ch;
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(
            st + (2 * BK + r) * LDS + 4 * ch);
      }
    }
    __syncthreads();  // this stage is free for the slice after next
    if (sl != ns - 1) continue;

    // ---- the tile's gradients ------------------------------------------
    const float* s_lse = s_stats + (ti & 1) * 2 * BQ;
    const float* s_delta = s_lse + BQ;
    const int kv_l = 16 * (wq & 1) + g;  // this thread's KV rows: +0, +8
    const int q_l = 32 * (wq >> 1) + 2 * c;  // its q columns: + 8nt, + 1
    if (is_s) {
      // P^T = exp2(S^T - lse[q]), 0 where masked.
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kv = j0 + kv_l + 8 * hh;
          const int ql = q_l + 8 * nt;
          float p[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int q = i0 + ql + x;
            const bool valid =
                q < q_len && kv < kv_len && !(causal && kv > q);
            p[x] = valid ? exp2f(acc[0][nt][2 * hh + x] - s_lse[ql + x])
                         : 0.f;
          }
          *reinterpret_cast<float2*>(s_pt + (kv_l + 8 * hh) * LDP + ql) =
              make_float2(p[0], p[1]);
        }
      }
    }
    __syncthreads();
    if (!is_s) {
      // dS^T = P^T (dP^T - delta[q]), kept as dS^T [kv][q] and dS [q][kv].
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = kv_l + 8 * hh;
          const int ql = q_l + 8 * nt;
          const float2 p =
              *reinterpret_cast<const float2*>(s_pt + r * LDP + ql);
          const float ds0 = p.x * (acc[0][nt][2 * hh] - s_delta[ql]);
          const float ds1 = p.y * (acc[0][nt][2 * hh + 1] - s_delta[ql + 1]);
          *reinterpret_cast<float2*>(s_dst + r * LDP + ql) =
              make_float2(ds0, ds1);
          s_ds[ql * LDD + r] = ds0;
          s_ds[(ql + 1) * LDD + r] = ds1;
        }
      }
    }
    __syncthreads();
    if (cols) {
      // dV += P^T dO_c and dK += dS^T Q2_c: one chain each over the tile.
      float part[2][NT][4];
      kv_product(s_pt, s_oc, n0, g, c, part);
      add(dv_acc, part);
      kv_product(s_dst, s_qc, n0, g, c, part);
      add(dk_acc, part);
      // dQ_c = dS K_c, 32 q rows at a time, added into dq_acc by 16-byte
      // reductions: lanes c and c ^ 1 swap halves so that the even one
      // holds row g's 4 columns from 2c and the odd one row g + 8's from
      // 2c - 2.
#pragma unroll 1
      for (int hq = 0; hq < 2; ++hq) {
        zero(part);
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          uint32_t a_hi[2][4], a_lo[2][4], b_hi[NT][2], b_lo[NT][2];
          frag_a(s_ds, LDD, 32 * hq, ks, g, c, a_hi[0], a_lo[0]);
          frag_a(s_ds, LDD, 32 * hq + 16, ks, g, c, a_hi[1], a_lo[1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            split_b(kc[ks][nt][0], kc[ks][nt][1], b_hi[nt], b_lo[nt]);
          mma_tf32x3(part, a_hi, a_lo, b_hi, b_lo);
        }
        const bool odd = c & 1;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int q = i0 + 32 * hq + 16 * mt + g + (odd ? 8 : 0);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* a = part[mt][nt];
            const float x = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
            const float y = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
            if (q < q_len) {
              float* dst = dq_acc + (q_base + q) * d + c0 + n0 + 8 * nt +
                           2 * (c & 2);
              if (odd)
                red_add_v4(dst, x, y, a[2], a[3]);
              else
                red_add_v4(dst, a[0], a[1], x, y);
            }
          }
        }
      }
    }
    __syncthreads();  // P^T, dS^T, dS and the chunk columns are read
  }

  if (cols) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const size_t at = kv_at +
                            static_cast<size_t>(16 * mt + g + 8 * hh) * d +
                            c0 + n0 + 8 * nt + 2 * c;
          *reinterpret_cast<float2*>(dk + at) =
              make_float2(dk_acc[mt][nt][2 * hh] * LN2,
                          dk_acc[mt][nt][2 * hh + 1] * LN2);
          *reinterpret_cast<float2*>(dv + at) = make_float2(
              dv_acc[mt][nt][2 * hh], dv_acc[mt][nt][2 * hh + 1]);
        }
      }
    }
  }
}

template <int NT>
static cudaError_t launch_nt(const void* q2, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq_acc, void* dk,
                             void* dv, int bh, int t, int tk, int d,
                             int kv_len, int q_len, int causal,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wide_tf32_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(tk / BK, bh, (d + DC - 1) / DC);
  flash_bwd_wide_tf32_kernel<NT><<<grid, THREADS, BYTES, stream>>>(
      static_cast<const float*>(q2), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<float*>(dk),
      static_cast<float*>(dv), t, tk, d, kv_len, q_len, causal);
  return cudaGetLastError();
}

// Each warp owns 8, 16 or 32 columns of a chunk: the least that gives the
// 8 warps all of the first chunk's (min(d, DC)) columns.
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dq_acc, void* dk, void* dv, int bh, int t,
                          int tk, int d, int kv_len, int q_len, int causal,
                          cudaStream_t stream) {
  const int cw = d < DC ? d : DC;
  auto fn = cw <= 8 * WARPS       ? launch_nt<1>
            : cw <= 16 * WARPS    ? launch_nt<2>
                                  : launch_nt<4>;
  return fn(q2, k, v, dout, lse, delta, dq_acc, dk, dv, bh, t, tk, d, kv_len,
            q_len, causal, stream);
}

}  // namespace wide_tf32

// One warp per row: delta[row] = sum(out * do) in f32 over d columns, and
// the row's acc_d floats of the f32 dq accumulator zeroed; 16 bytes a
// lane at a time (d is a multiple of 32, acc_d of 4).
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_any_pre_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                         float* __restrict__ delta, float* __restrict__ dq_acc,
                         int rows, int d, int acc_d) {
  constexpr int VEC = 16 / sizeof(T);
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t at = static_cast<size_t>(row) * d;
  float sum = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    const uint4 a = *reinterpret_cast<const uint4*>(out + at + c);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at + c);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum = fmaf(to_f(av[i]), to_f(bv[i]), sum);
  }
  float4* acc = reinterpret_cast<float4*>(dq_acc + static_cast<size_t>(row) * acc_d);
  for (int c = lane; c < acc_d / 4; c += 32)
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// dq = dq_acc * scale in T, both row-major.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_any_dq_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                        size_t n, float scale) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) dq[i] = from_f<T>(dq_acc[i] * scale);
}

}  // namespace bwd
}  // namespace any
}  // namespace rtt

// dtype: 0 f32, 1 bf16, 2 f16 (out, dout [rows, d], d a multiple of 32);
// delta f32 [rows];
// dq_acc f32 [rows * acc_d], zeroed here: acc_d is d for the f32
// kernel's row-major accumulator, d rounded up to 64 for the 16-bit
// kernels'. All contiguous. Returns the CUDA error of the launch.
extern "C" int rtt_flash_bwd_any_pre(int dtype, const void* out,
                                     const void* dout, void* delta,
                                     void* dq_acc, int rows, int d, int acc_d,
                                     void* stream) {
  using namespace rtt::any::bwd;
  using rtt::any::THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || d % 32 || acc_d < d || acc_d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  switch (dtype) {
    case 0:
      flash_bwd_any_pre_kernel<float><<<blocks, THREADS, 0, s>>>(
          static_cast<const float*>(out), static_cast<const float*>(dout), dl,
          acc, rows, d, acc_d);
      break;
    case 1:
      flash_bwd_any_pre_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(out),
          static_cast<const __nv_bfloat16*>(dout), dl, acc, rows, d, acc_d);
      break;
    case 2:
      flash_bwd_any_pre_kernel<__half><<<blocks, THREADS, 0, s>>>(
          static_cast<const __half*>(out), static_cast<const __half*>(dout),
          dl, acc, rows, d, acc_d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype as above for q2, k, v, dout, dk, dv; lse, delta [bh, t] and dq_acc
// f32, dq_acc zeroed (rtt_flash_bwd_any_pre): [bh * t * d] row-major for
// f32, [bh * t * round_up(d, 64)] in the wgmma kernel's order for bf16 and
// f16. All contiguous and 16-byte aligned; t and tk multiples of 64; d a
// multiple of 32 up to 256. Returns the CUDA error of the launch (0 on
// success).
extern "C" int rtt_flash_bwd_any(int dtype, const void* q2, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dq_acc, void* dk, void* dv, int bh,
                                 int t, int tk, int d, int kv_len, int q_len,
                                 int causal, void* stream) {
  using namespace rtt::any::bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t % 64 || tk % 64 || q_len <= 0 || q_len > t ||
      kv_len <= 0 || kv_len > tk || d <= 0 || d % 32 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return wide_tf32::launch(q2, k, v, dout, lse, delta, dq_acc, dk, dv,
                               bh, t, tk, d, kv_len, q_len, causal, s);
    case 1:
      return wg::launch_d<__nv_bfloat16>(q2, k, v, dout, lse, delta, dq_acc,
                                         dk, dv, bh, t, tk, d, kv_len, q_len,
                                         causal, s);
    case 2:
      return wg::launch_d<__half>(q2, k, v, dout, lse, delta, dq_acc, dk, dv,
                                  bh, t, tk, d, kv_len, q_len, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for any d that is a multiple of 32 (the op takes it for d >
// 256), on the column-split kernels: f32 on three-term TF32 mma.sync
// (dq_acc row-major [bh * t * d]), bf16 and f16 on wgmma (dq_acc [bh * t
// * round_up(d, 64)] in the wgmma kernels' order).
extern "C" int rtt_flash_bwd_wide(int dtype, const void* q2, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq_acc, void* dk, void* dv, int bh,
                                  int t, int tk, int d, int kv_len, int q_len,
                                  int causal, void* stream) {
  using namespace rtt::any::bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t % 64 || tk % 64 || q_len <= 0 || q_len > t ||
      kv_len <= 0 || kv_len > tk || d <= 0 || d % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return wide_tf32::launch(q2, k, v, dout, lse, delta, dq_acc, dk, dv,
                               bh, t, tk, d, kv_len, q_len, causal, s);
    case 1:
      return wide_wg::launch<__nv_bfloat16>(q2, k, v, dout, lse, delta,
                                            dq_acc, dk, dv, bh, t, tk, d,
                                            kv_len, q_len, causal, s);
    case 2:
      return wide_wg::launch<__half>(q2, k, v, dout, lse, delta, dq_acc, dk,
                                     dv, bh, t, tk, d, kv_len, q_len, causal,
                                     s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq [bh, t, d] in T = dq_acc * scale. `ordered`: dq_acc in the 16-bit
// kernels' order ([bh * t * round_up(d, 64)]); else row-major [bh * t *
// d] (the f32 kernel's). Returns the CUDA error of the launch.
extern "C" int rtt_flash_bwd_any_dq(int dtype, int ordered, const void* dq_acc,
                                    void* dq, int bh, int t, int d,
                                    float scale, void* stream) {
  using namespace rtt::any::bwd;
  using rtt::any::THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || t % 64 || d <= 0 || d % 32 ||
      (ordered && dtype == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* acc = static_cast<const float*>(dq_acc);
  if (ordered) {
    const int nb = (d + rtt::BOX_COLS - 1) / rtt::BOX_COLS;
    const size_t n4 = static_cast<size_t>(bh) * t * nb * rtt::BOX_COLS / 4;
    const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256);
    if (dtype == 1)
      wg::flash_bwd_any_dq_ordered_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
          acc, static_cast<__nv_bfloat16*>(dq), t, d, nb, n4, scale);
    else if (dtype == 2)
      wg::flash_bwd_any_dq_ordered_kernel<__half><<<blocks, 256, 0, s>>>(
          acc, static_cast<__half*>(dq), t, d, nb, n4, scale);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t n = static_cast<size_t>(bh) * t * d;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  switch (dtype) {
    case 0:
      flash_bwd_any_dq_kernel<float><<<blocks, THREADS, 0, s>>>(
          acc, static_cast<float*>(dq), n, scale);
      break;
    case 1:
      flash_bwd_any_dq_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
          acc, static_cast<__nv_bfloat16*>(dq), n, scale);
      break;
    case 2:
      flash_bwd_any_dq_kernel<__half><<<blocks, THREADS, 0, s>>>(
          acc, static_cast<__half*>(dq), n, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
