// Flash-attention backward for Hopper (sm_90a): three launches.
//
// Replaces the TPU kernel `_bwd_fused_kernel` launched by
// `_flash_backward_fused` (ray_tpu/ops/attention.py:302, pallas_call
// at :489), and the `delta` and dq-cast steps of that function.
//
// What the three compute, from one S/P per tile (q2 pre-scaled by
// scale*log2(e), lse in the log2 domain):
//   flash_bwd_pre_kernel:  delta = rowsum(out * do) in f32; dq_acc = 0
//   flash_bwd_kernel:      P  = exp2(q2 k^T - lse)          (masked entries 0)
//                          dv = P^T do
//                          dS = P * (do v^T - delta)        rounded to bf16
//                          dk = (dS^T q2) * ln2             (ln2 * log2e == 1)
//                          dq_acc += dS k                   (f32)
//   flash_bwd_dq_kernel:   dq = dq_acc * scale              in q's dtype
// Masks: KV columns >= kv_len, q rows >= q_len, and if causal
// column > row (top-left aligned).
//
// Bound on an H100 SXM: operations. Five products of 2*d FLOP per
// unmasked (q, kv) pair: at the training shape (bh 64, t = tk = 4096,
// d 128, causal) 6.87e11 FLOP, 0.69 ms at 989 TFLOP/s bf16; the bytes
// (q2, k, v, out, do, dk, dv, dq in bf16, lse) are 0.54 GB, 0.16 ms at
// 3.35 TB/s.
//
// Design of the main kernel (hopper.cuh has the primitives and the tile
// layout):
//   - One block per (128-row KV tile, bh) of three warpgroups. Warpgroup
//     2 is the producer: one thread issues every TMA load (setmaxnreg 24).
//     Warpgroups 0 and 1 are consumers of 64 KV rows each (setmaxnreg
//     240), holding dK and dV in f32 registers for the whole loop.
//   - Shared memory (146 KB at d 128): K and V resident; Q2 and dO tiles
//     of 64 rows, with their lse and delta rows (bulk copies), in a
//     2-stage ring with full/empty mbarriers; the dS^T tile.
//   - Per q tile and consumer: S^T = K Q2^T and dP^T = V dO^T by SS wgmma
//     (m64n64k16, K-major operands); P^T and dS^T in registers; dV +=
//     P^T dO and dK += dS^T Q2 by RS wgmma (m64n{d}k16) from those
//     registers, dO and Q2 read transposed (MN-major). dS^T goes to shared
//     memory once, in the swizzled layout, and dQ_tile = dS K is an SS
//     wgmma with both operands MN-major: consumer w forms columns
//     [64w, 64w + 64) of it (at d 64, consumer 0 forms all of it), in
//     the registers S^T has just freed.
//   - dq route: reductions into an f32 accumulator, no per-element
//     atomics. Each consumer adds its 64 x 64 f32 dQ tile straight from
//     its registers with 16-byte vector reductions (red.global.add.v4.f32,
//     8 per thread), into dq_acc laid out in the accumulator's register
//     order per (bh, 64-row q tile, 64-column half), so each warp's
//     reduction covers 512 contiguous bytes. The finishing launch undoes
//     the order, scales and casts. Staging the tile in shared memory for
//     one cp.reduce.async.bulk per q tile, issued by a producer warp (as
//     FlashAttention-3 does), measured slower on the card (PERF.md). A
//     q-major dq kernel would recompute S and dP: 7 products in place of
//     5.
//   - Blocks of one bh run together (KV tiles fastest), so the dq_acc
//     rows being added to, and the bh's Q2 and dO, stay in L2.
// What still holds it back: within a consumer every step waits for the
// one before (S^T/dP^T, then the elementwise step, then the three
// products, then the reductions); the two consumers meet at two
// barriers per q tile around the dS^T tile, so their elementwise steps
// coincide and leave the tensor cores idle; dq's reductions are 2.2 GB of
// L2 traffic per launch at the training shape.
#include "hopper.cuh"

namespace rtt {
namespace bwd {

constexpr int BN = 128;  // KV rows of a block
constexpr int BM = 64;   // q rows of a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;  // warpgroups, 64 KV rows each
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;
constexpr int DQ_CHUNK = 64 * 64;  // f32 of one consumer's dQ tile

template <int D>
struct Smem {
  static constexpr int kv_bytes = BN * D * 2;
  static constexpr int q_bytes = BM * D * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = kv_bytes;
  static constexpr int q_off = 2 * kv_bytes;                  // [STAGES]
  static constexpr int o_off = q_off + STAGES * q_bytes;      // [STAGES]
  static constexpr int ds_off = o_off + STAGES * q_bytes;     // dS^T [BN][BM]
  static constexpr int lse_off = ds_off + BN * BM * 2;        // [STAGES][BM]
  static constexpr int delta_off = lse_off + STAGES * BM * 4;  // [STAGES][BM]
  static constexpr int bar_off = delta_off + STAGES * BM * 4;
  static constexpr int bytes = bar_off + 64 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int t, int tk, int kv_len, int q_len,
                 int causal) {
  using S = Smem<D>;
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
      for (int h = 0; h < D / BOX_COLS; ++h) {
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
        for (int h = 0; h < D / BOX_COLS; ++h) {
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
    // ---- consumers: 64 KV rows each ----------------------------------
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32;
    const int g = (tid % 32) >> 2;
    const int c = tid & 3;
    const int wk0 = k0 + wg * 64;          // this warpgroup's first KV row
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows in the block: r0, +8
    const uint32_t k_tile = smem_u32(smem + S::k_off);
    const uint32_t v_tile = smem_u32(smem + S::v_off);
    const uint32_t ds_tile = smem_u32(smem + S::ds_off);
    unsigned char* ds_rows = smem + S::ds_off;
    // Consumer w forms dQ columns [64w, 64w + 64); at d 64 only consumer 0.
    const bool forms_dq = wg < D / 64;
    const int n_qt = t / BM;

    float dK[D / 2], dV[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.f;

    if (i0 < i1) mbar_wait(kv_full, 0);
    for (int i = i0; i < i1; ++i) {
      const int n = i - i0;
      const int s = n % STAGES;
      const uint32_t q_tile = smem_u32(smem + S::q_off + s * S::q_bytes);
      const uint32_t o_tile = smem_u32(smem + S::o_off + s * S::q_bytes);
      const float* lse_s = s_lse + s * BM;
      const float* delta_s = s_delta + s * BM;
      mbar_wait(&full[s], (n / STAGES) & 1);

      // S^T = K Q2^T and dP^T = V dO^T: [64 kv, 64 q] each.
      float sc[BM / 2], dp[BM / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0, 0>(sc, kmajor_desc(k_tile + wg * 64 * BOX_ROW_BYTES, BN, k),
                       kmajor_desc(q_tile, BM, k), k > 0);
      wgmma_commit();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0, 0>(dp, kmajor_desc(v_tile + wg * 64 * BOX_ROW_BYTES, BN, k),
                       kmajor_desc(o_tile, BM, k), k > 0);
      wgmma_commit();

      // P^T = exp2(S^T - lse[q]), zero where masked.
      wgmma_wait<1>();
      fence_operands(sc);
      const int q0 = i * BM;
      const bool masked = wk0 + 63 >= kv_len || q0 + BM > q_len ||
                          (causal && wk0 + 63 > q0);
#pragma unroll
      for (int e = 0; e < BM / 2; ++e) {
        const int qc = 8 * (e >> 2) + 2 * c + (e & 1);
        float p = exp2f(sc[e] - lse_s[qc]);
        if (masked) {
          const int kv_row = wk0 + warp * 16 + g + 8 * ((e >> 1) & 1);
          const int q_row = q0 + qc;
          if (kv_row >= kv_len || q_row >= q_len || (causal && q_row < kv_row))
            p = 0.f;
        }
        sc[e] = p;
      }
      // dS^T = P^T * (dP^T - delta[q]).
      wgmma_wait<0>();
      fence_operands(dp);
      uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
      for (int k = 0; k < BM / 16; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * k + 2 * r;
          const int qc = 8 * (e >> 2) + 2 * c;
          pa[k][r] = pack_bf16(sc[e], sc[e + 1]);
          da[k][r] = pack_bf16(sc[e] * (dp[e] - delta_s[qc]),
                               sc[e + 1] * (dp[e + 1] - delta_s[qc + 1]));
        }
      }

      // dV += P^T dO and dK += dS^T Q2, dO and Q2 read transposed.
      fence_operands(dV);
      fence_operands(dK);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BM / 16; ++k)
        wgmma_rs<1>(dV, pa[k], mnmajor_desc(o_tile, BM, k), 1);
#pragma unroll
      for (int k = 0; k < BM / 16; ++k)
        wgmma_rs<1>(dK, da[k], mnmajor_desc(q_tile, BM, k), 1);
      wgmma_commit();

      // dS^T to shared memory, swizzled as TMA would have placed it. The
      // first barrier: both consumers are done with the previous tile's.
      named_barrier(1, CONSUMERS * WG_THREADS);
#pragma unroll
      for (int k = 0; k < BM / 16; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the two 8-column halves of slice k
          const int chunk = 2 * k + h;
          unsigned char* p0 = ds_rows + r0 * BOX_ROW_BYTES + ((chunk ^ g) << 4) + 4 * c;
          *reinterpret_cast<uint32_t*>(p0) = da[k][2 * h];
          *reinterpret_cast<uint32_t*>(p0 + 8 * BOX_ROW_BYTES) = da[k][2 * h + 1];
        }
      }
      fence_proxy_async();
      named_barrier(1, CONSUMERS * WG_THREADS);

      // dQ_tile[:, 64w : 64w + 64] = dS K: A = (dS^T)^T and B = K, both
      // MN-major, the contraction over the block's 128 KV rows. Its
      // accumulator takes S^T's registers, free again: with registers of
      // its own the consumer needs more than 240, and ptxas then
      // serialises every wgmma of the kernel.
      float (&dq)[BM / 2] = sc;
      if (forms_dq) {
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BN / 16; ++k)
          wgmma_ss<1, 1>(dq, mnmajor_desc(ds_tile, BN, k),
                         mnmajor_desc(k_tile + wg * BN * BOX_ROW_BYTES, BN, k),
                         k > 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_operands(dV);
      fence_operands(dK);
      fence_operands(dq);
      if (tid == 0) mbar_arrive(&empty[s]);

      if (forms_dq) {
        // Added into dq_acc in the accumulator's register order: float4 r
        // of thread tid at (r * 128 + tid) * 4 of the (bh, q tile, half)
        // chunk, so each warp's reduction covers 512 contiguous bytes.
        float* dst = dq_acc +
                     ((static_cast<size_t>(bh) * n_qt + i) * (D / 64) + wg) *
                         DQ_CHUNK +
                     tid * 4;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          red_add_v4(dst + r * WG_THREADS * 4, dq[4 * r], dq[4 * r + 1],
                     dq[4 * r + 2], dq[4 * r + 3]);
      }
    }

    // dk = dK * ln2, dv = dV, rows past tk not stored.
    const int row = k0 + r0;
    const size_t base = (static_cast<size_t>(bh) * tk + row) * D + 2 * c;
    if (row < tk) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(dk + base + 8 * nt) =
            pack_bf16(dK[4 * nt] * LN2, dK[4 * nt + 1] * LN2);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * nt) =
            pack_bf16(dV[4 * nt], dV[4 * nt + 1]);
      }
    }
    if (row + 8 < tk) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(dk + base + 8 * D + 8 * nt) =
            pack_bf16(dK[4 * nt + 2] * LN2, dK[4 * nt + 3] * LN2);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * D + 8 * nt) =
            pack_bf16(dV[4 * nt + 2], dV[4 * nt + 3]);
      }
    }
  }
}

// delta[row] = sum(out[row] * do[row]) in f32, and dq_acc's D floats of
// the row zeroed. D / 8 threads per row, 16 bytes each.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_pre_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                     float* __restrict__ delta, float* __restrict__ dq_acc,
                     int rows) {
  constexpr int PER_ROW = D / 8;
  const int row = blockIdx.x * (256 / PER_ROW) + threadIdx.x / PER_ROW;
  const int part = threadIdx.x % PER_ROW;
  float sum = 0.f;
  if (row < rows) {
    const size_t at = static_cast<size_t>(row) * D + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(out + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(b2[i]);
      sum += x.x * y.x + x.y * y.y;
    }
    float4* z = reinterpret_cast<float4*>(dq_acc + at);
    z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = 1; off < PER_ROW; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && part == 0) delta[row] = sum;
}

// dq = dq_acc * scale in bf16, undoing dq_acc's order: each 16 KB chunk
// (bh, q tile, 64-column half) holds float4 r of accumulator thread tid at
// (r * 128 + tid) * 4, i.e. rows 16*(tid/32) + (tid%32)/4 (+8), columns
// 8r + 2*(tid%4) (+1).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                    int t, size_t n_float4, float scale) {
  const size_t f = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (f >= n_float4) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[f];
  const size_t chunk = f / (DQ_CHUNK / 4);
  const int within = static_cast<int>(f % (DQ_CHUNK / 4));
  const int r = within / WG_THREADS;
  const int tid = within % WG_THREADS;
  const int half = static_cast<int>(chunk % (D / 64));
  const size_t tile = chunk / (D / 64);  // bh * (t / 64) + q tile
  const int n_qt = t / BM;
  const size_t bh = tile / n_qt;
  const int qt = static_cast<int>(tile % n_qt);
  const int row = qt * BM + 16 * (tid / 32) + (tid % 32) / 4;
  const int col = half * 64 + 8 * r + 2 * (tid % 4);
  bf16* p = dq + (bh * t + row) * D + col;
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a.x * scale, a.y * scale);
  *reinterpret_cast<uint32_t*>(p + 8 * D) = pack_bf16(a.z * scale, a.w * scale);
}

template <int D>
static cudaError_t launch_main(const void* q2, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq_acc, void* dk,
                               void* dv, int bh, int t, int tk, int kv_len,
                               int q_len, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = make_tile_map(&tm_q, q2, D, t, bh, BM);
  if (err == cudaSuccess) err = make_tile_map(&tm_do, dout, D, t, bh, BM);
  if (err == cudaSuccess) err = make_tile_map(&tm_k, k, D, tk, bh, BN);
  if (err == cudaSuccess) err = make_tile_map(&tm_v, v, D, tk, bh, BN);
  if (err != cudaSuccess) return err;
  const int bytes = Smem<D>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + BN - 1) / BN, bh);
  flash_bwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, tk, kv_len, q_len,
      causal);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace rtt

// out, dout: bf16 [rows, d]; delta f32 [rows]; dq_acc f32 [rows * d], all
// contiguous. Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_bwd_pre_bf16(const void* out, const void* dout,
                                      void* delta, void* dq_acc, int rows,
                                      int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = 256 / (d / 8);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (d == 64)
    rtt::bwd::flash_bwd_pre_kernel<64><<<blocks, 256, 0, s>>>(
        static_cast<const rtt::bf16*>(out), static_cast<const rtt::bf16*>(dout),
        static_cast<float*>(delta), static_cast<float*>(dq_acc), rows);
  else
    rtt::bwd::flash_bwd_pre_kernel<128><<<blocks, 256, 0, s>>>(
        static_cast<const rtt::bf16*>(out), static_cast<const rtt::bf16*>(dout),
        static_cast<float*>(delta), static_cast<float*>(dq_acc), rows);
  return static_cast<int>(cudaGetLastError());
}

// q2, k, v, dout, dk, dv: bf16; lse, delta [bh, t] and dq_acc [bh * t * d]:
// f32, dq_acc zeroed (rtt_flash_bwd_pre_bf16); all contiguous and 16-byte
// aligned; t and tk multiples of 64; d in {64, 128}. Returns the CUDA
// error of the launch (0 on success).
extern "C" int rtt_flash_bwd_bf16(const void* q2, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq_acc, void* dk, void* dv, int bh,
                                  int t, int tk, int d, int kv_len, int q_len,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t % 64 || tk % 64 || q_len <= 0 || q_len > t || kv_len <= 0 ||
      kv_len > tk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return rtt::bwd::launch_main<64>(q2, k, v, dout, lse, delta, dq_acc, dk,
                                     dv, bh, t, tk, kv_len, q_len, causal, s);
  if (d == 128)
    return rtt::bwd::launch_main<128>(q2, k, v, dout, lse, delta, dq_acc, dk,
                                      dv, bh, t, tk, kv_len, q_len, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq [bh, t, d] in bf16 = dq_acc * scale (dq_acc as the main kernel left
// it). Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_bwd_dq_bf16(const void* dq_acc, void* dq, int bh,
                                     int t, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t % 64 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n_float4 = static_cast<size_t>(bh) * t * d / 4;
  const unsigned blocks = static_cast<unsigned>((n_float4 + 255) / 256);
  if (d == 64)
    rtt::bwd::flash_bwd_dq_kernel<64><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(dq_acc), static_cast<rtt::bf16*>(dq), t,
        n_float4, scale);
  else
    rtt::bwd::flash_bwd_dq_kernel<128><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(dq_acc), static_cast<rtt::bf16*>(dq), t,
        n_float4, scale);
  return static_cast<int>(cudaGetLastError());
}
