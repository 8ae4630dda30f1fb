// Flash-attention backward for every (dtype, head_dim) that the wgmma
// kernels (flash_bwd.cu: bf16, d 64 or 128) do not take: bf16, f16 and f32
// inputs, head_dim a multiple of 32 up to 256 (the op pads a head_dim with
// zero columns to the next multiple of 32, which leaves every gradient's
// true columns unchanged).
//
// Replaces the TPU kernel `_bwd_fused_kernel` launched by
// `_flash_backward_fused` (ray_tpu/ops/attention.py:302, pallas_call at
// :489) for those inputs. The op is three launches, as flash_bwd.cu's:
//   flash_bwd_any_pre_kernel: delta = rowsum(out * do) in f32; dq_acc = 0
//   flash_bwd_any_kernel:     P  = exp2(q2 k^T - lse)       (masked entries 0)
//                             dv = P^T do                   (P rounded to T)
//                             dS = P * (do v^T - delta)     rounded to T
//                             dk = (dS^T q2) * ln2
//                             dq_acc += dS k                (f32 reductions)
//   flash_bwd_any_dq_kernel:  dq = dq_acc * scale           in T
// Masks: KV columns >= kv_len, q rows >= q_len, and if causal column > row
// (top-left aligned). dk, dv and dq come out in the input dtype, as the
// reference's (attention.py:514-515). In f32 everything stays f32.
//
// Bound on an H100 SXM: operations (five products of 2*d FLOP per unmasked
// pair), at 989 TFLOP/s for bf16/f16 and 67 TFLOP/s for f32.
//
// Design of the main kernel: right and simple first; two paths by type.
//   - bf16/f16 (`flash_bwd_mma_kernel`): one block per (64-row KV tile,
//     bh) of 4 warps at d <= 128, 8 at d > 128. Each 16-row group of KV
//     rows belongs to CS warps (CS = 1, or 2 at d > 128), each holding
//     d/CS columns of dK and dV in f32 registers for the whole loop (d
//     columns of both would not fit a thread's 255 registers at d 256);
//     the CS warps of a group each form that group's S^T = K Q2^T and
//     dP^T = V dO^T (the same products, made CS times). K and V stay in
//     shared memory; Q2 and dO tiles of 32 rows, with their lse and
//     delta, come in a 2-stage ring by cp.async, the next tile's copies
//     in flight under this tile's products (causal: from the KV tile's
//     first row on). Rows are padded by 16 bytes for ldmatrix.
//     P^T and dS^T, rounded to T, are the A operands of dV += P^T dO and
//     dK += dS^T Q2 straight from registers; dS^T also goes to shared
//     memory, where every warp reads it back (transposed by ldmatrix) for
//     its rows and columns of dQ_tile = dS K, added to the f32
//     accumulator by 16-byte vector reductions (neighbouring lanes trade
//     halves of their fragments first). 140 KB of shared memory at d 256.
//   - f32 (`flash_bwd_simt_kernel`): CUDA-core FMA, one block of 256
//     threads per (32-row KV tile, bh); K and V stay in shared memory as
//     f32, Q2 and dO tiles of 32 rows come in turn; eight threads share a
//     row for S and dP (P and dS through shared memory), for dK and dV
//     (d/8 columns each in registers) and for dQ (summed in registers,
//     then atomicAdd). Rows padded by one float. 140 KB at d 256.
#include <cmath>
#include <cstddef>
#include <type_traits>

#include "flash_any.cuh"

namespace rtt {
namespace any {

constexpr int THREADS = 256;
constexpr float LN2 = 0.6931471805599453f;

namespace bwd {

constexpr int BQ = 32;             // q rows of a tile
constexpr int BK = 32;             // KV rows of a block
constexpr int TPR = THREADS / 32;  // threads of one row (q or KV)
constexpr int CPT = BK / TPR;      // S columns of a thread

template <int D>
struct Smem {
  static constexpr int LD = D + 1;  // padded row, in floats
  static constexpr int PLD = BK + 1;
  static constexpr int k = 0;
  static constexpr int v = k + BK * LD;
  static constexpr int q = v + BK * LD;
  static constexpr int dout = q + BQ * LD;
  static constexpr int p = dout + BQ * LD;
  static constexpr int ds = p + BQ * PLD;
  static constexpr int lse = ds + BQ * PLD;
  static constexpr int delta = lse + BQ;
  static constexpr int bytes = (delta + BQ) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_simt_kernel(const T* __restrict__ q2, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, T* __restrict__ dk,
                     T* __restrict__ dv, int t, int tk, int kv_len, int q_len,
                     int causal) {
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* sk = smem + S::k;
  float* sv = smem + S::v;
  float* sq = smem + S::q;
  float* sdo = smem + S::dout;
  float* sp = smem + S::p;
  float* sds = smem + S::ds;
  float* slse = smem + S::lse;
  float* sdelta = smem + S::delta;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * BK;
  const int a = tid / TPR;  // row of the tile this thread works on
  const int lane = tid % TPR;
  const size_t kv_at = (static_cast<size_t>(bh) * tk + j0) * D;
  const size_t q_base = static_cast<size_t>(bh) * t;

  for (int e = tid; e < BK * D; e += THREADS) {
    const int s_at = (e / D) * S::LD + e % D;
    sk[s_at] = to_f(k[kv_at + e]);
    sv[s_at] = to_f(v[kv_at + e]);
  }
  float dk_acc[D / TPR];
  float dv_acc[D / TPR];
#pragma unroll
  for (int i = 0; i < D / TPR; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int i_start = (causal && j0 < kv_len) ? j0 : 0;
  const int i_end = j0 < kv_len ? q_len : 0;
  for (int i0 = i_start; i0 < i_end; i0 += BQ) {
    __syncthreads();  // the last tile's Q2, dO, P and dS are read
    const size_t q_at = (q_base + i0) * D;
    for (int e = tid; e < BQ * D; e += THREADS) {
      const int s_at = (e / D) * S::LD + e % D;
      sq[s_at] = to_f(q2[q_at + e]);
      sdo[s_at] = to_f(dout[q_at + e]);
    }
    if (tid < BQ) {
      slse[tid] = lse[q_base + i0 + tid];
      sdelta[tid] = delta[q_base + i0 + tid];
    }
    __syncthreads();

    // S = q2 k^T and dP = do v^T on (row a, columns lane + TPR*u).
    float s[CPT], dp[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) s[u] = dp[u] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qv = sq[a * S::LD + c];
      const float dov = sdo[a * S::LD + c];
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int j = lane + TPR * u;
        s[u] = fmaf(qv, sk[j * S::LD + c], s[u]);
        dp[u] = fmaf(dov, sv[j * S::LD + c], dp[u]);
      }
    }
    const int row = i0 + a;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int j = lane + TPR * u;
      const int col = j0 + j;
      const bool valid =
          row < q_len && col < kv_len && !(causal && col > row);
      const float p = valid ? exp2f(s[u] - slse[a]) : 0.f;
      sp[a * S::PLD + j] = round_to<T>(p);
      sds[a * S::PLD + j] = round_to<T>(p * (dp[u] - sdelta[a]));
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q2 on (KV row a, columns lane + TPR*i).
#pragma unroll 2
    for (int i = 0; i < BQ; ++i) {
      const float pv = sp[i * S::PLD + a];
      const float dsv = sds[i * S::PLD + a];
#pragma unroll
      for (int x = 0; x < D / TPR; ++x) {
        const int c = lane + TPR * x;
        dv_acc[x] = fmaf(pv, sdo[i * S::LD + c], dv_acc[x]);
        dk_acc[x] = fmaf(dsv, sq[i * S::LD + c], dk_acc[x]);
      }
    }
    // dQ += dS K on (q row a, columns lane + TPR*x).
    if (row < q_len) {
      float dq[D / TPR];
#pragma unroll
      for (int x = 0; x < D / TPR; ++x) dq[x] = 0.f;
#pragma unroll 2
      for (int j = 0; j < BK; ++j) {
        const float dsv = sds[a * S::PLD + j];
#pragma unroll
        for (int x = 0; x < D / TPR; ++x)
          dq[x] = fmaf(dsv, sk[j * S::LD + lane + TPR * x], dq[x]);
      }
      float* dq_row = dq_acc + (q_base + row) * D;
#pragma unroll
      for (int x = 0; x < D / TPR; ++x) atomicAdd(dq_row + lane + TPR * x, dq[x]);
    }
  }

  T* dk_row = dk + kv_at + static_cast<size_t>(a) * D;
  T* dv_row = dv + kv_at + static_cast<size_t>(a) * D;
#pragma unroll
  for (int x = 0; x < D / TPR; ++x) {
    dk_row[lane + TPR * x] = from_f<T>(dk_acc[x] * LN2);
    dv_row[lane + TPR * x] = from_f<T>(dv_acc[x]);
  }
}

// Warps of the mma kernel's 16-row KV groups (CS) and of the block.
template <int D>
__host__ __device__ constexpr int mma_cs() {
  return D > 128 ? 2 : 1;
}

template <int D>
struct MmaSmem {
  static constexpr int BKM = 64;  // KV rows of a block
  static constexpr int BQM = 32;  // q rows of a tile
  static constexpr int LD = D + 8;
  static constexpr int SLD = BQM + 8;
  static constexpr int k = 0;
  static constexpr int v = k + BKM * LD;
  static constexpr int ring = v + BKM * LD;  // stage i: Q2, then dO
  static constexpr int stage = 2 * BQM * LD;
  static constexpr int ds = ring + 2 * stage;
  static constexpr int stats = (ds + BKM * SLD) * 2;  // bytes: lse, delta
  static constexpr int bytes = stats + 2 * 2 * BQM * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(128 * mma_cs<D>())
flash_bwd_mma_kernel(const T* __restrict__ q2, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, T* __restrict__ dk,
                     T* __restrict__ dv, int t, int tk, int kv_len, int q_len,
                     int causal) {
  using S = MmaSmem<D>;
  constexpr int CS = mma_cs<D>();
  constexpr int NWARP = 4 * CS;
  constexpr int BKM = S::BKM, BQM = S::BQM, LD = S::LD, SLD = S::SLD;
  constexpr int DC = D / CS;            // dK/dV columns of a warp
  constexpr int NTC = DC / 8;
  constexpr int SN = BQM / 8;           // S^T's n-tiles (q columns)
  constexpr int WD = NWARP / 2;         // dQ: 2 row groups x WD column parts
  constexpr int DQ = D / WD;
  constexpr int NTQ = DQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  T* sk = base + S::k;
  T* sv = base + S::v;
  T* sds = base + S::ds;
  float* stats = reinterpret_cast<float*>(smem_raw + S::stats);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int grp = warp / CS;   // 16-row KV group
  const int part = warp % CS;  // its dK/dV columns: [part * DC, + DC)
  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * BKM;
  const size_t kv_at = (static_cast<size_t>(bh) * tk + j0) * D;
  const size_t q_base = static_cast<size_t>(bh) * t;
  const int kv_row0 = j0 + grp * 16 + g;  // this thread's KV rows: +0, +8
  const int i_start = (causal && j0 < kv_len) ? j0 : 0;
  const int i_end = j0 < kv_len ? q_len : 0;
  const int n_tiles = i_end > i_start ? (i_end - i_start + BQM - 1) / BQM : 0;

  // Stage s holds Q2 rows at base + ring + s * stage, dO after them, and
  // lse / delta at stats + s * 2 * BQM.
  auto load_tile = [&](int it, int st) {
    const int i0 = i_start + it * BQM;
    const size_t q_at = (q_base + i0) * D;
    T* sq = base + S::ring + st * S::stage;
    copy_rows_async<T, D, LD>(sq, q2 + q_at, BQM, tid, NWARP * 32);
    copy_rows_async<T, D, LD>(sq + BQM * LD, dout + q_at, BQM, tid,
                              NWARP * 32);
    if (tid < BQM) {
      stats[st * 2 * BQM + tid] = lse[q_base + i0 + tid];
      stats[st * 2 * BQM + BQM + tid] = delta[q_base + i0 + tid];
    }
  };
  copy_rows_async<T, D, LD>(sk, k + kv_at, BKM, tid, NWARP * 32);
  copy_rows_async<T, D, LD>(sv, v + kv_at, BKM, tid, NWARP * 32);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  float dk_acc[NTC][4], dv_acc[NTC][4];
#pragma unroll
  for (int n = 0; n < NTC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = i_start + it * BQM;
    if (it + 1 < n_tiles) {
      // The stage it overwrites was last read before the previous
      // iteration's middle barrier.
      load_tile(it + 1, (it + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and K, V) visible to every warp
    const T* sq = base + S::ring + (it % 2) * S::stage;
    const T* sdo = sq + BQM * LD;
    const float* slse = stats + (it % 2) * 2 * BQM;
    const float* sdelta = slse + BQM;

    // S^T = K Q2^T and dP^T = V dO^T on this group's 16 KV rows.
    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < D / 16; ++ks) {
      const int a_at = (grp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8;
      uint32_t ak[4], av[4];
      ldsm_x4(ak, sk + a_at);
      ldsm_x4(av, sv + a_at);
#pragma unroll
      for (int n2 = 0; n2 < SN / 2; ++n2) {
        const int b_at = (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD +
                         ks * 16 + ((lane / 8) % 2) * 8;
        uint32_t b[4];
        ldsm_x4(b, sq + b_at);
        mma16816<T>(s[2 * n2], ak, b[0], b[1]);
        mma16816<T>(s[2 * n2 + 1], ak, b[2], b[3]);
        ldsm_x4(b, sdo + b_at);
        mma16816<T>(dp[2 * n2], av, b[0], b[1]);
        mma16816<T>(dp[2 * n2 + 1], av, b[2], b[3]);
      }
    }
    // P^T and dS^T (s and dp now hold them).
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + tq * 2 + (e & 1);
        const int row = i0 + qc;
        const int col = kv_row0 + (e >> 1) * 8;
        const bool valid =
            row < q_len && col < kv_len && !(causal && col > row);
        const float p = valid ? exp2f(s[n][e] - slse[qc]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sdelta[qc]);
      }
    }
    if (part == 0) {
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              sds + (grp * 16 + g + h * 8) * SLD + n * 8 + tq * 2) =
              pack2<T>(dp[n][2 * h], dp[n][2 * h + 1]);
    }
    // dV += P^T dO and dK += dS^T Q2 on this warp's columns.
#pragma unroll
    for (int kk = 0; kk < BQM / 16; ++kk) {
      const uint32_t ap[4] = {
          pack2<T>(s[2 * kk][0], s[2 * kk][1]),
          pack2<T>(s[2 * kk][2], s[2 * kk][3]),
          pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t ads[4] = {
          pack2<T>(dp[2 * kk][0], dp[2 * kk][1]),
          pack2<T>(dp[2 * kk][2], dp[2 * kk][3]),
          pack2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int row_at = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD;
#pragma unroll
      for (int n = 0; n < NTC; ++n) {
        const int c0 = part * DC + n * 8;
        uint32_t b[2];
        ldsm_x2_t(b, sdo + row_at + c0);
        mma16816<T>(dv_acc[n], ap, b[0], b[1]);
        ldsm_x2_t(b, sq + row_at + c0);
        mma16816<T>(dk_acc[n], ads, b[0], b[1]);
      }
    }
    __syncthreads();  // dS^T is whole; this stage's Q2 and dO are read
    // dQ_tile = dS K: q rows [16 qg, + 16), columns [DQ dpart, + DQ).
    const int qg = warp / WD;
    const int dpart = warp % WD;
    float dq[NTQ][4];
#pragma unroll
    for (int n = 0; n < NTQ; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BKM / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, sds + (kk * 16 + lane % 8 + (lane / 16) * 8) * SLD +
                       qg * 16 + ((lane / 8) % 2) * 8);
      const int row_at = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD;
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
        uint32_t b[2];
        ldsm_x2_t(b, sk + row_at + dpart * DQ + n * 8);
        mma16816<T>(dq[n], a, b[0], b[1]);
      }
    }
    // Lanes 2u and 2u + 1 trade halves, so that the even one holds row
    // g's columns [4u, 4u + 4) of each n-tile and the odd one row g + 8's:
    // one 16-byte reduction each in place of four scalar atomics.
    const bool odd = tq & 1;
    const int row = i0 + qg * 16 + g + (odd ? 8 : 0);
    float* dq_row = dq_acc + (q_base + row) * D + dpart * DQ + (tq >> 1) * 4;
#pragma unroll
    for (int n = 0; n < NTQ; ++n) {
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? dq[n][0] : dq[n][2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? dq[n][1] : dq[n][3], 1);
      if (row < q_len) {
        if (odd)
          red_add_v4(dq_row + n * 8, r0, r1, dq[n][2], dq[n][3]);
        else
          red_add_v4(dq_row + n * 8, dq[n][0], dq[n][1], r0, r1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row_at = (static_cast<size_t>(bh) * tk + kv_row0 + h * 8) * D;
#pragma unroll
    for (int n = 0; n < NTC; ++n) {
      const int c = part * DC + n * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(dk + row_at + c) = pack2<T>(
          dk_acc[n][2 * h] * LN2, dk_acc[n][2 * h + 1] * LN2);
      *reinterpret_cast<uint32_t*>(dv + row_at + c) =
          pack2<T>(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// One warp per row: delta[row] = sum(out * do) in f32, and the row of the
// f32 dq accumulator zeroed.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_any_pre_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                         float* __restrict__ delta, float* __restrict__ dq_acc,
                         int rows, int d) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t at = static_cast<size_t>(row) * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) {
    sum = fmaf(to_f(out[at + c]), to_f(dout[at + c]), sum);
    dq_acc[at + c] = 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_any_dq_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                        size_t n, float scale) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) dq[i] = from_f<T>(dq_acc[i] * scale);
}

template <typename T, int D>
static cudaError_t launch_main(const void* q2, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq_acc, void* dk,
                               void* dv, int bh, int t, int tk, int kv_len,
                               int q_len, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const int bytes = Smem<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_simt_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(tk / BK, bh);
    flash_bwd_simt_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(q2), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq_acc), static_cast<T*>(dk), static_cast<T*>(dv),
        t, tk, kv_len, q_len, causal);
  } else {
    const int bytes = MmaSmem<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_mma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(tk / MmaSmem<D>::BKM, bh);
    flash_bwd_mma_kernel<T, D><<<grid, 128 * mma_cs<D>(), bytes, stream>>>(
        static_cast<const T*>(q2), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq_acc), static_cast<T*>(dk), static_cast<T*>(dv),
        t, tk, kv_len, q_len, causal);
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_main_d(const void* q2, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq_acc, void* dk,
                                 void* dv, int bh, int t, int tk, int d,
                                 int kv_len, int q_len, int causal,
                                 cudaStream_t s) {
  switch (d) {
#define RTT_BWD_ANY_D(D)                                                      \
  case D:                                                                     \
    return launch_main<T, D>(q2, k, v, dout, lse, delta, dq_acc, dk, dv, bh, \
                             t, tk, kv_len, q_len, causal, s);
    RTT_BWD_ANY_D(32)
    RTT_BWD_ANY_D(64)
    RTT_BWD_ANY_D(96)
    RTT_BWD_ANY_D(128)
    RTT_BWD_ANY_D(160)
    RTT_BWD_ANY_D(192)
    RTT_BWD_ANY_D(224)
    RTT_BWD_ANY_D(256)
#undef RTT_BWD_ANY_D
  }
  return cudaErrorInvalidValue;
}

}  // namespace bwd
}  // namespace any
}  // namespace rtt

// dtype: 0 f32, 1 bf16, 2 f16 (out, dout); delta f32 [rows]; dq_acc f32
// [rows * d]; all contiguous. Returns the CUDA error of the launch.
extern "C" int rtt_flash_bwd_any_pre(int dtype, const void* out,
                                     const void* dout, void* delta,
                                     void* dq_acc, int rows, int d,
                                     void* stream) {
  using namespace rtt::any::bwd;
  using rtt::any::THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  switch (dtype) {
    case 0:
      flash_bwd_any_pre_kernel<float><<<blocks, THREADS, 0, s>>>(
          static_cast<const float*>(out), static_cast<const float*>(dout), dl,
          acc, rows, d);
      break;
    case 1:
      flash_bwd_any_pre_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(out),
          static_cast<const __nv_bfloat16*>(dout), dl, acc, rows, d);
      break;
    case 2:
      flash_bwd_any_pre_kernel<__half><<<blocks, THREADS, 0, s>>>(
          static_cast<const __half*>(out), static_cast<const __half*>(dout),
          dl, acc, rows, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype as above for q2, k, v, dout, dk, dv; lse, delta [bh, t] and dq_acc
// [bh * t * d] f32, dq_acc zeroed (rtt_flash_bwd_any_pre); all contiguous;
// t and tk multiples of 64; d a multiple of 32 up to 256. Returns the CUDA
// error of the launch (0 on success).
extern "C" int rtt_flash_bwd_any(int dtype, const void* q2, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dq_acc, void* dk, void* dv, int bh,
                                 int t, int tk, int d, int kv_len, int q_len,
                                 int causal, void* stream) {
  using namespace rtt::any::bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t % 64 || tk % 64 || q_len <= 0 || q_len > t ||
      kv_len <= 0 || kv_len > tk)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_main_d<float>(q2, k, v, dout, lse, delta, dq_acc, dk, dv,
                                  bh, t, tk, d, kv_len, q_len, causal, s);
    case 1:
      return launch_main_d<__nv_bfloat16>(q2, k, v, dout, lse, delta, dq_acc,
                                          dk, dv, bh, t, tk, d, kv_len, q_len,
                                          causal, s);
    case 2:
      return launch_main_d<__half>(q2, k, v, dout, lse, delta, dq_acc, dk, dv,
                                   bh, t, tk, d, kv_len, q_len, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq [n] in T = dq_acc * scale (dq_acc row-major, as the main kernel left
// it). Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_bwd_any_dq(int dtype, const void* dq_acc, void* dq,
                                    long long n, float scale, void* stream) {
  using namespace rtt::any::bwd;
  using rtt::any::THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  const float* acc = static_cast<const float*>(dq_acc);
  switch (dtype) {
    case 0:
      flash_bwd_any_dq_kernel<float><<<blocks, THREADS, 0, s>>>(
          acc, static_cast<float*>(dq), static_cast<size_t>(n), scale);
      break;
    case 1:
      flash_bwd_any_dq_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
          acc, static_cast<__nv_bfloat16*>(dq), static_cast<size_t>(n), scale);
      break;
    case 2:
      flash_bwd_any_dq_kernel<__half><<<blocks, THREADS, 0, s>>>(
          acc, static_cast<__half*>(dq), static_cast<size_t>(n), scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
