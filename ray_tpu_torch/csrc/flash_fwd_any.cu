// Flash-attention forward for every (dtype, head_dim) that the wgmma
// kernel (flash_fwd.cu: bf16, d 64 or 128) does not take: bf16, f16 and
// f32 inputs, head_dim a multiple of 32 up to 256 (the op pads a head_dim
// with zero columns to the next multiple of 32; the scale is the true d's).
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
// Bound on an H100 SXM: operations (4*d FLOP per unmasked pair; at Gemma's
// d 256 the bytes are a few percent of it), at 989 TFLOP/s for bf16/f16
// and 67 TFLOP/s for f32 (kept in f32: no TF32).
//
// Design: right and simple first; two paths by element type.
//   - bf16/f16 (`flash_fwd_mma_kernel`): one block of 4 warps per (64-row
//     q tile, bh), 16 q rows a warp. Q, and in turn each K and V tile (64
//     rows, 32 at d > 128), sit in shared memory with rows padded by 16
//     bytes so that ldmatrix reads 8 rows without bank conflicts. S = Q2
//     K^T and O += P V are mma.sync m16n8k16 products with f32
//     accumulators; the online softmax runs on S's accumulators (quad
//     shuffles for the row max and sum), and P, rounded to T, is the A
//     operand of P V straight from registers. O (d/2 floats a thread) stays
//     in registers. K and V come in a 2-stage ring by cp.async: the next
//     tile's copies are in flight while this tile's products run. 101 KB
//     of shared memory at d 256.
//   - f32 (`flash_fwd_simt_kernel`): CUDA-core FMA, one block of 256
//     threads per (64-row q tile, bh). Q stays in shared memory as f32;
//     K and V tiles of 32 rows are loaded in turn, rows padded by one
//     float. Four threads share a q row (d/4 output columns each in
//     registers, S columns lane + 4u); P goes through shared memory within
//     a warp. 140 KB of shared memory at d 256.
//   - Both skip causal KV tiles past the q tile's last row and tiles past
//     kv_len; t and tk are multiples of 64, so every tile is whole.
#include <cmath>
#include <cstddef>
#include <type_traits>

#include "flash_any.cuh"

namespace rtt {
namespace any {

// The plain version's DEFAULT_MASK_VALUE, -0.7 * float max.
constexpr float MASK = -0.7f * 3.4028234663852886e38f;

namespace fwd {

constexpr int THREADS = 256;         // the f32 kernel's block
constexpr int BQ = 64;               // q rows of a block (both kernels)
constexpr int BK = 32;               // KV rows of the f32 kernel's tile
constexpr int TPR = THREADS / BQ;    // threads of one q row (f32 kernel)

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
      if (col >= kv_len || (causal && col > row)) s[u] = MASK;
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

// KV rows of the mma kernel's tile: 32 at d > 128 keeps S's accumulators
// small beside O's d/2 floats a thread.
template <int D>
__host__ __device__ constexpr int mma_bk() {
  return D > 128 ? 32 : 64;
}

// Q, then two stages of (K, V) tiles, rows padded by 16 bytes.
template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (BQ + 4 * mma_bk<D>()) * (D + 8) * 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const T* __restrict__ q2, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int t, int tk, int kv_len,
                     int causal) {
  constexpr int BKM = mma_bk<D>();
  constexpr int LD = D + 8;     // padded row, in elements
  constexpr int NT = D / 8;     // O's n-tiles
  constexpr int SN = BKM / 8;   // S's n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* ring = sq + BQ * LD;  // stage i: K at ring + 2i * BKM * LD, V after it
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const size_t q_off = (static_cast<size_t>(bh) * t + q0) * D;
  const size_t kv_off = static_cast<size_t>(bh) * tk * D;
  const int kv_end = causal ? min(kv_len, q0 + BQ) : kv_len;
  const int n_tiles = (kv_end + BKM - 1) / BKM;

  auto load_tile = [&](int j, int stage) {
    const size_t at = kv_off + static_cast<size_t>(j) * BKM * D;
    T* sk = ring + 2 * stage * BKM * LD;
    copy_rows_async<T, D, LD>(sk, k + at, BKM, tid, 128);
    copy_rows_async<T, D, LD>(sk + BKM * LD, v + at, BKM, tid, 128);
  };
  copy_rows_async<T, D, LD>(sq, q2 + q_off, BQ, tid, 128);
  load_tile(0, 0);
  cp_async_commit();
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * BKM;
    if (jt + 1 < n_tiles) {
      // The stage it overwrites was last read before the previous
      // iteration's closing barrier.
      load_tile(jt + 1, (jt + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) visible to every warp
    const T* sk = ring + 2 * (jt % 2) * BKM * LD;
    const T* sv = sk + BKM * LD;

    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sq + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < SN / 2; ++n2) {
        uint32_t b[4];
        ldsm_x4(b, sk + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD + ks * 16 +
                       ((lane / 8) % 2) * 8);
        mma16816<T>(s[2 * n2], a, b[0], b[1]);
        mma16816<T>(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + n * 8 + tq * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= kv_len || (causal && col > row)) s[n][e] = MASK;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[n][e]);
      }
    }
    float alpha[2], m_new[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
      m_new[h] = fmaxf(m[h], tile_max[h]);
      alpha[h] = exp2f(m[h] - m_new[h]);
    }
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_new[e >> 1]);
        row_sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
      l[h] = l[h] * alpha[h] + row_sum[h];
      m[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BKM / 16; ++kk) {
      // P (rounded to T, as the plain version rounds it) as the A operand.
      const uint32_t a[4] = {
          pack2<T>(s[2 * kk][0], s[2 * kk][1]),
          pack2<T>(s[2 * kk][2], s[2 * kk][3]),
          pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t b[4];
        ldsm_x4_t(b, sv + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                         n2 * 16 + (lane / 16) * 8);
        mma16816<T>(o[2 * n2], a, b[0], b[1]);
        mma16816<T>(o[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is read: the next prefetch may take it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const int row = row0 + h * 8;
    T* o_row = out + (static_cast<size_t>(bh) * t + row) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(o_row + n * 8 + tq * 2) =
          pack2<T>(o[n][2 * h] / l_safe, o[n][2 * h + 1] / l_safe);
    if (tq == 0) lse[static_cast<size_t>(bh) * t + row] = m[h] + log2f(l_safe);
  }
}

template <typename T, int D>
static cudaError_t launch(const void* q2, const void* k, const void* v,
                          void* out, void* lse, int bh, int t, int tk,
                          int kv_len, int causal, cudaStream_t stream) {
  dim3 grid(t / BQ, bh);
  if constexpr (std::is_same<T, float>::value) {
    const int bytes = Smem<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_simt_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(q2), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), t, tk, kv_len, causal);
  } else {
    const int bytes = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_mma_kernel<T, D><<<grid, 128, bytes, stream>>>(
        static_cast<const T*>(q2), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), t, tk, kv_len, causal);
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_d(const void* q2, const void* k, const void* v,
                            void* out, void* lse, int bh, int t, int tk, int d,
                            int kv_len, int causal, cudaStream_t s) {
  switch (d) {
#define RTT_FWD_ANY_D(D) \
  case D:                \
    return launch<T, D>(q2, k, v, out, lse, bh, t, tk, kv_len, causal, s);
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
// contiguous; t and tk multiples of 64; d a multiple of 32 up to 256;
// 0 < kv_len <= tk. Returns the CUDA error of the launch (0 on success).
extern "C" int rtt_flash_fwd_any(int dtype, const void* q2, const void* k,
                                 const void* v, void* out, void* lse, int bh,
                                 int t, int tk, int d, int kv_len, int causal,
                                 void* stream) {
  using namespace rtt::any::fwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || t % 64 || tk % 64 || kv_len <= 0 || kv_len > tk)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_d<float>(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal,
                             s);
    case 1:
      return launch_d<__nv_bfloat16>(q2, k, v, out, lse, bh, t, tk, d, kv_len,
                                     causal, s);
    case 2:
      return launch_d<__half>(q2, k, v, out, lse, bh, t, tk, d, kv_len, causal,
                              s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
