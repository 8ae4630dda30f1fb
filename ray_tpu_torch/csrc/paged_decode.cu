// Paged decode attention for Hopper (sm_90a): the serving model step's
// attention when each row brings one query token.
//
// Replaces no TPU kernel. The JAX package's paged decode is plain jnp
// (ray_tpu/models/generate.py, `_paged_layer`): it gathers every row's
// whole block table back into logical order, repeats K and V to every
// query head, casts both to f32 and attends under a full-width mask. The
// port did the same in PyTorch (now `paged_attention_plain` in
// ops/paged_attention.py). At Qwen3-8B's serving shape (32 rows, tables
// of 96 blocks of 16, 8 KV heads of 128, groups of 4) that moves about
// 5.8 GB of device memory a layer, and takes some 27 launches a layer,
// to read at most the rows' live K/V, about 64 MB a layer. This kernel
// reads each live row's blocks once, through its table, in the pool's
// own dtype.
//
// What it computes, for row b, KV head g and p = q_pos[b]:
//   - append: this step's k, v (after qk_norm and RoPE) written at
//     physical block tables[b, min(p / bl, nb - 1)], offset p % bl: the
//     logical block is clamped to the table, as the plain path clamps it;
//   - attend: the group's query heads over logical positions 0 .. L - 1,
//     L = min(p + 1, valid_len[b], nb * bl), scores q.k * (1/sqrt(d)),
//     max-subtracted exponentials, their sum and P.V all in f32, P never
//     rounded; out [b, head, :] in the pool's dtype. Only the summation
//     order differs from the plain path (a bf16 or f16 to f32 cast is
//     exact).
//   Block 0 is read and written like any other block. A dead row (the
//   decode step masks its table to the null block 0, which the allocator
//   never hands out) appends into block 0 and attends over it, as the
//   plain path does: its result is junk that nothing reads, computed
//   from reads inside the pool. A table entry outside the pool reads
//   block 0.
//
// Bound on an H100 SXM: bytes. Each K/V element read feeds 2 flops per
// query head of the group: about 4 f32 flops a byte at a group of 4 in
// bf16, far below the card's ridge (295 a byte). The figure of merit is
// the live rows' K/V bytes over 3.35 TB/s: at 32 rows of about 1,000
// tokens, 8 KV heads of 128, 4 KB a token a layer, some 39 us a layer.
//
// Design:
//   - One CTA of 4 warps per (row, KV head, up to HG query heads of the
//     group; HG 1, 2, 4 or 8, a compile-time width, padded heads masked):
//     256 CTAs at the serving cell's 32 x 8, about two per SM. A row is
//     not split across CTAs: at that shape (rows of 693-1,425 tokens) the
//     unsplit kernel reads 60-61% of 3.35 TB/s on an H100 SXM (0.064-0.065
//     ms of device time against 0.039), at the line under which a split
//     would pay, and a split's combine pass would add a launch to a step
//     that is bound by its launches (the wrapper alone takes the host
//     about as long as the kernel takes the card).
//   - A K or V row of d elements is cut into 16-byte pieces; R = min(32,
//     pieces) lanes read one row and a warp reads 32 / R rows (tokens)
//     with one 16-byte load a lane. Each lane streams its own pieces with
//     cp.async (L1 bypassed, zero-filled past the row's length) into its
//     own slots of a 3-stage ring of 4 KB a warp: two stages (8 KB a
//     warp, 32 KB a CTA) stay in flight while the third is consumed. A
//     lane reads back only what it copied, so no barrier guards the ring.
//   - q of the CTA's heads sits in f32 registers (the lane's elements of
//     each head). A K piece is converted once and dotted with every head;
//     the R lanes of a row sum their partial dots by shuffles. K and V are
//     never repeated, copied or widened in device memory.
//   - Online softmax per (warp, token slot), merged across slots by
//     shuffles and across warps in shared memory (the ring's bytes,
//     reused), then normalised once.
//   - The appended token is read from the k/v inputs, not the pool, so no
//     read of its slot can race the append: position `cur` (where the
//     append lands) is taken from the inputs, every other position from
//     the pool.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if defined(RTT_PAGED_BF16)
typedef __nv_bfloat16 elem_t;
#elif defined(RTT_PAGED_F16)
typedef __half elem_t;
#elif defined(RTT_PAGED_F32)
typedef float elem_t;
#else
#error "build with one of -DRTT_PAGED_BF16, -DRTT_PAGED_F16, -DRTT_PAGED_F32"
#endif
#if !defined(RTT_PAGED_D) || (RTT_PAGED_D != 64 && RTT_PAGED_D != 128 && \
                              RTT_PAGED_D != 256)
#error "build with -DRTT_PAGED_D=64, 128 or 256 (the head_dim)"
#endif

namespace rtt {
namespace paged {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 4096;  // a warp's K and V pieces of one stage
constexpr int SMEM_BYTES = WARPS * STAGES * STAGE_BYTES;  // 48 KB, static
constexpr int VEC = 16 / static_cast<int>(sizeof(elem_t));  // elements a piece
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const elem_t* q;
  long long q_sb, q_sh;  // strides (elements) of a row and a head
  const elem_t* k;
  long long k_sb, k_sh;
  const elem_t* v;
  long long v_sb, v_sh;
  elem_t* k_pool;  // [n_blocks, kv_heads, block_len, d], contiguous
  elem_t* v_pool;
  long long n_blocks;
  int kv_heads, block_len;
  const long long* tables;  // [b, table_width], row stride tables_sb
  long long tables_sb;
  int table_width;
  const long long* q_pos;  // [b], stride q_pos_sb
  long long q_pos_sb;
  const long long* valid_len;  // [b], stride valid_sb
  long long valid_sb;
  elem_t* out;  // [b, n_heads, d], contiguous
  int n_heads, group;
  float scale_log2;  // 1/sqrt(d) * log2(e): scores in the log2 domain
};

__device__ __forceinline__ void unpack(const uint4& r, float* f) {
#if defined(RTT_PAGED_F32)
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
#else
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#if defined(RTT_PAGED_BF16)
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
#else
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
#endif
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
#endif
}

__device__ __forceinline__ elem_t from_float(float x) {
#if defined(RTT_PAGED_BF16)
  return __float2bfloat16_rn(x);
#elif defined(RTT_PAGED_F16)
  return __float2half_rn(x);
#else
  return x;
#endif
}

// 16 bytes global -> shared, L1 bypassed; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^(x - m) for a running maximum m >= x of log2-domain scores; 0 where
// x is -inf.
__device__ __forceinline__ float rescale(float x, float m) {
  return x == -INFINITY ? 0.f : exp2f(x - m);
}

template <int D, int HG>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(const Params p) {
  // A lane holds E elements of a row: two pieces where the heads' q and
  // sums fit (HG * E <= 64 floats each), else one, and at least d / 32.
  constexpr int E = (HG <= 4 ? 2 * VEC : VEC) > D / 32
                        ? (HG <= 4 ? 2 * VEC : VEC) : D / 32;
  constexpr int LOADS = E / VEC;                   // pieces a lane of a row
  constexpr int R = D / E;                         // lanes that read a row
  constexpr int TW = 32 / R;                       // rows a warp load
  constexpr int U = STAGE_BYTES / (32 * 16 * 2 * LOADS);  // warp loads a stage
  constexpr int CHUNK = WARPS * U * TW;            // tokens a CTA iteration
  static_assert(R * E == D && R * TW == 32 && U >= 1, "head_dim does not tile");
  static_assert(WARPS * HG * (D + 2) * 4 <= SMEM_BYTES, "merge exceeds ring");

  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];

  const int b = blockIdx.y;
  const int chunks = (p.group + HG - 1) / HG;
  const int g = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int head0 = g * p.group + chunk * HG;
  const int heads = min(HG, p.group - chunk * HG);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = lane / R;
  const int col = lane % R;
  // Token indices are 32-bit (the entry point checks the table's width
  // in tokens fits), and a token's block is one 32-bit division.
  const unsigned bl = p.block_len;

  const long long* table = p.tables + b * p.tables_sb;
  const long long pos = p.q_pos[b * p.q_pos_sb];
  const elem_t* k_new = p.k + b * p.k_sb + g * p.k_sh;
  const elem_t* v_new = p.v + b * p.v_sb + g * p.v_sh;
  auto row_of = [&](unsigned logical_block, unsigned offset) {
    long long id = table[logical_block];
    if (id < 0 || id >= p.n_blocks) id = 0;
    return ((id * p.kv_heads + g) * bl + offset) * D;
  };

  // The append, and the logical position it lands at.
  int cur = -1;
  int len = 0;
  if (pos >= 0) {
    const long long width = static_cast<long long>(p.table_width) * bl;
    const unsigned lb = static_cast<unsigned>(
        min(pos / bl, static_cast<long long>(p.table_width) - 1));
    const unsigned off = static_cast<unsigned>(pos % bl);
    cur = static_cast<int>(lb * bl + off);
    if (chunk == 0) {
      const long long row = row_of(lb, off);
      for (int i = threadIdx.x; i < D / VEC; i += THREADS) {
        reinterpret_cast<uint4*>(p.k_pool + row)[i] =
            reinterpret_cast<const uint4*>(k_new)[i];
        reinterpret_cast<uint4*>(p.v_pool + row)[i] =
            reinterpret_cast<const uint4*>(v_new)[i];
      }
    }
    len = static_cast<int>(
        max(min(min(pos + 1, p.valid_len[b * p.valid_sb]), width), 0LL));
  }
  const int iters = (len + CHUNK - 1) / CHUNK;

  float qf[HG][E];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      if (hh < heads) {
        const uint4 r = *reinterpret_cast<const uint4*>(
            p.q + b * p.q_sb + (head0 + hh) * p.q_sh + (i * R + col) * VEC);
        unpack(r, &qf[hh][i * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[hh][i * VEC + e] = 0.f;
      }
    }
  }

  // A lane's piece (u, i) of K (kv 0) or V (kv 1) in a stage.
  unsigned char* ring = smem + warp * STAGES * STAGE_BYTES;
  auto piece = [&](int stage, int u, int i, int kv) {
    return ring + stage * STAGE_BYTES + ((u * LOADS + i) * 2 + kv) * 512 +
           lane * 16;
  };
  auto token = [&](int it, int u) {
    return it * CHUNK + (warp * U + u) * TW + slot;
  };
  auto load_stage = [&](int it) {
    const int stage = it % STAGES;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = token(it, u);
      const bool ok = it < iters && j < len;
      const elem_t* kr = p.k_pool;
      const elem_t* vr = p.v_pool;
      if (ok && j == cur) {
        kr = k_new;
        vr = v_new;
      } else if (ok) {
        const unsigned blk = static_cast<unsigned>(j) / bl;
        const long long row = row_of(blk, static_cast<unsigned>(j) - blk * bl);
        kr += row;
        vr += row;
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int e0 = (i * R + col) * VEC;
        cp_async16(piece(stage, u, i, 0), kr + e0, ok);
        cp_async16(piece(stage, u, i, 1), vr + e0, ok);
      }
    }
    cp_async_commit();
  };

  float m[HG], l[HG], acc[HG][E];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[hh][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s);
  for (int it = 0; it < iters; ++it) {
    // The stage refilled here was consumed in the previous iteration by
    // this lane alone; its reads are done (their values were used).
    load_stage(it + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    const int stage = it % STAGES;
    float s[U][HG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        unpack(*reinterpret_cast<const uint4*>(piece(stage, u, i, 0)),
               &kf[i * VEC]);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[hh][e], kf[e], d);
        s[u][hh] = d;
      }
#pragma unroll
      for (int off = R / 2; off >= 1; off >>= 1) {
#pragma unroll
        for (int hh = 0; hh < HG; ++hh)
          s[u][hh] += __shfl_xor_sync(FULL, s[u][hh], off);
      }
      const bool ok = token(it, u) < len;
#pragma unroll
      for (int hh = 0; hh < HG; ++hh)
        s[u][hh] = ok ? s[u][hh] * p.scale_log2 : -INFINITY;
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][hh]);
      const float corr = rescale(m[hh], mx);
      m[hh] = mx;
      l[hh] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[hh][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        unpack(*reinterpret_cast<const uint4*>(piece(stage, u, i, 1)),
               &vf[i * VEC]);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const float pe = rescale(s[u][hh], m[hh]);
        l[hh] += pe;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[hh][e] = fmaf(pe, vf[e], acc[hh][e]);
      }
    }
  }

  // Merge the token slots of the warp.
#pragma unroll
  for (int off = R; off < 32; off <<= 1) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float mo = __shfl_xor_sync(FULL, m[hh], off);
      const float lo = __shfl_xor_sync(FULL, l[hh], off);
      const float mx = fmaxf(m[hh], mo);
      const float ca = rescale(m[hh], mx);
      const float cb = rescale(mo, mx);
      l[hh] = l[hh] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[hh][e] = acc[hh][e] * ca + __shfl_xor_sync(FULL, acc[hh][e], off) * cb;
      m[hh] = mx;
    }
  }

  // Merge the warps in shared memory (the ring's bytes), normalise, store.
  cp_async_wait<0>();
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem);  // [WARPS][HG][D]
  float* sm_ml = sm_acc + WARPS * HG * D;          // [WARPS][HG][2]
  if (slot == 0) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[(warp * HG + hh) * D + (i * R + col) * VEC + e] =
              acc[hh][i * VEC + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      sm_ml[(warp * HG + hh) * 2] = m[hh];
      sm_ml[(warp * HG + hh) * 2 + 1] = l[hh];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < heads * D; idx += THREADS) {
    const int hh = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_ml[(w * HG + hh) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = rescale(sm_ml[(w * HG + hh) * 2], mx);
      num += sm_acc[(w * HG + hh) * D + d] * c;
      den += sm_ml[(w * HG + hh) * 2 + 1] * c;
    }
    p.out[(static_cast<long long>(b) * p.n_heads + head0 + hh) * D + d] =
        from_float(den > 0.f ? num / den : 0.f);
  }
}

template <int D, int HG>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid(p.kv_heads * ((p.group + HG - 1) / HG), batch);
  paged_decode_kernel<D, HG><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_group(const Params& p, int batch, cudaStream_t stream) {
  if (p.group == 1) return launch<D, 1>(p, batch, stream);
  if (p.group == 2) return launch<D, 2>(p, batch, stream);
  if (p.group <= 4) return launch<D, 4>(p, batch, stream);
  return launch<D, 8>(p, batch, stream);
}

}  // namespace paged
}  // namespace rtt

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take (a head_dim other than the
// library's RTT_PAGED_D; heads not a multiple of kv_heads; a table wider
// than 2^30 tokens). Launches nothing for batch 0.
extern "C" int rtt_paged_decode(
    const void* q, long long q_sb, long long q_sh, const void* k,
    long long k_sb, long long k_sh, const void* v, long long v_sb,
    long long v_sh, void* k_pool, void* v_pool, long long n_blocks,
    int kv_heads, int block_len, const void* tables, long long tables_sb,
    int table_width, const void* q_pos, long long q_pos_sb,
    const void* valid_len, long long valid_sb, void* out, int batch,
    int n_heads, int head_dim, float scale, void* stream) {
  using rtt::paged::Params;
  if (batch < 0 || kv_heads < 1 || n_heads < kv_heads || n_heads % kv_heads ||
      block_len < 1 || table_width < 1 || n_blocks < 1 || batch > 65535 ||
      static_cast<long long>(table_width) * block_len > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p;
  p.q = static_cast<const elem_t*>(q);
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k = static_cast<const elem_t*>(k);
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.v = static_cast<const elem_t*>(v);
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.k_pool = static_cast<elem_t*>(k_pool);
  p.v_pool = static_cast<elem_t*>(v_pool);
  p.n_blocks = n_blocks;
  p.kv_heads = kv_heads;
  p.block_len = block_len;
  p.tables = static_cast<const long long*>(tables);
  p.tables_sb = tables_sb;
  p.table_width = table_width;
  p.q_pos = static_cast<const long long*>(q_pos);
  p.q_pos_sb = q_pos_sb;
  p.valid_len = static_cast<const long long*>(valid_len);
  p.valid_sb = valid_sb;
  p.out = static_cast<elem_t*>(out);
  p.n_heads = n_heads;
  p.group = n_heads / kv_heads;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (head_dim != RTT_PAGED_D) return static_cast<int>(cudaErrorInvalidValue);
  return rtt::paged::launch_group<RTT_PAGED_D>(
      p, batch, static_cast<cudaStream_t>(stream));
}
