// Shared pieces of the two flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile geometry, the bf16 tensor-core product, and
// shared-memory tile loads.
//
// Both kernels use mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// each warp owning 16 rows of a 64-row tile. Fragment layouts (PTX ISA,
// "Matrix fragments for mma.m16n8k16"), with g = lane / 4 and
// c = lane % 4:
//   A (16x16, row-major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2c..2c+1]      a1 = A[g+8][2c..2c+1]
//     a2 = A[g][2c+8..2c+9]    a3 = A[g+8][2c+8..2c+9]
//   B (16x8, "col"), two registers: b0 = B[2c..2c+1][g], b1 = B[2c+8..2c+9][g]
//   C/D (16x8, f32), four registers: C[g][2c], C[g][2c+1], C[g+8][2c], C[g+8][2c+1]
// So two adjacent 8-column C tiles of a row block are exactly the A
// fragment of the next product: P = softmax(S) never leaves registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

typedef __nv_bfloat16 bf16;

constexpr int BLOCK = 64;           // rows of a q tile and of a kv tile
constexpr int WARPS = 4;            // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // as in JAX
constexpr float LN2 = 0.6931471805599453f;

// Row pitch (in elements) of a [BLOCK][D] tile in shared memory: 8
// elements of padding put the 8 rows a fragment load touches on 8
// distinct bank groups.
template <int D>
struct Pitch {
  static constexpr int value = D + 8;
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 from f32, lo in the low half (the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent bf16 of one row in shared memory.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column in shared memory, `pitch` elements apart.
__device__ __forceinline__ uint32_t ld_col_pair(const bf16* p, int pitch) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return static_cast<uint32_t>(u[0]) | (static_cast<uint32_t>(u[pitch]) << 16);
}

// Copy a [BLOCK][D] tile of a row-major global array (row stride D) to
// shared memory (row stride D + 8), 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src) {
  constexpr int CHUNKS = D / 8;
  constexpr int LD = Pitch<D>::value;
  for (int i = threadIdx.x; i < BLOCK * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
  }
}

// A fragment of rows r0 and r0 + 8 of a shared [.][LD] bf16 tile, at
// columns k0 .. k0 + 15.
__device__ __forceinline__ void ld_a_frag(uint32_t a[4], const bf16* tile,
                                          int ld, int r0, int k0, int c) {
  const bf16* p = tile + r0 * ld + k0 + 2 * c;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

}  // namespace rtt
