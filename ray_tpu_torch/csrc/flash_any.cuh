// Shared device helpers of the "any" flash kernels (flash_fwd_any.cu,
// flash_bwd_any.cu): element conversions that round as PyTorch's `.to()`
// does, and the warp-level tensor-core primitives their 16-bit paths use
// (ldmatrix and mma.sync m16n8k16 with f32 accumulation, sm_80 and later).
//
// Fragment layout of mma.sync m16n8k16 (PTX ISA), for lane l, g = l / 4,
// q = l % 4: A (16x16, row-major) holds rows {g, g + 8} x columns
// {2q, 2q + 1, 2q + 8, 2q + 9} in four 32-bit registers (a0: row g cols
// 2q..; a1: row g + 8; a2: row g, cols 8 + 2q..; a3: row g + 8, cols 8 +
// 2q..); B (16x8, column-major) holds k {2q, 2q + 1} (b0) and {2q + 8,
// 2q + 9} (b1) of column g; C (16x8) holds rows {g, g + 8} x columns
// {2q, 2q + 1} (c0, c1 on row g; c2, c3 on row g + 8). Two neighbouring
// C tiles of a row block are therefore the A operand of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rtt {
namespace any {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back, as the plain version's `.to(T).float()`.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Two floats rounded to T and packed into one register, `lo` in the low
// half (the lower column of an mma fragment).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b on the tensor cores: m16n8k16, T inputs, f32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i] (lane l: row l / 4, columns
// 2(l % 4), +1). `_t`: each matrix transposed (lane l: column l / 4, rows
// 2(l % 4), +1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// Two matrices (addresses from lanes 0-15), transposed.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// dst[0..3] += (a, b, c, d) in one 16-byte vector reduction (dst 16-byte
// aligned), issued without waiting for it (sm_90).
__device__ __forceinline__ void red_add_v4(float* dst, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Copy `rows` rows of D elements from global (row stride D) into shared
// memory with row stride LD elements, 16 bytes a thread at a time.
template <typename T, int D, int LD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows,
                                          int tid, int threads) {
  constexpr int VEC = 16 / sizeof(T);
  for (int e = tid; e < rows * (D / VEC); e += threads) {
    const int r = e / (D / VEC);
    const int c = (e % (D / VEC)) * VEC;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
  }
}

// The same copy by cp.async (16 bytes a thread, L2 only): it returns at
// once; `cp_async_commit` closes a group of copies and `cp_async_wait<N>`
// waits until at most N groups are still in flight (then a barrier makes
// the tile visible to the other threads).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D, int LD>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src,
                                                int rows, int tid,
                                                int threads) {
  constexpr int VEC = 16 / sizeof(T);
  for (int e = tid; e < rows * (D / VEC); e += threads) {
    const int r = e / (D / VEC);
    const int c = (e % (D / VEC)) * VEC;
    cp_async16(dst + r * LD + c, src + static_cast<size_t>(r) * D + c);
  }
}

}  // namespace any
}  // namespace rtt
