// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu, and the 16-bit kernels of flash_fwd_any.cu
// and flash_bwd_any.cu), in raw PTX: TMA tile loads on 3-D tensor maps,
// mbarrier pipelines, warpgroup matrix products (wgmma) and their
// shared-memory descriptors, and warp-specialisation register moves; the
// f32 kernels' TF32 split, TF32 wgmma and TF32 mma.sync; cp.async.
//
// Tile layout. Every 16-bit tile a kernel keeps in shared memory arrives by
// TMA under CU_TENSOR_MAP_SWIZZLE_128B, as boxes of 64 columns (128
// bytes, the widest a 128-byte-swizzled box may be) by `rows` rows: a
// d = 128 tile is two such boxes, one after the other. In a box, row r
// sits at byte 128 * r and its 16-byte chunk c at chunk c ^ (r % 8);
// eight rows make one 1024-byte swizzle atom, so every box starts on a
// 1024-byte boundary.
//
// wgmma descriptors over such boxes (PTX ISA, "Matrix Descriptor"):
//   K-major operand (the contraction axis runs along the 128-byte row):
//     stride byte offset 1024 (the next eight rows), leading byte offset
//     unused; the k-th 16-wide slice of a box starts 32 * k bytes in, and
//     the hardware applies the swizzle to the address it forms.
//   MN-major operand (the contraction axis runs down the rows, i.e. the
//     tile is read transposed): stride byte offset 1024 (the next eight
//     contraction rows), leading byte offset = the distance between two
//     64-column boxes; the k-th 16-row slice starts 2048 * k bytes in.
//
// Register fragments. A warpgroup's m64nN f32 accumulator gives warp w
// of the group rows 16w + g and 16w + g + 8 (g = lane / 4, c = lane % 4)
// and, for j in [0, N/2), element j at row 16w + g + 8 * ((j >> 1) & 1),
// column 8 * (j >> 2) + 2c + (j & 1): the layout of mma.sync's C
// fragments, side by side. The A operand of a register-sourced wgmma
// (m64k16) is the m16n8k16 A fragment of each warp's 16 rows, so the
// accumulator elements 8k .. 8k + 7, rounded to bf16 in pairs, are the
// A fragment of the k-th 16-column slice: P never leaves registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace rtt {

typedef __nv_bfloat16 bf16;

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // as in JAX
constexpr float LN2 = 0.6931471805599453f;
constexpr int BOX_COLS = 64;       // bf16 columns of one swizzled box
constexpr int BOX_ROW_BYTES = 128;
constexpr int WG_THREADS = 128;    // one warpgroup

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two bf16 from f32, lo in the low half (the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Barrier over `threads` threads of the block on hardware barrier `id`
// (0 is __syncthreads's).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives on hardware barrier `id` without waiting: the threads that
// bar.sync on it wait for these arrivals too (`threads` counts both).
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of transactions (TMA) to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A wrong parity or byte count would otherwise hang the card: after about
// ten seconds of waiting the kernel traps, and the launch fails instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA and bulk copies
// ---------------------------------------------------------------------------

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completes `bytes` of transactions on `bar`. Rows past the
// tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[0..3] += {a, b, c, d}: one 16-byte vector reduction in L2 (dst
// 16-byte aligned), issued without waiting for it.
__device__ __forceinline__ void red_add_v4(float* dst, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled shared-memory operand.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t desc = static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  desc |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  desc |= 1ull << 62;  // 128-byte swizzle
  return desc;
}

// The k-th 16-wide contraction slice of a K-major tile whose rows (the
// M or N axis) start at `tile`, in boxes of `rows` rows each: the
// contraction axis runs along a box's 64 columns, then into the next box.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int k) {
  return sw128_desc(tile + (k >> 2) * rows * BOX_ROW_BYTES + (k & 3) * 32, 16,
                    1024);
}

// The k-th 16-row contraction slice of an MN-major tile of boxes of
// `rows` rows: the M or N axis runs along the 64 columns of a box, and on
// into the next box `rows * 128` bytes further.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int k) {
  return sw128_desc(tile + k * 16 * BOX_ROW_BYTES, rows * BOX_ROW_BYTES,
                    1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products, m64nNk16 with f32 accumulators, in T = bf16 (the
// default) or f16 (RTT_WGMMA_F16): one overload per accumulator size
// (N / 2 registers a thread). SS: N in {64, 80, 128}; RS: N in {64, 128,
// 192, 256}. RTT_REGS<R> and RTT_ACC<R> spell out an accumulator's
// operands.
#define RTT_WGMMA_F16(T) (std::is_same<T, __half>::value)

#define RTT_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define RTT_ACC16(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define RTT_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31}"

#define RTT_ACC32(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31])

#define RTT_REGS40 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"

#define RTT_ACC40(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])

#define RTT_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
  "%58, %59, %60, %61, %62, %63}"

#define RTT_ACC64(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
    "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
    "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
    "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define RTT_REGS96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85," \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"

#define RTT_ACC96(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
    "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
    "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
    "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
    "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), \
    "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
    "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), \
    "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
    "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
    "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])

#define RTT_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85," \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99," \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110," \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121," \
  "%122, %123, %124, %125, %126, %127}"

#define RTT_ACC128(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
    "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
    "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
    "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
    "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), \
    "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
    "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), \
    "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
    "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
    "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
    "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), \
    "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), \
    "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), \
    "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
    "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), \
    "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
    "+f"(d[126]), "+f"(d[127])

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory.
template <int TRANS_A, int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (RTT_WGMMA_F16(T))
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        RTT_REGS32 ", "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : RTT_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
          "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        RTT_REGS32 ", "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : RTT_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
          "n"(TRANS_B));
}

// D[64 x 80] (+)= A[64 x 16] B[16 x 80], A and B from shared memory.
template <int TRANS_A, int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (RTT_WGMMA_F16(T))
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.f16.f16 "
        RTT_REGS40 ", "
        "%40, %41, p, 1, 1, %43, %44;\n}\n"
        : RTT_ACC40(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
          "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        RTT_REGS40 ", "
        "%40, %41, p, 1, 1, %43, %44;\n}\n"
        : RTT_ACC40(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
          "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory.
template <int TRANS_A, int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (RTT_WGMMA_F16(T))
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        RTT_REGS64 ", "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : RTT_ACC64(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
          "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        RTT_REGS64 ", "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : RTT_ACC64(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
          "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the m16n8k16
// A fragment of the warp's 16 rows), B from shared memory.
template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (RTT_WGMMA_F16(T))
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        RTT_REGS32 ", "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : RTT_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        RTT_REGS32 ", "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : RTT_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (the m16n8k16
// A fragment of the warp's 16 rows), B from shared memory.
template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (RTT_WGMMA_F16(T))
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        RTT_REGS64 ", "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : RTT_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        RTT_REGS64 ", "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : RTT_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 192] (+)= A[64 x 16] B[16 x 192], A from registers (the m16n8k16
// A fragment of the warp's 16 rows), B from shared memory.
template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (RTT_WGMMA_F16(T))
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.f16.f16 "
        RTT_REGS96 ", "
        "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : RTT_ACC96(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        RTT_REGS96 ", "
        "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : RTT_ACC96(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A from registers (the m16n8k16
// A fragment of the warp's 16 rows), B from shared memory.
template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (RTT_WGMMA_F16(T))
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
        RTT_REGS128 ", "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : RTT_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        RTT_REGS128 ", "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : RTT_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TRANS_B));
}

// D[64 x N] (+)= A[64 x 8] B[8 x N] in TF32 with f32 accumulators, A from
// registers (the m16n8k8 TF32 A fragment of each warp's 16 rows), B a
// K-major shared-memory operand (TF32 has no transposed form): N = 32
// (16 accumulators a thread), 64 (32) or 128 (64).
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      RTT_REGS16 ", "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : RTT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      RTT_REGS32 ", "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : RTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      RTT_REGS64 ", "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : RTT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: three-term TF32 (flash_fwd_any.cu's f32 kernel)
// ---------------------------------------------------------------------------

// x rounded to TF32 by cvt.rna.tf32.f32 (the reference of chip_smoke.py's
// check and kernel_ablation.py's cvt_split).
__device__ __forceinline__ uint32_t tf32_rna_cvt(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The same value for every finite x (10 mantissa bits, to nearest, ties
// away from zero, the low 13 bits zero), by an integer add of half a TF32
// ulp to the magnitude and a mask (a carry runs into the exponent as
// rounding up should): faster than the cvt in the f32 forward
// (kernel_ablation.py's cvt_split).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 of |x|: hi = tf32(x), lo = tf32(x - hi),
// the subtraction exact in f32 (CVT: rounded by the cvt instruction).
template <bool CVT = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = CVT ? tf32_rna_cvt(x) : tf32_rna(x);
  const float rest = x - __uint_as_float(hi);
  lo = CVT ? tf32_rna_cvt(rest) : tf32_rna(rest);
}

// D[16 x 8] += A[16 x 8] B[8 x 8] in TF32 with f32 accumulators, by one
// warp (mma.sync m16n8k8): A's fragment holds rows g, g + 8 (a0/a2, a1/a3)
// at k = c (a0, a1) and c + 4 (a2, a3), B's k = c (b0) and c + 4 (b1) at
// column g, D's rows g (d0, d1) and g + 8 (d2, d3) at columns 2c, 2c + 1
// (g = lane / 4, c = lane % 4). The f32 "wide" backward's products. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of an M x N grid of m16n8 tiles in three TF32 terms, small
// ones first into each accumulator: lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
// (lo*lo dropped). Term by term over the grid, so that the M * N
// independent accumulators hide each product's latency.
template <int M, int N>
__device__ __forceinline__ void mma_tf32x3(float (&d)[M][N][4],
                                           const uint32_t (&a_hi)[M][4],
                                           const uint32_t (&a_lo)[M][4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_lo[m], b_hi[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_hi[m], b_lo[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_hi[m], b_hi[n]);
  }
}

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies from global into shared memory, in groups
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// looked up through the runtime, so the library needs no link against
// libcuda.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous 16-bit [batch][rows][cols] array (bf16
// unless `type` says f16), read as 128-byte-swizzled boxes of 64 columns
// by `box_rows` rows. Columns past `cols` (a box that overhangs a row of
// fewer than a multiple of 64) arrive as zeros, as rows past `rows` do.
static cudaError_t make_tile_map(
    CUtensorMap* map, const void* base, int cols, int rows, int batch,
    int box_rows,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {BOX_COLS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      fn(map, type, 3, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The first 1024-byte boundary at or after p (swizzled boxes need it).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

}  // namespace rtt
