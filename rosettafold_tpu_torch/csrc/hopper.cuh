// Hopper (sm_90a) building blocks for kernels that stage operands by TMA
// or cp.async and multiply them with wgmma (kernels F, A, B, C's three
// launches, C', D, E, G and H's bf16 path):
//  * shared-memory addresses, mbarriers (init, arrive, expect_tx, a bounded
//    parity wait) and named barriers;
//  * TMA tiled loads (2-D, 3-D and 4-D) that complete on an mbarrier, and a
//    2-D tiled store in a bulk group; they, expect_tx and the bulk-group
//    commit and wait take a predicate, so a warpgroup runs the issue code in
//    step and one thread acts (a branch around them diverges the warpgroup,
//    and ptxas then serialises its wgmmas);
//  * wgmma: the shared-memory descriptors of a K-major and an MN-major
//    operand in the 128-byte swizzle, fence / commit / wait, `Wgmma<N>`
//    (m64nNk16 bf16, N = 32, 64, 128, 144, 256): A in shared memory (ss, K-major
//    or MN-major) or in registers (rs), B in shared memory K-major or
//    MN-major; and `WgmmaTf32<N>` (m64nNk8 tf32, N = 32, 64; K-major only)
//    with the split of a float32 into two TF32 parts for 3-pass products;
//  * rows of the pair width (288) as a warpgroup holds them: a LayerNorm
//    straight into wgmma A fragments, the epilogue of a 64 x 288
//    accumulator (bias, residual, 16-byte row stores through shared memory),
//    and a bulk prefetch of rows into L2;
//  * the FAVOR+ feature map into A fragments: rounded to bf16 (kernels C and
//    C'), or split into bf16 high and low parts (kernel H);
//  * cp.async copies of 4 and 16 bytes that zero-fill where a predicate
//    is false;
//  * the card's SM count;
//  * the host's cuTensorMapEncodeTiled, reached through the runtime's
//    driver entry point (no link against libcuda).
//
// The 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout 1):
// a tile of rows of 128 bytes, 1024-byte aligned, holds the 16-byte chunk c
// of row r at r * 128 + ((c ^ (r & 7)) << 4).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rf {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The TMA issue helpers take `pred`: only threads that pass a non-zero one
// act, with no branch, so a warpgroup can run the issue code in step.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes,
                                                      uint32_t pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes), "r"(pred)
      : "memory");
}

// Wait for the completion of the phase of parity `parity`. A wait that never
// ends (a phase-parity or transaction-count fault) traps after 2^25 polls,
// so a fault surfaces as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 25)) __trap();
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, uint32_t pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %5, 0;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(pred)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, uint32_t pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %6, 0;\n"
      " @p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(pred)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, uint32_t pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %7, 0;\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(pred)
      : "memory");
}

// A 2-D tile from shared memory (laid out as the map's swizzle) to global
// memory, in this thread's bulk group; elements outside the tensor are not
// written. The source must not change until the group has read it.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             uint32_t pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %4, 0;\n"
      " @p cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(pred)
      : "memory");
}

__device__ __forceinline__ void bulk_commit(uint32_t pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n @p cp.async.bulk.commit_group;\n}\n" ::"r"(
          pred)
      : "memory");
}

// Wait until at most N of this thread's bulk groups still read their shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read(uint32_t pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n @p cp.async.bulk.wait_group.read %1;\n}\n" ::"r"(
          pred),
      "n"(N)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a K-major operand tile in the 128-byte swizzle: rows of 64
// bf16 (128 bytes), groups of 8 rows 1024 bytes apart (SBO); the leading
// offset is unused in this layout. `addr` is the shared address of the first
// row plus the K offset (k * 2 bytes, < 128), in a tile whose swizzle was
// laid out from a 1024-byte boundary (as TMA writes it). The swizzle follows
// the address bits, so the first row may be any row of that tile: a shifted
// view (kernel F's taps) keeps the base offset, bits 49-51, at 0 (measured
// on the H100: r % 8 there gives wrong products).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major operand tile in the 128-byte swizzle (wgmma's
// transposed B): rows of 64 bf16 along N (128 bytes) for consecutive K, so a
// K step of 16 is two 8-row groups 1024 bytes apart (SBO), and a block of 64
// N-columns follows the previous one `lbo` bytes on (LBO; unused at N = 64).
// `addr` is the first row of the K step, 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Two floats rounded to bf16 as one 32-bit register: lo in the low half (the
// lower column of a wgmma A fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of them (a wgmma operand written by the threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// m64nNk16 bf16 -> float32, written out for each N the kernels use. The
// accumulator d[N / 2] of a thread (warp w of the warpgroup, lane = 4g + t):
// d[4i], d[4i + 1] at row 16w + g, columns 8i + 2t, 8i + 2t + 1; d[4i + 2],
// d[4i + 3] at row 16w + g + 8. An A fragment in registers for K step k is
// the same layout's columns 16k .. 16k + 15 as bf16 pairs: {d[8k], d[8k+1]},
// {d[8k+2], d[8k+3]}, {d[8k+4], d[8k+5]}, {d[8k+6], d[8k+7]} (pack_bf16).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (64 x 32) = (scale_d ? d : 0) + A . B; A in shared memory: K-major
  // (TRANS_A 0) or MN-major (TRANS_A 1); B in shared memory: K-major
  // (TRANS_B 0) or MN-major (TRANS_B 1)
  template <int TRANS_B = 0, int TRANS_A = 0>
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64) = (scale_d ? d : 0) + A . B; A in shared memory: K-major
  // (TRANS_A 0) or MN-major (TRANS_A 1); B in shared memory: K-major
  // (TRANS_B 0) or MN-major (TRANS_B 1)
  template <int TRANS_B = 0, int TRANS_A = 0>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  }
  // d (64 x 64) = (scale_d ? d : 0) + A . B; A (64 x 16) in registers (the
  // accumulator layout, bf16 pairs), B in shared memory: K-major (TRANS_B 0)
  // or MN-major (TRANS_B 1)
  template <int TRANS_B>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128) = (scale_d ? d : 0) + A . B; A in shared memory: K-major
  // (TRANS_A 0) or MN-major (TRANS_A 1); B in shared memory: K-major
  // (TRANS_B 0) or MN-major (TRANS_B 1)
  template <int TRANS_B = 0, int TRANS_A = 0>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  }
  // d (64 x 128) = (scale_d ? d : 0) + A . B; A (64 x 16) in registers (the
  // accumulator layout, bf16 pairs), B in shared memory: K-major (TRANS_B 0)
  // or MN-major (TRANS_B 1)
  template <int TRANS_B>
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<144> {
  // d (64 x 144) = (scale_d ? d : 0) + A . B; A K-major in shared memory, B
  // in shared memory: K-major (TRANS_B 0) or MN-major (TRANS_B 1)
  template <int TRANS_B = 0>
  __device__ __forceinline__ static void ss(float (&d)[72], uint64_t desc_a, uint64_t desc_b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, 0, %75;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
  // d (64 x 144) = (scale_d ? d : 0) + A . B; A (64 x 16) in registers (the
  // accumulator layout, bf16 pairs), B in shared memory: K-major (TRANS_B 0)
  // or MN-major (TRANS_B 1)
  template <int TRANS_B>
  __device__ __forceinline__ static void rs(float (&d)[72], const uint32_t (&a)[4],
                                            uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
        "}, {%72, %73, %74, %75}, %76, p, 1, 1, %78;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<256> {
  // d (64 x 256) = (scale_d ? d : 0) + A . B; A in shared memory: K-major
  // (TRANS_A 0) or MN-major (TRANS_A 1); B in shared memory: K-major
  // (TRANS_B 0) or MN-major (TRANS_B 1)
  template <int TRANS_B = 0, int TRANS_A = 0>
  __device__ __forceinline__ static void ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %132, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  }

  // d (64 x 256) = (scale_d ? d : 0) + A . B; A (64 x 16) in registers (the
  // accumulator layout, bf16 pairs), B in shared memory: K-major (TRANS_B 0)
  // or MN-major (TRANS_B 1)
  template <int TRANS_B>
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
};

// m64nNk8 tf32 -> float32 (N = 32, 64): the accumulator layout of Wgmma<N>.
// TF32 operands are K-major only (the transpose bits exist for f16 / bf16
// alone); a K-major tile of float32 rows of 32 values (128 bytes) in the
// 128-byte swizzle has the layout of a bf16 tile of rows of 64, so
// desc_sw128 describes it and a K step of 8 advances it by 32 bytes, as a
// bf16 K step of 16 does. The tensor cores read the top 19 bits of each
// value (tf32_split below).
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  // d (64 x 32) = (scale_d ? d : 0) + A . B over K = 8; A and B K-major in
  // shared memory
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  // d (64 x 64) = (scale_d ? d : 0) + A . B over K = 8; A and B K-major in
  // shared memory
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// x = big + small for a 3-pass TF32 product: big is x cut to TF32 (its low
// 13 mantissa bits cleared), small = x - big exactly (at most 13 significant
// bits, of which the tensor cores read the top 11): big + small holds x to
// 2^-21 of |x|, in two integer / float operations (no conversion)
__device__ __forceinline__ void tf32_split(float x, float& big, float& small) {
  big = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  small = x - big;
}

// FAVOR+ feature map of a 64 x 16 KS accumulator (kernels C and C'):
// relu(d) + eps as bf16 pairs into the A fragments of its KS K steps; columns
// at or past `valid` are zero. sum[h] gains the rounded values of row half h.
template <int KS = 4>
__device__ __forceinline__ void favor_features(uint32_t (&a)[KS][4], const float (&d)[8 * KS],
                                               float eps, int valid, int t, float (&sum)[2]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 16 * ks + 8 * (k >> 1) + 2 * t, e = 8 * ks + 2 * k;
      a[ks][k] = pack_bf16(col < valid ? fmaxf(d[e], 0.f) + eps : 0.f,
                           col + 1 < valid ? fmaxf(d[e + 1], 0.f) + eps : 0.f);
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[ks][k]);
      sum[k & 1] += __low2float(v) + __high2float(v);
    }
}

// The same feature map held to float32 accuracy (kernel H): x = relu(d) +
// eps in float32 (zero at columns at or past `valid`) as two bf16 A fragments
// per K step, hi = bf16(x) and lo = bf16(x - hi), so that hi . B + lo . B
// carries x to about 2^-17 of itself. sum[h] gains x * weight(column) of row
// half h, from the unrounded x.
template <int KS, typename Weight>
__device__ __forceinline__ void favor_features_split(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4],
                                                     const float (&d)[8 * KS], float eps,
                                                     int valid, int t, float (&sum)[2],
                                                     Weight&& weight) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 16 * ks + 8 * (k >> 1) + 2 * t, e = 8 * ks + 2 * k;
      const float x0 = col < valid ? fmaxf(d[e], 0.f) + eps : 0.f;
      const float x1 = col + 1 < valid ? fmaxf(d[e + 1], 0.f) + eps : 0.f;
      hi[ks][k] = pack_bf16(x0, x1);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[ks][k]);
      lo[ks][k] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
      sum[k & 1] += x0 * weight(col) + x1 * weight(col + 1);
    }
}

// ---- rows of the pair width -------------------------------------------------
// A warpgroup of a pair-track kernel holds 64 rows of D = 288 values: thread
// (warp w of the warpgroup, lane 4g + t) holds rows 16w + g and 16w + g + 8.

constexpr int PAIR_D = 288;
constexpr int PAIR_KSTEPS = PAIR_D / 16;  // K steps of 16 over a row
constexpr int PAIR_LDH = PAIR_D / 2 + 8;  // staging row stride of a half row (elements),
                                          // conflict-free for the fragments' 4-byte pairs
constexpr int PAIR_STAGE_BYTES = 64 * PAIR_LDH * 2;  // a warpgroup's epilogue staging

// LayerNorm of the thread's two rows (float32 statistics, var = E[x^2] -
// E[x]^2 as flax's fast variance), rounded to bf16 straight into the wgmma
// A fragments of the 18 K steps: a[ks][k] holds columns 16ks + 8(k >> 1) +
// 2t, +1 of row `lo` (k even) or `hi` (k odd), the accumulator layout's bf16
// pairs. The four threads of a quad hold a row between them; each reads its
// 72 values of each row as 4-byte pairs. A null row reads as zeros; a null
// gamma copies the rows (no LayerNorm).
__device__ __forceinline__ void ln_a_fragments(uint32_t (&a)[PAIR_KSTEPS][4],
                                               const __nv_bfloat16* lo, const __nv_bfloat16* hi,
                                               const float* gamma, const float* beta, float eps,
                                               int t) {
#pragma unroll
  for (int ks = 0; ks < PAIR_KSTEPS; ++ks)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat16* row = (k & 1) ? hi : lo;
      const int col = 16 * ks + 8 * (k >> 1) + 2 * t;
      a[ks][k] = row == nullptr ? 0u : __ldg(reinterpret_cast<const unsigned int*>(row + col));
    }
  if (gamma == nullptr) return;
  float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < PAIR_KSTEPS; ++ks)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[ks][k]));
      s[k & 1] += v.x + v.y;
      ss[k & 1] += v.x * v.x + v.y * v.y;
    }
  float mu[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
    mu[h] = s[h] / PAIR_D;
    inv[h] = rsqrtf(fmaxf(ss[h] / PAIR_D - mu[h] * mu[h], 0.f) + eps);
  }
#pragma unroll
  for (int ks = 0; ks < PAIR_KSTEPS; ++ks)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 16 * ks + 8 * (k >> 1) + 2 * t, h = k & 1;
      const float2 g = __ldg(reinterpret_cast<const float2*>(gamma + col));
      const float2 b = __ldg(reinterpret_cast<const float2*>(beta + col));
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[ks][k]));
      a[ks][k] = pack_bf16((v.x - mu[h]) * inv[h] * g.x + b.x, (v.y - mu[h]) * inv[h] * g.y + b.y);
    }
}

// 16 bytes from global to shared memory without passing through registers
// (both 16-byte aligned), and the wait for all of this thread's such copies.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 4 or 16 bytes from global to shared memory, or zeros where `valid` is 0
// (the source is then not read, but must be an address)
__device__ __forceinline__ void cp_async_4z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The epilogue of a warpgroup holding 64 rows x 288 float32 sums in two
// m64n144 accumulators (columns 0-143, 144-287): out row r = bf16(acc + bias
// (+ x row r)), added in float32 and rounded once (a null bias adds
// nothing). Each half goes through
// shared memory `st` (64 rows of PAIR_LDH elements, 19,456 bytes) so that x
// is read and out written as whole 16-byte vectors: row_x(r), row_out(r)
// give row r's first element (x is read only with `residual`); rows >=
// `valid`, and rows whose row_out is null, are not written. Whole warpgroup;
// `bar` is a named barrier of its 128 threads. `st` may be written again
// once it returns.
template <typename RowX, typename RowOut>
__device__ __forceinline__ void epilogue_rows_288(__nv_bfloat16* st, const float (&acc0)[72],
                                                  const float (&acc1)[72],
                                                  const float* __restrict__ bias, int residual,
                                                  RowX row_x, RowOut row_out, int valid, int bar) {
  constexpr int VPH = PAIR_D / 2 / 8;  // 16-byte vectors a half row
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5) + g;
  auto half = [&](const float(&d)[72], int col0) {
    if (residual) {  // asynchronous copies: every row's loads in flight at once
      for (int e = tid; e < valid * VPH; e += 128) {
        const int r = e / VPH, c = 8 * (e % VPH);
        cp_async_16(st + r * PAIR_LDH + c, row_x(r) + col0 + c);
      }
      cp_async_wait_all();
    }
    named_barrier(bar, 128);
#pragma unroll
    for (int n = 0; n < 18; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 b = bias == nullptr ? make_float2(0.f, 0.f)
                                       : __ldg(reinterpret_cast<const float2*>(bias + col0 + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8 * h) * PAIR_LDH + col);
        float v0 = d[4 * n + 2 * h] + b.x, v1 = d[4 * n + 2 * h + 1] + b.y;
        if (residual) {
          const float2 x = __bfloat1622float2(*p);
          v0 = x.x + v0;
          v1 = x.y + v1;
        }
        *p = __floats2bfloat162_rn(v0, v1);
      }
    }
    named_barrier(bar, 128);
    for (int e = tid; e < valid * VPH; e += 128) {
      const int r = e / VPH, c = 8 * (e % VPH);
      __nv_bfloat16* o = row_out(r);
      if (o != nullptr)
        *reinterpret_cast<uint4*>(o + col0 + c) =
            *reinterpret_cast<const uint4*>(st + r * PAIR_LDH + c);
    }
    named_barrier(bar, 128);  // st is read before it is written again
  };
  half(acc0, 0);
  half(acc1, PAIR_D / 2);
}

// Prefetch `bytes` (a multiple of 16) from 16-byte aligned global memory into L2.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// ---- host ---------------------------------------------------------------------

// the current device's SM count, read once a process
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point; null if
// the driver does not offer it
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first), byte strides of
// dimensions 1 .. rank-1, a box of `box` elements, 128-byte swizzle, zero
// fill outside the tensor. cudaErrorInvalidValue if it cannot be encoded.
inline cudaError_t encode_bf16_sw128(CUtensorMap* map, const void* base, int rank,
                                     const cuuint64_t* dims, const cuuint64_t* strides,
                                     const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base),
                  dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace rf
