// Hopper (sm_90a) building blocks for TMA + mbarrier + wgmma pipelines,
// as inline PTX in the idiom of common.cuh: mbarriers, cp.async copies
// whose completion arrives on an mbarrier, 2D and 4D TMA tile loads, the
// wgmma shared-memory descriptor for 128-byte swizzled tiles,
// the wgmma fence / commit / wait, the bf16 products with f32
// accumulators (m64n256k16 from shared memory; m64n64k16 and m64n128k16
// with A from shared memory or from registers), the tf32 products
// (m64n16k8, m64n32k8 and m64n64k8 with A from shared memory, m64n32k8,
// m64n64k8 and m64n128k8 with A from registers), the async-proxy fence
// and named barriers, setmaxnreg, and the host-side tensor-map encoders
// (a row-major bf16 matrix, or a byte matrix in the 64-byte swizzle;
// one head of a bf16 or f32 BSHD tensor).
//
// Layout conventions (PTX ISA, "Matrix Descriptor Format" and
// "Shared Memory Matrix Layout"; one 128-byte-swizzled tile is what a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B and a 128-byte inner box (64 bf16
// or 32 f32 elements) writes, rows of 128 bytes in atoms of 8 rows = 1024
// bytes, the 16-byte chunk c of row r at chunk c ^ (r % 8), so every tile
// base must be 1024-byte aligned):
//   K-major operand, stored [mn][128 bytes of k]: SBO = 1024 (one 8-row
//     atom to the next along M/N), LBO unused; a k step of 32 bytes (k16
//     in bf16, k8 in tf32) starts 32 bytes further into the row (the
//     swizzle is applied to the address, so the start moves within the
//     atom). tf32 operands are read K-major only (PTX has no transpose
//     for them).
//   MN-major operand, stored as boxes [64 k][64 mn]: SBO = 1024 (8 k rows
//     to the next 8), LBO = the byte distance from one 64-wide MN box to
//     the next; the k16 slice kk starts 16 * 128 * kk bytes in.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make initialised barriers visible to the async proxy (TMA) and to the
// other threads; call once after the inits, before a __syncthreads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and add `bytes` to the transactions the current phase waits
// for (the TMA loads started against this barrier complete them)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// true once the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting on parity 1 passes at once)
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- cp.async into an mbarrier-tracked stage --------------------------------

// 4-byte global -> shared copy; the first src_bytes (0 or 4) are read,
// the rest zero-filled (ptt::cp_async16 is the 16-byte form)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread started before
// has landed; the arrival counts towards the barrier's expected count
// (.noinc), so the barrier is initialised with one arrival per thread
// that calls this
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ---- TMA ------------------------------------------------------------------

// Copy the box at (c0 = inner coordinate, c1 = row) of `map` into shared
// memory at dst and complete its bytes on `bar`. Out-of-range elements are
// written as zero and still count towards the box's bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The 4D form (c0 innermost): a box of one head of a BSHD tensor
// (tma_map_bshd) at (c0 = column, c1 = head, c2 = row, c3 = batch).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile starting at
// p (byte offsets in the layout comment above).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;                   // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma (call around each batch of products and
// after wgmma_wait, before reading them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] = A[64 x 16] B[16 x 256] + (accumulate ? d : 0), bf16
// operands from shared memory, f32 accumulators. TA / TB: the transpose
// bits (0: K-major; 1: A M-major, B N-major). Accumulator layout, thread t
// of the warpgroup: d[4j + 2h + e] is row 16 (t / 32) + (t % 32) / 4 + 8h,
// column 8j + 2 (t % 4) + e. Starting a sum with accumulate = 0 rather
// than zeroing d keeps non-wgmma instructions off the accumulators, which
// would make ptxas serialise the products (its warning C7515).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, %130, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "n"(TA), "n"(TB), "r"(accumulate));
}

// The narrower products, overloaded on the accumulator array: 32 f32 a
// thread for N = 64, 64 for N = 128 (the same accumulator layout as
// m64n256k16 above, j < N / 8). wgmma_ss reads both operands from
// shared memory (TA / TB as above); wgmma_rs reads A from registers, four
// bf16 pairs a thread in the layout of mma.sync's m16n8k16 A fragment,
// warp w of the warpgroup holding rows 16w..16w + 15: a[0] = (row g, k
// 2c, 2c + 1), a[1] = (row g + 8, the same k), a[2] and a[3] the same
// rows at k + 8, with g = lane / 4, c = lane % 4. The accumulators of a
// product whose N columns are the k of the next one are that fragment
// already: k slice kk of the next product is the pairs (d[8kk], d[8kk +
// 1]), (d[8kk + 2], d[8kk + 3]), (d[8kk + 4], d[8kk + 5]), (d[8kk + 6],
// d[8kk + 7]), rounded to bf16 (FlashAttention-3's P hand-off).
// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "n"(TA), "n"(TB), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %66, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(TA), "n"(TB), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TB),
        "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TB),
        "r"(accumulate));
}

// ---- tf32 products (f32 accumulators) ------------------------------------
//
// A 3xTF32 product keeps an f32 operand as hi + lo, both tf32: the
// accumulator layout is the bf16 products' (d[4j + 2h + e] is row 16 (t /
// 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e); A from registers
// is four tf32 values a thread in the layout of mma.sync's m16n8k8 tf32
// A fragment, warp w holding rows 16w..16w + 15: a[0] = (row g, k c),
// a[1] = (row g + 8, k c), a[2] = (row g, k c + 4), a[3] = (row g + 8,
// k c + 4), g = lane / 4, c = lane % 4.

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding) as an f32 whose low 13 bits are zero
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

#define PTT_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PTT_D16(i) PTT_D4(i), PTT_D4(i + 4), PTT_D4(i + 8), PTT_D4(i + 12)
#define PTT_R16                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define PTT_R32                                                               \
  PTT_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, "                        \
          "%24, %25, %26, %27, %28, %29, %30, %31"
#define PTT_R64                                                               \
  PTT_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, "                        \
          "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
          "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
          "%56, %57, %58, %59, %60, %61, %62, %63"

// d[64 x 16] (+)= A[64 x 8] B[8 x 16], tf32, both K-major from shared
// memory
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : PTT_D4(0), PTT_D4(4)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32, both K-major from shared
// memory
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" PTT_R16
      "}, %16, %17, p, 1, 1;\n}\n"
      : PTT_D16(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32, both from shared memory
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" PTT_R32
      "}, %32, %33, p, 1, 1;\n}\n"
      : PTT_D16(0), PTT_D16(16)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32, A from registers
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" PTT_R16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : PTT_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32, A from registers
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" PTT_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : PTT_D16(0), PTT_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 8] B[8 x 128], tf32, A from registers
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" PTT_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : PTT_D16(0), PTT_D16(16), PTT_D16(32), PTT_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

#undef PTT_D4
#undef PTT_D16
#undef PTT_R16
#undef PTT_R32
#undef PTT_R64

// ---- ordering between the generic and the async proxy -------------------

// make this thread's shared-memory writes visible to later async-proxy
// reads (wgmma operands, TMA) and order them after earlier ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads, whole
// warps
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- register rebalancing between warpgroups ------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry), looked up through the runtime
// so the library links against nothing beyond cudart.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, cols] matrix (row length cols, 16-byte aligned
// base, cols % 8 == 0) as a TMA map whose box is [box_rows, 64 columns]
// with the 128-byte swizzle; out-of-range elements load as zero. Returns
// 0, or the CUresult of the encoder (cudaErrorNotSupported without one).
inline int tma_map_bf16(CUtensorMap* map, const void* base, uint64_t rows,
                        uint64_t cols, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return static_cast<int>(fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// A row-major byte matrix [rows, cols] (int8 codes; cols % 16 == 0,
// 16-byte aligned base) as a TMA map whose box is [box_rows, 64 bytes]
// with the 64-byte swizzle: a box lands as box_rows rows of 64 bytes,
// the 16-byte chunk c of row r at chunk c ^ (r / 2 % 4) (512-byte
// aligned destination), so 8 consecutive rows of one chunk sit in 8
// different bank groups; out-of-range bytes load as zero. Returns 0 or
// the encoder's CUresult, as tma_map_bf16.
inline int tma_map_u8_sw64(CUtensorMap* map, const void* base, uint64_t rows,
                           uint64_t cols, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return static_cast<int>(fn(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// One head of a BSHD tensor [B][S][H][D] of `elem_bytes`-byte elements
// (bf16: 2, f32: 4; D * elem_bytes % 16 == 0, 16-byte aligned base) as a
// 4D TMA map, dims {D, H, S, B} innermost first, whose box is one head's
// [box_rows][128 bytes of columns] (64 bf16 or 32 f32) with the 128-byte
// swizzle: a box lands in shared memory as the [rows][128 bytes] swizzle
// atoms a K-major or MN-major descriptor reads. Rows past S load as zero
// within each batch. Returns 0 or the encoder's CUresult, as
// tma_map_bf16.
inline int tma_map_bshd(CUtensorMap* map, const void* base, uint64_t B,
                        uint64_t S, uint64_t H, uint64_t D,
                        uint32_t box_rows, uint32_t elem_bytes = 2) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const uint64_t e = elem_bytes;
  const cuuint64_t dims[4] = {D, H, S, B};
  const cuuint64_t strides[3] = {D * e, H * D * e, S * H * D * e};
  const cuuint32_t box[4] = {128 / elem_bytes, 1, box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return static_cast<int>(fn(
      map, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace hopper
}  // namespace ptt
