// Hopper's asynchronous primitives, shared by the kernels that use them
// (built for sm_90a): wgmma's shared-memory descriptors and instructions,
// mbarriers, and TMA tile loads.
//   * vocab_head_mma.cuh: the bf16 heads' first pass (wgmma m64n128k16 fed
//     by a cp.async ring).
//   * cell_wgmma.cu: the bf16 cell (wgmma m64n32k16 fed by a TMA ring with
//     a producer warpgroup, setmaxnreg).
//   * att_step.cu: the attention's stream (mbarriers over cp.async.bulk).
#pragma once

#include "common.cuh"

namespace cic {

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of wgmma: the address, the leading and the
// stride byte offsets in 16-byte units, and the layout type (1: 128-byte
// swizzle, 2: 64-byte swizzle).  The tiles start on a boundary of their
// swizzle pattern (1024 / 512 bytes), so the base offset is 0.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo,
                                             uint32_t layout = 1) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

#define CIC_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A[64 x 16] * B[16 x N]: bf16 in, f32 accumulators; A K-major, B
// MN-major (the transposed form of the descriptor).  `accumulate` 0 starts
// from zero.  N = 128, 32: 64, 16 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : CIC_ACC8(0), CIC_ACC8(8), CIC_ACC8(16), CIC_ACC8(24), CIC_ACC8(32),
        CIC_ACC8(40), CIC_ACC8(48), CIC_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : CIC_ACC8(0), CIC_ACC8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef CIC_ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers of a warpgroup's threads from here on (a multiple of 8 in [24,
// 256]; every warp of the warpgroup executes it): a producer gives
// registers back, its consumers take them.
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

// The barriers' initialisation, visible to the async proxy (TMA, bulk
// copies) before any copy completes on them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies completing on the
// barrier's current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
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

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -------------------------------------------------------------------

// The box of a 2-D tensor map at (x, y) -- x the inner (contiguous)
// coordinate -- into shared memory at `dst`, counted on `bar`.  Elements
// outside the tensor arrive as zeros and count toward the box's bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

}  // namespace cic
