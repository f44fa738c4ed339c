// Hopper's asynchronous primitives, shared by the kernels that use them
// (built for sm_90a): wgmma's shared-memory descriptors and instructions,
// mbarriers, TMA tile loads, and the host's tensor maps.
//   * vocab_head_tma.cuh: the bf16 heads' first pass (wgmma m64n64k16 into
//     two accumulator sets, fed by a TMA ring with a producer warp).
//   * cell_wgmma.cu: the bf16 cell (wgmma m64n32k16 fed by a TMA ring with
//     a producer warpgroup, setmaxnreg).
//   * att_step.cu: the attention's stream (mbarriers over cp.async.bulk).
#pragma once

#include <cuda.h>

#include <mutex>

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
// from zero.  N = 64, 32: 32, 16 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : CIC_ACC8(0), CIC_ACC8(8), CIC_ACC8(16), CIC_ACC8(24)
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

// mbar_wait that traps after ~2^32 cycles (about 2 s): a fault of the
// tensor maps would otherwise leave the warps spinning, and the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023u) == 1023u) {
      const long long now = clock64();
      if (start == 0)
        start = now;
      else if (now - start > (1LL << 32))
        __trap();
    }
  }
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

// --- tensor maps (host) ----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, reached through
// cudaGetDriverEntryPoint: nothing links libcuda.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major bf16 matrix [rows, cols] read in boxes of
// box_rows x box_cols; elements outside it arrive as zeros.
inline bool encode_bf16_map(CUtensorMap* map, const void* p, int rows,
                            int cols, int box_cols, int box_rows,
                            CUtensorMapSwizzle swizzle,
                            CUtensorMapL2promotion promotion) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The last kSlots maps of weights, keyed by every argument of the encoding
// (address, shape -- the row stride follows from it: the tensors are
// contiguous bf16 --, box, swizzle, promotion): a map holds no data, so an
// update of the weights in place leaves it right, and a new tensor at an
// old address with another shape gets a map of its own.
class WeightMaps {
 public:
  bool get(CUtensorMap* map, const void* p, int rows, int cols, int box_cols,
           int box_rows, CUtensorMapSwizzle swizzle,
           CUtensorMapL2promotion promotion) {
    const Key key{p, rows, cols, box_cols, box_rows, (int)swizzle,
                  (int)promotion};
    std::lock_guard<std::mutex> hold(lock_);
    for (int i = 0; i < used_; ++i) {
      if (entries_[i].key == key) {
        *map = entries_[i].map;
        return true;
      }
    }
    if (!encode_bf16_map(map, p, rows, cols, box_cols, box_rows, swizzle,
                         promotion))
      return false;
    entries_[next_] = {key, *map};
    next_ = (next_ + 1) % kSlots;
    if (used_ < kSlots) ++used_;
    return true;
  }

 private:
  static constexpr int kSlots = 16;
  struct Key {
    const void* p;
    int rows, cols, box_cols, box_rows, swizzle, promotion;
    bool operator==(const Key& o) const {
      return p == o.p && rows == o.rows && cols == o.cols &&
             box_cols == o.box_cols && box_rows == o.box_rows &&
             swizzle == o.swizzle && promotion == o.promotion;
    }
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  std::mutex lock_;
  Entry entries_[kSlots];
  int used_ = 0;
  int next_ = 0;
};

}  // namespace cic
