// Shared helpers for the package's Hopper kernels (built for sm_90a).
//
// The kernels take float32 or bfloat16 inputs and always accumulate in
// float32.  Every C entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// (too many threads, too much shared memory) reaches the Python wrapper,
// which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define CIC_EXPORT extern "C" __attribute__((visibility("default")))

namespace cic {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Candidate order of the vocabulary heads: larger value first, and on an
// exact tie the lower id first -- the order of jnp.argmax and lax.top_k.
__device__ __forceinline__ bool before(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Streaming log-sum-exp state (m = running max, s = sum of exp(x - m)).
__device__ __forceinline__ void lse_push(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -CUDART_INF_F) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// --- asynchronous copies to shared memory (cp.async) -----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; zero-fills when !valid (src must still be an address inside
// the tensor).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid = true) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4-byte copy (through L1).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- bf16 tensor cores (mma.sync) ------------------------------------------

// d += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulators, the fragments of
// mma.sync.m16n8k16 (row-major A, column-major B).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8 x 8 bf16 matrices from shared memory, transposed, lane l < 16
// giving the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// --- TF32 tensor cores (mma.sync), for split-TF32 f32 products ------------

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away),
// in a 32-bit register with the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// tf32_rna's rounding on the integer pipe: half a TF32 ulp added to the
// magnitude bits (a carry into the exponent is the right rounding), the low
// 13 bits cleared; the same bits as cvt.rna.tf32.f32 for every finite x.
__device__ __forceinline__ uint32_t tf32_rna_alu(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// split_tf32 with tf32_rna_alu: two integer adds and two logic ops in place
// of two conversions, which issue at a lower rate (the cell kernel's split
// of every operand element is measured 7-9% faster this way).
__device__ __forceinline__ void split_tf32_alu(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = tf32_rna_alu(x);
  lo = tf32_rna_alu(x - __uint_as_float(hi));
}

// d += a[16 x 8] * b[8 x 8], TF32 in, f32 accumulators (row-major A,
// column-major B).
__device__ __forceinline__ void mma_tf32_1688(float* d, const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, from zero accumulators.
__device__ __forceinline__ void mma_tf32_1688_zero(float* d,
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

}  // namespace cic
