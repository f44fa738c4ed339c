// Fused additive attention for one Att2in2 decode step (forward only), in
// three context layouts.
//
// Replaces the Pallas kernels of
//   cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:
//   _attention_pallas         b-major context   att_emb [B,K,H], p_att [B,K,A]
//   _attention_pallas_kmajor  K-major context   att_emb_t [K,B,H], p_att_t [K,B,A]
//   _attention_pallas_q       int8 context      emb_q, p_q int8 [B,K,*] with
//                                               f32 scales [B,K] per (row, slot)
// Per batch row b:
//   att_h  = h[b] @ W_h2att + b_h2att                              [A]
//   s[k]   = tanh(p_att[b,k] + att_h) . w_alpha + b_alpha          [K]
//   w      = softmax(s); with a mask: w = w * mask, w = w / sum(w)
//   out[b] = sum_k w[k] * att_emb[b,k]                             [H]
// The mask is applied after the softmax and the weights renormalized, as in
// the reference (not -inf masking); with no mask there is no renormalization.
// The mask is [B,K] in every layout.  The int8 call dequantizes in
// registers: p_att[b,k,a] = float(p_q[b,k,a]) * p_scale[b,k], and the scale
// of att_emb is folded into the weight after mask and renormalization
// (ws[k] = w[k] * emb_scale[b,k]; out = sum_k ws[k] * float(emb_q[b,k])).
//
// What bounds it on the H100: streaming the context.  Each step reads
// att_emb [B,K,H] and p_att [B,K,A] once -- at K=36, H=A=512 in bf16 that is
// 72 KiB per row, 37 MiB at B=512 (half of that in int8, plus 288 bytes of
// scales per row) -- against ~2*K*(H+A) flops per row for scores and output,
// far below the card's flop/byte balance.  A stream only reaches the memory's
// rate with tens of KiB in flight on every SM, and the int8 context only if
// its arithmetic (unpacking, tanh) keeps pace with half the bytes.
//
// Design: two launches a call, the same for the three layouts.
//   1. att_h pre-pass on the tensor cores: att_h = h @ W_h2att + b_h2att as
//      f32 [B,A] into a scratch tensor of the wrapper's (launch_att_h).
//      f32: att_h_splitk_kernel, 16 x 32 tiles (128 blocks at B = 128):
//      a block starts the copies of its h rows and its slab of W for the
//      whole depth at once (one memory latency a block; a ring of a few
//      128-byte steps, tried first, paid about a latency a step and took
//      twice as long), eight warps multiply a 64-deep slice each for the
//      whole tile, and the partial tiles are summed through shared memory.
//      Split TF32 on mma.sync m16n8k8 -- each operand as a TF32 high part
//      and a TF32 remainder (cic::split_tf32_alu), three products (hi*hi,
//      hi*lo, lo*hi), the hi*hi products of a slice summed from zero and
//      added in f32 (the tensor cores round their sums toward zero; over 8
//      steps of a fresh sum that stays far below the pre-pass's 1e-5).
//      bf16 below kPreManyRows rows: att_h_mma_kernel<2, 2, 4>, 32 x 64
//      tiles, the same whole-depth copies in four cp.async groups, mma.sync
//      m16n8k16 with f32 accumulators.  bf16 from kPreManyRows rows:
//      att_h_ring_kernel, 64 x 128 tiles through a 4-stage cp.async ring (W
//      read B / 64 times from L2, not B / 32).  Shapes or pointers that are
//      not 16-byte aligned take att_h_fma_kernel (fmaf in f32).  Each block
//      runs griddepcontrol.launch_dependents once its first loads are in
//      flight, and keeps within kPreSmem of shared memory.
//   2. The stream, launched as the pre-pass's programmatic dependent
//      (cudaLaunchKernelEx with programmatic stream serialization; every
//      call at vector width, where stream_plan asks for it): its blocks
//      start while the pre-pass runs, start their first context copies,
//      and wait (griddepcontrol.wait) only before the copies of att_h, which
//      nothing but the scores needs.  The plan leaves a pre-pass block's
//      shared memory (kPreSmem) and registers free beside a stream block on
//      an SM for that.  In a CUDA graph the capture keeps the launch's
//      programmatic edge (CUDA 12.9; chip_smoke.py counts it).
//      A block is eight consumer warps and one producer warp.  The grid is
//      up to kStreamBlocks blocks an SM for bf16 (56 registers a thread),
//      kStreamBlocksF32 for f32 (72), one a row while rows last
//      (stream_plan); block i walks rows i, i + grid, ...  A row's context
//      is cut into chunks of `slots` attention
//      slots: first its p_att chunks, then its att_emb chunks.  All chunks
//      of a block flow in order through a ring of `stages` shared-memory
//      stages.  The producer warp fills a stage as soon as its empty
//      mbarrier says that every consumer warp is done with it: one lane
//      announces the bytes on the stage's full mbarrier and starts one
//      cp.async.bulk a contiguous run (the whole chunk in the b-major
//      layouts, a slot in the K-major); with a row's first chunk come the
//      row's att_h (bulk) and its mask and scale values (the warp's stores,
//      released by its 32 arrivals on the full barrier) into a ring of row
//      slots.  No block-wide barrier: the ring runs as far ahead as it
//      holds, and a warp that finishes a row's weighted sum goes on to the
//      next row's scores while the others finish theirs.
//      Consumers: the scores one warp a slot (16-byte shared loads, lanes
//      along A; without b_alpha, which moves every score of a row alike and
//      which the softmax does not see); one consumer barrier a row (bar.sync
//      1, after the row's last score), after which every warp computes the
//      row's softmax maximum and normalizer itself; a chunk's weights one a
//      lane (mask and, int8, att_emb's scale folded in), read back by every
//      lane from a per-warp row; the weighted sum of A and E with 16 bytes
//      of neighbouring columns a thread, the chunk's slots split over the
//      thread groups that share those columns and reduced through shared
//      memory at the row's end (a second consumer barrier), 16-byte
//      stores; the int8 context's with a pair of columns a thread (no
//      reduction).  The [B,K,A] tanh intermediate never leaves the SM.
//      Layout (BMajor / KMajor / QuantBMajor) decides where slot (b, k) lies
//      and, for the int8 context, the element type and the scales.
//   The scores are bound by the special-function unit (16 results a clock
//   an SM): f32 inputs take tanh as 1 - 2 / (exp(2x) + 1) on the fast
//   exponential, |x| clamped to 15 (two special-function results an element,
//   absolute error below 1e-6, inside the call's f32 tolerance of 1e-4);
//   bf16 inputs take tanh.approx.f32 (one result an element; relative error
//   2^-11, below the inputs' own rounding).
//   bf16 calls over the int8 context compute in packed half precision
//   (f16x2): two int8 values become an f16x2 by one byte permute against the
//   exponent of 1024 and one subtraction (exact: integers below 2048), the
//   dequantization and the add of att_h are one HFMA2, tanh.approx.f16x2
//   gives two results a special-function op, w_alpha multiplies and adds in
//   f16x2, and every 4 pairs go into the f32 sum of the lane; the weighted
//   sum multiplies and adds pairs of columns in f16x2 and goes into f32
//   every 8 slots.  Error: f16 keeps 11 significant bits (unit roundoff
//   2^-11) against bf16's 8 (2^-8 for the inputs the call was given), and
//   att_h and the slot's scale are rounded to f16 once; each of the A terms
//   of a score carries a few units of 2^-11 relative (tanh.approx.f16x2
//   included), so a score moves by about 2^-11 |w_alpha| sqrt(A) (~1e-3 at
//   A = 512), a weight by as much relative, the output by as much of its
//   magnitude: below the bf16 rounding of the output (2^-9) and far inside
//   the call's bf16 tolerance of 3e-2, which phase 3 of chip_smoke.py and
//   the CPU emulation in tests/test_torch_att_stream.py hold it to.
//   Half the range is no concern: the products are bounded by the row's
//   largest context value, and a weight below f16's smallest normal (6e-5)
//   adds at most 127 of its own size to a sum.  f32 calls keep f32
//   arithmetic.
//   VEC is a template parameter: VEC = 16 / sizeof(element) is the path
//   above; VEC = 1 is the same kernel for widths or pointers that are not
//   16-byte aligned, its producer warp copying elements with plain loads and
//   stores (and waiting for the pre-pass first), a consumer thread owning up
//   to kMaxCols columns.  K is a runtime argument up to kMaxK.
#include <cuda_fp16.h>

#include "hopper.cuh"

#ifndef CIC_ATT_TANH
#define CIC_ATT_TANH 3  // 3: tanh.approx for bf16, the exp form for f32; 2:
                        // the exp form for both; 1: tanhf; 0: identity (probe)
#endif

// Timing probes (att_stream_bench.py --probe; wrong results): bit 0 skips
// the score arithmetic, bit 1 the weighted sum's, bit 2 the copies.
#ifndef CIC_ATT_PROBE
#define CIC_ATT_PROBE 0
#endif

// 1: bf16 calls over the int8 context in f16x2 (above); 0: in the f32
// arithmetic of the f32 calls (att_stream_bench.py --probe packed).
#ifndef CIC_ATT_PACKED
#define CIC_ATT_PACKED 1
#endif


namespace {

constexpr int kThreads = 256;  // consumer threads of a stream block
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 32;  // and one producer warp
constexpr int kMaxK = 256;  // attention slots a call may have
constexpr int kMaxStages = 8;   // longest ring of the stream
constexpr int kMaxSlots = 16;   // slots a chunk: at most two a consumer warp
constexpr int kMaxCols = 16;    // columns a thread of the VEC=1 path may own
constexpr int kMaxSmem = 232448;  // 227 KiB a block may ask for
constexpr int kBarBytes = 16 * kMaxStages;  // a full and an empty mbarrier a stage
constexpr int kStreamBlocks = 4;  // most blocks an SM of the vector path, bf16
constexpr int kStreamBlocksF32 = 3;  // and f32
constexpr int kMaxSplit = 8;  // most thread groups sharing a column group

// att_h pre-pass
constexpr int kPreThreads = 128;  // four warps (the ring pre-pass)
constexpr int kPreDepth = 512;  // of H a pre-pass block holds at once
constexpr int kPreGroups = 4;   // cp.async groups of that depth (bf16)
constexpr int kPrePad = 8;  // bf16 elements: row pitches of 16 bytes mod 128
constexpr int kPreSmem = 116736;  // the most a pre-pass block takes
constexpr int kPreManyRows = 2048;  // bf16 B from which a block is 64 x 128
constexpr int kFmaRows = 16;
constexpr int kFmaCols = 32;
constexpr int kFmaDepth = 512;
constexpr int kFmaPitch = kFmaDepth + 4;  // floats: h rows 4 banks apart

// Where slot (b, k) of a context lies, how many of a row's consecutive
// slots are one contiguous run (one bulk copy) when a chunk has nk of them,
// and the context's element type for inputs of type T (kQuant: int8 with a
// scale a (row, slot) for each of the two tensors).
struct BMajor {  // [B, K, *]
  template <typename T> using Elem = T;
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ size_t slot(int b, int k, int B, int K) {
    return (size_t)b * K + k;
  }
  static __device__ __forceinline__ int run(int nk) { return nk; }
};
struct KMajor {  // [K, B, *]
  template <typename T> using Elem = T;
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ size_t slot(int b, int k, int B, int K) {
    return (size_t)k * B + b;
  }
  static __device__ __forceinline__ int run(int nk) { return 1; }
};
struct QuantBMajor : BMajor {  // int8 [B, K, *], f32 scales [B, K]
  template <typename T> using Elem = int8_t;
  static constexpr bool kQuant = true;
};
template <typename T, typename Layout>
using ElemOf = typename Layout::template Elem<T>;

using cic::cp_async_16;
using cic::cp_async_commit;
using cic::cp_async_wait;
using cic::smem_u32;

// mbarriers in shared memory (hopper.cuh); a wait that lasts seconds traps,
// so that a fault fails the launch instead of holding the card
using cic::mbar_arrive;
using cic::mbar_expect_tx;
using cic::mbar_init;
using cic::mbar_wait_or_trap;

// One asynchronous bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Programmatic dependent launch: the primary lets its dependents start; a
// dependent waits until every prerequisite grid has completed and its
// writes are visible (a no-op in a launch without a prerequisite).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The stream's consumer warps only (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// tanh of the scores.  bf16 inputs: the hardware's tanh.approx.f32 (relative
// error 2^-11, below the 2^-9 of the inputs' own rounding); f32 inputs: 1 - 2
// / (exp(2x) + 1) on the fast exponential, |x| clamped to 15 (absolute error
// below 1e-6).
template <typename T>
__device__ __forceinline__ float att_tanh(float x) {
#if CIC_ATT_TANH == 0
  return x;
#elif CIC_ATT_TANH == 1
  return tanhf(x);
#else
  if (CIC_ATT_TANH == 3 && sizeof(T) == 2) {
    float y;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  }
  const float c = fminf(fmaxf(x, -15.0f), 15.0f);
  return 1.0f - __fdividef(2.0f, __expf(2.0f * c) + 1.0f);
#endif
}

__device__ __forceinline__ __half2 u32_as_half2(uint32_t u) {
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = u;
  return h;
}
__device__ __forceinline__ uint32_t half2_as_u32(__half2 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two int8 values as f16x2, exactly: `u` holds them XORed with 0x80 (x +
// 128) in the bytes `sel` picks (0x4140: bytes 0 and 1, 0x4342: bytes 2 and
// 3); each goes under the exponent of 1024 (the half 1024 + x + 128), and
// 1152 comes off.
__device__ __forceinline__ __half2 int8x2_to_half2(uint32_t u, uint32_t sel) {
  return __hsub2(u32_as_half2(__byte_perm(u, 0x64646464u, sel)),
                 u32_as_half2(0x64806480u));  // 1152, 1152
}

__device__ __forceinline__ __half2 tanh_half2(__half2 x) {
#if CIC_ATT_TANH == 0
  return x;
#else
  uint32_t y;
  asm("tanh.approx.f16x2 %0, %1;\n" : "=r"(y) : "r"(half2_as_u32(x)));
  return u32_as_half2(y);
#endif
}

// The 16 int8 values of one 16-byte load, as floats, without the
// conversion unit (which, like tanh, yields 16 results a clock an SM): byte
// x + 128 placed under the exponent of 2^23 is the float 2^23 + x + 128,
// exactly; one byte permute and one add a value.
__device__ __forceinline__ float int8_from(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
         8388736.0f;  // 2^23 + 128
}
__device__ __forceinline__ void unpack16(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;  // each byte x + 128
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = int8_from(u, j);
  }
}

// VEC neighbouring elements of E from 16-byte aligned shared memory (VEC = 8
// bf16, 4 f32 or 16 int8: one 16-byte load), or one element (VEC = 1), as
// floats.
template <typename E, int VEC>
__device__ __forceinline__ void load_vec(const E* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(E) == 1) f[0] = (float)p[0];
    else f[0] = cic::to_f32(p[0]);
  } else if constexpr (sizeof(E) == 1) {
    static_assert(VEC == 16, "16 int8 values a load");
    unpack16(*reinterpret_cast<const uint4*>(p), f);
  } else if constexpr (sizeof(E) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// VEC floats from 16-byte aligned shared memory, 16 bytes a load.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  }
}

// CW neighbouring columns of E from shared memory as floats: one element
// (CW = 1), or an aligned pair of int8 values (CW = 2), one load.
template <typename E, int CW>
__device__ __forceinline__ void load_cols(const E* p, float (&f)[CW]) {
  if constexpr (CW == 1) {
    if constexpr (sizeof(E) == 1) f[0] = (float)p[0];
    else f[0] = cic::to_f32(p[0]);
  } else {
    static_assert(sizeof(E) == 1 && CW == 2, "pairs of int8 values");
    const uint32_t u = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    f[0] = int8_from(u, 0);
    f[1] = int8_from(u, 1);
  }
}

// CW floats to global memory as T (2: an aligned pair, one store).
template <typename T, int CW>
__device__ __forceinline__ void store_cols(T* p, const float (&f)[CW]) {
  if constexpr (CW == 1) {
    p[0] = cic::from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
  }
}

// VEC floats to 16-byte aligned memory as T, 16 bytes a store (VEC a
// multiple of 16 bytes' worth of T).
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
#pragma unroll
    for (int i0 = 0; i0 < VEC; i0 += 8) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(f[i0 + 2 * i], f[i0 + 2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&v);
      }
      *reinterpret_cast<uint4*>(p + i0) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// att_h pre-pass: ah[B,A] (f32) = h[B,H] @ wh[H,A] + bh[A]
// ---------------------------------------------------------------------------

// bf16 on the tensor cores.  H and A are multiples of 8 and h, wh 16-byte
// aligned (the caller checks).  A block of WM x WN warps owns 16 WM rows x
// 8 NT WN columns: a warp one 16-row tile and NT 8-column tiles.  It starts
// the copies of its h rows and its slab of W for kPreDepth of H at once, as
// kPreGroups cp.async groups, and multiplies each group as it lands: one
// memory latency a block at the usual H, not one a step.  32 x 64 (2 x 2
// warps, NT = 4: the instance launch_att_h takes below kPreManyRows rows),
// so that the grid is large where B is small.
template <int WM, int WN, int NT>
__global__ void __launch_bounds__(32 * WM * WN)
att_h_mma_kernel(const __nv_bfloat16* __restrict__ h,
                 const __nv_bfloat16* __restrict__ wh,
                 const __nv_bfloat16* __restrict__ bh, float* __restrict__ ah,
                 int B, int H, int A) {
  constexpr int kThreadsB{32 * WM * WN};
  constexpr int kRowsB{16 * WM};
  constexpr int kColsB{8 * NT * WN};
  constexpr int kStep{kPreDepth / kPreGroups};
  constexpr int kPitch{kPreDepth + kPrePad};     // of an h row (k contiguous)
  constexpr int kWPitch{kColsB + kPrePad};       // of a W row (n contiguous)
  extern __shared__ __align__(16) unsigned char pre_raw[];
  __nv_bfloat16 (*hs)[kPitch] =
      reinterpret_cast<__nv_bfloat16 (*)[kPitch]>(pre_raw);
  __nv_bfloat16 (*ws)[kWPitch] = reinterpret_cast<__nv_bfloat16 (*)[kWPitch]>(
      pre_raw + sizeof(__nv_bfloat16) * kRowsB * kPitch);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * kRowsB;
  const int n0 = blockIdx.x * kColsB;

  // depth [k0, k0 + kStep) of the block's h rows and W slab, at shared
  // depth s0; zero-filled beyond B, H and A
  auto load_group = [&](int s0, int k0) {
    for (int g = tid; g < kRowsB * (kStep / 8); g += kThreadsB) {
      const int r = g / (kStep / 8);
      const int c = (g % (kStep / 8)) * 8;
      const bool ok = m0 + r < B && k0 + c < H;
      cp_async_16(&hs[r][s0 + c],
                  ok ? h + (size_t)(m0 + r) * H + k0 + c : h, ok);
    }
    for (int g = tid; g < kStep * (kColsB / 8); g += kThreadsB) {
      const int r = g / (kColsB / 8);
      const int c = (g % (kColsB / 8)) * 8;
      const bool ok = k0 + r < H && n0 + c < A;
      cp_async_16(&ws[s0 + r][c],
                  ok ? wh + (size_t)(k0 + r) * A + n0 + c : wh, ok);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int g = lane >> 2;   // fragment row
  const int t = lane & 3;    // fragment column pair
  const int wm = (warp % WM) * 16;
  const int wn = (warp / WM) * 8 * NT;

  for (int kc = 0; kc < H; kc += kPreDepth) {
#pragma unroll
    for (int grp = 0; grp < kPreGroups; ++grp) {
      load_group(grp * kStep, kc + grp * kStep);
      cp_async_commit();
    }
    // the stream reads att_h only after griddepcontrol.wait, which waits
    // for this whole grid: its blocks may start now
    if (kc == 0) launch_dependents();
#pragma unroll
    for (int grp = 0; grp < kPreGroups; ++grp) {
      if (grp == 0) cp_async_wait<kPreGroups - 1>();
      else if (grp == 1) cp_async_wait<kPreGroups - 2>();
      else if (grp == 2) cp_async_wait<kPreGroups - 3>();
      else cp_async_wait<0>();
      __syncthreads();
      if (kc + grp * kStep >= H) continue;  // zeros only
#pragma unroll 4
      for (int kk = grp * kStep; kk < (grp + 1) * kStep; kk += 16) {
        const int r = wm + g;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(&hs[r][kk + 2 * t]);
        a[1] = *reinterpret_cast<const uint32_t*>(&hs[r + 8][kk + 2 * t]);
        a[2] = *reinterpret_cast<const uint32_t*>(&hs[r][kk + 2 * t + 8]);
        a[3] = *reinterpret_cast<const uint32_t*>(&hs[r + 8][kk + 2 * t + 8]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // B fragment [16 k x 8 n] from rows of W (n contiguous), transposed
          uint32_t b[2];
          cic::ldmatrix_x2_trans(b, &ws[kk + (lane & 15)][wn + 8 * nt]);
          cic::mma_bf16_16816(acc[nt], a, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // before the next kPreDepth refills the tiles
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn + 8 * nt + 2 * t;
    if (col >= A) continue;  // A is even: col + 1 < A too
    const float b0 = cic::to_f32(bh[col]), b1 = cic::to_f32(bh[col + 1]);
    const int r0 = m0 + wm + g, r1 = r0 + 8;
    if (r0 < B)
      *reinterpret_cast<float2*>(ah + (size_t)r0 * A + col) =
          make_float2(acc[nt][0] + b0, acc[nt][1] + b1);
    if (r1 < B)
      *reinterpret_cast<float2*>(ah + (size_t)r1 * A + col) =
          make_float2(acc[nt][2] + b0, acc[nt][3] + b1);
  }
}

// bf16 from kPreManyRows rows (see the header).  H and A are multiples of 8
// and h, wh 16-byte aligned.  Four warps, WM x WN, own 16 MT WM rows x 8 NT
// WN columns: a warp MT 16-row tiles and NT 8-column tiles.  A ring stage
// holds 64 of depth of the tile's h rows (pitch + 16 bytes: the fragment
// loads hit 32 banks) and the matching rows of W's slab (as W lies, [H, A];
// pitch + 8 elements).
template <int WM, int WN, int MT, int NT, int STAGES>
__global__ void __launch_bounds__(kPreThreads)
att_h_ring_kernel(const __nv_bfloat16* __restrict__ h,
                  const __nv_bfloat16* __restrict__ wh,
                  const __nv_bfloat16* __restrict__ bh,
                  float* __restrict__ ah, int B, int H, int A) {
  using T = __nv_bfloat16;
  static_assert(WM * WN * 32 == kPreThreads, "four warps");
  constexpr int kRowsB{16 * WM * MT};
  constexpr int kColsB{8 * WN * NT};
  constexpr int kKC{64};                // depth a stage: 128 bytes a row
  constexpr int kHP{kKC + kPrePad};     // h row pitch
  constexpr int kWP{kColsB + kPrePad};  // W row pitch
  constexpr int kStage{kRowsB * kHP + kKC * kWP};
  static_assert(STAGES * sizeof(T) * kStage <= kPreSmem,
                "a pre-pass block keeps within kPreSmem");
  extern __shared__ __align__(16) unsigned char pre_raw[];
  T* smem = reinterpret_cast<T*>(pre_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * kRowsB;
  const int n0 = blockIdx.x * kColsB;
  const int g = lane >> 2;  // fragment row
  const int t = lane & 3;   // fragment column
  const int wm = (warp % WM) * 16 * MT;
  const int wn = (warp / WM) * 8 * NT;

  // depth [k0, k0 + kKC) into stage st; zero-filled beyond B, H and A
  auto load_stage = [&](int st, int k0) {
    T* hs = smem + st * kStage;
    T* ws = hs + kRowsB * kHP;
    for (int i = tid; i < kRowsB * (kKC / 8); i += kPreThreads) {
      const int r = i / (kKC / 8);
      const int c = (i % (kKC / 8)) * 8;
      const bool ok = m0 + r < B && k0 + c < H;
      cp_async_16(hs + r * kHP + c, ok ? h + (size_t)(m0 + r) * H + k0 + c : h,
                  ok);
    }
    for (int i = tid; i < kKC * (kColsB / 8); i += kPreThreads) {
      const int r = i / (kColsB / 8);
      const int c = (i % (kColsB / 8)) * 8;
      const bool ok = k0 + r < H && n0 + c < A;
      cp_async_16(ws + r * kWP + c,
                  ok ? wh + (size_t)(k0 + r) * A + n0 + c : wh, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int nk = (H + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * kKC);
    cp_async_commit();
  }
  // the stream reads att_h only after griddepcontrol.wait, which waits for
  // this whole grid: its blocks may start now
  launch_dependents();

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kc landed for all; stage kc - 1 is free
    {
      const int nx = kc + STAGES - 1;
      if (nx < nk) load_stage(nx % STAGES, nx * kKC);
      cp_async_commit();
    }
    const T* hs = smem + (kc % STAGES) * kStage;
    const T* ws = hs + kRowsB * kHP;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const T* ap = hs + (wm + 16 * mt + g) * kHP + kk + 2 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kHP);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kHP + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B fragment [16 k x 8 n] from rows of W (n contiguous), transposed
        uint32_t b[2];
        cic::ldmatrix_x2_trans(b, ws + (kk + (lane & 15)) * kWP + wn + 8 * nt);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          cic::mma_bf16_16816(acc[mt][nt], a[mt], b[0], b[1]);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn + 8 * nt + 2 * t;
    if (col >= A) continue;  // A is even: col + 1 < A too
    const float b0 = cic::to_f32(bh[col]), b1 = cic::to_f32(bh[col + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = m0 + wm + 16 * mt + g, r1 = r0 + 8;
      const float* v = acc[mt][nt];
      if (r0 < B)
        *reinterpret_cast<float2*>(ah + (size_t)r0 * A + col) =
            make_float2(v[0] + b0, v[1] + b1);
      if (r1 < B)
        *reinterpret_cast<float2*>(ah + (size_t)r1 * A + col) =
            make_float2(v[2] + b0, v[3] + b1);
    }
  }
}

// The whole depth at once (up to kPreDepth of H a pass), split over eight
// warps (see the header), f32 as split TF32.  H and A are multiples of 4 and
// h, wh 16-byte aligned.  A block owns 16 MT rows x 8 NT columns; it starts
// the copies of its h rows and its slab of W for kPreDepth of H at once
// (one memory latency a block), each warp multiplies a 64-deep slice for
// the whole tile (MT 16-row x NT 8-column fragments, independent chains),
// and the eight partial tiles are summed through shared memory in warp
// order.  h rows pitch + 16 bytes and W rows + 8 elements: the fragment
// loads hit 32 banks.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads)
att_h_splitk_kernel(const float* __restrict__ h, const float* __restrict__ wh,
                    const float* __restrict__ bh, float* __restrict__ ah,
                    int B, int H, int A) {
  constexpr int kVec{4};
  constexpr int kRowsB{16 * MT};
  constexpr int kColsB{8 * NT};
  constexpr int kHP{kPreDepth + kVec};  // h row pitch
  constexpr int kWP{kColsB + 8};        // W row pitch
  constexpr int kSlice{kPreDepth / kWarps};
  static_assert(sizeof(float) * (kRowsB * kHP + kPreDepth * kWP) <= kPreSmem,
                "a pre-pass block keeps within kPreSmem");
  static_assert(sizeof(float) * kWarps * kRowsB * kColsB <=
                    sizeof(float) * (kRowsB * kHP + kPreDepth * kWP),
                "the partial tiles fit where h and W were");
  extern __shared__ __align__(16) unsigned char pre_raw[];
  float* hs = reinterpret_cast<float*>(pre_raw);
  float* ws = hs + kRowsB * kHP;
  float* red = reinterpret_cast<float*>(pre_raw);  // after the products

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * kRowsB;
  const int n0 = blockIdx.x * kColsB;
  const int g = lane >> 2;  // fragment row
  const int t = lane & 3;   // fragment column

  float acc[MT][NT][4];    // the hi * hi sums
  float small[MT][NT][4];  // the two cross products
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = small[i][j][q] = 0.0f;

  for (int kc = 0; kc < H; kc += kPreDepth) {
    if (kc > 0) __syncthreads();  // every warp is done with the last pass
    for (int i = tid; i < kRowsB * (kPreDepth / kVec); i += kThreads) {
      const int r = i / (kPreDepth / kVec);
      const int c = (i % (kPreDepth / kVec)) * kVec;
      const bool ok = m0 + r < B && kc + c < H;
      cp_async_16(hs + r * kHP + c,
                  ok ? h + (size_t)(m0 + r) * H + kc + c : h, ok);
    }
    for (int i = tid; i < kPreDepth * (kColsB / kVec); i += kThreads) {
      const int r = i / (kColsB / kVec);
      const int c = (i % (kColsB / kVec)) * kVec;
      const bool ok = kc + r < H && n0 + c < A;
      cp_async_16(ws + r * kWP + c,
                  ok ? wh + (size_t)(kc + r) * A + n0 + c : wh, ok);
    }
    cp_async_commit();
    // the stream reads att_h only after griddepcontrol.wait, which waits
    // for this whole grid: its blocks may start now
    if (kc == 0) launch_dependents();
    cp_async_wait<0>();
    __syncthreads();
    const int k0 = warp * kSlice;
    float part[MT][NT][4];
#pragma unroll
    for (int k8 = 0; k8 < kSlice / 8; ++k8) {
      const int kk = k0 + 8 * k8;
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ap = hs + (16 * mt + g) * kHP + kk + t;
        cic::split_tf32_alu(ap[0], ahi[mt][0], alo[mt][0]);
        cic::split_tf32_alu(ap[8 * kHP], ahi[mt][1], alo[mt][1]);
        cic::split_tf32_alu(ap[4], ahi[mt][2], alo[mt][2]);
        cic::split_tf32_alu(ap[8 * kHP + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* bp = ws + (kk + t) * kWP + 8 * nt + g;
        uint32_t bhi0, blo0, bhi1, blo1;
        cic::split_tf32_alu(bp[0], bhi0, blo0);
        cic::split_tf32_alu(bp[4 * kWP], bhi1, blo1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          cic::mma_tf32_1688(small[mt][nt], alo[mt], bhi0, bhi1);
          cic::mma_tf32_1688(small[mt][nt], ahi[mt], blo0, blo1);
          if (k8 == 0)
            cic::mma_tf32_1688_zero(part[mt][nt], ahi[mt], bhi0, bhi1);
          else
            cic::mma_tf32_1688(part[mt][nt], ahi[mt], bhi0, bhi1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
  }

  __syncthreads();  // every warp is done with h and W: their room takes
                    // the partial tiles
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = 16 * mt + g, c = 8 * nt + 2 * t;
      float* p = red + (warp * kRowsB + r) * kColsB + c;
      const float* v = acc[mt][nt];
      const float* sm = small[mt][nt];
      p[0] = v[0] + sm[0];
      p[1] = v[1] + sm[1];
      p[8 * kColsB] = v[2] + sm[2];
      p[8 * kColsB + 1] = v[3] + sm[3];
    }
  __syncthreads();
  for (int o = tid; o < kRowsB * kColsB; o += kThreads) {
    const int r = o / kColsB, c = o % kColsB;
    if (m0 + r >= B || n0 + c >= A) continue;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * kRowsB * kColsB + o];
    ah[(size_t)(m0 + r) * A + n0 + c] = v + bh[n0 + c];
  }
}

// Any type and alignment, on fmaf in f32.  A block of 8 warps owns kFmaRows x
// kFmaCols: it brings its h rows and its slab of W into shared memory in one
// go (kFmaDepth of H at a time), each warp multiplies an eighth of the depth
// for the whole tile (a lane 4 rows x 4 columns), and the eight partial tiles
// are summed through shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
att_h_fma_kernel(const T* __restrict__ h, const T* __restrict__ wh,
                 const T* __restrict__ bh, float* __restrict__ ah, int B,
                 int H, int A) {
  extern __shared__ __align__(16) float pre_smem[];
  float (*hs)[kFmaPitch] = reinterpret_cast<float (*)[kFmaPitch]>(pre_smem);
  float (*ws)[kFmaCols] = reinterpret_cast<float (*)[kFmaCols]>(
      pre_smem + kFmaRows * kFmaPitch);
  float* red = pre_smem + kFmaRows * kFmaPitch + kFmaDepth * kFmaCols;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * kFmaRows;
  const int n0 = blockIdx.x * kFmaCols;
  const int r4 = (lane >> 3) * 4;   // the lane's 4 rows of the tile
  const int c4 = (lane & 7) * 4;    // and its 4 columns

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kc = 0; kc < H; kc += kFmaDepth) {
    for (int i = tid; i < kFmaRows * kFmaDepth; i += kThreads) {
      const int r = i / kFmaDepth, c = i % kFmaDepth;
      hs[r][c] = (m0 + r < B && kc + c < H)
                     ? cic::to_f32(h[(size_t)(m0 + r) * H + kc + c]) : 0.0f;
    }
    for (int i = tid; i < kFmaDepth * kFmaCols; i += kThreads) {
      const int r = i / kFmaCols, c = i % kFmaCols;
      ws[r][c] = (kc + r < H && n0 + c < A)
                     ? cic::to_f32(wh[(size_t)(kc + r) * A + n0 + c]) : 0.0f;
    }
    __syncthreads();
    const int k0 = warp * (kFmaDepth / kWarps);
#pragma unroll 2
    for (int k = k0; k < k0 + kFmaDepth / kWarps; k += 4) {
      float hv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_f32<4>(&hs[r4 + i][k], hv[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[4];
        load_f32<4>(&ws[k + kk][c4], wv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(hv[i][kk], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // the eight warps' partial tiles, summed in warp order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * kFmaRows + r4 + i) * kFmaCols + c4 + j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < kFmaRows * kFmaCols; o += kThreads) {
    const int r = o / kFmaCols, c = o % kFmaCols;
    if (m0 + r >= B || n0 + c >= A) continue;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * kFmaRows * kFmaCols + o];
    ah[(size_t)(m0 + r) * A + n0 + c] = v + cic::to_f32(bh[n0 + c]);
  }
}

// Raise the kernel's dynamic shared memory limit where the block needs more
// than the 48 KiB every kernel may use.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// allow_smem, and ask for the SM's largest shared-memory carveout, so that
// as many blocks as fit share an SM (the kernels here read through cp.async
// and shared memory; they have no use for L1).
template <typename Kernel>
cudaError_t allow_smem_shared(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  return e != cudaSuccess ? e : allow_smem(kernel, smem);
}

template <typename T>
int launch_att_h_fma(const void* h, const void* wh, const void* bh, void* ah,
                     int B, int H, int A, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (kFmaRows * kFmaPitch +
                                           kFmaDepth * kFmaCols +
                                           kWarps * kFmaRows * kFmaCols);
  cudaError_t e = allow_smem_shared(att_h_fma_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((A + kFmaCols - 1) / kFmaCols,
                  (B + kFmaRows - 1) / kFmaRows);
  att_h_fma_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wh),
      static_cast<const T*>(bh), static_cast<float*>(ah), B, H, A);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int NT>
int launch_att_h_mma(const void* h, const void* wh, const void* bh, void* ah,
                     int B, int H, int A, cudaStream_t stream) {
  constexpr int kRowsB{16 * WM};
  constexpr int kColsB{8 * NT * WN};
  constexpr size_t smem = sizeof(__nv_bfloat16) *
                          (kRowsB * (kPreDepth + kPrePad) +
                           kPreDepth * (kColsB + kPrePad));
  cudaError_t e = allow_smem_shared(att_h_mma_kernel<WM, WN, NT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((A + kColsB - 1) / kColsB, (B + kRowsB - 1) / kRowsB);
  att_h_mma_kernel<WM, WN, NT><<<grid, 32 * WM * WN, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(bh), static_cast<float*>(ah), B, H, A);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int MT, int NT, int STAGES>
int launch_att_h_ring(const void* h, const void* wh, const void* bh, void* ah,
                      int B, int H, int A, cudaStream_t stream) {
  constexpr int kRowsB{16 * WM * MT};
  constexpr int kColsB{8 * WN * NT};
  constexpr size_t smem = STAGES * sizeof(__nv_bfloat16) *
                          (kRowsB * (64 + kPrePad) + 64 * (kColsB + kPrePad));
  auto kernel = att_h_ring_kernel<WM, WN, MT, NT, STAGES>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((A + kColsB - 1) / kColsB, (B + kRowsB - 1) / kRowsB);
  kernel<<<grid, kPreThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(bh), static_cast<float*>(ah), B, H, A);
  return (int)cudaGetLastError();
}

template <int MT, int NT>
int launch_att_h_splitk(const void* h, const void* wh, const void* bh,
                        void* ah, int B, int H, int A, cudaStream_t stream) {
  constexpr int kRowsB{16 * MT};
  constexpr int kColsB{8 * NT};
  constexpr size_t smem =
      sizeof(float) * (kRowsB * (kPreDepth + 4) + kPreDepth * (kColsB + 8));
  auto kernel = att_h_splitk_kernel<MT, NT>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((A + kColsB - 1) / kColsB, (B + kRowsB - 1) / kRowsB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(wh),
      static_cast<const float*>(bh), static_cast<float*>(ah), B, H, A);
  return (int)cudaGetLastError();
}

// vec != 0: H and A are multiples of 16 / sizeof(T) and h, wh 16-byte
// aligned.  f32: 16 x 32 tiles of att_h_splitk_kernel (128 blocks at B =
// 128, A = 512).  bf16: 32 x 64 tiles of att_h_mma_kernel below
// kPreManyRows rows; from there 64 x 128 tiles of att_h_ring_kernel (W read
// B / 64 times from L2, not B / 32).  Every block keeps within kPreSmem.
template <typename T>
int launch_att_h(const void* h, const void* wh, const void* bh, void* ah,
                 int B, int H, int A, int vec, cudaStream_t stream) {
  if (!vec) return launch_att_h_fma<T>(h, wh, bh, ah, B, H, A, stream);
  if constexpr (sizeof(T) == 4) {
    return launch_att_h_splitk<1, 4>(h, wh, bh, ah, B, H, A, stream);
  } else {
    return B >= kPreManyRows
               ? launch_att_h_ring<2, 2, 2, 8, 4>(h, wh, bh, ah, B, H, A,
                                                  stream)
               : launch_att_h_mma<2, 2, 4>(h, wh, bh, ah, B, H, A, stream);
  }
}

// ---------------------------------------------------------------------------
// the stream
// ---------------------------------------------------------------------------

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Thread groups of the weighted sum of A and E that share a column group
// (16 bytes of neighbouring columns): the consumer threads over the H / vec
// column groups, at most kMaxSplit.
__host__ __device__ inline int col_split(int H, int vec) {
  const int groups = H / vec;
  if (groups >= kThreads) return 1;
  const int split = kThreads / groups;
  return split < kMaxSplit ? split : kMaxSplit;
}

// Bytes of a ring stage (`slots` slots of the wider of A and H, a multiple
// of 16) and of the block's shared memory: the stages' full and empty
// mbarriers (kBarBytes), the ring, then as floats the row slots [stages][A
// att_h, K mask; int8: K emb_scale, K p_scale], w_alpha [A], the scores of two
// rows [2][K], each consumer warp's weights of a chunk [kWarps,
// kMaxSlots], and for A and E at vector width (`groups`) the partial sums
// of the thread groups beyond the first [split - 1, H].
inline size_t stage_bytes(int slots, int H, int A, size_t item) {
  const size_t b = (size_t)slots * (H > A ? H : A) * item;
  return (b + 15) & ~(size_t)15;
}
inline size_t stream_smem(int slots, int stages, int K, int H, int A,
                          size_t item, int groups_vec) {
  const int side = item == 1 ? 3 : 1;  // mask, and int8's two scale rows
  return kBarBytes + stages * stage_bytes(slots, H, A, item) +
         sizeof(float) *
             ((size_t)stages * (round4(A) + side * round4(K)) + round4(A) +
              2 * (size_t)round4(K) + kWarps * kMaxSlots +
              (groups_vec ? (size_t)(col_split(H, groups_vec) - 1) * H : 0));
}

// The vector paths hold 56 registers a thread for bf16 (kStreamBlocks blocks
// of 288 threads an SM), 72 for f32 (kStreamBlocksF32): a block of the
// stream leaves a pre-pass block's registers free beside it.
template <typename T, int VEC, int MAXC, typename Layout>
__global__ void __launch_bounds__(
    kBlockThreads,
    VEC > 1 ? (sizeof(T) == 2 ? kStreamBlocks : kStreamBlocksF32) : 1)
attention_kernel(const float* __restrict__ ah,
                 const ElemOf<T, Layout>* __restrict__ emb,
                 const ElemOf<T, Layout>* __restrict__ patt,
                 const float* __restrict__ emb_scale,
                 const float* __restrict__ p_scale, const T* __restrict__ wa,
                 const float* __restrict__ mask, T* __restrict__ out, int B,
                 int K, int H, int A, int slots, int stages,
                 unsigned stage_size) {
  using E = ElemOf<T, Layout>;
  constexpr bool kPacked =
      Layout::kQuant && sizeof(T) == 2 && VEC > 1 && CIC_ATT_PACKED;
  // the weighted sum: A and E at vector width by column groups (VEC
  // columns, shared by `split` thread groups, reduced at the row's end);
  // the int8 context by pairs of columns (units of CW columns: tid, tid +
  // kThreads, ...; H <= 1024); width 1 by single columns (H <= kMaxCols x
  // kThreads)
  constexpr bool kGroups = VEC > 1 && !Layout::kQuant;
  constexpr int CW{VEC > 1 ? (kGroups ? VEC : 2) : 1};  // columns a unit
  constexpr int NU{VEC > 1 ? (kGroups ? 1 : 2) : MAXC};  // units a thread
  extern __shared__ __align__(16) unsigned char smem_all[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_all);  // [kMaxStages]
  uint64_t* empty = full + kMaxStages;                     // [kMaxStages]
  unsigned char* ring = smem_all + kBarBytes;
  const int A4 = round4(A);
  const int K4 = round4(K);
  const int RW = A4 + (Layout::kQuant ? 3 : 1) * K4;  // floats of a row slot
  float* rows_ring = reinterpret_cast<float*>(ring + (size_t)stages * stage_size);
  float* was = rows_ring + (size_t)stages * RW;  // [A] w_alpha
  float* sc = was + A4;                          // [2][K] scores
  float* wts = sc + 2 * K4;                      // [kWarps][kMaxSlots]
  float* red = wts + kWarps * kMaxSlots;         // [split - 1, H]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const int nrows = (B - 1 - (int)blockIdx.x) / G + 1;  // grid <= B
  const int cpt = (K + slots - 1) / slots;   // chunks of a tensor of a row
  const int cpr = 2 * cpt;                   // chunks of a row: p_att, att_emb
  const int total = nrows * cpr;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 32);      // the producer warp's lanes
      mbar_init(empty + i, kWarps);  // one arrival a consumer warp
    }
    cic::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- the producer warp ------------------------------------------------
    // Fill chunk c into stage c % stages; with a row's first chunk, the
    // row's mask and scale values (this warp's stores) and, `with_ah`, its
    // att_h, into the row's slot of the row ring.  Every lane arrives on
    // the stage's full barrier once its stores are done (lane 0's arrival
    // also announces the bulk copies' bytes).
    auto fill = [&](int c, bool with_ah) {
      const int r = c / cpr;
      const int q = c - r * cpr;
      const bool is_p = q < cpt;
      const int k0 = (is_p ? q : q - cpt) * slots;
      const int nk = min(slots, K - k0);
      const int W = is_p ? A : H;
      const E* src = is_p ? patt : emb;
      const int s = c % stages;
      E* dst = reinterpret_cast<E*>(ring + (size_t)s * stage_size);
      const int b = blockIdx.x + r * G;
      float* rw = rows_ring + (size_t)(r % stages) * RW;
      if (q == 0) {
        const size_t o = (size_t)b * K;
        for (int k = lane; k < K; k += 32) {
          if (mask != nullptr) rw[A4 + k] = mask[o + k];
          if constexpr (Layout::kQuant) {
            rw[A4 + K4 + k] = emb_scale[o + k];
            rw[A4 + 2 * K4 + k] = p_scale[o + k];
          }
        }
      }
      if (CIC_ATT_PROBE & 4) {
        mbar_arrive(full + s);
        return;
      }
      if constexpr (VEC == 1) {
        for (int g = lane; g < nk * W; g += 32) {
          const int j = g / W;
          dst[g] = src[Layout::slot(b, k0 + j, B, K) * W + (g - j * W)];
        }
        if (q == 0)
          for (int a = lane; a < A; a += 32) rw[a] = ah[(size_t)b * A + a];
        mbar_arrive(full + s);
      } else if (lane == 0) {
        const uint32_t slot_bytes = (uint32_t)(W * sizeof(E));
        mbar_expect_tx(full + s,
                       nk * slot_bytes +
                           (q == 0 ? (uint32_t)(A * sizeof(float)) : 0u));
        const int run = Layout::run(nk);
        for (int j = 0; j < nk; j += run)
          bulk_copy(dst + (size_t)j * W,
                    src + Layout::slot(b, k0 + j, B, K) * W, run * slot_bytes,
                    full + s);
        if (q == 0 && with_ah)
          bulk_copy(rw, ah + (size_t)b * A, (uint32_t)(A * sizeof(float)),
                    full + s);
      } else {
        mbar_arrive(full + s);
      }
    };
    // The first `stages` chunks need no release; their context does not
    // depend on the pre-pass.  Their rows' att_h (announced with them) is
    // copied once the pre-pass has completed.  The element-wise path waits
    // first.
    const int first = min(stages, total);
    if constexpr (VEC == 1) wait_prerequisites();
    for (int c = 0; c < first; ++c) fill(c, false);
    if constexpr (VEC > 1) {
      wait_prerequisites();
      if (lane == 0 && !(CIC_ATT_PROBE & 4))
        for (int r = 0; r * cpr < first; ++r)
          bulk_copy(rows_ring + (size_t)(r % stages) * RW,
                    ah + (size_t)(blockIdx.x + r * G) * A,
                    (uint32_t)(A * sizeof(float)), full + (r * cpr) % stages);
    }
    for (int c = first; c < total; ++c) {
      // every consumer warp is done with chunk c - stages
      mbar_wait_or_trap(empty + c % stages, (uint32_t)(c / stages - 1) & 1u);
      fill(c, true);
    }
    return;
  }

  // ---- the consumer warps ---------------------------------------------------
  // b_alpha moves every score of a row alike, which the softmax does not
  // see: the scores here are without it
  for (int a = tid; a < A; a += kThreads) was[a] = cic::to_f32(wa[a]);
  consumers_sync();

  // f16x2 of 16 floats (the packed path's att_h and w_alpha of a lane)
  auto to_half2 = [](const float* p, __half2 (&r)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
      r[2 * i] = __floats2half2_rn(v.x, v.y);
      r[2 * i + 1] = __floats2half2_rn(v.z, v.w);
    }
  };
  // A slot's score from the lane's 16 int8 values of it (v), f16x2 att_h
  // and w_alpha, and the slot's p_scale: in f16x2, into f32 every 4 pairs.
  auto packed_score = [](const uint4& v, const __half2 (&x2)[8],
                         const __half2 (&w2)[8], __half2 ps2) {
    const uint32_t wd[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                            v.z ^ 0x80808080u, v.w ^ 0x80808080u};
    float s = 0.0f;
    __half2 part = u32_as_half2(0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 lo = int8x2_to_half2(wd[i], 0x4140u);
      const __half2 hi = int8x2_to_half2(wd[i], 0x4342u);
      part = __hfma2(tanh_half2(__hfma2(lo, ps2, x2[2 * i])), w2[2 * i], part);
      part = __hfma2(tanh_half2(__hfma2(hi, ps2, x2[2 * i + 1])),
                     w2[2 * i + 1], part);
      if (i & 1) {  // every 4 pairs into f32
        const float2 f = __half22float2(part);
        s += f.x + f.y;
        part = u32_as_half2(0u);
      }
    }
    return s;
  };

  const int cgt = kGroups ? min(H / VEC, kThreads) : kThreads;
  const int split = kGroups ? col_split(H, VEC) : 1;
  const int sg = tid / cgt;  // the thread's group of slots (A, E)
  const int cg = tid - sg * cgt;
  float acc[NU][CW];
  float mx = 0.0f, inv = 0.0f;  // the row's softmax, in every warp
  float* wrow = wts + warp * kMaxSlots;  // the chunk's weights (packed: f16x2)
  int cs = 0;            // the stage consumed next
  uint32_t cphase = 0;   // and the parity of its fill
  for (int c = 0; c < total; ++c) {
    const int r = c / cpr;
    const int q = c - r * cpr;
    const bool is_p = q < cpt;
    const int k0 = (is_p ? q : q - cpt) * slots;
    const int nk = min(slots, K - k0);
    const float* rw = rows_ring + (size_t)(r % stages) * RW;
    float* scr = sc + (r & 1) * K4;

    if (q == cpt) {
      // the row's first att_emb chunk: every warp's scores of the row are
      // in scr (a warp past this point has used row r - 1's weights for the
      // last time, so the other score buffer is free for row r + 1)
      consumers_sync();
      const float* mrow = mask != nullptr ? rw + A4 : nullptr;
      float m = -CUDART_INF_F;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, scr[k]);
      m = cic::warp_max(m);
      float tot = 0.0f;
      for (int k = lane; k < K; k += 32) {
        const float e = expf(scr[k] - m);
        tot += mrow != nullptr ? e * mrow[k] : e;
      }
      mx = m;
      inv = 1.0f / cic::warp_sum(tot);  // an all-zero mask row: NaN weights
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int v = 0; v < CW; ++v) acc[i][v] = 0.0f;
    }

    mbar_wait_or_trap(full + cs, cphase);
    const E* st = reinterpret_cast<const E*>(ring + (size_t)cs * stage_size);

    if (is_p && !(CIC_ATT_PROBE & 1)) {
      // scores: one warp a slot
      const float* ahr = rw;  // the row's att_h
      if constexpr (kPacked) {
        // a lane's 16 columns of the warp's (up to) two slots of the chunk,
        // att_h and w_alpha for them as f16x2 once for both
        float s[2] = {0.0f, 0.0f};
        for (int a = lane * 16; a < A; a += 32 * 16) {
          __half2 x2[8], w2[8];
          to_half2(ahr + a, x2);
          to_half2(was + a, w2);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = warp + kWarps * u;
            if (j < nk)
              s[u] += packed_score(
                  *reinterpret_cast<const uint4*>(st + (size_t)j * A + a), x2,
                  w2, __float2half2_rn(rw[A4 + 2 * K4 + k0 + j]));
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = warp + kWarps * u;
          if (j < nk) {  // the same for the whole warp
            const float sum = cic::warp_sum(s[u]);
            if (lane == 0) scr[k0 + j] = sum;
          }
        }
      } else {
        for (int j = warp; j < nk; j += kWarps) {
          const E* prow = st + (size_t)j * A;
          const float ps = Layout::kQuant ? rw[A4 + 2 * K4 + k0 + j] : 1.0f;
          float s0 = 0.0f, s1 = 0.0f;  // even and odd elements
          for (int a = lane * VEC; a < A; a += 32 * VEC) {
            float p[VEC];
            load_vec<E, VEC>(prow + a, p);
            // att_h and w_alpha 16 bytes at a time, for fewer live
            // registers (bf16 holds 56 a thread)
            constexpr int C{VEC >= 8 ? 4 : VEC};
#pragma unroll
            for (int v0 = 0; v0 < VEC; v0 += C) {
              float x[C], w[C];
              load_f32<C>(ahr + a + v0, x);
              load_f32<C>(was + a + v0, w);
#pragma unroll
              for (int v = 0; v < C; ++v) {
                const float pv = Layout::kQuant ? p[v0 + v] * ps : p[v0 + v];
                if (v & 1) s1 = fmaf(att_tanh<T>(pv + x[v]), w[v], s1);
                else s0 = fmaf(att_tanh<T>(pv + x[v]), w[v], s0);
              }
            }
          }
          const float s = cic::warp_sum(s0 + s1);
          if (lane == 0) scr[k0 + j] = s;
        }
      }
    } else if (!is_p) {
      // the chunk's weights, one a lane, into the warp's row of wts
      __syncwarp();  // the warp's reads of its previous weights are done
      if (lane < nk) {
        const int k = k0 + lane;
        float wl = expf(scr[k] - mx) * inv;
        if (mask != nullptr) wl *= rw[A4 + k];
        if constexpr (Layout::kQuant) wl *= rw[A4 + K4 + k];
        if constexpr (kPacked)
          reinterpret_cast<uint32_t*>(wrow)[lane] =
              half2_as_u32(__float2half2_rn(wl));
        else
          wrow[lane] = wl;
      }
      __syncwarp();
      // out += sum over the chunk's slots of w_k * att_emb[b, k]
      if (CIC_ATT_PROBE & 2) {
      } else if constexpr (kGroups) {
        // slots sg, sg + split, ... of column group cg
        if (sg < split)
          for (int j = sg; j < nk; j += split) {
            const float w = wrow[j];
            float e[VEC];
            load_vec<E, VEC>(st + (size_t)j * H + cg * VEC, e);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[0][v] = fmaf(w, e[v], acc[0][v]);
          }
      } else {
        // CW neighbouring columns a unit, units tid, tid + kThreads, ...;
        // the weights four slots a load
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const int col = CW * (tid + kThreads * i);
          if (col >= H) break;
          const E* ecol = st + col;
          if constexpr (kPacked) {
            // pairs in f16x2, into f32 every 8 slots
            for (int j0 = 0; j0 < nk; j0 += 8) {
              __half2 part = u32_as_half2(0u);
#pragma unroll
              for (int j4 = 0; j4 < 8; j4 += 4) {
                const uint4 w4 = *reinterpret_cast<const uint4*>(
                    reinterpret_cast<const uint32_t*>(wrow) + j0 + j4);
                const uint32_t wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const int j = j0 + j4 + u;
                  if (j < nk) {
                    const uint32_t e =
                        *reinterpret_cast<const uint16_t*>(
                            ecol + (size_t)j * H) ^ 0x8080u;
                    part = __hfma2(u32_as_half2(wv[u]),
                                   int8x2_to_half2(e, 0x4140u), part);
                  }
                }
              }
              const float2 f = __half22float2(part);
              acc[i][0] += f.x;
              acc[i][1] += f.y;
            }
          } else {
            for (int j0 = 0; j0 < nk; j0 += 4) {
              const float4 w4 = *reinterpret_cast<const float4*>(wrow + j0);
              const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (j0 + u < nk) {
                  float e[CW];
                  load_cols<E, CW>(ecol + (size_t)(j0 + u) * H, e);
#pragma unroll
                  for (int v = 0; v < CW; ++v)
                    acc[i][v] = fmaf(wv[u], e[v], acc[i][v]);
                }
              }
            }
          }
        }
      }
    }
    // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + cs);
    if (++cs == stages) {
      cs = 0;
      cphase ^= 1u;
    }

    if (q == cpr - 1) {  // the row's last chunk: store the thread's columns
      T* orow = out + (size_t)(blockIdx.x + r * G) * H;
      if constexpr (kGroups) {
        // the groups' partial sums into group 0's (the other groups' row of
        // `red` is rewritten only at the next row's end, after every
        // thread's next consumer barrier)
        if (split > 1) {
          if (sg > 0 && sg < split)
            store_vec<float, VEC>(red + (size_t)(sg - 1) * H + cg * VEC,
                                  acc[0]);
          consumers_sync();
          if (sg == 0)
            for (int g2 = 1; g2 < split; ++g2) {
              float p[VEC];
              load_f32<VEC>(red + (size_t)(g2 - 1) * H + cg * VEC, p);
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[0][v] += p[v];
            }
        }
        if (sg == 0) store_vec<T, VEC>(orow + cg * VEC, acc[0]);
      } else {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const int col = CW * (tid + kThreads * i);
          if (col >= H) break;
          store_cols<T, CW>(orow + col, acc[i]);
        }
      }
    }
  }
}

template <typename T, int VEC, int MAXC, typename Layout>
int launch_stream(const void* ah, const void* emb, const void* patt,
                  const void* emb_scale, const void* p_scale, const void* wa,
                  const void* mask, void* out, int B, int K, int H, int A,
                  int grid, int slots, int stages, int dependent,
                  cudaStream_t stream) {
  using E = ElemOf<T, Layout>;
  const size_t smem = stream_smem(slots, stages, K, H, A, sizeof(E),
                                  VEC > 1 && !Layout::kQuant ? VEC : 0);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = attention_kernel<T, VEC, MAXC, Layout>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = dependent ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(ah), static_cast<const E*>(emb),
      static_cast<const E*>(patt), static_cast<const float*>(emb_scale),
      static_cast<const float*>(p_scale), static_cast<const T*>(wa),
      static_cast<const float*>(mask),
      static_cast<T*>(out), B, K, H, A, slots, stages,
      (unsigned)stage_bytes(slots, H, A, sizeof(E)));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Blocks of the stream kernel that fit one SM under a plan (or minus the
// CUDA error code).
template <typename T, int VEC, int MAXC, typename Layout>
int stream_blocks_per_sm(int slots, int stages, int K, int H, int A) {
  const size_t smem =
      stream_smem(slots, stages, K, H, A, sizeof(ElemOf<T, Layout>),
                  VEC > 1 && !Layout::kQuant ? VEC : 0);
  auto kernel = attention_kernel<T, VEC, MAXC, Layout>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kBlockThreads, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename T, typename Layout>
int blocks_per_sm(int vec, int slots, int stages, int K, int H, int A) {
  constexpr int kVec{16 / (int)sizeof(ElemOf<T, Layout>)};
  return vec ? stream_blocks_per_sm<T, kVec, 1, Layout>(slots, stages, K, H,
                                                        A)
             : stream_blocks_per_sm<T, 1, kMaxCols, Layout>(slots, stages, K,
                                                            H, A);
}

template <typename T>
int blocks_per_sm_of(int layout, int vec, int slots, int stages, int K,
                     int H, int A) {
  switch (layout) {
    case 0: return blocks_per_sm<T, BMajor>(vec, slots, stages, K, H, A);
    case 1: return blocks_per_sm<T, KMajor>(vec, slots, stages, K, H, A);
    case 2: return blocks_per_sm<T, QuantBMajor>(vec, slots, stages, K, H, A);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The pre-pass, then the stream (its programmatic dependent where
// `dependent`).  `vec` != 0 asks for the 16-byte path: the caller has
// checked that H and A are multiples of 16 bytes' worth of the context's
// elements, that H has at most kThreads such column groups and that the
// tensors are 16-byte aligned (so the pre-pass may take its tensor-core
// path too).
template <typename T, typename Layout>
int launch(const void* h, const void* emb, const void* patt,
           const void* emb_scale, const void* p_scale, const void* wh,
           const void* bh, const void* wa, const void* ba, const void* mask,
           void* ah, void* out, int B, int K, int H, int A, int vec, int grid,
           int slots, int stages, int dependent, cudaStream_t stream) {
  constexpr int kVec{16 / (int)sizeof(ElemOf<T, Layout>)};
  if (K < 1 || K > kMaxK || B < 1 || grid < 1 || grid > B || slots < 1 ||
      slots > kMaxSlots || stages < 2 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (vec ? (H % kVec != 0 || A % kVec != 0 || H / kVec > kThreads ||
             (Layout::kQuant && H > 4 * kThreads))
          : H > kMaxCols * kThreads)
    return (int)cudaErrorInvalidValue;
  if (Layout::kQuant && (emb_scale == nullptr || p_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int code = launch_att_h<T>(h, wh, bh, ah, B, H, A, vec, stream);
  if (code != 0) return code;
  // b_alpha (`ba`) moves every score of a row alike, which the softmax
  // does not see: the stream leaves it out
  if (vec)
    return launch_stream<T, kVec, 1, Layout>(ah, emb, patt, emb_scale,
                                             p_scale, wa, mask, out, B, K, H,
                                             A, grid, slots, stages,
                                             dependent, stream);
  return launch_stream<T, 1, kMaxCols, Layout>(ah, emb, patt, emb_scale,
                                               p_scale, wa, mask, out, B, K,
                                               H, A, grid, slots, stages,
                                               dependent, stream);
}

}  // namespace

// att_h [B, A] (f32) = h @ wh + bh alone: the pre-pass of the calls below.
CIC_EXPORT int cic_att_h(const void* h, const void* wh, const void* bh,
                         void* att_h, int B, int H, int A, int is_bf16,
                         int vec, void* stream) {
  if (B < 1 || H < 1 || A < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_att_h<__nv_bfloat16>(h, wh, bh, att_h, B, H, A, vec, s);
  return launch_att_h<float>(h, wh, bh, att_h, B, H, A, vec, s);
}

// Not a launch: the blocks of the stream kernel that one SM holds at once
// under a plan (a negative number is minus a CUDA error code).  layout: 0
// b-major, 1 K-major, 2 int8.
CIC_EXPORT int cic_attention_blocks_per_sm(int is_bf16, int layout, int vec,
                                           int slots, int stages, int K,
                                           int H, int A) {
  if (is_bf16)
    return blocks_per_sm_of<__nv_bfloat16>(layout, vec, slots, stages, K, H,
                                           A);
  return blocks_per_sm_of<float>(layout, vec, slots, stages, K, H, A);
}

// att_h: f32 scratch [B, A] of the caller's; vec, grid, slots, stages,
// dependent: the wrapper's stream_plan.
CIC_EXPORT int cic_attention(const void* h, const void* emb, const void* patt,
                             const void* wh, const void* bh, const void* wa,
                             const void* ba, const void* mask, void* att_h,
                             void* out, int B, int K, int H, int A,
                             int is_bf16, int vec, int grid, int slots,
                             int stages, int dependent, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, BMajor>(h, emb, patt, nullptr, nullptr, wh,
                                         bh, wa, ba, mask, att_h, out, B, K,
                                         H, A, vec, grid, slots, stages,
                                         dependent, s);
  return launch<float, BMajor>(h, emb, patt, nullptr, nullptr, wh, bh, wa, ba,
                               mask, att_h, out, B, K, H, A, vec, grid, slots,
                               stages, dependent, s);
}

// emb and patt K-major: [K, B, H] and [K, B, A]; mask [B, K].
CIC_EXPORT int cic_attention_kmajor(const void* h, const void* emb,
                                    const void* patt, const void* wh,
                                    const void* bh, const void* wa,
                                    const void* ba, const void* mask,
                                    void* att_h, void* out, int B, int K,
                                    int H, int A, int is_bf16, int vec,
                                    int grid, int slots, int stages,
                                    int dependent, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, KMajor>(h, emb, patt, nullptr, nullptr, wh,
                                         bh, wa, ba, mask, att_h, out, B, K,
                                         H, A, vec, grid, slots, stages,
                                         dependent, s);
  return launch<float, KMajor>(h, emb, patt, nullptr, nullptr, wh, bh, wa, ba,
                               mask, att_h, out, B, K, H, A, vec, grid, slots,
                               stages, dependent, s);
}

// emb_q, p_q int8 [B, K, H] and [B, K, A]; emb_scale, p_scale f32 [B, K];
// the rest as cic_attention.
CIC_EXPORT int cic_attention_q(const void* h, const void* emb_q,
                               const void* emb_scale, const void* p_q,
                               const void* p_scale, const void* wh,
                               const void* bh, const void* wa, const void* ba,
                               const void* mask, void* att_h, void* out,
                               int B, int K, int H, int A, int is_bf16,
                               int vec, int grid, int slots, int stages,
                               int dependent, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, QuantBMajor>(
        h, emb_q, p_q, emb_scale, p_scale, wh, bh, wa, ba, mask, att_h, out,
        B, K, H, A, vec, grid, slots, stages, dependent, s);
  return launch<float, QuantBMajor>(h, emb_q, p_q, emb_scale, p_scale, wh, bh,
                                    wa, ba, mask, att_h, out, B, K, H, A, vec,
                                    grid, slots, stages, dependent, s);
}
