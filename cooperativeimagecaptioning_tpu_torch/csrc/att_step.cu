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
// rate with tens of KiB in flight on every SM, so the design is about loads
// in flight, not arithmetic.
//
// Design: two launches a call, the same for the three layouts.
//   1. att_h pre-pass.  att_h = h @ W_h2att + b_h2att as f32 [B,A] into a
//      scratch tensor of the wrapper's (1 MiB at B=512: it stays in L2).
//      bf16: tensor cores through mma.sync.m16n8k16 (f32 accumulators).  A
//      block owns 32 rows x 64 columns, or 64 x 128 from B = 2048 (W_h2att
//      is read B/32 or B/64 times from L2, not B/8 times); it starts the
//      16-byte cp.async copies of its whole depth of h and W at once, in
//      four groups, and multiplies each group as it lands (one memory
//      latency a block); W fragments by ldmatrix.trans (W is [H,A] with A
//      contiguous).  f32, and any call whose widths or pointers are not
//      16-byte aligned: fmaf in true f32 (no TF32); a block owns 16 rows x
//      32 columns so that B=128 already gives 128 blocks, loads its rows and
//      its slab of W at once, and its 8 warps each multiply an eighth of
//      the depth, 4 rows x 4 columns a lane, summed through shared memory.
//   2. The stream.  A block owns `rows` batch rows (a launch parameter from
//      the wrapper's stream_plan: 1 up to B of about a thousand, so that the
//      grid fills the card) and walks them in order.  A row's context is cut
//      into chunks of `slots` attention slots: first its p_att chunks, then
//      its att_emb chunks.  All chunks of all the block's rows form one
//      sequence that flows through a ring of `stages` shared-memory stages,
//      filled by cp.async.bulk: one thread starts one copy a contiguous run
//      and the stage's mbarrier counts the bytes, so no thread spends
//      instructions on addresses (with per-thread 16-byte copies the kernel
//      was bound by the instructions it had to dispatch, the copies' share
//      as large as the arithmetic's).  The ring is
//      kept stages-1 chunks ahead of the consumer: the att_emb copies are in
//      flight while the scores are computed, and the next row's p_att copies
//      during the weighted sum, so the stream never stops at the softmax.
//      The row's att_h travels with its first chunk into a small ring of
//      its own.  A row's mask values (and, int8, its two scale rows) come
//      through 4-byte cp.async copies of warp 0 into a two-row ring, started
//      a row ahead.  Consumers read shared memory 16 bytes at a time: scores
//      by one warp a slot, softmax / mask / renormalize in warp 0 (K in
//      strides of 32 lanes, the scores in shared memory), the weighted sum
//      with 16 bytes of neighbouring columns a thread (8 bf16, 4 f32 or 16
//      int8 values) and the chunk's slots split over the thread groups that
//      share those columns, reduced through shared memory at the row's end,
//      16-byte stores.  The [B,K,A] tanh intermediate never leaves the SM.
//      Layout (BMajor / KMajor / QuantBMajor) decides where slot (b, k) lies
//      and, for the int8 context, the element type and the scales.
//   The scores are bound by the special-function unit (16 results a clock
//   an SM): f32 inputs take tanh as 1 - 2 / (exp(2x) + 1) on the fast
//   exponential, |x| clamped to 15 (two special-function results an element,
//   absolute error below 1e-6, inside the call's f32 tolerance of 1e-4);
//   bf16 inputs take tanh.approx.f32 (one result an element; relative error
//   2^-11, below the inputs' own rounding).
//   VEC is a template parameter: VEC = 16 / sizeof(element) is the path
//   above; VEC = 1 is the same kernel for widths or pointers that are not
//   16-byte aligned, filling its stages with plain loads and stores and
//   owning up to kMaxCols columns a thread.  K is a runtime argument up to
//   kMaxK; the scores and the side rows take 7 floats a slot of shared
//   memory.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;  // attention slots a call may have
constexpr int kMaxStages = 8;   // longest ring of the stream
constexpr int kMaxSplit = 8;    // most thread groups sharing a column group
constexpr int kMaxCols = 16;    // columns a thread of the VEC=1 path may own
constexpr int kMaxSmem = 232448;  // 227 KiB a block may ask for
constexpr int kBarBytes = 8 * kMaxStages;  // one mbarrier a ring stage

// att_h pre-pass tiles
constexpr int kPreDepth = 512;  // of H in shared memory at once
constexpr int kPreGroups = 4;   // cp.async groups of that depth
constexpr int kPreManyRows = 2048;  // B from which a block is 64 x 128
constexpr int kPrePad = 8;  // bf16 elements: row pitches of 16 bytes mod 128
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
using cic::cp_async_4;
using cic::cp_async_commit;
using cic::cp_async_wait;
using cic::smem_u32;

// mbarriers in shared memory: one arrival a phase (the thread that
// announces the bytes of the phase's bulk copies), completed by the copies
// themselves.
using cic::mbar_expect_tx;
using cic::mbar_init;
using cic::mbar_wait;

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

// The 16 int8 values of one 16-byte load, as floats, without the
// conversion unit (which, like tanh, yields 16 results a clock an SM): byte
// x + 128 placed under the exponent of 2^23 is the float 2^23 + x + 128,
// exactly; one byte permute and one add a value.
__device__ __forceinline__ void unpack16(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;  // each byte x + 128
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
          8388736.0f;  // 2^23 + 128
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

// VEC floats to 16-byte aligned global memory as T, 16 bytes a store (VEC
// a multiple of 16 bytes' worth of T), or one element (VEC = 1).
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = cic::from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
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
// warps, NT = 4) where B is small, so that the grid is large; 64 x 128 (4 x 2
// warps, NT = 8) for many rows, so that W and h are read less often from L2.
template <int WM, int WN, int NT>
__global__ void __launch_bounds__(32 * WM * WN)
att_h_mma_kernel(const __nv_bfloat16* __restrict__ h,
                 const __nv_bfloat16* __restrict__ wh,
                 const __nv_bfloat16* __restrict__ bh, float* __restrict__ ah,
                 int B, int H, int A) {
  constexpr int kThreadsB{32 * WM * WN};
  constexpr int kRowsB{16 * WM};
  constexpr int kColsB{8 * NT * WN};
  constexpr int kStep = kPreDepth / kPreGroups;
  constexpr int kPitch = kPreDepth + kPrePad;    // of an h row (k contiguous)
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

// Any type and alignment, on fmaf in f32.  A block of 8 warps owns kFmaRows x
// kFmaCols: it brings its h rows and its slab of W into shared memory in one
// go (all loads in flight at once; kFmaDepth of H at a time), each warp
// multiplies an eighth of the depth for the whole tile (a lane 4 rows x 4
// columns, h and W read 16 bytes a load), and the eight partial tiles are
// summed through shared memory.  ASYNC (f32 with H and A multiples of 4 and
// 16-byte aligned tensors): the fill is 16-byte cp.async; else plain loads.
template <typename T, bool ASYNC>
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
    if constexpr (ASYNC) {
      for (int g = tid; g < kFmaRows * (kFmaDepth / 4); g += kThreads) {
        const int r = g / (kFmaDepth / 4), c = (g % (kFmaDepth / 4)) * 4;
        const bool ok = m0 + r < B && kc + c < H;
        cp_async_16(&hs[r][c], ok ? h + (size_t)(m0 + r) * H + kc + c : h, ok);
      }
      for (int g = tid; g < kFmaDepth * (kFmaCols / 4); g += kThreads) {
        const int r = g / (kFmaCols / 4), c = (g % (kFmaCols / 4)) * 4;
        const bool ok = kc + r < H && n0 + c < A;
        cp_async_16(&ws[r][c], ok ? wh + (size_t)(kc + r) * A + n0 + c : wh,
                    ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
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

template <typename T, bool ASYNC>
int launch_att_h_fma(const void* h, const void* wh, const void* bh, void* ah,
                     int B, int H, int A, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (kFmaRows * kFmaPitch +
                                           kFmaDepth * kFmaCols +
                                           kWarps * kFmaRows * kFmaCols);
  cudaError_t e = allow_smem_shared(att_h_fma_kernel<T, ASYNC>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((A + kFmaCols - 1) / kFmaCols,
                  (B + kFmaRows - 1) / kFmaRows);
  att_h_fma_kernel<T, ASYNC><<<grid, kThreads, smem, stream>>>(
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

// vec != 0: H and A are multiples of 16 / sizeof(T) and h, wh 16-byte aligned.
template <typename T>
int launch_att_h(const void* h, const void* wh, const void* bh, void* ah,
                 int B, int H, int A, int vec, cudaStream_t stream) {
  if (!vec) return launch_att_h_fma<T, false>(h, wh, bh, ah, B, H, A, stream);
  if constexpr (sizeof(T) == 4) {
    return launch_att_h_fma<T, true>(h, wh, bh, ah, B, H, A, stream);
  } else {
    return B >= kPreManyRows
               ? launch_att_h_mma<4, 2, 8>(h, wh, bh, ah, B, H, A, stream)
               : launch_att_h_mma<2, 2, 4>(h, wh, bh, ah, B, H, A, stream);
  }
}

// ---------------------------------------------------------------------------
// softmax over K
// ---------------------------------------------------------------------------

// One warp turns the K scores of a row into weights, in place, K in strides
// of 32 lanes (a lane reads and writes only its own slots): softmax, then,
// with a mask row, the mask and a renormalization, then, with a scale row,
// the per-slot scales of a quantized att_emb.
__device__ __forceinline__ void warp_softmax(float* srow, int K,
                                             const float* mrow,
                                             const float* zrow) {
  const int lane = threadIdx.x & 31;
  float mx = -CUDART_INF_F;
  for (int k = lane; k < K; k += 32) mx = fmaxf(mx, srow[k]);
  mx = cic::warp_max(mx);
  float tot = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float e = expf(srow[k] - mx);
    srow[k] = e;
    tot += e;
  }
  tot = cic::warp_sum(tot);
  if (mrow != nullptr) {
    float tot2 = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float w = srow[k] / tot * mrow[k];
      srow[k] = w;
      tot2 += w;
    }
    tot = cic::warp_sum(tot2);
  }
  for (int k = lane; k < K; k += 32)
    srow[k] = zrow != nullptr ? srow[k] / tot * zrow[k] : srow[k] / tot;
}

// ---------------------------------------------------------------------------
// the stream
// ---------------------------------------------------------------------------

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Thread groups that share one column group of the weighted sum: the block's
// threads over the H / VEC column groups, at most kMaxSplit.
inline int col_split(int H, int vec) {
  const int groups = H / vec;
  if (groups >= kThreads) return 1;
  const int split = kThreads / groups;
  return split < kMaxSplit ? split : kMaxSplit;
}

// Bytes of a ring stage (`slots` slots of the wider of A and H, a multiple
// of 16) and of the block's shared memory: the stages' mbarriers
// (kBarBytes), the ring, then as floats the att_h ring [stages, A], w_alpha
// [A], the scores [K], the side ring [2 rows][mask, emb_scale, p_scale][K]
// and the weighted sum's partials [split - 1, H].
inline size_t stage_bytes(int slots, int H, int A, size_t item) {
  const size_t b = (size_t)slots * (H > A ? H : A) * item;
  return (b + 15) & ~(size_t)15;
}
inline size_t stream_smem(int slots, int stages, int K, int H, int A,
                          size_t item, int vec) {
  return kBarBytes + stages * stage_bytes(slots, H, A, item) +
         sizeof(float) * ((size_t)(stages + 1) * round4(A) +
                          7 * (size_t)round4(K) +
                          (size_t)(col_split(H, vec) - 1) * H);
}

// The vector paths are held to 64 registers: 4 blocks an SM (uncapped they
// take 70-93, 3 blocks, and A took 0.0387 ms at bf16 B=512 instead of 0.030).
template <typename T, int VEC, int MAXC, typename Layout>
__global__ void __launch_bounds__(kThreads, VEC > 1 ? 4 : 1)
attention_kernel(const float* __restrict__ ah,
                 const ElemOf<T, Layout>* __restrict__ emb,
                 const ElemOf<T, Layout>* __restrict__ patt,
                 const float* __restrict__ emb_scale,
                 const float* __restrict__ p_scale, const T* __restrict__ wa,
                 const T* __restrict__ ba, const float* __restrict__ mask,
                 T* __restrict__ out, int B, int K, int H, int A, int rows,
                 int slots, int stages, int split, unsigned stage_size) {
  using E = ElemOf<T, Layout>;
  extern __shared__ __align__(16) unsigned char smem_all[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_all);  // [kMaxStages]
  unsigned char* smem_raw = smem_all + kBarBytes;          // the ring
  const int A4 = round4(A);
  const int K4 = round4(K);
  float* ahs = reinterpret_cast<float*>(smem_raw + (size_t)stages * stage_size);
  float* was = ahs + (size_t)stages * A4;   // [A]  w_alpha
  float* sc = was + A4;                      // [K] scores, then weights
  float* side = sc + K4;                     // [2][3][K] mask, scales
  float* red = side + 6 * K4;                // [split - 1, H] partial sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * rows;
  const int nrows = min(rows, B - b0);
  const int cpt = (K + slots - 1) / slots;   // chunks of a tensor of a row
  const int cpr = 2 * cpt;                   // chunks of a row: p_att, att_emb
  const int total = nrows * cpr;

  // Copy chunk c into its stage (and, with a row's first chunk, the row's
  // att_h into the att_h ring).  VEC > 1: thread 0 announces the bytes on the
  // stage's mbarrier and starts one bulk copy a contiguous run (the whole
  // chunk in the b-major layouts, a slot in the K-major); VEC == 1: every
  // thread copies elements with plain loads and stores.
  auto fill = [&](int c) {
    if (c >= total || (CIC_ATT_PROBE & 4)) return;
    const int r = c / cpr;
    const int q = c - r * cpr;
    const bool is_p = q < cpt;
    const int k0 = (is_p ? q : q - cpt) * slots;
    const int nk = min(slots, K - k0);
    const int W = is_p ? A : H;
    const E* src = is_p ? patt : emb;
    E* dst = reinterpret_cast<E*>(smem_raw + (size_t)(c % stages) * stage_size);
    float* ah_dst = ahs + (size_t)(r % stages) * A4;
    const float* ah_src = ah + (size_t)(b0 + r) * A;
    if constexpr (VEC == 1) {
      for (int g = tid; g < nk * W; g += kThreads) {
        const int j = g / W;
        const int col = g - j * W;
        dst[g] = src[Layout::slot(b0 + r, k0 + j, B, K) * W + col];
      }
      if (q == 0)
        for (int a = tid; a < A; a += kThreads) ah_dst[a] = ah_src[a];
    } else if (tid == 0) {
      uint64_t* bar = bars + c % stages;
      const uint32_t slot_bytes = (uint32_t)(W * sizeof(E));
      mbar_expect_tx(bar, nk * slot_bytes +
                              (q == 0 ? (uint32_t)(A * sizeof(float)) : 0u));
      const int run = Layout::run(nk);
      for (int j = 0; j < nk; j += run)
        bulk_copy(dst + j * W, src + Layout::slot(b0 + r, k0 + j, B, K) * W,
                  run * slot_bytes, bar);
      if (q == 0) bulk_copy(ah_dst, ah_src, (uint32_t)(A * sizeof(float)), bar);
    }
  };

  // Warp 0: start the copies of row r's mask values and scale rows into
  // its slot of the side ring (one cp.async group).
  auto load_side = [&](int r) {
    float* d = side + (size_t)(r & 1) * 3 * K4;
    const size_t o = (size_t)(b0 + r) * K;
    for (int k = lane; k < K; k += 32) {
      if (mask != nullptr) cp_async_4(d + k, mask + o + k);
      if constexpr (Layout::kQuant) {
        cp_async_4(d + K4 + k, emb_scale + o + k);
        cp_async_4(d + 2 * K4 + k, p_scale + o + k);
      }
    }
    cp_async_commit();
  };

  if constexpr (VEC > 1) {
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) mbar_init(bars + i, 1);
      cic::mbar_init_fence();
    }
    __syncthreads();
  }
  // the first row's side rows first: with a deep ring they would otherwise
  // queue behind every chunk in flight
  if (warp == 0) load_side(0);
  for (int c = 0; c < stages - 1; ++c) fill(c);
  for (int a = tid; a < A; a += kThreads) was[a] = cic::to_f32(wa[a]);
  const float b_alpha = cic::to_f32(ba[0]);

  // the weighted sum's columns of this thread: column groups cg0 + j * cgt,
  // shared with the threads of the other `split` groups (sg)
  const int groups = H / VEC;
  const int cgt = groups < kThreads ? groups : kThreads;
  const int sg = tid / cgt;
  const int cg0 = tid - sg * cgt;
  const bool active = sg < split;
  float acc[MAXC][VEC];

  for (int c = 0; c < total; ++c) {
    const int r = c / cpr;
    const int q = c - r * cpr;
    // int8, warp 0: row r's scale rows have landed (started a row ahead);
    // the scores of every warp read them after the barrier
    if constexpr (Layout::kQuant) {
      if (q == 0 && warp == 0) cp_async_wait<0>();
    }
    // every thread is done with chunk c - 1 (and, VEC == 1, has written its
    // part of chunk c): that stage takes chunk c + stages - 1; then wait for
    // chunk c's bytes
    __syncthreads();
    fill(c + stages - 1);
    if (q == 0 && warp == 0 && r + 1 < nrows) load_side(r + 1);
    if constexpr (VEC > 1) {
      if (!(CIC_ATT_PROBE & 4))
        mbar_wait(bars + c % stages, (uint32_t)(c / stages) & 1u);
    }

    const bool is_p = q < cpt;
    const int k0 = (is_p ? q : q - cpt) * slots;
    const int nk = min(slots, K - k0);
    const E* st = reinterpret_cast<const E*>(
        smem_raw + (size_t)(c % stages) * stage_size);
    const int b = b0 + r;
    const float* sider = side + (size_t)(r & 1) * 3 * K4;

    if (is_p) {
      // scores: one warp a slot
      const float* ahr = ahs + (size_t)(r % stages) * A4;
      for (int j = warp; j < nk && !(CIC_ATT_PROBE & 1); j += kWarps) {
        const E* prow = st + j * A;
        const float ps = Layout::kQuant ? sider[2 * K4 + k0 + j] : 1.0f;
        float s = 0.0f;
        for (int a = lane * VEC; a < A; a += 32 * VEC) {
          float p[VEC];
          load_vec<E, VEC>(prow + a, p);
          // int8: att_h and w_alpha 16 bytes at a time, for fewer live
          // registers
          constexpr int C{VEC == 16 ? 4 : VEC};
#pragma unroll
          for (int v0 = 0; v0 < VEC; v0 += C) {
            float x[C], w[C];
            load_f32<C>(ahr + a + v0, x);
            load_f32<C>(was + a + v0, w);
#pragma unroll
            for (int v = 0; v < C; ++v) {
              const float pv = Layout::kQuant ? p[v0 + v] * ps : p[v0 + v];
              s = fmaf(att_tanh<T>(pv + x[v]), w[v], s);
            }
          }
        }
        s = cic::warp_sum(s);
        if (lane == 0) sc[k0 + j] = s + b_alpha;
      }
      continue;
    }

    if (q == cpt) {  // the row's first att_emb chunk: weights first (the
                     // barrier above came after the row's last score)
      if (warp == 0) {
        // the row's mask values have landed (each lane reads the slots
        // it copied)
        if constexpr (!Layout::kQuant) cp_async_wait<0>();
        warp_softmax(sc, K, mask != nullptr ? sider : nullptr,
                     Layout::kQuant ? sider + K4 : nullptr);
      }
#pragma unroll
      for (int j = 0; j < MAXC; ++j)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[j][v] = 0.0f;
      __syncthreads();
    }
    // out += sum over the chunk's slots of w_k * att_emb[b, k]
    if (active && !(CIC_ATT_PROBE & 2)) {
      for (int j = sg; j < nk; j += split) {
        const float w = sc[k0 + j];
        const E* erow = st + j * H;
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int cg = cg0 + i * cgt;
          if (cg < groups) {
            float e[VEC];
            load_vec<E, VEC>(erow + cg * VEC, e);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[i][v] = fmaf(w, e[v], acc[i][v]);
          }
        }
      }
    }
    if (q == cpr - 1) {  // the row's last chunk: reduce the groups, store
      if (split > 1) {
        if (active && sg > 0) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            red[(size_t)(sg - 1) * H + cg0 * VEC + v] = acc[0][v];
        }
        __syncthreads();
      }
      if (sg == 0) {
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int cg = cg0 + i * cgt;
          if (cg < groups) {
            for (int g2 = 1; g2 < split; ++g2)
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                acc[i][v] += red[(size_t)(g2 - 1) * H + cg * VEC + v];
            store_vec<T, VEC>(out + (size_t)b * H + cg * VEC, acc[i]);
          }
        }
      }
    }
  }
}

template <typename T, int VEC, int MAXC, typename Layout>
int launch_stream(const void* ah, const void* emb, const void* patt,
                  const void* emb_scale, const void* p_scale, const void* wa,
                  const void* ba, const void* mask, void* out, int B, int K,
                  int H, int A, int rows, int slots, int stages,
                  cudaStream_t stream) {
  using E = ElemOf<T, Layout>;
  const size_t smem = stream_smem(slots, stages, K, H, A, sizeof(E), VEC);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = attention_kernel<T, VEC, MAXC, Layout>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ah), static_cast<const E*>(emb),
      static_cast<const E*>(patt), static_cast<const float*>(emb_scale),
      static_cast<const float*>(p_scale), static_cast<const T*>(wa),
      static_cast<const T*>(ba), static_cast<const float*>(mask),
      static_cast<T*>(out), B, K, H, A, rows, slots, stages,
      col_split(H, VEC), (unsigned)stage_bytes(slots, H, A, sizeof(E)));
  return (int)cudaGetLastError();
}

// Blocks of the stream kernel that fit one SM under a plan (or minus the
// CUDA error code).
template <typename T, int VEC, int MAXC, typename Layout>
int stream_blocks_per_sm(int slots, int stages, int K, int H, int A) {
  const size_t smem =
      stream_smem(slots, stages, K, H, A, sizeof(ElemOf<T, Layout>), VEC);
  auto kernel = attention_kernel<T, VEC, MAXC, Layout>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
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

// The pre-pass, then the stream.  `vec` != 0 asks for the 16-byte path: the
// caller has checked that H and A are multiples of 16 bytes' worth of the
// context's elements, that H has at most kThreads such column groups and
// that the tensors are 16-byte aligned (so the pre-pass may take its own
// 16-byte path too).
template <typename T, typename Layout>
int launch(const void* h, const void* emb, const void* patt,
           const void* emb_scale, const void* p_scale, const void* wh,
           const void* bh, const void* wa, const void* ba, const void* mask,
           void* ah, void* out, int B, int K, int H, int A, int vec, int rows,
           int slots, int stages, cudaStream_t stream) {
  constexpr int kVec{16 / (int)sizeof(ElemOf<T, Layout>)};
  if (K < 1 || K > kMaxK || B < 1 || rows < 1 || slots < 1 || stages < 2 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (vec ? (H % kVec != 0 || A % kVec != 0 || H / kVec > kThreads)
          : H > kMaxCols * kThreads)
    return (int)cudaErrorInvalidValue;
  if (Layout::kQuant && (emb_scale == nullptr || p_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int code = launch_att_h<T>(h, wh, bh, ah, B, H, A, vec, stream);
  if (code != 0) return code;
  if (vec)
    return launch_stream<T, kVec, 1, Layout>(ah, emb, patt, emb_scale,
                                             p_scale, wa, ba, mask, out, B, K,
                                             H, A, rows, slots, stages,
                                             stream);
  return launch_stream<T, 1, kMaxCols, Layout>(ah, emb, patt, emb_scale,
                                               p_scale, wa, ba, mask, out, B,
                                               K, H, A, rows, slots, stages,
                                               stream);
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

// att_h: f32 scratch [B, A] of the caller's; vec, rows, slots, stages: the
// wrapper's stream_plan.
CIC_EXPORT int cic_attention(const void* h, const void* emb, const void* patt,
                             const void* wh, const void* bh, const void* wa,
                             const void* ba, const void* mask, void* att_h,
                             void* out, int B, int K, int H, int A,
                             int is_bf16, int vec, int rows, int slots,
                             int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, BMajor>(h, emb, patt, nullptr, nullptr, wh,
                                         bh, wa, ba, mask, att_h, out, B, K,
                                         H, A, vec, rows, slots, stages, s);
  return launch<float, BMajor>(h, emb, patt, nullptr, nullptr, wh, bh, wa, ba,
                               mask, att_h, out, B, K, H, A, vec, rows, slots,
                               stages, s);
}

// emb and patt K-major: [K, B, H] and [K, B, A]; mask [B, K].
CIC_EXPORT int cic_attention_kmajor(const void* h, const void* emb,
                                    const void* patt, const void* wh,
                                    const void* bh, const void* wa,
                                    const void* ba, const void* mask,
                                    void* att_h, void* out, int B, int K,
                                    int H, int A, int is_bf16, int vec,
                                    int rows, int slots, int stages,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, KMajor>(h, emb, patt, nullptr, nullptr, wh,
                                         bh, wa, ba, mask, att_h, out, B, K,
                                         H, A, vec, rows, slots, stages, s);
  return launch<float, KMajor>(h, emb, patt, nullptr, nullptr, wh, bh, wa, ba,
                               mask, att_h, out, B, K, H, A, vec, rows, slots,
                               stages, s);
}

// emb_q, p_q int8 [B, K, H] and [B, K, A]; emb_scale, p_scale f32 [B, K];
// the rest as cic_attention.
CIC_EXPORT int cic_attention_q(const void* h, const void* emb_q,
                               const void* emb_scale, const void* p_q,
                               const void* p_scale, const void* wh,
                               const void* bh, const void* wa, const void* ba,
                               const void* mask, void* att_h, void* out,
                               int B, int K, int H, int A, int is_bf16,
                               int vec, int rows, int slots, int stages,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, QuantBMajor>(
        h, emb_q, p_q, emb_scale, p_scale, wh, bh, wa, ba, mask, att_h, out,
        B, K, H, A, vec, rows, slots, stages, s);
  return launch<float, QuantBMajor>(h, emb_q, p_q, emb_scale, p_scale, wh, bh,
                                    wa, ba, mask, att_h, out, B, K, H, A, vec,
                                    rows, slots, stages, s);
}
