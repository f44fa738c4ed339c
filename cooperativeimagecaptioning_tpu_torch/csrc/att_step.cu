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
// The mask is [B,K] in every layout.  The int8 kernel dequantizes in
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
// Design of the b-major and the K-major call: two launches.
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
//      its own.  Consumers read shared memory 16 bytes at a time: scores by
//      one warp a slot, softmax / mask / renormalize in warp 0 (its mask
//      values were loaded at the row's first chunk), the weighted sum with 8
//      (bf16) or 4 (f32) neighbouring columns a thread and the chunk's slots
//      split over the thread groups that share those columns, reduced through
//      shared memory at the row's end, 16-byte stores.  The [B,K,A] tanh
//      intermediate never leaves the SM.  Layout (BMajor / KMajor) decides
//      only where slot (b, k) lies.
//   The scores are bound by the special-function unit (16 results a clock
//   an SM): f32 inputs take tanh as 1 - 2 / (exp(2x) + 1) on the fast
//   exponential, |x| clamped to 15 (two special-function results an element,
//   absolute error below 1e-6, inside the call's f32 tolerance of 1e-4);
//   bf16 inputs take tanh.approx.f32 (one result an element; relative error
//   2^-11, below the inputs' own rounding).
//   VEC is a template parameter: VEC = 16 / sizeof(T) is the path above; VEC =
//   1 is the same kernel for widths or pointers that are not 16-byte aligned,
//   filling its stages with plain loads and stores and owning up to kMaxCols
//   columns a thread.  K is a runtime argument up to kMaxK.
//
// The int8 kernel keeps the earlier design: one block of 256 threads owns
// kRows rows, computes their att_h itself (block_att_h, an FMA loop over
// W_h2att), and reads each slot with one 16-byte load a lane (16 values).
#include "common.cuh"

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
constexpr int kRows = 8;    // batch rows per block of the int8 kernel
constexpr int kMaxK = 64;   // attention slots the softmax stage holds
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

// Where slot (b, k) of a context lies, and how many of a row's consecutive
// slots are one contiguous run (one bulk copy) when a chunk has nk of them.
struct BMajor {  // [B, K, *]
  static __device__ __forceinline__ size_t slot(int b, int k, int B, int K) {
    return (size_t)b * K + k;
  }
  static __device__ __forceinline__ int run(int nk) { return nk; }
};
struct KMajor {  // [K, B, *]
  static __device__ __forceinline__ size_t slot(int b, int k, int B, int K) {
    return (size_t)k * B + b;
  }
  static __device__ __forceinline__ int run(int nk) { return 1; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zero-fills when !valid (src
// must still be an address inside the tensor).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid = true) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier in shared memory: one arrival a phase (the thread that announces
// the bytes of the phase's bulk copies), completed by the copies themselves.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
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

// VEC neighbouring elements of T from 16-byte aligned shared memory (VEC = 8
// bf16 or 4 f32: one 16-byte load), or one element (VEC = 1), as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = cic::to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
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

// VEC floats to 16-byte aligned global memory as T (one 16-byte store).
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = cic::from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
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
          uint32_t b0, b1;
          const uint32_t addr = smem_u32(&ws[kk + (lane & 15)][wn + 8 * nt]);
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
              "[%2];\n"
              : "=r"(b0), "=r"(b1)
              : "r"(addr));
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]),
                "+f"(acc[nt][3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// softmax over K, shared by the stream and the int8 kernel
// ---------------------------------------------------------------------------

// One warp turns the K scores of a row into weights, in place: softmax, then
// the mask values m0, m1 of slots lane and lane + 32 and a renormalization
// (masked), then the per-slot scales z0, z1 of a quantized att_emb.
__device__ __forceinline__ void warp_softmax(float* srow, int K, bool masked,
                                             float m0, float m1, float z0,
                                             float z1) {
  const int lane = threadIdx.x & 31;
  const int k0 = lane, k1 = lane + 32;
  const float s0 = k0 < K ? srow[k0] : -CUDART_INF_F;
  const float s1 = k1 < K ? srow[k1] : -CUDART_INF_F;
  const float mx = cic::warp_max(fmaxf(s0, s1));
  const float e0 = k0 < K ? expf(s0 - mx) : 0.0f;
  const float e1 = k1 < K ? expf(s1 - mx) : 0.0f;
  const float tot = cic::warp_sum(e0 + e1);
  float w0 = e0 / tot, w1 = e1 / tot;
  if (masked) {
    w0 = k0 < K ? w0 * m0 : 0.0f;
    w1 = k1 < K ? w1 * m1 : 0.0f;
    const float tot2 = cic::warp_sum(w0 + w1);
    w0 /= tot2;
    w1 /= tot2;
  }
  if (k0 < K) srow[k0] = w0 * z0;
  if (k1 < K) srow[k1] = w1 * z1;
}

// ---------------------------------------------------------------------------
// the stream (b-major and K-major)
// ---------------------------------------------------------------------------

inline int round4(int n) { return (n + 3) & ~3; }

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
// (kBarBytes), the ring, then as floats the
// att_h ring [stages, A], w_alpha [A], the scores [kMaxK] and the weighted
// sum's partials [split - 1, H].
inline size_t stage_bytes(int slots, int H, int A, size_t item) {
  const size_t b = (size_t)slots * (H > A ? H : A) * item;
  return (b + 15) & ~(size_t)15;
}
inline size_t stream_smem(int slots, int stages, int H, int A, size_t item,
                          int vec) {
  return kBarBytes + stages * stage_bytes(slots, H, A, item) +
         sizeof(float) * ((size_t)(stages + 1) * round4(A) + kMaxK +
                          (size_t)(col_split(H, vec) - 1) * H);
}

template <typename T, int VEC, int MAXC, typename Layout>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ ah, const T* __restrict__ emb,
                 const T* __restrict__ patt, const T* __restrict__ wa,
                 const T* __restrict__ ba, const float* __restrict__ mask,
                 T* __restrict__ out, int B, int K, int H, int A, int rows,
                 int slots, int stages, int split, unsigned stage_size) {
  extern __shared__ __align__(16) unsigned char smem_all[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_all);  // [kMaxStages]
  unsigned char* smem_raw = smem_all + kBarBytes;          // the ring
  const int A4 = (A + 3) & ~3;
  float* ahs = reinterpret_cast<float*>(smem_raw + (size_t)stages * stage_size);
  float* was = ahs + (size_t)stages * A4;   // [A]  w_alpha
  float* sc = was + A4;                      // [kMaxK] scores, then weights
  float* red = sc + kMaxK;                   // [split - 1, H] partial sums

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
  // chunk in the b-major layout, a slot in the K-major); VEC == 1: every
  // thread copies elements with plain loads and stores.
  auto fill = [&](int c) {
    if (c >= total || (CIC_ATT_PROBE & 4)) return;
    const int r = c / cpr;
    const int q = c - r * cpr;
    const bool is_p = q < cpt;
    const int k0 = (is_p ? q : q - cpt) * slots;
    const int nk = min(slots, K - k0);
    const int W = is_p ? A : H;
    const T* src = is_p ? patt : emb;
    T* dst = reinterpret_cast<T*>(smem_raw + (size_t)(c % stages) * stage_size);
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
      const uint32_t slot_bytes = (uint32_t)(W * sizeof(T));
      mbar_expect_tx(bar, nk * slot_bytes +
                              (q == 0 ? (uint32_t)(A * sizeof(float)) : 0u));
      const int run = Layout::run(nk);
      for (int j = 0; j < nk; j += run)
        bulk_copy(dst + j * W, src + Layout::slot(b0 + r, k0 + j, B, K) * W,
                  run * slot_bytes, bar);
      if (q == 0) bulk_copy(ah_dst, ah_src, (uint32_t)(A * sizeof(float)), bar);
    }
  };

  if constexpr (VEC > 1) {
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
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
  float m0 = 1.0f, m1 = 1.0f;  // warp 0: the row's mask values

  for (int c = 0; c < total; ++c) {
    // every thread is done with chunk c - 1 (and, VEC == 1, has written its
    // part of chunk c): that stage takes chunk c + stages - 1; then wait for
    // chunk c's bytes
    __syncthreads();
    fill(c + stages - 1);
    if constexpr (VEC > 1) {
      if (!(CIC_ATT_PROBE & 4))
        mbar_wait(bars + c % stages, (uint32_t)(c / stages) & 1u);
    }

    const int r = c / cpr;
    const int q = c - r * cpr;
    const bool is_p = q < cpt;
    const int k0 = (is_p ? q : q - cpt) * slots;
    const int nk = min(slots, K - k0);
    const T* st = reinterpret_cast<const T*>(
        smem_raw + (size_t)(c % stages) * stage_size);
    const int b = b0 + r;

    if (is_p) {
      if (q == 0 && warp == 0 && mask != nullptr) {
        m0 = lane < K ? mask[(size_t)b * K + lane] : 0.0f;
        m1 = lane + 32 < K ? mask[(size_t)b * K + lane + 32] : 0.0f;
      }
      // scores: one warp a slot
      const float* ahr = ahs + (size_t)(r % stages) * A4;
      for (int j = warp; j < nk && !(CIC_ATT_PROBE & 1); j += kWarps) {
        const T* prow = st + j * A;
        float s = 0.0f;
        for (int a = lane * VEC; a < A; a += 32 * VEC) {
          float p[VEC], x[VEC], w[VEC];
          load_vec<T, VEC>(prow + a, p);
          load_f32<VEC>(ahr + a, x);
          load_f32<VEC>(was + a, w);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            s = fmaf(att_tanh<T>(p[v] + x[v]), w[v], s);
        }
        s = cic::warp_sum(s);
        if (lane == 0) sc[k0 + j] = s + b_alpha;
      }
      continue;
    }

    if (q == cpt) {  // the row's first att_emb chunk: weights first (the
                     // barrier above came after the row's last score)
      if (warp == 0) warp_softmax(sc, K, mask != nullptr, m0, m1, 1.0f, 1.0f);
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
        const T* erow = st + j * H;
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int cg = cg0 + i * cgt;
          if (cg < groups) {
            float e[VEC];
            load_vec<T, VEC>(erow + cg * VEC, e);
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

// The 16 int8 values of one 16-byte load, as floats.
__device__ __forceinline__ void unpack16(const int4& v, float* f) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)(signed char)((w[i] >> (8 * j)) & 0xff);
  }
}

// ---------------------------------------------------------------------------
// the int8 kernel
// ---------------------------------------------------------------------------

// Shared memory of a block: hs [kRows,H], ah [kRows,A], was [A],
// sc [kRows,kMaxK].
inline size_t smem_floats(int H, int A) {
  return (size_t)kRows * H + (size_t)kRows * A + A + (size_t)kRows * kMaxK;
}

// att_h = h @ W_h2att + b_h2att for the block's rows, and w_alpha, into
// shared memory.  Ends with a barrier.
template <typename T>
__device__ __forceinline__ void block_att_h(
    const T* __restrict__ h, const T* __restrict__ wh,
    const T* __restrict__ bh, const T* __restrict__ wa, float* hs, float* ah,
    float* was, int b0, int B, int H, int A) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kRows * H; i += kThreads) {
    const int r = i / H;
    hs[i] = (b0 + r < B) ? cic::to_f32(h[(size_t)(b0 + r) * H + (i - r * H)])
                         : 0.0f;
  }
  for (int a = tid; a < A; a += kThreads) was[a] = cic::to_f32(wa[a]);
  __syncthreads();

  for (int a = tid; a < A; a += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float w = cic::to_f32(wh[(size_t)k * A + a]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
    }
    const float bias = cic::to_f32(bh[a]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) ah[r * A + a] = acc[r] + bias;
  }
  __syncthreads();
}

// int8 context (b-major).  H and A are multiples of 16 and the int8 rows
// 16-byte aligned (the wrapper checks), so a lane loads 16 values at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_q_kernel(const T* __restrict__ h, const int8_t* __restrict__ emb_q,
                   const float* __restrict__ emb_scale,
                   const int8_t* __restrict__ p_q,
                   const float* __restrict__ p_scale,
                   const T* __restrict__ wh, const T* __restrict__ bh,
                   const T* __restrict__ wa, const T* __restrict__ ba,
                   const float* __restrict__ mask, T* __restrict__ out, int B,
                   int K, int H, int A) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;              // [kRows, H]   h rows (f32)
  float* ah = hs + kRows * H;    // [kRows, A]   att_h
  float* was = ah + kRows * A;   // [A]          w_alpha
  float* sc = was + A;           // [kRows, kMaxK] scores, then weights

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kRows;

  block_att_h(h, wh, bh, wa, hs, ah, was, b0, B, H, A);

  // scores: one warp per (row, slot); p_q streamed once, 16 bytes a lane,
  // dequantized in registers with the slot's scale
  const float b_alpha = cic::to_f32(ba[0]);
  for (int p = warp; p < kRows * K; p += kWarps) {
    const int r = p / K;
    const int k = p - r * K;
    if (b0 + r >= B) continue;
    const size_t slot = (size_t)(b0 + r) * K + k;
    const int8_t* prow = p_q + slot * A;
    const float ps = p_scale[slot];
    float s = 0.0f;
    for (int a0 = lane * 16; a0 < A; a0 += 32 * 16) {
      float q[16];
      unpack16(*reinterpret_cast<const int4*>(prow + a0), q);
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const float4 av = *reinterpret_cast<const float4*>(ah + r * A + a0 + j);
        const float4 wv = *reinterpret_cast<const float4*>(was + a0 + j);
        s = fmaf(tanhf(q[j] * ps + av.x), wv.x, s);
        s = fmaf(tanhf(q[j + 1] * ps + av.y), wv.y, s);
        s = fmaf(tanhf(q[j + 2] * ps + av.z), wv.z, s);
        s = fmaf(tanhf(q[j + 3] * ps + av.w), wv.w, s);
      }
    }
    s = cic::warp_sum(s);
    if (lane == 0) sc[r * kMaxK + k] = s + b_alpha;
  }
  __syncthreads();

  // weights, one warp a row, with the att_emb scale folded in:
  // ws[k] = w[k] * emb_scale[b,k]
  for (int r = warp; r < kRows; r += kWarps) {
    if (b0 + r >= B) continue;
    const size_t row = (size_t)(b0 + r) * K;
    const bool in0 = lane < K, in1 = lane + 32 < K;
    const bool masked = mask != nullptr;
    warp_softmax(sc + r * kMaxK, K, masked,
                 masked && in0 ? mask[row + lane] : 0.0f,
                 masked && in1 ? mask[row + lane + 32] : 0.0f,
                 in0 ? emb_scale[row + lane] : 0.0f,
                 in1 ? emb_scale[row + lane + 32] : 0.0f);
  }
  __syncthreads();

  // out = sum_k ws_k * float(emb_q[b, k]); emb_q streamed once, each thread
  // 16 neighbouring columns of one row
  const int chunks = H / 16;
  for (int i = tid; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c0 = (i - r * chunks) * 16;
    if (b0 + r >= B) continue;
    const int8_t* erow = emb_q + (size_t)(b0 + r) * K * H + c0;
    const float* wrow = sc + r * kMaxK;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float q[16];
      unpack16(*reinterpret_cast<const int4*>(erow + (size_t)k * H), q);
      const float w = wrow[k];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(w, q[j], acc[j]);
    }
    T* orow = out + (size_t)(b0 + r) * H + c0;
#pragma unroll
    for (int j = 0; j < 16; ++j) orow[j] = cic::from_f32<T>(acc[j]);
  }
}

template <typename T, int VEC, int MAXC, typename Layout>
int launch_stream(const void* ah, const void* emb, const void* patt,
                  const void* wa, const void* ba, const void* mask, void* out,
                  int B, int K, int H, int A, int rows, int slots, int stages,
                  cudaStream_t stream) {
  const size_t smem = stream_smem(slots, stages, H, A, sizeof(T), VEC);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = attention_kernel<T, VEC, MAXC, Layout>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ah), static_cast<const T*>(emb),
      static_cast<const T*>(patt), static_cast<const T*>(wa),
      static_cast<const T*>(ba), static_cast<const float*>(mask),
      static_cast<T*>(out), B, K, H, A, rows, slots, stages,
      col_split(H, VEC), (unsigned)stage_bytes(slots, H, A, sizeof(T)));
  return (int)cudaGetLastError();
}

// Blocks of the stream kernel that fit one SM under a plan (or minus the
// CUDA error code).
template <typename T, int VEC, int MAXC, typename Layout>
int stream_blocks_per_sm(int slots, int stages, int H, int A) {
  const size_t smem = stream_smem(slots, stages, H, A, sizeof(T), VEC);
  auto kernel = attention_kernel<T, VEC, MAXC, Layout>;
  cudaError_t e = allow_smem_shared(kernel, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename T, typename Layout>
int blocks_per_sm(int vec, int slots, int stages, int H, int A) {
  constexpr int kVec{16 / (int)sizeof(T)};
  return vec ? stream_blocks_per_sm<T, kVec, 1, Layout>(slots, stages, H, A)
             : stream_blocks_per_sm<T, 1, kMaxCols, Layout>(slots, stages, H,
                                                            A);
}

// The pre-pass, then the stream.  `vec` != 0 asks for the 16-byte path: the
// caller has checked that H and A are multiples of 16 / sizeof(T), that H
// has at most kThreads such column groups and that the tensors are 16-byte
// aligned.
template <typename T, typename Layout>
int launch(const void* h, const void* emb, const void* patt, const void* wh,
           const void* bh, const void* wa, const void* ba, const void* mask,
           void* ah, void* out, int B, int K, int H, int A, int vec, int rows,
           int slots, int stages, cudaStream_t stream) {
  constexpr int kVec{16 / (int)sizeof(T)};
  if (K < 1 || K > kMaxK || B < 1 || rows < 1 || slots < 1 || stages < 2 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (vec ? (H % kVec != 0 || A % kVec != 0 || H / kVec > kThreads)
          : H > kMaxCols * kThreads)
    return (int)cudaErrorInvalidValue;
  const int code = launch_att_h<T>(h, wh, bh, ah, B, H, A, vec, stream);
  if (code != 0) return code;
  if (vec)
    return launch_stream<T, kVec, 1, Layout>(ah, emb, patt, wa, ba, mask, out,
                                             B, K, H, A, rows, slots, stages,
                                             stream);
  return launch_stream<T, 1, kMaxCols, Layout>(ah, emb, patt, wa, ba, mask,
                                               out, B, K, H, A, rows, slots,
                                               stages, stream);
}

template <typename T>
int launch_q(const void* h, const void* emb_q, const void* emb_scale,
             const void* p_q, const void* p_scale, const void* wh,
             const void* bh, const void* wa, const void* ba, const void* mask,
             void* out, int B, int K, int H, int A, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(H, A);
  cudaError_t e = allow_smem(attention_q_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + kRows - 1) / kRows);
  attention_q_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const int8_t*>(emb_q),
      static_cast<const float*>(emb_scale), static_cast<const int8_t*>(p_q),
      static_cast<const float*>(p_scale), static_cast<const T*>(wh),
      static_cast<const T*>(bh), static_cast<const T*>(wa),
      static_cast<const T*>(ba), static_cast<const float*>(mask),
      static_cast<T*>(out), B, K, H, A);
  return (int)cudaGetLastError();
}

}  // namespace

// att_h [B, A] (f32) = h @ wh + bh alone: the pre-pass of the two calls below.
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
// under a plan (a negative number is minus a CUDA error code).
CIC_EXPORT int cic_attention_blocks_per_sm(int is_bf16, int kmajor, int vec,
                                           int slots, int stages, int H,
                                           int A) {
  if (is_bf16)
    return kmajor ? blocks_per_sm<__nv_bfloat16, KMajor>(vec, slots, stages,
                                                         H, A)
                  : blocks_per_sm<__nv_bfloat16, BMajor>(vec, slots, stages,
                                                         H, A);
  return kmajor ? blocks_per_sm<float, KMajor>(vec, slots, stages, H, A)
                : blocks_per_sm<float, BMajor>(vec, slots, stages, H, A);
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
    return launch<__nv_bfloat16, BMajor>(h, emb, patt, wh, bh, wa, ba, mask,
                                         att_h, out, B, K, H, A, vec, rows,
                                         slots, stages, s);
  return launch<float, BMajor>(h, emb, patt, wh, bh, wa, ba, mask, att_h, out,
                               B, K, H, A, vec, rows, slots, stages, s);
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
    return launch<__nv_bfloat16, KMajor>(h, emb, patt, wh, bh, wa, ba, mask,
                                         att_h, out, B, K, H, A, vec, rows,
                                         slots, stages, s);
  return launch<float, KMajor>(h, emb, patt, wh, bh, wa, ba, mask, att_h, out,
                               B, K, H, A, vec, rows, slots, stages, s);
}

// emb_q, p_q int8 [B, K, H] and [B, K, A]; emb_scale, p_scale f32 [B, K].
CIC_EXPORT int cic_attention_q(const void* h, const void* emb_q,
                               const void* emb_scale, const void* p_q,
                               const void* p_scale, const void* wh,
                               const void* bh, const void* wa, const void* ba,
                               const void* mask, void* out, int B, int K,
                               int H, int A, int is_bf16, void* stream) {
  if (K < 1 || K > kMaxK || B < 1 || H % 16 != 0 || A % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_q<__nv_bfloat16>(h, emb_q, emb_scale, p_q, p_scale, wh, bh,
                                   wa, ba, mask, out, B, K, H, A, s);
  return launch_q<float>(h, emb_q, emb_scale, p_q, p_scale, wh, bh, wa, ba,
                         mask, out, B, K, H, A, s);
}
