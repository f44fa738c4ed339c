// Tensor-core first pass of the two vocabulary heads, for bfloat16 inputs
// (instantiated in logit_head_mma.cu and beam_head_mma.cu).
//
// It replaces, for bf16, the bodies of the Pallas kernels
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas_resident
//   cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py::beam_head_pallas
// which compute logits = h @ W + b ([R,H] x [H,V], f32 accumulation) in
// their own bodies and reduce each row without writing the [R,V] logits.
//
// What bounds it on the H100: operations.  One call is 2*R*H*V = 5.0 / 9.9 /
// 39.8 GFLOP at R = 512 / 1024 / 4096 (H=512, V=9488) against 9.7 MB of W,
// which stays in the 50 MB L2 across row tiles; only the tensor cores reach
// the card's bf16 rate, and only through wgmma.  vocab_head.cuh's FMA pass
// (one f32 fmaf per product on the CUDA cores) stays for float32 inputs and
// for bf16 shapes this pass does not take.
//
// Design.  A block is two warpgroups (256 threads) and owns 128 rows (64 a
// warpgroup) and one vocab split, a run of 128-column tiles.
//   * The block's h rows [128 x H] are copied to shared memory once and stay
//     (H/64 blocks of [128 rows x 64 k], K-major, 128-byte swizzle): a block
//     with several column tiles reads h once, not once a tile.
//   * W goes through a ring of kMmaStages stages of [64 k x 128 columns].  W
//     is [H,V] with V contiguous, so the stage is MN-major: two halves of 64
//     columns, each [64 k rows of 128 bytes], 128-byte swizzle, read by wgmma
//     through the transposed-B form of its descriptor.  No transposed copy
//     of W exists anywhere.
//   * Copies are cp.async, 16 bytes a thread, zero-filling rows >= R and
//     columns >= V; the step that is loaded runs two steps ahead of the one
//     multiplied, also across a tile's end, so the next tile's first stages
//     arrive during the epilogue.
//   * The product is wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators
//     in registers: 64 a thread), A and B from shared memory, four a stage,
//     at most two stages' worth in flight.
//   * Epilogue, once a column tile: a thread holds 2 rows x 32 columns of
//     the tile (rows warp*16 + lane/4 and +8; columns 8j + 2*(lane%4) +
//     {0,1}).  It adds the bias, skips columns >= V, and folds each logit
//     into its own per-row state, kept in registers across all tiles of the
//     split: a streaming log-sum-exp (one rescale a tile) and a top-KK list
//     (topk_push: branch-free, constant indices, so it stays in registers);
//     in a later round of the beam head only logits after the row's
//     threshold (vocab_head.cuh) enter the list.
//   * After the last tile the four lanes of a quad, which share their rows,
//     merge by shuffles (log-sum-exp pairwise; the lists by KK rounds of
//     pop-the-winner) and lane 0 of the quad writes the (row, split)
//     partial, in the format of the FMA pass.  A row belongs to one quad
//     only, so there is no merge across warps.
// Ties go to the lower id at every level through cic::before.  The heads'
// merge kernels (logit_head.cu, beam_head.cu) reduce the splits as before.
//
// Needs H % 64 == 0, H <= kMmaMaxDepth, V % 8 == 0 and 16-byte aligned h, W
// and b; the Python wrappers route everything else to the FMA pass.
#pragma once

#include "hopper.cuh"
#include "vocab_head.cuh"

namespace {

constexpr int kMmaRows = 128;       // rows a block: two warpgroups of 64
constexpr int kMmaCols = 128;       // columns a tile: one wgmma n
constexpr int kMmaDepth = 64;       // k a ring stage: one 128-byte bf16 row
constexpr int kMmaStages = 4;       // W ring; the load runs 2 steps ahead
constexpr int kMmaMaxDepth = 640;   // largest H whose rows fit beside the ring
constexpr int kMmaThreads = 256;
constexpr int kMmaTileBytes = 16384;  // [128 x 64] or [64 x 128] bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zero-fills when !valid.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

using cic::mma_desc;
using cic::wgmma_commit;
using cic::wgmma_fence;
using cic::wgmma_m64n128k16;
using cic::wgmma_wait;

// Insert (x, i), which comes before the list's last entry, into a list kept
// in cic::before order: x takes the first slot it leads, and each displaced
// entry moves one slot down.  Branch-free, every index a constant, so the
// lists stay in registers.
template <int KK>
__device__ __forceinline__ void topk_push(float (&v)[KK], int (&id)[KK],
                                          float x, int i) {
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    const bool lead = cic::before(x, i, v[j], id[j]);
    const float vj = v[j];
    const int ij = id[j];
    v[j] = lead ? x : vj;
    id[j] = lead ? i : ij;
    x = lead ? vj : x;
    i = lead ? ij : i;
  }
}

// The per-row state a thread carries over a split's column tiles in both
// tensor-core passes (this one and vocab_head_tf32.cuh's): the accumulator
// layout of an m16 x n8 tile -- wgmma's per warp, mma.sync's -- gives each
// thread two rows, row0 = the warp's first row + lane / 4 and row0 + 8
// (index hf), and in column tile j the columns 8 j + 2 (lane % 4) + {0, 1}
// (acc[4 j + 2 hf + e]).  For each row: a streaming log-sum-exp (m, s) and a
// top-KK list (tv, ti); THR: the row's threshold of a later round (thv,
// thi), only logits after it enter the list.
template <int KK, bool THR>
__device__ __forceinline__ void row_state_init(float (&tv)[2][KK],
                                               int (&ti)[2][KK], float (&m)[2],
                                               float (&s)[2], float (&thv)[2],
                                               int (&thi)[2], int row0, int R,
                                               const float* __restrict__ thr_v,
                                               const int* __restrict__ thr_i) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    topk_clear<KK>(tv[hf], ti[hf]);
    m[hf] = -CUDART_INF_F;
    s[hf] = 0.0f;
    if constexpr (THR) {
      const int row = row0 + 8 * hf;
      thv[hf] = row < R ? thr_v[row] : CUDART_INF_F;
      thi[hf] = row < R ? thr_i[row] : -1;
    }
  }
}

__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* b, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + col));
}

__device__ __forceinline__ float2 bias_pair(const float* b, int col) {
  return *reinterpret_cast<const float2*>(b + col);
}

// Epilogue of one tile of NT n8 tiles (the wgmma pass's 128 columns, the
// split-TF32 pass's 72): add the bias, mask the columns >= c_end (c_end is
// even: a column pair is in or out together), and fold the thread's 2 x
// 2 NT logits into its rows' state -- one rescale of the log-sum-exp a
// tile, then each logit that leads the list's last entry (and, THR,
// follows the row's threshold) pushed into the list.  cbase: the tile's
// first column + 2 (lane % 4).
template <int KK, bool THR, int NT, typename T>
__device__ __forceinline__ void fold_tile(float (&acc)[4 * NT],
                                          const T* __restrict__ b, int cbase,
                                          int c_end, float (&tv)[2][KK],
                                          int (&ti)[2][KK], float (&m)[2],
                                          float (&s)[2], const float (&thv)[2],
                                          const int (&thi)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = cbase + 8 * j;
    if (col < c_end) {
      const float2 bias = bias_pair(b, col);
      acc[4 * j + 0] += bias.x;
      acc[4 * j + 1] += bias.y;
      acc[4 * j + 2] += bias.x;
      acc[4 * j + 3] += bias.y;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] = -CUDART_INF_F;
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    // four independent chains each for the max and the sum: a thread has
    // few other warps to hide its latencies behind
    float tm[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                   -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j)
      tm[j & 3] = fmaxf(tm[j & 3], fmaxf(acc[4 * j + 2 * hf],
                                         acc[4 * j + 2 * hf + 1]));
    const float tmax = fmaxf(fmaxf(tm[0], tm[1]), fmaxf(tm[2], tm[3]));
    if (tmax > -CUDART_INF_F) {
      const float mn = fmaxf(m[hf], tmax);
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sum[j & 3] += expf(acc[4 * j + 2 * hf] - mn) +
                      expf(acc[4 * j + 2 * hf + 1] - mn);
      s[hf] = s[hf] * expf(m[hf] - mn) +
              ((sum[0] + sum[1]) + (sum[2] + sum[3]));
      m[hf] = mn;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cbase + 8 * j + e;
        const float x = acc[4 * j + 2 * hf + e];
        if (col < c_end && cic::before(x, col, tv[hf][KK - 1], ti[hf][KK - 1])
            && (!THR || cic::before(thv[hf], thi[hf], x, col)))
          topk_push<KK>(tv[hf], ti[hf], x, col);
      }
    }
  }
}

// After a split's last tile: the four lanes of each quad, which share their
// two rows, merge by shuffles (log-sum-exp pairwise; the lists by KK rounds
// of pop-the-winner), and lane 0 of the quad writes the (row, split)
// partial in the FMA pass's format.  A row belongs to one quad only, so
// there is no merge across warps.
template <int KK>
__device__ __forceinline__ void write_quad_partials(
    float (&tv)[2][KK], int (&ti)[2][KK], const float (&m)[2],
    const float (&s)[2], int row0, int R, int lane, int splits, int split,
    float* __restrict__ part_val, int* __restrict__ part_id,
    float* __restrict__ part_m, float* __restrict__ part_s) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    const bool writer = (lane & 3) == 0 && row < R;
    const size_t o = (size_t)row * splits + split;
    float mm = m[hf], ss = s[hf];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(cic::kFullMask, mm, off);
      const float s2 = __shfl_xor_sync(cic::kFullMask, ss, off);
      cic::lse_merge(mm, ss, m2, s2);
    }
    if (writer) {
      part_m[o] = mm;
      part_s[o] = ss;
    }
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      float v = tv[hf][0];
      int id = ti[hf][0];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(cic::kFullMask, v, off);
        const int oi = __shfl_xor_sync(cic::kFullMask, id, off);
        if (cic::before(ov, oi, v, id)) {
          v = ov;
          id = oi;
        }
      }
      if (writer) {
        part_val[o * KK + j] = v;
        part_id[o * KK + j] = id;
      }
      if (tv[hf][0] == v && ti[hf][0] == id) {  // this lane's head won: pop
#pragma unroll
        for (int q = 0; q + 1 < KK; ++q) {
          tv[hf][q] = tv[hf][q + 1];
          ti[hf][q] = ti[hf][q + 1];
        }
        tv[hf][KK - 1] = -CUDART_INF_F;
        ti[hf][KK - 1] = INT_MAX;
      }
    }
  }
}

inline size_t vocab_partials_mma_smem(int H) {
  // 1024 bytes of slack to align the tiles, the resident h blocks, the ring
  return 1024 + (size_t)(H / kMmaDepth + kMmaStages) * kMmaTileBytes;
}

// THR: a later round of the beam head, with per-row thresholds (a separate
// instantiation, so that every other launch compiles as it did without).
template <int KK, bool THR>
__global__ void __launch_bounds__(kMmaThreads, 1)
vocab_partials_mma(const __nv_bfloat16* __restrict__ h,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ part_val, int* __restrict__ part_id,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   int R, int H, int V, int splits, int split_cols,
                   const float* __restrict__ thr_v,
                   const int* __restrict__ thr_i) {
  extern __shared__ uint8_t mma_smem[];
  const int ksteps = H / kMmaDepth;
  const uint32_t hs = (smem_u32(mma_smem) + 1023u) & ~1023u;
  const uint32_t ws = hs + ksteps * kMmaTileBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int r0 = blockIdx.x * kMmaRows;
  const int split = blockIdx.y;
  const int c_begin = split * split_cols;
  const int c_end = min(V, c_begin + split_cols);
  const int total = (c_end - c_begin + kMmaCols - 1) / kMmaCols * ksteps;

  // Step g multiplies k block g % ksteps of column tile g / ksteps.  Its
  // copies: the W stage, and during the first tile the h block it needs.
  auto load_step = [&](int g) {
    const int t = g / ksteps;
    const int kb = g - t * ksteps;
    const int n0 = c_begin + t * kMmaCols;
    const uint32_t stage = ws + (g % kMmaStages) * kMmaTileBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int k = idx >> 4;
      const int c = idx & 15;
      const int col = n0 + c * 8;
      const bool ok = col < V;
      const __nv_bfloat16* src =
          ok ? w + (size_t)(kb * kMmaDepth + k) * V + col : w;
      cp_async_16(stage + (c >> 3) * 8192 + k * 128 + (((c & 7) ^ (k & 7)) << 4),
                  src, ok);
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * kMmaThreads;
        const int row = idx >> 3;
        const int c = idx & 7;
        const bool ok = r0 + row < R;
        const __nv_bfloat16* src =
            ok ? h + (size_t)(r0 + row) * H + kb * kMmaDepth + c * 8 : h;
        cp_async_16(hs + kb * kMmaTileBytes + row * 128 + ((c ^ (row & 7)) << 4),
                    src, ok);
      }
    }
  };

  // the thread's two rows: r0 + 16 * warp + lane / 4 (+ 8)
  const int row0 = r0 + 16 * (tid >> 5) + (lane >> 2);
  float tv[2][KK];
  int ti[2][KK];
  float m[2], s[2];
  float thv[2];  // THR: the thread's two rows' thresholds
  int thi[2];
  row_state_init<KK, THR>(tv, ti, m, s, thv, thi, row0, R, thr_v, thr_i);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  constexpr int kAhead = kMmaStages - 2;
#pragma unroll
  for (int g = 0; g < kAhead; ++g) {
    if (g < total) load_step(g);
    cp_async_commit();
  }

  const int tiles = total / ksteps;
  int g = 0;  // the step: k block kb of column tile t
  for (int t = 0; t < tiles; ++t) {
    for (int kb = 0; kb < ksteps; ++kb, ++g) {
      cp_async_wait<kAhead - 1>();  // this thread's copies of step g landed
      // the copies were written through the generic proxy, wgmma reads
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // Everyone's copies of step g landed, and every thread has waited for
      // the products of step g - 2: its stage may be overwritten.
      __syncthreads();
      if (g + kAhead < total) load_step(g + kAhead);
      cp_async_commit();

      const uint32_t a0 = hs + kb * kMmaTileBytes + wg * 64 * 128;
      const uint32_t b0 = ws + (g % kMmaStages) * kMmaTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMmaDepth / 16; ++kk) {
        // A: 16 k are 32 bytes along the swizzled row; 8 rows are 1024
        // bytes.  B: 16 k are 16 rows of 128 bytes; the next 64 columns are
        // 8192 bytes on, the next 8 k 1024 bytes on.
        wgmma_m64n128k16(acc, mma_desc(a0 + kk * 32, 16, 1024),
                         mma_desc(b0 + kk * 2048, 8192, 1024),
                         (kb | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products of step g - 1 are done
    }

    // ---- epilogue of column tile t ----
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    fold_tile<KK, THR, kMmaCols / 8>(acc, b,
                                     c_begin + t * kMmaCols + 2 * (lane & 3),
                                     V, tv, ti, m, s, thv, thi);
  }

  write_quad_partials<KK>(tv, ti, m, s, row0, R, lane, splits, split,
                          part_val, part_id, part_m, part_s);
}

template <int KK, bool THR = false>
int launch_vocab_partials_mma(const void* h, const void* w, const void* b,
                              float* part_val, int* part_id, float* part_m,
                              float* part_s, int R, int H, int V, int splits,
                              int split_cols, cudaStream_t stream,
                              const float* thr_v = nullptr,
                              const int* thr_i = nullptr) {
  if (H < kMmaDepth || H % kMmaDepth != 0 || H > kMmaMaxDepth || V % 8 != 0 ||
      split_cols % kMmaCols != 0 ||
      ((uintptr_t)h | (uintptr_t)w | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = vocab_partials_mma_smem(H);
  cudaError_t e = cudaFuncSetAttribute(
      vocab_partials_mma<KK, THR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((R + kMmaRows - 1) / kMmaRows, splits);
  vocab_partials_mma<KK, THR><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), part_val, part_id, part_m, part_s,
      R, H, V, splits, split_cols, thr_v, thr_i);
  return (int)cudaGetLastError();
}

}  // namespace
