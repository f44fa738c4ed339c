// Shared first pass of the two vocabulary heads (logit_head.cu, beam_head.cu).
//
// Both heads reduce logits = h @ W + b ([R,H] x [H,V]) per row without ever
// writing the [R,V] logits: the greedy head to (argmax, logsumexp), the beam
// head to (top-kk values and ids, logsumexp).  On the TPU a sequential grid
// axis carried the running state from one vocab tile to the next in scratch
// memory; Hopper's blocks run in parallel in no order and carry nothing, so
// the work is two passes:
//   1. vocab_partials: a grid over (row tile, vocab split).  Each block
//      computes its rows' logits for its split with an FMA loop (h tile in
//      shared memory, W read coalesced along V, f32 accumulators), keeps a
//      per-thread top-KK and streaming log-sum-exp, merges them across the
//      warp (shuffles) and the block (shared memory), and writes one
//      partial (top-KK values and ids, max, sumexp) per (row, split).
//   2. a small merge kernel per head (in its .cu) reduces the splits, one
//      warp a row (merge_splits).
// Ties go to the lower id everywhere -- in a thread, across a warp, across
// warps and across splits -- through cic::before.  Columns past V are masked
// by bounds; nothing is padded.
//
// A round of the beam head past its longest list (THR) passes thr_v / thr_i:
// per row the last candidate an earlier round took, and only candidates
// after it in cic::before order enter the lists.
//
// vocab_partials runs the product on the CUDA cores (f32 FMAs) and takes
// float32 and bfloat16.  Pass 1 is instead a tensor-core pass for the shapes
// that fit one (same grid idea, same partials, same merge kernels):
// vocab_head_tma.cuh's wgmma pass fed by a TMA ring for bfloat16,
// vocab_head_tf32.cuh's split-TF32 mma.sync pass for float32.  The Python
// wrappers choose by type, shape and alignment (`first_pass`: kPassFma,
// kPassTma or kPassTf32).
#pragma once

#include <limits.h>

#include "common.cuh"

namespace cic {

// The heads' first passes, as the entry points' first_pass argument names
// them.
constexpr int kPassFma = 0;
constexpr int kPassTf32 = 2;  // f32, split TF32 on mma.sync
constexpr int kPassTma = 3;   // bf16, wgmma fed by a TMA ring

// The tensor-core first passes, bf16 (vocab_head_tma.cuh) and f32
// (vocab_head_tf32.cuh); defined in logit_head_{tma,tf32}.cu (top-1 list)
// and beam_head_{tma,tf32}.cu (kk_slots of 1, 2, 4, 8 or 16; thr_v non-NULL:
// a later round, kk_slots 16) so that nvcc compiles them beside the FMA
// instantiations.
int greedy_partials_tma(const void* h, const void* w, const void* b,
                        float* part_val, int* part_id, float* part_m,
                        float* part_s, int R, int H, int V, int splits,
                        int split_cols, cudaStream_t stream);
int beam_partials_tma(int kk_slots, const void* h, const void* w,
                      const void* b, float* part_val, int* part_id,
                      float* part_m, float* part_s, int R, int H, int V,
                      int splits, int split_cols, const float* thr_v,
                      const int* thr_i, cudaStream_t stream);
int greedy_partials_tf32(const void* h, const void* w, const void* b,
                         float* part_val, int* part_id, float* part_m,
                         float* part_s, int R, int H, int V, int splits,
                         int split_cols, cudaStream_t stream);
int beam_partials_tf32(int kk_slots, const void* h, const void* w,
                       const void* b, float* part_val, int* part_id,
                       float* part_m, float* part_s, int R, int H, int V,
                       int splits, int split_cols, const float* thr_v,
                       const int* thr_i, cudaStream_t stream);

}  // namespace cic

namespace {

constexpr int kHeadThreads = 256;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kColsPerThread = 2;
constexpr int kChunk = kHeadThreads * kColsPerThread;  // columns per sweep

// Insert (x, i) into a list kept in cic::before order, dropping the last.
template <int KK>
__device__ __forceinline__ void topk_insert(float (&v)[KK], int (&id)[KK],
                                            float x, int i) {
  if (!cic::before(x, i, v[KK - 1], id[KK - 1])) return;
#pragma unroll
  for (int j = KK - 1; j > 0; --j) {
    if (cic::before(x, i, v[j - 1], id[j - 1])) {
      v[j] = v[j - 1];
      id[j] = id[j - 1];
    } else {
      v[j] = x;
      id[j] = i;
      return;
    }
  }
  v[0] = x;
  id[0] = i;
}

template <int KK>
__device__ __forceinline__ void topk_clear(float (&v)[KK], int (&id)[KK]) {
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    v[j] = -CUDART_INF_F;
    id[j] = INT_MAX;
  }
}

// Dynamic shared memory: the block's h rows, transposed to [H][RT] so that
// one float4 load gives four rows of one k.
template <int RT>
size_t vocab_partials_smem(int H) {
  return sizeof(float) * (size_t)H * RT;
}

template <typename T, int RT, int KK, bool THR>
__global__ void __launch_bounds__(kHeadThreads)
vocab_partials(const T* __restrict__ h, const T* __restrict__ w,
               const T* __restrict__ b, float* __restrict__ part_val,
               int* __restrict__ part_id, float* __restrict__ part_m,
               float* __restrict__ part_s, int R, int H, int V, int splits,
               int split_cols, const float* __restrict__ thr_v,
               const int* __restrict__ thr_i) {
  static_assert(RT % 4 == 0, "row tile must be a multiple of 4");
  extern __shared__ __align__(16) float hs[];  // [H][RT]
  __shared__ float wv[kHeadWarps][RT][KK];
  __shared__ int wi[kHeadWarps][RT][KK];
  __shared__ float wm[kHeadWarps][RT];
  __shared__ float ws[kHeadWarps][RT];
  __shared__ float tv_s[RT];  // THR: the rows' thresholds
  __shared__ int ti_s[RT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * RT;
  const int split = blockIdx.y;
  const int c_begin = split * split_cols;
  const int c_end = min(V, c_begin + split_cols);

  for (int i = tid; i < RT * H; i += kHeadThreads) {
    const int r = i / H;
    const int k = i - r * H;
    hs[k * RT + r] =
        (r0 + r < R) ? cic::to_f32(h[(size_t)(r0 + r) * H + k]) : 0.0f;
  }
  if (THR && tid < RT && r0 + tid < R) {
    tv_s[tid] = thr_v[r0 + tid];
    ti_s[tid] = thr_i[r0 + tid];
  }
  __syncthreads();

  float tv[RT][KK];
  int ti[RT][KK];
  float m[RT], s[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    topk_clear<KK>(tv[r], ti[r]);
    m[r] = -CUDART_INF_F;
    s[r] = 0.0f;
  }

  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  for (int base = c_begin; base < c_end; base += kChunk) {
    int col[kColsPerThread];
    bool ok[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      col[c] = base + c * kHeadThreads + tid;
      ok[c] = col[c] < c_end;
    }
    float acc[RT][kColsPerThread];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;

    for (int k = 0; k < H; ++k) {
      float wk[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        wk[c] = ok[c] ? cic::to_f32(w[(size_t)k * V + col[c]]) : 0.0f;
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const float4 hv = hs4[k * (RT / 4) + q];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          acc[4 * q + 0][c] = fmaf(hv.x, wk[c], acc[4 * q + 0][c]);
          acc[4 * q + 1][c] = fmaf(hv.y, wk[c], acc[4 * q + 1][c]);
          acc[4 * q + 2][c] = fmaf(hv.z, wk[c], acc[4 * q + 2][c]);
          acc[4 * q + 3][c] = fmaf(hv.w, wk[c], acc[4 * q + 3][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (!ok[c]) continue;
      const float bias = cic::to_f32(b[col[c]]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float x = acc[r][c] + bias;
        cic::lse_push(m[r], s[r], x);
        if (!THR || cic::before(tv_s[r], ti_s[r], x, col[c]))
          topk_insert<KK>(tv[r], ti[r], x, col[c]);
      }
    }
  }

  // merge the warp's 32 lists: KK rounds of warp arg-best, the winner pops
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float mm = m[r], ss = s[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(cic::kFullMask, mm, off);
      const float s2 = __shfl_xor_sync(cic::kFullMask, ss, off);
      cic::lse_merge(mm, ss, m2, s2);
    }
    if (lane == 0) {
      wm[warp][r] = mm;
      ws[warp][r] = ss;
    }
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      float v = tv[r][0];
      int id = ti[r][0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(cic::kFullMask, v, off);
        const int oi = __shfl_xor_sync(cic::kFullMask, id, off);
        if (cic::before(ov, oi, v, id)) {
          v = ov;
          id = oi;
        }
      }
      if (lane == 0) {
        wv[warp][r][j] = v;
        wi[warp][r][j] = id;
      }
      if (tv[r][0] == v && ti[r][0] == id) {  // this lane's head won: pop it
#pragma unroll
        for (int q = 0; q + 1 < KK; ++q) {
          tv[r][q] = tv[r][q + 1];
          ti[r][q] = ti[r][q + 1];
        }
        tv[r][KK - 1] = -CUDART_INF_F;
        ti[r][KK - 1] = INT_MAX;
      }
    }
  }
  __syncthreads();

  // merge the block's warps: one thread per row
  if (tid < RT && r0 + tid < R) {
    const int r = tid;
    float fv[KK];
    int fi[KK];
    topk_clear<KK>(fv, fi);
    float M = -CUDART_INF_F, S = 0.0f;
    for (int wp = 0; wp < kHeadWarps; ++wp) {
      cic::lse_merge(M, S, wm[wp][r], ws[wp][r]);
#pragma unroll
      for (int j = 0; j < KK; ++j)
        topk_insert<KK>(fv, fi, wv[wp][r][j], wi[wp][r][j]);
    }
    const size_t o = (size_t)(r0 + r) * splits + split;
    part_m[o] = M;
    part_s[o] = S;
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      part_val[o * KK + j] = fv[j];
      part_id[o * KK + j] = fi[j];
    }
  }
}

// lse_merge with the sum in float64: the merge of a row's splits is the
// last of the roundings its log-sum-exp takes, and the largest share of
// them (beam search compares rows through it).
__device__ __forceinline__ void lse_merge64(float& m, double& s, float m2,
                                            double s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -CUDART_INF_F) return;  // both empty
  s = s * exp((double)m - mx) + s2 * exp((double)m2 - mx);
  m = mx;
}

// Reduce the splits of one row with the 32 lanes of a warp: lane l folds
// splits l, l + 32, ... into its own top-KK list and log-sum-exp, then the
// warp merges them (log-sum-exp by shuffles; the lists by KK rounds of
// pop-the-winner, each round's winner the row's next candidate).  Every lane
// returns the row's top-KK and its log-sum-exp M + log(S), the sum S in
// float64.  One warp a row, not one thread: the tensor-core passes' grids
// give a row up to 132 splits, which one thread would read one after
// another.
template <int KK>
__device__ __forceinline__ void merge_splits(
    const float* __restrict__ part_val, const int* __restrict__ part_id,
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    int row, int splits, int lane, float (&fv)[KK], int (&fi)[KK],
    double& lse) {
  float tv[KK];
  int ti[KK];
  topk_clear<KK>(tv, ti);
  float M = -CUDART_INF_F;
  double S = 0.0;
  for (int sp = lane; sp < splits; sp += 32) {
    const size_t o = (size_t)row * splits + sp;
    lse_merge64(M, S, part_m[o], part_s[o]);
#pragma unroll
    for (int j = 0; j < KK; ++j)
      topk_insert<KK>(tv, ti, part_val[o * KK + j], part_id[o * KK + j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(cic::kFullMask, M, off);
    const double s2 = __shfl_xor_sync(cic::kFullMask, S, off);
    lse_merge64(M, S, m2, s2);
  }
  lse = (double)M + log(S);
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    float v = tv[0];
    int id = ti[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(cic::kFullMask, v, off);
      const int oi = __shfl_xor_sync(cic::kFullMask, id, off);
      if (cic::before(ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
    fv[j] = v;
    fi[j] = id;
    if (tv[0] == v && ti[0] == id) {  // this lane's head won: pop it
#pragma unroll
      for (int q = 0; q + 1 < KK; ++q) {
        tv[q] = tv[q + 1];
        ti[q] = ti[q + 1];
      }
      tv[KK - 1] = -CUDART_INF_F;
      ti[KK - 1] = INT_MAX;
    }
  }
}

// The merge kernels' launch: one warp a row, eight rows a block.
constexpr int kMergeRows = 8;

template <typename T, int RT, int KK, bool THR = false>
int launch_vocab_partials(const void* h, const void* w, const void* b,
                          float* part_val, int* part_id, float* part_m,
                          float* part_s, int R, int H, int V, int splits,
                          int split_cols, cudaStream_t stream,
                          const float* thr_v = nullptr,
                          const int* thr_i = nullptr) {
  const size_t smem = vocab_partials_smem<RT>(H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        vocab_partials<T, RT, KK, THR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((R + RT - 1) / RT, splits);
  vocab_partials<T, RT, KK, THR><<<grid, kHeadThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(b), part_val, part_id, part_m, part_s, R, H, V,
      splits, split_cols, thr_v, thr_i);
  return (int)cudaGetLastError();
}

// The TMA pass takes bf16 only, the split-TF32 pass f32 only.
bool valid_pass(int first_pass, int is_bf16) {
  return first_pass == cic::kPassFma ||
         (first_pass == cic::kPassTma && is_bf16) ||
         (first_pass == cic::kPassTf32 && !is_bf16);
}

bool valid_split(int V, int splits, int split_cols) {
  // every split non-empty and together covering [0, V)
  return splits >= 1 && split_cols >= 1 &&
         (long long)splits * split_cols >= V &&
         (long long)(splits - 1) * split_cols < V;
}

}  // namespace
