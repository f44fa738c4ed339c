// The epilogue that the heads' tensor-core first passes share: the bf16
// TMA pass (vocab_head_tma.cuh) and the f32 split-TF32 pass
// (vocab_head_tf32.cuh).  Both give a thread the accumulator layout of an
// m16 x n8 tile -- wgmma's per warp, mma.sync's -- so a thread holds two
// rows of each column tile and folds them into per-row state that it
// carries over a split's tiles: a streaming log-sum-exp and a top-KK list
// (row_state_init, fold_tile), merged across the quad that shares the rows
// and written as the (row, split) partial of the FMA pass's format
// (write_quad_partials).
#pragma once

#include "vocab_head.cuh"

namespace {

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
// tensor-core passes (the TMA pass's and the split-TF32 pass's): the
// accumulator layout of an m16 x n8 tile -- wgmma's per warp, mma.sync's --
// gives each thread two rows, row0 = the warp's first row + lane / 4 and
// row0 + 8 (index hf), and in column tile j the columns 8 j + 2 (lane % 4)
// + {0, 1} (acc[4 j + 2 hf + e]).  For each row: a streaming log-sum-exp
// (m, s) and a top-KK list (tv, ti); THR: the row's threshold of a later
// round (thv, thi), only logits after it enter the list.
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

// Epilogue of one tile of NT n8 tiles (the TMA pass's 64 columns, the
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

}  // namespace
