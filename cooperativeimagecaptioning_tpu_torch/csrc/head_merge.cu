// Merge of the vocabulary-sharded heads (forward only): the model group's
// gathered per-shard candidates -> the global top-m and the global
// log-sum-exp.
//
// Replaces the merge lines of the JAX package's shard_map compositions
//   cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py::beam_head_sharded
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_sharded
// (beam_head.py:131-142: the offset of each shard's ids, lax.top_k over the
// [R, n*m] all_gather, the log-sum-exp over the [n, R] shard partials); the
// per-shard top-m itself is kernel C (beam_head.cu) on the local vocabulary
// slice.  The id offset (shard x V/n) is folded in here, which saves JAX's
// separate add.
//
// Inputs: vals f32 [R, n*m] and shard-local idx int32 [R, n*m] in shard-major
// order (column j is shard j / m), lse f32 [n, R].  Outputs: vals f32 [R, m]
// and global idx int32 [R, m] in lax.top_k's order (larger value first, the
// lower global id on an exact tie: cic::before), lse f32 [R].
//
// What bounds it on the H100: nothing but latency.  At the evaluation's
// beam-2 decode on a model axis of 2 it reads R x 4 candidates (R = 256: 8 KB)
// and writes R x 2; the kernel is one launch of a few microseconds.
//
// Design: one warp per row.  The warp first takes the row's log-sum-exp over
// the n shard partials (lane-strided, warp max then warp sum).  Then m rounds
// of a warp arg-max: in round k every lane scans its strided share of the
// n*m candidates for the best one that comes after the candidate taken in
// round k - 1 in cic::before order (a strict total order, since global ids
// are distinct), and a shuffle reduction picks the warp's best.  So any m
// works without registers or shared memory that grow with m: the rounds
// re-read the row's candidates (n*m*m loads a row, from L1 after the first
// round).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMergeWarps = 4;  // rows per block

__global__ void head_merge_kernel(const float* __restrict__ vals,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ lse,
                                  float* __restrict__ out_vals,
                                  int* __restrict__ out_idx,
                                  float* __restrict__ out_lse, int R, int n,
                                  int m, int v_local) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // uniform across the warp: one row a warp
  const int C = n * m;
  const float* rv = vals + (size_t)row * C;
  const int* ri = idx + (size_t)row * C;

  float mx = -CUDART_INF_F;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, lse[(size_t)s * R + row]);
  mx = cic::warp_max(mx);
  float sum = 0.0f;
  for (int s = lane; s < n; s += 32) sum += expf(lse[(size_t)s * R + row] - mx);
  sum = cic::warp_sum(sum);
  if (lane == 0) out_lse[row] = mx + logf(sum);

  float tv = 0.0f;  // the candidate taken in the round before
  int ti = 0;
  for (int k = 0; k < m; ++k) {
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    int have = 0;
    for (int j = lane; j < C; j += 32) {
      const float v = __ldg(rv + j);
      const int g = __ldg(ri + j) + (j / m) * v_local;
      if (k > 0 && !cic::before(tv, ti, v, g)) continue;  // taken already
      if (!have || cic::before(v, g, bv, bi)) {
        bv = v;
        bi = g;
        have = 1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(cic::kFullMask, bv, off);
      const int oi = __shfl_xor_sync(cic::kFullMask, bi, off);
      const int oh = __shfl_xor_sync(cic::kFullMask, have, off);
      if (oh && (!have || cic::before(ov, oi, bv, bi))) {
        bv = ov;
        bi = oi;
        have = 1;
      }
    }
    if (lane == 0) {
      out_vals[(size_t)row * m + k] = bv;
      out_idx[(size_t)row * m + k] = bi;
    }
    tv = bv;
    ti = bi;
  }
}

}  // namespace

CIC_EXPORT int cic_head_merge(const void* vals, const void* idx,
                              const void* lse, void* out_vals, void* out_idx,
                              void* out_lse, int R, int n, int m, int v_local,
                              void* stream) {
  if (R < 1 || n < 1 || m < 1 || v_local < m ||
      (long long)n * v_local > INT_MAX || (long long)n * m > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  head_merge_kernel<<<(R + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps,
                      0, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(lse), static_cast<float*>(out_vals),
      static_cast<int*>(out_idx), static_cast<float*>(out_lse), R, n, m,
      v_local);
  return (int)cudaGetLastError();
}
