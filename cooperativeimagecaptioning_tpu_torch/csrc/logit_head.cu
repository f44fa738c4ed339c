// Fused greedy logit head (forward only): h @ W + b -> (argmax, logprob of
// the argmax), never writing the [R, V] logits.
//
// Replaces both Pallas variants
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas_resident
// whose split was a VMEM-size choice on the TPU.  Ties go to the lower id
// (jnp.argmax's first maximum).
//
// What bounds it on the H100: the [R,512] x [512,9488] product.  At R=512
// that is 5 GFLOP per decode step against 9.7 MB of bf16 W (which stays in
// the 50 MB L2 across row tiles), so it is compute-bound.  Keeping the
// logits in registers removes the [R,V] f32 write and re-read of the unfused
// path.
//
// Design: a first pass over (row tile, vocab split) with a top-1 list, then
// one warp per row merges the vocab splits' (best, id, max, sumexp).  The
// first pass (first_pass) is vocab_head_tma.cuh's TMA pass (bf16;
// instantiated in logit_head_tma.cu), vocab_head_tf32.cuh's split-TF32 pass
// (f32; logit_head_tf32.cu) or vocab_head.cuh's FMA pass with a 16-row tile
// (the shapes neither tensor-core pass takes).
#include "vocab_head.cuh"

namespace {

constexpr int kGreedyRows = 16;

__global__ void greedy_merge(const float* __restrict__ part_val,
                             const int* __restrict__ part_id,
                             const float* __restrict__ part_m,
                             const float* __restrict__ part_s,
                             int* __restrict__ it, float* __restrict__ lp,
                             int R, int splits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeRows + (threadIdx.x >> 5);
  if (row >= R) return;  // a whole warp: the merge shuffles
  float fv[1];
  int fi[1];
  double lse;
  merge_splits<1>(part_val, part_id, part_m, part_s, row, splits, lane, fv,
                  fi, lse);
  if (lane == 0) {
    it[row] = fi[0];
    lp[row] = (float)(fv[0] - lse);
  }
}

}  // namespace

CIC_EXPORT int cic_greedy_head(const void* h, const void* w, const void* b,
                               void* part_val, void* part_id, void* part_m,
                               void* part_s, void* it, void* lp, int R, int H,
                               int V, int splits, int split_cols, int is_bf16,
                               int first_pass, void* stream) {
  if (R < 1 || H < 1 || !valid_split(V, splits, split_cols) ||
      !valid_pass(first_pass, is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_id);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  const int e =
      first_pass == cic::kPassTma
          ? cic::greedy_partials_tma(h, w, b, pv, pi, pm, ps, R, H, V, splits,
                                     split_cols, s)
      : first_pass == cic::kPassTf32
          ? cic::greedy_partials_tf32(h, w, b, pv, pi, pm, ps, R, H, V,
                                      splits, split_cols, s)
      : is_bf16 ? launch_vocab_partials<__nv_bfloat16, kGreedyRows, 1>(
                      h, w, b, pv, pi, pm, ps, R, H, V, splits, split_cols, s)
                : launch_vocab_partials<float, kGreedyRows, 1>(
                      h, w, b, pv, pi, pm, ps, R, H, V, splits, split_cols, s);
  if (e != 0) return e;
  greedy_merge<<<(R + kMergeRows - 1) / kMergeRows, 32 * kMergeRows, 0, s>>>(
      pv, pi, pm, ps, static_cast<int*>(it), static_cast<float*>(lp), R,
      splits);
  return (int)cudaGetLastError();
}
