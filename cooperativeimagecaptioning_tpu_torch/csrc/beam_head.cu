// Fused beam logit head (forward only): h @ W + b -> per row the top-kk
// logits and their ids (larger first, the lower id first on a tie) plus the
// row's logsumexp, without writing the [R, V] logits or sorting them.
//
// Replaces the Pallas kernel
//   cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py::beam_head_pallas
// which took kk masked-argmax passes over logits resident in VMEM.  Ids come
// out in lax.top_k's order, so beam search is unchanged.
//
// What bounds it on the H100: as for the greedy head, the [R,512] x
// [512,9488] product (R = batch x beam: 10 GFLOP per step at R=1024); the
// top-kk upkeep is a few compares per logit in registers.
//
// Design: a first pass over (row tile, vocab split) with a per-thread
// top-KK list, KK a compile-time slot count (1, 2, 4, 8 or 16) of at least
// kk, so the lists stay in registers; then one thread per row merges the
// vocab splits' lists and log-sum-exp partials and writes the first kk.
// The first pass is vocab_head_mma.cuh's tensor-core pass (use_mma, bf16
// only; instantiated in beam_head_mma.cu) or vocab_head.cuh's FMA pass with
// an 8-row tile (float32, and bf16 shapes the tensor-core pass does not
// take).
// The top-KK list holds the top-kk in the same order, so rounding kk up to
// KK changes no result.
#include "vocab_head.cuh"

namespace {

constexpr int kBeamRows = 8;

template <int KK>
__global__ void beam_merge(const float* __restrict__ part_val,
                           const int* __restrict__ part_id,
                           const float* __restrict__ part_m,
                           const float* __restrict__ part_s,
                           float* __restrict__ vals, int* __restrict__ idx,
                           float* __restrict__ lse, int R, int splits,
                           int kk) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float fv[KK];
  int fi[KK];
  float M, S;
  merge_splits<KK>(part_val, part_id, part_m, part_s, row, splits, fv, fi, M,
                   S);
  lse[row] = M + logf(S);
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    if (j < kk) {
      vals[(size_t)row * kk + j] = fv[j];
      idx[(size_t)row * kk + j] = fi[j];
    }
  }
}

template <typename T, int KK>
int launch(const void* h, const void* w, const void* b, float* pv, int* pi,
           float* pm, float* ps, float* vals, int* idx, float* lse, int R,
           int H, int V, int kk, int splits, int split_cols, bool use_mma,
           cudaStream_t s) {
  const int e =
      use_mma ? cic::beam_partials_mma(KK, h, w, b, pv, pi, pm, ps, R, H, V,
                                       splits, split_cols, s)
              : launch_vocab_partials<T, kBeamRows, KK>(
                    h, w, b, pv, pi, pm, ps, R, H, V, splits, split_cols, s);
  if (e != 0) return e;
  beam_merge<KK><<<(R + 127) / 128, 128, 0, s>>>(pv, pi, pm, ps, vals, idx,
                                                 lse, R, splits, kk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_slots(int kk_slots, const void* h, const void* w, const void* b,
                   float* pv, int* pi, float* pm, float* ps, float* vals,
                   int* idx, float* lse, int R, int H, int V, int kk,
                   int splits, int split_cols, bool use_mma,
                   cudaStream_t s) {
  switch (kk_slots) {
    case 1:
      return launch<T, 1>(h, w, b, pv, pi, pm, ps, vals, idx, lse, R, H, V,
                          kk, splits, split_cols, use_mma, s);
    case 2:
      return launch<T, 2>(h, w, b, pv, pi, pm, ps, vals, idx, lse, R, H, V,
                          kk, splits, split_cols, use_mma, s);
    case 4:
      return launch<T, 4>(h, w, b, pv, pi, pm, ps, vals, idx, lse, R, H, V,
                          kk, splits, split_cols, use_mma, s);
    case 8:
      return launch<T, 8>(h, w, b, pv, pi, pm, ps, vals, idx, lse, R, H, V,
                          kk, splits, split_cols, use_mma, s);
    case 16:
      return launch<T, 16>(h, w, b, pv, pi, pm, ps, vals, idx, lse, R, H, V,
                           kk, splits, split_cols, use_mma, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

CIC_EXPORT int cic_beam_head(const void* h, const void* w, const void* b,
                             void* part_val, void* part_id, void* part_m,
                             void* part_s, void* vals, void* idx, void* lse,
                             int R, int H, int V, int kk, int kk_slots,
                             int splits, int split_cols, int is_bf16,
                             int use_mma, void* stream) {
  if (R < 1 || H < 1 || kk < 1 || kk > kk_slots || kk > V ||
      !valid_split(V, splits, split_cols) || (use_mma && !is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_id);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  if (is_bf16)
    return dispatch_slots<__nv_bfloat16>(
        kk_slots, h, w, b, pv, pi, pm, ps, static_cast<float*>(vals),
        static_cast<int*>(idx), static_cast<float*>(lse), R, H, V, kk, splits,
        split_cols, use_mma != 0, s);
  return dispatch_slots<float>(kk_slots, h, w, b, pv, pi, pm, ps,
                               static_cast<float*>(vals),
                               static_cast<int*>(idx),
                               static_cast<float*>(lse), R, H, V, kk, splits,
                               split_cols, false, s);
}
