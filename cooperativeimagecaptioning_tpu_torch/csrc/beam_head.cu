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
// kk, so the lists stay in registers; then one warp per row merges the
// vocab splits' lists and log-sum-exp partials and writes the first kk.
// A kk above the longest list (16: registers) takes rounds of both passes:
// round n yields the row's candidates 16n .. 16n + 15, because the first
// pass admits only candidates after the last one round n - 1 took, in
// cic::before order (a strict total order: value, then id), which the merge
// of round n - 1 leaves per row in thr_v / thr_i.  Each round recomputes
// the product; the log-sum-exp comes from the first.
// The first pass (first_pass) is vocab_head_tma.cuh's TMA pass (bf16;
// instantiated in beam_head_tma.cu), vocab_head_tf32.cuh's split-TF32 pass
// (f32; beam_head_tf32.cu) or vocab_head.cuh's FMA pass with an 8-row tile
// (the shapes neither tensor-core pass takes).
// The top-KK list holds the top-kk in the same order, so rounding kk up to
// KK changes no result.
#include "vocab_head.cuh"

namespace {

constexpr int kBeamRows = 8;
constexpr int kRoundKK = 16;  // the longest list; a longer kk takes rounds

// Writes the row's candidates off .. off + KK - 1 (those below kk) at
// vals / idx + row x ld, the log-sum-exp with the first round (off == 0) at
// lse + row x lse_ld, and, when a further round follows, the last candidate
// taken as the row's threshold.  ld = kk, lse_ld = 1: the [R, kk], [R, kk]
// and [R] outputs; ld = lse_ld = 2kk + 1, idx = vals + kk, lse = vals + 2kk:
// one record a row, [vals kk | ids kk | lse] (cic_beam_head_records).
template <int KK>
__global__ void beam_merge(const float* __restrict__ part_val,
                           const int* __restrict__ part_id,
                           const float* __restrict__ part_m,
                           const float* __restrict__ part_s,
                           float* __restrict__ vals, int* __restrict__ idx,
                           float* __restrict__ lse, float* __restrict__ thr_v,
                           int* __restrict__ thr_i, int R, int splits, int kk,
                           int off, int ld, int lse_ld) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeRows + (threadIdx.x >> 5);
  if (row >= R) return;  // a whole warp: the merge shuffles
  float fv[KK];
  int fi[KK];
  double row_lse;
  merge_splits<KK>(part_val, part_id, part_m, part_s, row, splits, lane, fv,
                   fi, row_lse);
  if (lane != 0) return;
  if (off == 0) lse[(size_t)row * lse_ld] = (float)row_lse;
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    if (off + j < kk) {
      vals[(size_t)row * ld + off + j] = fv[j];
      idx[(size_t)row * ld + off + j] = fi[j];
    }
  }
  if (off + KK < kk) {
    thr_v[row] = fv[KK - 1];
    thr_i[row] = fi[KK - 1];
  }
}

// One first pass of a round: thr_v / thr_i NULL in the first round, the
// rows' thresholds in a later one (only the longest list takes rounds).
template <typename T, int KK>
int first_pass_partials(int first_pass, const void* h, const void* w,
                        const void* b, float* pv, int* pi, float* pm,
                        float* ps, int R, int H, int V, int splits,
                        int split_cols, const float* thr_v, const int* thr_i,
                        cudaStream_t s) {
  if (first_pass == cic::kPassTma)
    return cic::beam_partials_tma(KK, h, w, b, pv, pi, pm, ps, R, H, V,
                                  splits, split_cols, thr_v, thr_i, s);
  if (first_pass == cic::kPassTf32)
    return cic::beam_partials_tf32(KK, h, w, b, pv, pi, pm, ps, R, H, V,
                                   splits, split_cols, thr_v, thr_i, s);
  if (thr_v == nullptr)
    return launch_vocab_partials<T, kBeamRows, KK>(
        h, w, b, pv, pi, pm, ps, R, H, V, splits, split_cols, s);
  if constexpr (KK == kRoundKK)
    return launch_vocab_partials<T, kBeamRows, KK, true>(
        h, w, b, pv, pi, pm, ps, R, H, V, splits, split_cols, s, thr_v,
        thr_i);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int KK>
int launch(const void* h, const void* w, const void* b, float* pv, int* pi,
           float* pm, float* ps, float* vals, int* idx, float* lse,
           float* thr_v, int* thr_i, int R, int H, int V, int kk, int splits,
           int split_cols, int first_pass, int ld, int lse_ld,
           cudaStream_t s) {
  for (int off = 0; off < kk; off += KK) {
    const int e = first_pass_partials<T, KK>(
        first_pass, h, w, b, pv, pi, pm, ps, R, H, V, splits, split_cols,
        off == 0 ? nullptr : thr_v, off == 0 ? nullptr : thr_i, s);
    if (e != 0) return e;
    beam_merge<KK><<<(R + kMergeRows - 1) / kMergeRows, 32 * kMergeRows, 0,
                     s>>>(
        pv, pi, pm, ps, vals, idx, lse, thr_v, thr_i, R, splits, kk, off, ld,
        lse_ld);
    const cudaError_t m = cudaGetLastError();
    if (m != cudaSuccess) return (int)m;
  }
  return 0;
}

template <typename T>
int dispatch_slots(int kk_slots, const void* h, const void* w, const void* b,
                   float* pv, int* pi, float* pm, float* ps, float* vals,
                   int* idx, float* lse, float* thr_v, int* thr_i, int R,
                   int H, int V, int kk, int splits, int split_cols,
                   int first_pass, int ld, int lse_ld, cudaStream_t s) {
#define CIC_SLOTS(KK)                                                        \
  case KK:                                                                   \
    return launch<T, KK>(h, w, b, pv, pi, pm, ps, vals, idx, lse, thr_v,      \
                         thr_i, R, H, V, kk, splits, split_cols, first_pass, \
                         ld, lse_ld, s)
  switch (kk_slots) {
    CIC_SLOTS(1);
    CIC_SLOTS(2);
    CIC_SLOTS(4);
    CIC_SLOTS(8);
    CIC_SLOTS(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CIC_SLOTS
}

// The entry points' shared body: vals / idx at a row stride of ld, lse at
// one of lse_ld (beam_merge).
int beam_head(const void* h, const void* w, const void* b, void* part_val,
              void* part_id, void* part_m, void* part_s, float* vals,
              int* idx, float* lse, void* thr, int R, int H, int V, int kk,
              int kk_slots, int splits, int split_cols, int is_bf16,
              int first_pass, int ld, int lse_ld, cudaStream_t s) {
  if (R < 1 || H < 1 || kk < 1 || kk > V ||
      (kk > kk_slots && (!thr || kk_slots != kRoundKK)) ||
      !valid_split(V, splits, split_cols) || !valid_pass(first_pass, is_bf16))
    return (int)cudaErrorInvalidValue;
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_id);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  float* tv = static_cast<float*>(thr);
  int* ti = thr ? reinterpret_cast<int*>(tv + R) : nullptr;
  if (is_bf16)
    return dispatch_slots<__nv_bfloat16>(
        kk_slots, h, w, b, pv, pi, pm, ps, vals, idx, lse, tv, ti, R, H, V,
        kk, splits, split_cols, first_pass, ld, lse_ld, s);
  return dispatch_slots<float>(kk_slots, h, w, b, pv, pi, pm, ps, vals, idx,
                               lse, tv, ti, R, H, V, kk, splits, split_cols,
                               first_pass, ld, lse_ld, s);
}

}  // namespace

// thr: scratch of 2R words (f32 [R] then int32 [R]) for the rounds of a kk
// above kk_slots; may be NULL when kk <= kk_slots.  Outputs vals f32 [R, kk],
// idx int32 [R, kk], lse f32 [R].
CIC_EXPORT int cic_beam_head(const void* h, const void* w, const void* b,
                             void* part_val, void* part_id, void* part_m,
                             void* part_s, void* vals, void* idx, void* lse,
                             void* thr, int R, int H, int V, int kk,
                             int kk_slots, int splits, int split_cols,
                             int is_bf16, int first_pass, void* stream) {
  return beam_head(h, w, b, part_val, part_id, part_m, part_s,
                   static_cast<float*>(vals), static_cast<int*>(idx),
                   static_cast<float*>(lse), thr, R, H, V, kk, kk_slots,
                   splits, split_cols, is_bf16, first_pass, kk, 1,
                   static_cast<cudaStream_t>(stream));
}

// As cic_beam_head, the outputs as one record a row: rec f32 [R, 2kk + 1],
// [vals kk | ids kk (int32 bits) | lse] -- what the model group of the
// vocab-sharded heads gathers and head_merge.cu merges.
CIC_EXPORT int cic_beam_head_records(const void* h, const void* w,
                                     const void* b, void* part_val,
                                     void* part_id, void* part_m,
                                     void* part_s, void* rec, void* thr,
                                     int R, int H, int V, int kk,
                                     int kk_slots, int splits,
                                     int split_cols, int is_bf16,
                                     int first_pass, void* stream) {
  float* r = static_cast<float*>(rec);
  return beam_head(h, w, b, part_val, part_id, part_m, part_s, r,
                   reinterpret_cast<int*>(r + kk), r + 2 * kk, thr, R, H, V,
                   kk, kk_slots, splits, split_cols, is_bf16, first_pass,
                   2 * kk + 1, 2 * kk + 1, static_cast<cudaStream_t>(stream));
}
