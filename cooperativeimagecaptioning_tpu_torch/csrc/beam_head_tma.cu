// The beam head's bf16 first pass: vocab_head_tma.cuh with a top-KK list
// for each compiled slot count (see that file for what it replaces, its
// bound and its design).  A source of its own so that nvcc compiles it
// beside beam_head.cu, whose cic_beam_head calls it and then merges the
// splits.
#include "vocab_head_tma.cuh"

int cic::beam_partials_tma(int kk_slots, const void* h, const void* w,
                           const void* b, float* part_val, int* part_id,
                           float* part_m, float* part_s, int R, int H, int V,
                           int splits, int split_cols, const float* thr_v,
                           const int* thr_i, cudaStream_t stream) {
#define CIC_SLOTS(KK)                                                       \
  case KK:                                                                  \
    return launch_vocab_partials_tma<KK>(h, w, b, part_val, part_id, part_m, \
                                         part_s, R, H, V, splits, split_cols, \
                                         stream)
  if (thr_v != nullptr)  // a later round: only the longest list takes rounds
    return kk_slots == 16 ? launch_vocab_partials_tma<16, true>(
                                h, w, b, part_val, part_id, part_m, part_s, R,
                                H, V, splits, split_cols, stream, thr_v, thr_i)
                          : (int)cudaErrorInvalidValue;
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
