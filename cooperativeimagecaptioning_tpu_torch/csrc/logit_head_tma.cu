// The greedy head's bf16 first pass: vocab_head_tma.cuh with a top-1 list
// (see that file for what it replaces, its bound and its design).  A
// source of its own so that nvcc compiles it beside logit_head.cu, whose
// cic_greedy_head calls it and then merges the splits.
#include "vocab_head_tma.cuh"

int cic::greedy_partials_tma(const void* h, const void* w, const void* b,
                             float* part_val, int* part_id, float* part_m,
                             float* part_s, int R, int H, int V, int splits,
                             int split_cols, cudaStream_t stream) {
  return launch_vocab_partials_tma<1>(h, w, b, part_val, part_id, part_m,
                                      part_s, R, H, V, splits, split_cols,
                                      stream);
}
