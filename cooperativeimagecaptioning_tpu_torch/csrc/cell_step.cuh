// What the cell's kernels share (cell_step.cu: the split-TF32 and FMA
// kernels and the entry point; cell_wgmma.cu: the bf16 wgmma kernel):
// the entry point's pass codes, the gate epilogue, and the wgmma kernel's
// launcher, defined in its own source so that nvcc compiles it beside
// cell_step.cu.
#pragma once

#include "common.cuh"

namespace cic {

// The kernels, as cic_cell's first_pass names them (the wrapper's
// PASS_CODES).
constexpr int kCellFma = 0;
constexpr int kCellTf32 = 2;   // f32, split TF32 on mma.sync
constexpr int kCellWgmma = 3;  // bf16, wgmma fed by a TMA ring

constexpr int kCellGates = 5;  // i, f, o, and the two in-transform halves

// bf16, D and H multiples of 8, every pointer 16-byte aligned (cic_cell
// checks); rows (64 or 128) and cols (32) name the tile of a block.
int cell_wgmma(const void* xt, const void* h, const void* c, const void* att,
               const void* wi, const void* bi, const void* wh, const void* bh,
               const void* wc, const void* bc, void* h_out, void* c_out,
               int B, int D, int H, int rows, int cols, cudaStream_t stream);

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The gate epilogue of one (row, j): the five sums (biases included).
template <typename T>
__device__ __forceinline__ void cell_out(const float (&x)[kCellGates],
                                         float c, T* h_out, T* c_out) {
  const float ig = sigmoid(x[0]);
  const float fg = sigmoid(x[1]);
  const float og = sigmoid(x[2]);
  const float cn = fg * c + ig * fmaxf(x[3], x[4]);
  *h_out = from_f32<T>(og * tanhf(cn));
  *c_out = from_f32<T>(cn);
}

// bi + bh (+ bc for gates 3 and 4) of column j.
template <typename T>
__device__ __forceinline__ void gate_bias(const T* bi, const T* bh,
                                          const T* bc, int H, int j,
                                          float (&bias)[kCellGates]) {
#pragma unroll
  for (int g = 0; g < kCellGates; ++g)
    bias[g] = to_f32(bi[g * H + j]) + to_f32(bh[g * H + j]);
  if (bc != nullptr) {
    bias[3] += to_f32(bc[j]);
    bias[4] += to_f32(bc[H + j]);
  }
}

}  // namespace cic
