// Split-TF32 tensor-core first pass of the two vocabulary heads, for
// float32 inputs (instantiated in logit_head_tf32.cu and beam_head_tf32.cu).
//
// It replaces, for f32, the bodies of the Pallas kernels
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas_resident
//   cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py::beam_head_pallas
// (and, on a vocab slice, the per-shard kernel of beam_head_sharded and
// greedy_head_sharded), which compute logits = h @ W + b in f32 and reduce
// each row without writing the [R,V] logits.
//
// What bounds it on the H100: operations.  One call is 2*R*H*V = 1.24 /
// 2.49 / 4.97 / 9.95 GFLOP at R = 128 / 256 / 512 / 1024 (H=512, V=9488)
// against 19.4 MB of f32 W, which stays in the 50 MB L2 across row tiles.
// The CUDA cores' f32 rate (67 TFLOP/s) caps an FMA loop at 0.0186 ms for
// R=128; plain TF32 on the tensor cores (495 TFLOP/s) keeps only 11
// significant bits of each operand, too few for the f32 gates.  So each
// operand is split into two TF32 parts, hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi) (x - hi is exact in f32), and the product is
// (lo_h*hi_w + hi_h*lo_w) + hi_h*hi_w in f32 accumulators: three TF32
// products, a floor of 3 * 2*R*H*V / 495 TFLOP/s (0.0075 ms at R=128).  The
// dropped lo_h*lo_w and the rounding of lo cost about 2^-22 of each
// product, the order of f32's own summation-order differences.  Both parts
// are rounded explicitly: the tensor cores would truncate a raw f32 operand.
//
// Design.  A block is eight warps (256 threads) and owns 128 rows (16 a
// warp) and one vocab split, a run of 72-column tiles (9 n8 tiles: at
// V=9488 the vocab is 132 of them, one an SM at R=128; `mma_split` in
// ops/kernels/logit_head.py sizes the splits in whole tiles so that the
// grid is one wave).  mma.sync's TF32 rate (below wgmma's 495 TFLOP/s)
// bounds the pass, so no product is spent on columns past a split: only
// the vocab's last tile is ragged, and no guard breaks the scheduling of
// the products.
//   * h and W go through one ring of kTf32Stages stages, each [128 rows x
//     64 k] of h and [64 k x 72 columns] of W, as W lies ([k][n], V
//     contiguous: mma.sync's B fragment reads it without a transposed
//     copy).  The row strides (h 68, W 72 floats) make the fragment loads
//     hit 32 distinct banks.  64 k a stage: half the barriers of 32.
//     Copies are cp.async, 16 bytes a thread, zero-filling rows >= R and
//     columns >= the split's end; the load runs
//     kTf32Stages - 1 steps ahead, across a tile's end too, so the next
//     tile's first stages arrive during the epilogue.  h streams rather
//     than staying resident: 128 rows of f32 h (256 KB at H=512) do not
//     fit, and 128 rows a block let each row's list live in one quad (no
//     merge across warps) and read W from L2 R/128 times.
//   * Each k8 step a warp loads its A fragment (rows 16 w + lane/4 (+8), k
//     lane%4 (+4)) and splits it once, then loads and splits the B
//     fragments of its 9 n8 tiles (k lane%4 (+4), column lane/4) and issues
//     three mma.sync.m16n8k8 tf32 a tile, each product over the 9 tiles
//     before the next, so that no mma waits on the one before it.  The
//     tensor cores round each sum toward zero at its accumulator's scale,
//     which over 64 k8 steps into one f32 accumulator costs ~1e-5 at the
//     heads' logits; so the two small products go into an accumulator of
//     their own (its roundings 2^-11 of the main one's), each big product
//     starts from zero and joins the main accumulator by an f32 add (to
//     nearest), and the small accumulator joins it once a tile.
//   * The accumulator layout is the bf16 pass's (vocab_head_tma.cuh): a
//     thread holds rows lane/4 and +8 and columns 8 j + 2 (lane%4) + {0,1}
//     of each tile, so its epilogue is shared: bias, the streaming
//     log-sum-exp once a tile, the branch-free topk_push, with the columns
//     >= the split's end masked (fold_tile); after the last tile the quad
//     merge by shuffles and pop-the-winner rounds (write_quad_partials)
//     writes the (row, split) partial in the FMA pass's format.
// Ties go to the lower id at every level through cic::before.  The heads'
// merge kernels (logit_head.cu, beam_head.cu) reduce the splits, one warp a
// row, the log-sum-exp's sum in float64 (merge_splits): the pass's grids
// have 66-132 splits at R <= 256.
//
// Needs H % 64 == 0, V % 4 == 0, split_cols % kTf32Cols == 0 and 16-byte
// aligned h, W and b; the Python wrappers route every other f32 shape to
// the FMA pass (vocab_head.cuh).
#pragma once

#include "vocab_head_epilogue.cuh"

namespace {

constexpr int kTf32Rows = 128;     // rows a block: eight warps of 16
constexpr int kTf32Cols = 72;      // columns a tile: 9 n8 tiles
constexpr int kTf32Depth = 64;     // k a ring stage; H must be a multiple
constexpr int kTf32Stages = 3;     // ring; the load runs 2 steps ahead
constexpr int kTf32Threads = 256;
constexpr int kTf32Tiles = kTf32Cols / 8;     // n8 tiles a tile
constexpr int kTf32HStride = kTf32Depth + 4;  // floats a staged h row
constexpr int kTf32WStride = kTf32Cols;       // floats a staged W row
constexpr int kTf32HCopies = kTf32Rows * kTf32Depth / 4;  // 16 bytes each
constexpr int kTf32WCopies = kTf32Depth * kTf32Cols / 4;
constexpr int kTf32StageFloats =
    kTf32Rows * kTf32HStride + kTf32Depth * kTf32WStride;

static_assert(kTf32Rows == 16 * (kTf32Threads / 32), "16 rows a warp");
static_assert(kTf32HCopies % kTf32Threads == 0, "whole h copies a thread");
static_assert(kTf32HStride % 32 == 4 && kTf32WStride % 32 == 8,
              "row strides for conflict-free fragment loads");
static_assert(kTf32Cols % 8 == 0, "whole n8 tiles");

using cic::mma_tf32_1688;
using cic::mma_tf32_1688_zero;
using cic::split_tf32;

constexpr size_t vocab_partials_tf32_smem() {
  return sizeof(float) * (size_t)kTf32Stages * kTf32StageFloats;
}

// THR: a later round of the beam head, with per-row thresholds (a separate
// instantiation, so that every other launch compiles as it did without).
template <int KK, bool THR>
__global__ void __launch_bounds__(kTf32Threads, 1)
vocab_partials_tf32(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ part_val,
                    int* __restrict__ part_id, float* __restrict__ part_m,
                    float* __restrict__ part_s, int R, int H, int V,
                    int splits, int split_cols,
                    const float* __restrict__ thr_v,
                    const int* __restrict__ thr_i) {
  extern __shared__ __align__(16) float tf32_smem[];
  const int ksteps = H / kTf32Depth;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // the fragments' row / column in the tile
  const int tq = lane & 3;   // and k
  const int r0 = blockIdx.x * kTf32Rows;
  const int split = blockIdx.y;
  const int c_begin = split * split_cols;
  const int c_end = min(V, c_begin + split_cols);
  const int tiles = (c_end - c_begin + kTf32Cols - 1) / kTf32Cols;
  const int total = tiles * ksteps;

  // Step g multiplies k block g % ksteps of column tile g / ksteps; its
  // copies are the h and the W block of that step.
  auto load_step = [&](int g) {
    const int t = g / ksteps;
    const int kb = g - t * ksteps;
    const int n0 = c_begin + t * kTf32Cols;
    float* hs = tf32_smem + (g % kTf32Stages) * kTf32StageFloats;
    float* ws = hs + kTf32Rows * kTf32HStride;
#pragma unroll
    for (int i = 0; i < kTf32HCopies / kTf32Threads; ++i) {
      const int idx = tid + i * kTf32Threads;
      const int row = idx / (kTf32Depth / 4);
      const int c = idx % (kTf32Depth / 4);
      const bool ok = r0 + row < R;
      cic::cp_async_16(
          hs + row * kTf32HStride + 4 * c,
          ok ? h + (size_t)(r0 + row) * H + kb * kTf32Depth + 4 * c : h, ok);
    }
#pragma unroll
    for (int i = 0; i < (kTf32WCopies + kTf32Threads - 1) / kTf32Threads;
         ++i) {
      const int idx = tid + i * kTf32Threads;
      const int k = idx / (kTf32Cols / 4);
      const int c = idx % (kTf32Cols / 4);
      const int col = n0 + 4 * c;
      const bool ok = col < c_end;
      if (idx < kTf32WCopies)
        cic::cp_async_16(
            ws + k * kTf32WStride + 4 * c,
            ok ? w + (size_t)(kb * kTf32Depth + k) * V + col : w, ok);
    }
  };

  const int row0 = r0 + 16 * warp + gq;
  float tv[2][KK];
  int ti[2][KK];
  float m[2], s[2];
  float thv[2];  // THR: the thread's two rows' thresholds
  int thi[2];
  row_state_init<KK, THR>(tv, ti, m, s, thv, thi, row0, R, thr_v, thr_i);
  // the main accumulators (f32 adds of each k8 step's big product) and
  // the small products' (mma.sync's own), a tile's
  float acc[4 * kTf32Tiles], small[4 * kTf32Tiles];
#pragma unroll
  for (int i = 0; i < 4 * kTf32Tiles; ++i) acc[i] = small[i] = 0.0f;

  constexpr int kAhead = kTf32Stages - 1;
#pragma unroll
  for (int g = 0; g < kAhead; ++g) {
    if (g < total) load_step(g);
    cic::cp_async_commit();
  }

  int g = 0;  // the step: k block kb of column tile t
  for (int t = 0; t < tiles; ++t) {
    for (int kb = 0; kb < ksteps; ++kb, ++g) {
      cic::cp_async_wait<kAhead - 1>();  // this thread's copies of step g
      // Everyone's copies of step g landed, and every warp is done reading
      // step g - 1's stage: the load below may overwrite it.
      __syncthreads();
      if (g + kAhead < total) load_step(g + kAhead);
      cic::cp_async_commit();

      const float* hs = tf32_smem + (g % kTf32Stages) * kTf32StageFloats;
      const float* ap = hs + (16 * warp + gq) * kTf32HStride + tq;
      const float* bp = hs + kTf32Rows * kTf32HStride + tq * kTf32WStride + gq;
      // the lists of 8 and 16 leave too few registers for a whole stage's
      // fragments in flight
#pragma unroll(KK >= 8 ? 2 : kTf32Depth / 8)
      for (int k8 = 0; k8 < kTf32Depth / 8; ++k8) {
        uint32_t ahi[4], alo[4];
        split_tf32(ap[8 * k8], ahi[0], alo[0]);
        split_tf32(ap[8 * kTf32HStride + 8 * k8], ahi[1], alo[1]);
        split_tf32(ap[8 * k8 + 4], ahi[2], alo[2]);
        split_tf32(ap[8 * kTf32HStride + 8 * k8 + 4], ahi[3], alo[3]);
        const float* bk = bp + 8 * k8 * kTf32WStride;
        uint32_t bhi[kTf32Tiles][2], blo[kTf32Tiles][2];
#pragma unroll
        for (int j = 0; j < kTf32Tiles; ++j) {
          split_tf32(bk[8 * j], bhi[j][0], blo[j][0]);
          split_tf32(bk[4 * kTf32WStride + 8 * j], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < kTf32Tiles; ++j)
          mma_tf32_1688(small + 4 * j, alo, bhi[j][0], bhi[j][1]);
#pragma unroll
        for (int j = 0; j < kTf32Tiles; ++j)
          mma_tf32_1688(small + 4 * j, ahi, blo[j][0], blo[j][1]);
#pragma unroll
        for (int j = 0; j < kTf32Tiles; ++j) {
          float big[4];
          mma_tf32_1688_zero(big, ahi, bhi[j][0], bhi[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] += big[e];
        }
      }
    }

    // ---- epilogue of column tile t ----
#pragma unroll
    for (int i = 0; i < 4 * kTf32Tiles; ++i) {
      acc[i] += small[i];
      small[i] = 0.0f;
    }
    fold_tile<KK, THR, kTf32Tiles>(acc, b,
                                   c_begin + t * kTf32Cols + 2 * tq, c_end,
                                   tv, ti, m, s, thv, thi);
#pragma unroll
    for (int i = 0; i < 4 * kTf32Tiles; ++i) acc[i] = 0.0f;
  }

  write_quad_partials<KK>(tv, ti, m, s, row0, R, lane, splits, split,
                          part_val, part_id, part_m, part_s);
}

template <int KK, bool THR = false>
int launch_vocab_partials_tf32(const void* h, const void* w, const void* b,
                               float* part_val, int* part_id, float* part_m,
                               float* part_s, int R, int H, int V, int splits,
                               int split_cols, cudaStream_t stream,
                               const float* thr_v = nullptr,
                               const int* thr_i = nullptr) {
  if (H < kTf32Depth || H % kTf32Depth != 0 || V % 4 != 0 ||
      split_cols % kTf32Cols != 0 ||
      ((uintptr_t)h | (uintptr_t)w | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = vocab_partials_tf32_smem();
  cudaError_t e = cudaFuncSetAttribute(
      vocab_partials_tf32<KK, THR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((R + kTf32Rows - 1) / kTf32Rows, splits);
  vocab_partials_tf32<KK, THR><<<grid, kTf32Threads, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(b), part_val, part_id, part_m, part_s, R, H,
      V, splits, split_cols, thr_v, thr_i);
  return (int)cudaGetLastError();
}

}  // namespace
