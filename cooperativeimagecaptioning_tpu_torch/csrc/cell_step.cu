// Fused maxout-LSTM cell for one Att2in2 / FC step (forward only).
//
// Replaces the Pallas kernel
//   cooperativeimagecaptioning_tpu/ops/pallas/cell_step.py::_cell_pallas
// Per batch row b and hidden column j (Wi [D,5H], Wh [H,5H], Wc [H,2H]):
//   s[g]  = xt[b] . Wi[:, gH+j] + bi[gH+j] + h[b] . Wh[:, gH+j] + bh[gH+j]
//           for the five gates g = 0..4;
//   with attention: s[3] += att[b] . Wc[:, j] + bc[j],
//                   s[4] += att[b] . Wc[:, H+j] + bc[H+j];
//   i, f, o = sigmoid(s[0..2]);  g = max(s[3], s[4]);
//   c'[b,j] = f*c[b,j] + i*g;    h'[b,j] = o*tanh(c'[b,j]).
// Inputs are float32 or bfloat16 (one type for all), accumulation is float32,
// and h', c' are written in that type, as the Pallas kernel writes them.
//
// What bounds it on the H100: operations.  The three products are
// 2*B*(D*5H + H*5H + H*2H) flops (3.2 GFLOP at B=512, H=D=512) over 6.3 MB
// (bf16) or 12.6 MB (f32) of weights that every row tile reads again from
// L2; only the tensor cores reach the card's bf16 rate, and the f32 cell,
// which must stay as close to true f32 as the FMA loop (the training gates
// hold the first step to the CPU's loss), would cap at the CUDA cores' 67
// TFLOP/s on FMAs.  So f32 takes split TF32 on the tensor cores, as the f32
// vocabulary heads do (vocab_head_tf32.cuh): each operand x is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each product is
// (lo_a hi_w + hi_a lo_w) + hi_a hi_w, three TF32 products at 495 TFLOP/s
// (a floor of 0.0049 ms at B=128) that give up ~2^-22 of each product.
// The plain version runs the products as cuBLAS GEMMs and then writes the
// [B,5H] gate pre-activations and the [B,2H] a2c sum to device memory
// between its elementwise kernels; here they stay on the SM and only h' and
// c' leave it.
//
// Design.  A block owns a tile of rows x a run of hidden columns j with all
// five gates of those j: for gate g the columns g*H + j0 .. are one
// contiguous run of each Wi / Wh row (Wc: gates 3 and 4 only), so the
// weights are read as they lie, with no repacking.  The reduction walks the
// three products as one sequence of depth steps (the attention product
// feeds gates 3 and 4 only), through a ring of shared-memory stages filled
// by 16-byte cp.async copies that run (stages - 1) steps ahead of the
// arithmetic, so a block pays one memory latency, not one a step.
//   * bf16 with D, H multiples of 8 and 16-byte aligned tensors: wgmma
//     fed by a TMA ring (cell_wgmma_kernel, in cell_wgmma.cu).
//   * f32 with D, H multiples of 8 and 16-byte aligned tensors
//     (cell_tf32x3_kernel): a block owns 32 rows x 8 WJ j (the wrapper's
//     `tf32x3_cols` picks WJ from B: 1 below B=512, so that B=128 gives 64 x
//     4 = 256 blocks, one wave at two resident an SM; 2 from B=512, which
//     reads the rows half as often from L2).  Its 4 WJ warps are WJ groups
//     of 8 j times kTf32Slices = 4 slices of each stage's depth: a warp owns
//     all 32 rows x its 8 j x 5 gates (two m16 tiles a gate: 10 m16n8
//     tiles, each with a main and a small accumulator and a stage's
//     big-product partial, 120 registers) over 32 k of every 128-deep stage,
//     four k8 steps between two barriers (64-deep stages, two k8 steps, were
//     measured 20% slower: the barriers and the copies' waits set the pace,
//     not the tensor cores).  So each weight element of a stage is read and
//     split by exactly one warp of the block, once, at its fragment load: no
//     warp loads it again and no hi / lo planes are staged.  The split
//     rounds on the integer pipe (cic::split_tf32_alu: the bits of
//     cvt.rna.tf32.f32).  Each k8 step a warp loads and splits its two A
//     fragments and one B fragment a gate, then issues the three products a
//     tile, each product over the 10 tiles before the next.  The tensor
//     cores round each sum toward zero at its accumulator's scale, so as in
//     the heads the two small products go into an accumulator of their own;
//     the big product of the warp's k8 steps of a stage starts from zero
//     and joins the main accumulator by one f32 add (to nearest).  After the
//     last stage the small accumulators join the main ones, the slices'
//     sums meet in shared memory (in slice order: the result does not
//     depend on timing), and each thread finishes (row, j) pairs.  Row
//     pitches of 132 (rows) and 40 or 88 (weights) floats put the 32 lanes
//     of every fragment load on 32 distinct banks.  On the H100 it runs at
//     ~3 TB/s of traffic from L2 (each block reads its rows and weights
//     once: 100 MB at B=128 for 13 MB of inputs), far from its tensor-core
//     floor: that traffic and the copies' waits set its pace.
//   * f32 otherwise, and bf16 that is not 16-byte aligned or whose D or H
//     is no multiple of 8 (cell_fma_kernel): fmaf in true f32.  A block of
//     8 warps owns 16 rows x 32 j (B=128 gives 128 blocks); its warps split
//     each stage's depth in eight, a lane 4 rows x 4 j x 5 gates (80 sums;
//     per 4 k of depth 4 16-byte loads of rows and 20 of weights for 320
//     fmaf), and the eight depth slices are summed through shared memory
//     before the epilogue.
#include <initializer_list>
#include <type_traits>

#include "cell_step.cuh"

namespace {

constexpr int kGates = cic::kCellGates;
constexpr int kCols = 32;    // hidden columns j a block owns
constexpr int kGateCols = kGates * kCols;  // 160 weight columns a stage row
constexpr int kStages = 3;   // ring of depth steps; copies run 2 ahead
// split-TF32 path (f32)
constexpr int kTf32Rows = 32;       // rows a block: two m16 tiles a warp
constexpr int kTf32Depth = 128;     // depth of a step
constexpr int kTf32Slices = 4;      // warps along a step's depth, 32 k each
constexpr int kTf32Stages = 3;      // ring; copies run 2 steps ahead
constexpr int kTf32K8 = kTf32Depth / (8 * kTf32Slices);  // k8 steps a warp
constexpr int kTf32APitch = kTf32Depth + 4;  // floats: rows 4 banks apart
// FMA path
constexpr int kFmaRows = 16;
constexpr int kFmaDepth = 64;
constexpr int kFmaThreads = 256;
constexpr int kFmaSlices = kFmaThreads / 32;  // warps along a stage's depth
constexpr int kFmaPitch = kFmaDepth + 4;  // floats: row starts 4 banks apart

using cic::cell_out;
using cic::gate_bias;

// One of the three products: x [B, K] times the columns of w [K, ldw] of
// gates g0..4 (gate g's run starts at column (g - g0) * H + j0).
template <typename T>
struct Product {
  const T* x;
  const T* w;
  int K;
  int ldw;
  int g0;
};

// The step sequence: xt @ Wi, h @ Wh, then (with attention) att @ Wc, each
// in steps of `depth`.  Returns the product of step s and its first k.
template <typename T>
__device__ __forceinline__ Product<T> step_product(
    int s, int depth, int n0, int n1, const T* xt, const T* h, const T* att,
    const T* wi, const T* wh, const T* wc, int D, int H, int& k0) {
  if (s < n0) {
    k0 = s * depth;
    return {xt, wi, D, kGates * H, 0};
  }
  if (s < n0 + n1) {
    k0 = (s - n0) * depth;
    return {h, wh, H, kGates * H, 0};
  }
  k0 = (s - n0 - n1) * depth;
  return {att, wc, H, 2 * H, 3};
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: split TF32
// ---------------------------------------------------------------------------

// Weight stage row pitch of WJ groups of 8 j: 40 or 88 floats, 8 or 24 banks
// mod 32, so that a B fragment load (k = lane % 4, j = lane / 4) hits 32
// distinct banks.
template <int WJ>
__host__ __device__ constexpr int tf32_wpitch() {
  return kGates * 8 * WJ + (WJ == 1 ? 0 : 8);
}

template <int WJ>
constexpr size_t tf32_smem() {
  return sizeof(float) * kTf32Stages *
         ((size_t)kTf32Rows * kTf32APitch +
          (size_t)kTf32Depth * tf32_wpitch<WJ>());
}

static_assert(kTf32APitch % 32 == 4 && tf32_wpitch<1>() % 32 == 8 &&
                  tf32_wpitch<2>() % 32 == 24,
              "row pitches for conflict-free fragment loads");
static_assert(kTf32Depth == 8 * kTf32K8 * kTf32Slices, "whole k8 steps");

// f32, D and H multiples of 8, every pointer 16-byte aligned (the caller
// checks).
template <int WJ>
__global__ void __launch_bounds__(32 * kTf32Slices * WJ, WJ == 1 ? 2 : 1)
cell_tf32x3_kernel(const float* __restrict__ xt, const float* __restrict__ h,
                   const float* __restrict__ c, const float* __restrict__ att,
                   const float* __restrict__ wi, const float* __restrict__ bi,
                   const float* __restrict__ wh, const float* __restrict__ bh,
                   const float* __restrict__ wc, const float* __restrict__ bc,
                   float* __restrict__ h_out, float* __restrict__ c_out,
                   int B, int D, int H) {
  constexpr int kThreadsB = 32 * kTf32Slices * WJ;
  constexpr int kColsB = 8 * WJ;  // j a block
  constexpr int kWPitch = tf32_wpitch<WJ>();
  constexpr int kAStage = kTf32Rows * kTf32APitch;
  constexpr int kStage = kAStage + kTf32Depth * kWPitch;
  constexpr int kRedPitch = kGates * 8;  // a warp's 5 gates x 8 j
  extern __shared__ __align__(16) float tf32_cell_smem[];
  // [stages][rows][kTf32APitch] then [depth][gate][kColsB j] a stage; after
  // the loop the warps' sums, [WJ][slices][rows][gate][8 j]
  float* red = tf32_cell_smem;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slice = warp % kTf32Slices;  // the warp's 32 k of each stage
  const int wj = warp / kTf32Slices;     // and its 8 j of the block's
  const int gq = lane >> 2;  // the fragments' row / column in a tile
  const int tq = lane & 3;   // and k
  const int m0 = blockIdx.y * kTf32Rows;
  const int j0 = blockIdx.x * kColsB;
  const int n0 = (D + kTf32Depth - 1) / kTf32Depth;
  const int n1 = (H + kTf32Depth - 1) / kTf32Depth;
  const int total = n0 + n1 + (att != nullptr ? n1 : 0);

  // step s into stage s % kTf32Stages: the rows' depth slice, and for each
  // gate the product feeds its [depth x kColsB] run of weights; zero-filled
  // beyond B, the product's depth and H
  auto load = [&](int s) {
    int k0;
    const Product<float> p = step_product(s, kTf32Depth, n0, n1, xt, h, att,
                                          wi, wh, wc, D, H, k0);
    float* a_st = tf32_cell_smem + (s % kTf32Stages) * kStage;
    float* w_st = a_st + kAStage;
    for (int g = tid; g < kTf32Rows * (kTf32Depth / 4); g += kThreadsB) {
      const int r = g / (kTf32Depth / 4);
      const int cc = (g % (kTf32Depth / 4)) * 4;
      const bool ok = m0 + r < B && k0 + cc < p.K;
      cic::cp_async_16(a_st + r * kTf32APitch + cc,
                       ok ? p.x + (size_t)(m0 + r) * p.K + k0 + cc : p.x, ok);
    }
    for (int gate = p.g0; gate < kGates; ++gate) {
      for (int g = tid; g < kTf32Depth * (kColsB / 4); g += kThreadsB) {
        const int k = g / (kColsB / 4);
        const int c4 = (g % (kColsB / 4)) * 4;
        const bool ok = k0 + k < p.K && j0 + c4 < H;
        const float* src =
            p.w + (size_t)(k0 + k) * p.ldw + (gate - p.g0) * H + j0 + c4;
        cic::cp_async_16(w_st + k * kWPitch + gate * kColsB + c4,
                         ok ? src : p.w, ok);
      }
    }
  };

  // acc[g][mt]: gate g, rows 16 mt + lane / 4 (+ 8) x j 2 (lane % 4) (+ 1)
  // of the warp's 8; small: the small products' accumulators
  float acc[kGates][2][4], small[kGates][2][4];
#pragma unroll
  for (int g = 0; g < kGates; ++g)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][mt][e] = small[g][mt][e] = 0.0f;

  // the warp's k8 steps of a stage, for the gates from G0
  auto multiply = [&](auto g0_const, const float* a_st, const float* w_st) {
    constexpr int G0 = decltype(g0_const)::value;
    float big[kGates][2][4];
#pragma unroll
    for (int k8 = 0; k8 < kTf32K8; ++k8) {
      const int kk = (slice * kTf32K8 + k8) * 8;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = a_st + (mt * 16 + gq) * kTf32APitch + kk + tq;
        cic::split_tf32_alu(ap[0], ahi[mt][0], alo[mt][0]);
        cic::split_tf32_alu(ap[8 * kTf32APitch], ahi[mt][1], alo[mt][1]);
        cic::split_tf32_alu(ap[4], ahi[mt][2], alo[mt][2]);
        cic::split_tf32_alu(ap[8 * kTf32APitch + 4], ahi[mt][3], alo[mt][3]);
      }
      uint32_t bhi[kGates][2], blo[kGates][2];
      const float* bp = w_st + (kk + tq) * kWPitch + wj * 8 + gq;
#pragma unroll
      for (int g = G0; g < kGates; ++g) {
        cic::split_tf32_alu(bp[g * kColsB], bhi[g][0], blo[g][0]);
        cic::split_tf32_alu(bp[4 * kWPitch + g * kColsB], bhi[g][1],
                            blo[g][1]);
      }
#pragma unroll
      for (int g = G0; g < kGates; ++g)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          cic::mma_tf32_1688(small[g][mt], alo[mt], bhi[g][0], bhi[g][1]);
#pragma unroll
      for (int g = G0; g < kGates; ++g)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          cic::mma_tf32_1688(small[g][mt], ahi[mt], blo[g][0], blo[g][1]);
#pragma unroll
      for (int g = G0; g < kGates; ++g)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (k8 == 0)
            cic::mma_tf32_1688_zero(big[g][mt], ahi[mt], bhi[g][0],
                                    bhi[g][1]);
          else
            cic::mma_tf32_1688(big[g][mt], ahi[mt], bhi[g][0], bhi[g][1]);
        }
    }
#pragma unroll
    for (int g = G0; g < kGates; ++g)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][mt][e] += big[g][mt][e];
  };

#pragma unroll
  for (int s = 0; s < kTf32Stages - 1; ++s) {
    if (s < total) load(s);
    cic::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cic::cp_async_wait<kTf32Stages - 2>();  // this thread's copies of step s
    // everyone's copies of step s landed, and everyone is done with step
    // s - 1, whose stage the next load refills
    __syncthreads();
    if (s + kTf32Stages - 1 < total) load(s + kTf32Stages - 1);
    cic::cp_async_commit();
    const float* a_st = tf32_cell_smem + (s % kTf32Stages) * kStage;
    const float* w_st = a_st + kAStage;
    if (s < n0 + n1)
      multiply(std::integral_constant<int, 0>{}, a_st, w_st);
    else
      multiply(std::integral_constant<int, 3>{}, a_st, w_st);
  }
  cic::cp_async_wait<0>();
  __syncthreads();  // the stages become the warps' sums

#pragma unroll
  for (int g = 0; g < kGates; ++g)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + gq + 8 * hf;
        *reinterpret_cast<float2*>(
            red + ((wj * kTf32Slices + slice) * kTf32Rows + r) * kRedPitch +
            g * 8 + 2 * tq) =
            make_float2(acc[g][mt][2 * hf] + small[g][mt][2 * hf],
                        acc[g][mt][2 * hf + 1] + small[g][mt][2 * hf + 1]);
      }
  __syncthreads();

  const float* bcp = att != nullptr ? bc : nullptr;
  for (int o = tid; o < kTf32Rows * kColsB; o += kThreadsB) {
    const int r = o / kColsB, jj = o % kColsB;
    const int row = m0 + r, j = j0 + jj;
    if (row >= B || j >= H) continue;
    float x[kGates];
    gate_bias(bi, bh, bcp, H, j, x);
    const float* rp =
        red + ((jj / 8) * kTf32Slices * kTf32Rows + r) * kRedPitch + jj % 8;
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      float v = 0.0f;
#pragma unroll
      for (int sl = 0; sl < kTf32Slices; ++sl)
        v += rp[sl * kTf32Rows * kRedPitch + g * 8];
      x[g] += v;
    }
    const size_t oo = (size_t)row * H + j;
    cell_out(x, c[oo], h_out + oo, c_out + oo);
  }
}

// ---------------------------------------------------------------------------
// fmaf in f32
// ---------------------------------------------------------------------------

// The ring, or after the loop the slices' partial sums, whichever is larger.
constexpr size_t fma_smem() {
  const size_t ring = (size_t)kStages * ((size_t)kFmaRows * kFmaPitch +
                                         (size_t)kFmaDepth * kGateCols);
  const size_t red = (size_t)kFmaSlices * kFmaRows * kGateCols;
  return sizeof(float) * (ring > red ? ring : red);
}

// Any type and alignment.  ASYNC (f32 with D and H multiples of 4 and
// 16-byte aligned tensors): stages filled by 16-byte cp.async; else by
// plain loads, converted to f32.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(kFmaThreads)
cell_fma_kernel(const T* __restrict__ xt, const T* __restrict__ h,
                const T* __restrict__ c, const T* __restrict__ att,
                const T* __restrict__ wi, const T* __restrict__ bi,
                const T* __restrict__ wh, const T* __restrict__ bh,
                const T* __restrict__ wc, const T* __restrict__ bc,
                T* __restrict__ h_out, T* __restrict__ c_out, int B, int D,
                int H) {
  constexpr int kAStage = kFmaRows * kFmaPitch;
  constexpr int kWStage = kFmaDepth * kGateCols;
  constexpr int kSlice = kFmaDepth / kFmaSlices;  // depth of a warp's share
  extern __shared__ __align__(16) float cell_smem[];
  float* as = cell_smem;                // [stages][16][kFmaPitch]
  float* ws = as + kStages * kAStage;   // [stages][depth][5 gates][32 j]
  float* red = cell_smem;               // after the loop: [slices][16][160]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;         // the warp's slice of a stage's depth
  const int r4 = (lane >> 3) * 4;    // the lane's 4 rows
  const int j4 = (lane & 7) * 4;     // and its 4 columns j, of every gate
  const int m0 = blockIdx.y * kFmaRows;
  const int j0 = blockIdx.x * kCols;
  const int n0 = (D + kFmaDepth - 1) / kFmaDepth;
  const int n1 = (H + kFmaDepth - 1) / kFmaDepth;
  const int total = n0 + n1 + (att != nullptr ? n1 : 0);

  auto load = [&](int s) {
    int k0;
    const Product<T> p =
        step_product(s, kFmaDepth, n0, n1, xt, h, att, wi, wh, wc, D, H, k0);
    float* a_st = as + (s % kStages) * kAStage;
    float* w_st = ws + (s % kStages) * kWStage;
    if constexpr (ASYNC) {
      for (int g = tid; g < kFmaRows * (kFmaDepth / 4); g += kFmaThreads) {
        const int r = g / (kFmaDepth / 4);
        const int cc = (g % (kFmaDepth / 4)) * 4;
        const bool ok = m0 + r < B && k0 + cc < p.K;
        cic::cp_async_16(a_st + r * kFmaPitch + cc,
                         ok ? p.x + (size_t)(m0 + r) * p.K + k0 + cc : p.x,
                         ok);
      }
      for (int gate = p.g0; gate < kGates; ++gate) {
        for (int g = tid; g < kFmaDepth * (kCols / 4); g += kFmaThreads) {
          const int k = g / (kCols / 4);
          const int c4 = (g % (kCols / 4)) * 4;
          const bool ok = k0 + k < p.K && j0 + c4 < H;
          const T* src =
              p.w + (size_t)(k0 + k) * p.ldw + (gate - p.g0) * H + j0 + c4;
          cic::cp_async_16(w_st + k * kGateCols + gate * kCols + c4,
                           ok ? src : p.w, ok);
        }
      }
    } else {
      for (int i = tid; i < kFmaRows * kFmaDepth; i += kFmaThreads) {
        const int r = i / kFmaDepth, cc = i % kFmaDepth;
        a_st[r * kFmaPitch + cc] =
            (m0 + r < B && k0 + cc < p.K)
                ? cic::to_f32(p.x[(size_t)(m0 + r) * p.K + k0 + cc]) : 0.0f;
      }
      for (int gate = p.g0; gate < kGates; ++gate) {
        for (int i = tid; i < kFmaDepth * kCols; i += kFmaThreads) {
          const int k = i / kCols, cc = i % kCols;
          w_st[k * kGateCols + gate * kCols + cc] =
              (k0 + k < p.K && j0 + cc < H)
                  ? cic::to_f32(p.w[(size_t)(k0 + k) * p.ldw +
                                    (gate - p.g0) * H + j0 + cc])
                  : 0.0f;
        }
      }
    }
  };

  float acc[kGates][4][4];
#pragma unroll
  for (int g = 0; g < kGates; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][i][e] = 0.0f;

  // the warp's slice of a stage, 4 k at a time: the lane's 4 rows (four
  // 16-byte loads) times 4 j of each gate from G0 (a 16-byte load each)
  auto multiply = [&](auto g0_const, const float* a_st, const float* w_st) {
    constexpr int G0 = decltype(g0_const)::value;
#pragma unroll
    for (int k = warp * kSlice; k < (warp + 1) * kSlice; k += 4) {
      float av[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(a_st + (r4 + i) * kFmaPitch + k);
        av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int g = G0; g < kGates; ++g) {
          const float4 wv = *reinterpret_cast<const float4*>(
              w_st + (k + kk) * kGateCols + g * kCols + j4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[g][i][0] = fmaf(av[i][kk], wv.x, acc[g][i][0]);
            acc[g][i][1] = fmaf(av[i][kk], wv.y, acc[g][i][1]);
            acc[g][i][2] = fmaf(av[i][kk], wv.z, acc[g][i][2]);
            acc[g][i][3] = fmaf(av[i][kk], wv.w, acc[g][i][3]);
          }
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    if constexpr (ASYNC) cic::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    if constexpr (ASYNC) cic::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < total) load(s + kStages - 1);
    if constexpr (ASYNC) cic::cp_async_commit();
    const float* a_st = as + (s % kStages) * kAStage;
    const float* w_st = ws + (s % kStages) * kWStage;
    if (s < n0 + n1)
      multiply(std::integral_constant<int, 0>{}, a_st, w_st);
    else
      multiply(std::integral_constant<int, 3>{}, a_st, w_st);
  }
  if constexpr (ASYNC) cic::cp_async_wait<0>();
  __syncthreads();  // the stages become the slices' partial sums

#pragma unroll
  for (int g = 0; g < kGates; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(
          red + (warp * kFmaRows + r4 + i) * kGateCols + g * kCols + j4) =
          make_float4(acc[g][i][0], acc[g][i][1], acc[g][i][2],
                      acc[g][i][3]);
  __syncthreads();

  const T* bcp = att != nullptr ? bc : nullptr;
  for (int o = tid; o < kFmaRows * kCols; o += kFmaThreads) {
    const int r = o / kCols, jj = o % kCols;
    const int row = m0 + r, j = j0 + jj;
    if (row >= B || j >= H) continue;
    float x[kGates];
    gate_bias(bi, bh, bcp, H, j, x);
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      float v = 0.0f;
#pragma unroll
      for (int sl = 0; sl < kFmaSlices; ++sl)
        v += red[(sl * kFmaRows + r) * kGateCols + g * kCols + jj];
      x[g] += v;
    }
    const size_t oo = (size_t)row * H + j;
    cell_out(x, cic::to_f32(c[oo]), h_out + oo, c_out + oo);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int WJ>
int launch_tf32x3(const void* xt, const void* h, const void* c,
                  const void* att, const void* wi, const void* bi,
                  const void* wh, const void* bh, const void* wc,
                  const void* bc, void* h_out, void* c_out, int B, int D,
                  int H, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem<WJ>();
  cudaError_t e = allow_smem(cell_tf32x3_kernel<WJ>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H + 8 * WJ - 1) / (8 * WJ),
                  (B + kTf32Rows - 1) / kTf32Rows);
  cell_tf32x3_kernel<WJ><<<grid, 32 * kTf32Slices * WJ, smem, stream>>>(
      static_cast<const float*>(xt), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(att),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<const float*>(wc), static_cast<const float*>(bc),
      static_cast<float*>(h_out), static_cast<float*>(c_out), B, D, H);
  return (int)cudaGetLastError();
}

template <typename T, bool ASYNC>
int launch_fma(const void* xt, const void* h, const void* c, const void* att,
               const void* wi, const void* bi, const void* wh, const void* bh,
               const void* wc, const void* bc, void* h_out, void* c_out,
               int B, int D, int H, cudaStream_t stream) {
  constexpr size_t smem = fma_smem();
  cudaError_t e = allow_smem(cell_fma_kernel<T, ASYNC>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H + kCols - 1) / kCols, (B + kFmaRows - 1) / kFmaRows);
  cell_fma_kernel<T, ASYNC><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const T*>(xt), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(att),
      static_cast<const T*>(wi), static_cast<const T*>(bi),
      static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const T*>(wc), static_cast<const T*>(bc),
      static_cast<T*>(h_out), static_cast<T*>(c_out), B, D, H);
  return (int)cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace

// att, wc and bc are all NULL for the FC cell, or none of them.  first_pass
// names the kernel (the wrapper's cell_pass, cell_step.cuh's codes):
// kCellFma the FMA kernel (any shape), kCellTf32 the split-TF32 kernel
// (f32), kCellWgmma the bf16 wgmma kernel (cell_wgmma.cu); the last two
// need D and H multiples of 8 and every pointer 16-byte aligned.  cols and rows name a block's tile: the
// split-TF32 kernel's j, 8 or 16 (the wrapper's tf32x3_cols); the wgmma
// kernel's j, 32 or 64, and rows, 64 or 128 (the wrapper's wgmma_tile).
CIC_EXPORT int cic_cell(const void* xt, const void* h, const void* c,
                        const void* att, const void* wi, const void* bi,
                        const void* wh, const void* bh, const void* wc,
                        const void* bc, void* h_out, void* c_out, int B,
                        int D, int H, int is_bf16, int first_pass, int cols,
                        int rows, void* stream) {
  if (B < 1 || D < 1 || H < 1 || (B + kFmaRows - 1) / kFmaRows > 65535)
    return (int)cudaErrorInvalidValue;
  if ((att == nullptr) != (wc == nullptr) ||
      (att == nullptr) != (bc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16({xt, h, c, att, wi, bi, wh, bh, wc, bc,
                                  h_out, c_out});
  const bool fits = D % 8 == 0 && H % 8 == 0 && aligned;
  if (first_pass == cic::kCellWgmma) {
    if (!is_bf16 || !fits) return (int)cudaErrorInvalidValue;
    return cic::cell_wgmma(xt, h, c, att, wi, bi, wh, bh, wc, bc, h_out,
                           c_out, B, D, H, rows, cols, s);
  }
  if (first_pass == cic::kCellTf32) {
    if (is_bf16 || !fits || (cols != 8 && cols != 16))
      return (int)cudaErrorInvalidValue;
    return cols == 8
               ? launch_tf32x3<1>(xt, h, c, att, wi, bi, wh, bh, wc, bc,
                                  h_out, c_out, B, D, H, s)
               : launch_tf32x3<2>(xt, h, c, att, wi, bi, wh, bh, wc, bc,
                                  h_out, c_out, B, D, H, s);
  }
  if (first_pass != cic::kCellFma) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_fma<__nv_bfloat16, false>(xt, h, c, att, wi, bi, wh, bh, wc,
                                            bc, h_out, c_out, B, D, H, s);
  if (D % 4 == 0 && H % 4 == 0 && aligned)
    return launch_fma<float, true>(xt, h, c, att, wi, bi, wh, bh, wc, bc,
                                   h_out, c_out, B, D, H, s);
  return launch_fma<float, false>(xt, h, c, att, wi, bi, wh, bh, wc, bc,
                                  h_out, c_out, B, D, H, s);
}
