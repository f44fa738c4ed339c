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
// What bounds it on the H100: the three products, 2*B*(D*5H + H*5H + H*2H)
// flops (0.8 GFLOP at B=128, H=D=512) over 12.6 MB of f32 weights that every
// row tile reads again from L2.  The plain version runs them as cuBLAS GEMMs
// and then writes the [B,5H] gate pre-activations and the [B,2H] a2c sum to
// device memory between its elementwise kernels; here they stay in
// registers and only h' and c' leave the SM.
//
// Design (simple first): one block of 128 threads owns kRows batch rows x
// kCols hidden columns j.  For each of the three products it walks the
// reduction in kDepth-deep steps, staging the input rows [kRows, kDepth] and
// the weight columns of every gate of its j's [kDepth, gates, kCols] in
// shared memory (float32), and each thread accumulates 4 rows x 5 gates of
// one column j in registers with CUDA-core FMAs.  The next step's tiles are
// loaded into registers while the current one computes (at B=128 there is
// one block of 4 warps per SM, so nothing else hides the load latency);
// kDepth = 16 keeps those 22 staged values and the 20 sums within 128
// registers, so four blocks fit on an SM at large B.  The gate epilogue
// then runs in registers.  No tensor cores, TMA or async copies yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;    // batch rows per block
constexpr int kCols = 32;    // hidden columns j per block
constexpr int kDepth = 16;   // reduction depth of one shared-memory step
constexpr int kGates = 5;    // i, f, o, and the two in-transform halves
constexpr int kRowGroups = kThreads / kCols;       // 4
constexpr int kRowsPerThread = kRows / kRowGroups;  // 4
constexpr int kMinBlocks = 4;  // blocks per SM the register budget allows
static_assert(kRows * kDepth % kThreads == 0 && kThreads % kDepth == 0 &&
                  kThreads % kCols == 0 && kDepth % kRowGroups == 0,
              "the tile loads split evenly over the threads");

struct Tiles {
  float a[kRows][kDepth + 1];
  float w[kDepth][kGates][kCols];
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One step's tiles, staged in registers.  Thread tid holds the inputs
// x[row0 + tid / kDepth + it * (kThreads / kDepth), k0 + tid % kDepth] in
// `a`, and the weights w[k0 + ty + m * kRowGroups, g * H + col0 + tx]
// (ty = tid / kCols, tx = tid % kCols) for every gate g < NG and
// m < kDepth / kRowGroups in `w`.  The weight loads of a tile are offsets
// from one pointer, so they need no address registers of their own.
template <int NG>
struct Staged {
  float a[kRows * kDepth / kThreads];
  float w[NG][kDepth / kRowGroups];
};

template <typename T, int NG>
__device__ __forceinline__ void load_tiles(
    const T* __restrict__ x, int K, const T* __restrict__ w, int ldw, int H,
    int B, int row0, int col0, int k0, Staged<NG>& st) {
  constexpr int kARows = kThreads / kDepth;  // input rows one pass loads
  const int tid = threadIdx.x;
  const int ar = tid / kDepth;
  const int ak = k0 + tid % kDepth;
#pragma unroll
  for (int it = 0; it < kRows * kDepth / kThreads; ++it) {
    const int row = row0 + ar + it * kARows;
    st.a[it] = (row < B && ak < K) ? cic::to_f32(x[(size_t)row * K + ak])
                                   : 0.0f;
  }
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  const bool col_ok = col0 + tx < H;
  const T* wp = w + (size_t)(k0 + ty) * ldw + col0 + tx;
#pragma unroll
  for (int m = 0; m < kDepth / kRowGroups; ++m) {
    const bool ok = col_ok && k0 + ty + m * kRowGroups < K;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      st.w[g][m] = ok ? cic::to_f32(wp[(size_t)m * kRowGroups * ldw +
                                       (size_t)g * H]) : 0.0f;
  }
}

// acc[r][G0 + g] += x[row r, :] . w[:, g*H + j] for g < NG, over K.
// Software-pipelined: the next step's tiles are loaded from device memory
// into registers while the current step computes from shared memory, so the
// load latency hides behind the FMAs.
template <typename T, int NG, int G0>
__device__ __forceinline__ void accumulate(
    const T* __restrict__ x, int K, const T* __restrict__ w, int ldw, int H,
    int B, int row0, int col0, Tiles& s,
    float (&acc)[kRowsPerThread][kGates]) {
  constexpr int kARows = kThreads / kDepth;
  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  Staged<NG> st;
  load_tiles<T, NG>(x, K, w, ldw, H, B, row0, col0, 0, st);
  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int it = 0; it < kRows * kDepth / kThreads; ++it)
      s.a[tid / kDepth + it * kARows][tid % kDepth] = st.a[it];
#pragma unroll
    for (int m = 0; m < kDepth / kRowGroups; ++m)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        s.w[ty + m * kRowGroups][g][tx] = st.w[g][m];
    __syncthreads();
    if (k0 + kDepth < K)
      load_tiles<T, NG>(x, K, w, ldw, H, B, row0, col0, k0 + kDepth, st);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        a[r] = s.a[ty + r * kRowGroups][kk];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float wv = s.w[kk][g][tx];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r][G0 + g] = fmaf(a[r], wv, acc[r][G0 + g]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cell_kernel(const T* __restrict__ xt, const T* __restrict__ h,
            const T* __restrict__ c, const T* __restrict__ att,
            const T* __restrict__ wi, const T* __restrict__ bi,
            const T* __restrict__ wh, const T* __restrict__ bh,
            const T* __restrict__ wc, const T* __restrict__ bc,
            T* __restrict__ h_out, T* __restrict__ c_out, int B, int D,
            int H) {
  __shared__ Tiles s;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  float acc[kRowsPerThread][kGates];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int g = 0; g < kGates; ++g) acc[r][g] = 0.0f;

  accumulate<T, kGates, 0>(xt, D, wi, kGates * H, H, B, row0, col0, s, acc);
  accumulate<T, kGates, 0>(h, H, wh, kGates * H, H, B, row0, col0, s, acc);
  if (att != nullptr)  // the same for the whole grid: no divergent barrier
    accumulate<T, 2, 3>(att, H, wc, 2 * H, H, B, row0, col0, s, acc);

  const int j = col0 + threadIdx.x % kCols;
  if (j >= H) return;
  const int ty = threadIdx.x / kCols;
  float bias[kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g)
    bias[g] = cic::to_f32(bi[g * H + j]) + cic::to_f32(bh[g * H + j]);
  if (att != nullptr) {
    bias[3] += cic::to_f32(bc[j]);
    bias[4] += cic::to_f32(bc[H + j]);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + ty + r * kRowGroups;
    if (row >= B) continue;
    const float ig = sigmoid(acc[r][0] + bias[0]);
    const float fg = sigmoid(acc[r][1] + bias[1]);
    const float og = sigmoid(acc[r][2] + bias[2]);
    const float gg = fmaxf(acc[r][3] + bias[3], acc[r][4] + bias[4]);
    const size_t o = (size_t)row * H + j;
    const float cn = fg * cic::to_f32(c[o]) + ig * gg;
    h_out[o] = cic::from_f32<T>(og * tanhf(cn));
    c_out[o] = cic::from_f32<T>(cn);
  }
}

template <typename T>
int launch(const void* xt, const void* h, const void* c, const void* att,
           const void* wi, const void* bi, const void* wh, const void* bh,
           const void* wc, const void* bc, void* h_out, void* c_out, int B,
           int D, int H, cudaStream_t stream) {
  const dim3 grid((H + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  cell_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xt), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(att),
      static_cast<const T*>(wi), static_cast<const T*>(bi),
      static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const T*>(wc), static_cast<const T*>(bc),
      static_cast<T*>(h_out), static_cast<T*>(c_out), B, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

// att, wc and bc are all NULL for the FC cell, or none of them.
CIC_EXPORT int cic_cell(const void* xt, const void* h, const void* c,
                        const void* att, const void* wi, const void* bi,
                        const void* wh, const void* bh, const void* wc,
                        const void* bc, void* h_out, void* c_out, int B,
                        int D, int H, int is_bf16, void* stream) {
  if (B < 1 || D < 1 || H < 1 || B > 65535 * kRows)
    return (int)cudaErrorInvalidValue;
  if ((att == nullptr) != (wc == nullptr) ||
      (att == nullptr) != (bc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(xt, h, c, att, wi, bi, wh, bh, wc, bc,
                                 h_out, c_out, B, D, H, s);
  return launch<float>(xt, h, c, att, wi, bi, wh, bh, wc, bc, h_out, c_out,
                       B, D, H, s);
}
