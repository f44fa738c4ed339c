// Merge of the vocabulary-sharded heads (forward only): the model group's
// gathered per-shard records -> the global top-m and the global
// log-sum-exp, in one pass over the candidates.
//
// Replaces the merge lines of the JAX package's shard_map compositions
//   cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py::beam_head_sharded
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_sharded
// (beam_head.py:131-142: the offset of each shard's ids, lax.top_k over the
// gathered candidates, the log-sum-exp over the [n, R] shard partials; and
// logit_head.py:213, vals[:, 0] - lse); the per-shard top-m itself is
// kernel C (beam_head.cu) on the local vocabulary slice, which writes each
// row as one record so that the model group gathers one buffer a call.
//
// Input: records f32 [n, R, W], shard-major (block s is shard s's [R, W],
// as one all_gather along dim 0 leaves them).  A record is W 32-bit words:
// [vals m | local ids m (int32 bits) | lse], W = 2m + 1; in the argmax mode
// [val | local id], W = 2 (m = 1, no lse).  Modes:
//   beam    vals f32 [R, m], global idx int32 [R, m], lse f32 [R];
//   greedy  (m = 1) it int32 [R], lp = val - lse f32 [R] (the same lse and
//           the same f32 subtraction as the beam mode's outputs);
//   argmax  (m = 1) global ids int64 [R] (the categorical draw over the
//           slices, parallel/vocab.argmax).
// Order: lax.top_k's over the gathered candidates, the larger value first
// and the lower global id on an exact tie (cic::before); a NaN comes first,
// as in torch.sort, and -0.0 ties with +0.0.
//
// What bounds it on the H100: one launch.  At the (1, 2) evaluation's beam-2
// decode it reads R x 2 x 5 words (R = 256: 10 KB) and writes R x 5: the
// bytes take ~0.005 us, while an empty kernel launched the same way
// (cic_head_merge_floor, the floor) takes 0.0018-0.0022 ms a call of
// device time (H100 80GB HBM3 at 700 W; chip_smoke.py and
// head_merge_bench.py time both).  So the design removes every dependent
// step instead of trading bytes (1.2-1.4x the floor where n x m <= 32):
//   - all loads of a row are issued at once, one lane a candidate, and none
//     waits on a reduction (the shard lse words in the same step);
//   - a candidate's global id is its local id + shard x v_local;
//   - its rank is the number of the row's candidates that come before it,
//     compared as one 64-bit key (the value's order-preserving bits, then
//     the complement of the global id): a strict total order, since global
//     ids are distinct, so the ranks are a permutation and the candidate of
//     rank k < m is written at out[k] -- one pass, no rounds;
//   - the lse is a max and a sum of exp(l - max) over the row's n words,
//     with shuffles confined to the row's lanes.
// Rows of C = n x m <= 32 candidates (every mesh path: n = 2, m <= 5) take
// merge_small<G>: G = the power of two >= C lanes a row, 32 / G rows a warp
// (several rows a warp where C <= 16), G - 1 shuffles of the keys.  Longer
// rows take merge_large: a block of kLargeThreads a row; the candidates are
// staged in shared memory a tile of kLargeThreads at a time and each thread
// counts, for its candidate, those of every tile before it (C^2 /
// kLargeThreads compares a thread; a row longer than one tile re-reads its
// candidates from L2 once a tile of its own), the lse as streaming
// (max, sum) pairs merged across the block: any n and any m <= v_local.
#include <climits>

#include "common.cuh"

namespace {

enum Mode { kBeam = 0, kGreedy = 1, kArgmax = 2 };

constexpr int kSmallWarps = 4;      // warps a block of merge_small
constexpr int kLargeThreads = 128;  // threads a row (a block) of merge_large

// The candidate's place in cic::before order as one unsigned 64-bit key, a
// larger key first: the value's bits made order-preserving (-0.0 as +0.0,
// every NaN as one NaN above +inf), then the complement of the global id
// (0 <= g <= INT_MAX), so that the lower id of equal values comes first.
// Every candidate's key is above 0, the key of an empty lane.
__device__ __forceinline__ unsigned long long order_key(float v, int g) {
  unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  if (v != v) b = 0x7fc00000u;
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (unsigned)(~(unsigned)g);
}

// Word j of the row's gathered candidates: shard j / m's candidate j % m.
__device__ __forceinline__ void load_candidate(const float* __restrict__ rec,
                                               int row, int j, int R, int m,
                                               int W, int v_local, float& v,
                                               int& g) {
  const int s = j / m;
  const int k = j - s * m;
  const float* r = rec + ((size_t)s * R + row) * W;
  v = __ldg(r + k);
  g = __ldg(reinterpret_cast<const int*>(r) + m + k) + s * v_local;
}

// Writes the candidate of rank `rank` (< m) and, where `lse_lane`, the row's
// log-sum-exp; every output a single writer.
template <int kMode>
__device__ __forceinline__ void write_out(void* out0, void* out1, void* out2,
                                          int row, int m, int rank, float v,
                                          int g, bool lse_lane, float lse) {
  if (kMode == kBeam) {
    if (rank < m) {
      static_cast<float*>(out0)[(size_t)row * m + rank] = v;
      static_cast<int*>(out1)[(size_t)row * m + rank] = g;
    }
    if (lse_lane) static_cast<float*>(out2)[row] = lse;
  } else if (rank == 0) {
    if (kMode == kGreedy) {
      static_cast<int*>(out0)[row] = g;
      static_cast<float*>(out1)[row] = v - lse;
    } else {
      static_cast<long long*>(out0)[row] = g;
    }
  }
}

template <int G, int kMode>
__global__ void __launch_bounds__(32 * kSmallWarps)
    merge_small(const float* __restrict__ rec, void* out0, void* out1,
                void* out2, int R, int n, int m, int v_local) {
  constexpr bool kLse = kMode != kArgmax;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // the lane's place in its row
  const int row =
      (blockIdx.x * kSmallWarps + (threadIdx.x >> 5)) * (32 / G) + lane / G;
  const int W = 2 * m + (kLse ? 1 : 0);
  const bool in_row = row < R;
  const bool live = in_row && sub < n * m;
  // every load of the row, in one step
  float v = 0.0f, l = -CUDART_INF_F;
  int g = 0;
  if (live) load_candidate(rec, row, sub, R, m, W, v_local, v, g);
  const bool has_l = kLse && in_row && sub < n;
  if (has_l) l = __ldg(rec + ((size_t)sub * R + row) * W + 2 * m);
  // rank: the row's candidates before this one (no lane keeps rows apart:
  // the shuffles stay inside the G lanes of the row)
  const unsigned long long key = live ? order_key(v, g) : 0ull;
  int rank = 0;
#pragma unroll
  for (int t = 1; t < G; ++t)
    rank += __shfl_sync(cic::kFullMask, key, (sub + t) & (G - 1), G) > key;
  float lse = 0.0f;
  if (kLse) {
    float mx = l;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(cic::kFullMask, mx, off, G));
    float sum = has_l ? expf(l - mx) : 0.0f;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(cic::kFullMask, sum, off, G);
    lse = mx + logf(sum);  // the same bits on every lane of the row
  }
  if (live)
    write_out<kMode>(out0, out1, out2, row, m, rank, v, g, sub == 0, lse);
}

template <int kMode>
__global__ void __launch_bounds__(kLargeThreads)
    merge_large(const float* __restrict__ rec, void* out0, void* out1,
                void* out2, int R, int n, int m, int v_local) {
  constexpr bool kLse = kMode != kArgmax;
  constexpr int kWarps = kLargeThreads / 32;
  __shared__ unsigned long long tile[kLargeThreads];
  __shared__ float part_m[kWarps], part_s[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = n * m;
  const int W = 2 * m + (kLse ? 1 : 0);
  // first the loads: this thread's first shard word and first candidate
  const float* lse_of = rec + (size_t)row * W + 2 * m;  // shard 0's word
  float l0 = -CUDART_INF_F;
  if (kLse && tid < n) l0 = __ldg(lse_of + (size_t)tid * R * W);
  float v = 0.0f;
  int g = 0;
  if (tid < C) load_candidate(rec, row, tid, R, m, W, v_local, v, g);
  float lse = 0.0f;
  if (kLse) {
    // streaming (max, sum) over this thread's shards (a shard's -inf adds
    // nothing), merged over the block
    float mx = -CUDART_INF_F, sum = 0.0f;
    if (l0 != -CUDART_INF_F) cic::lse_push(mx, sum, l0);
    for (int s = tid + kLargeThreads; s < n; s += kLargeThreads) {
      const float l = __ldg(lse_of + (size_t)s * R * W);
      if (l != -CUDART_INF_F) cic::lse_push(mx, sum, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(cic::kFullMask, mx, off);
      const float s2 = __shfl_xor_sync(cic::kFullMask, sum, off);
      cic::lse_merge(mx, sum, m2, s2);
    }
    if ((tid & 31) == 0) {
      part_m[tid >> 5] = mx;
      part_s[tid >> 5] = sum;
    }
    __syncthreads();
    mx = part_m[0];
    sum = part_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      cic::lse_merge(mx, sum, part_m[w], part_s[w]);
    lse = mx + logf(sum);
  }
  for (int base = 0; base < C; base += kLargeThreads) {
    const int j = base + tid;
    if (base > 0 && j < C) load_candidate(rec, row, j, R, m, W, v_local, v, g);
    const unsigned long long key = j < C ? order_key(v, g) : 0ull;
    int rank = 0;
    for (int t0 = 0; t0 < C; t0 += kLargeThreads) {
      unsigned long long other = key;  // this thread's own tile
      if (t0 != base) {
        other = 0ull;
        if (t0 + tid < C) {
          float ov;
          int og;
          load_candidate(rec, row, t0 + tid, R, m, W, v_local, ov, og);
          other = order_key(ov, og);
        }
      }
      __syncthreads();  // every thread has read the tile before
      tile[tid] = other;
      __syncthreads();
      const int cnt = min(kLargeThreads, C - t0);
      for (int i = 0; i < cnt; ++i) rank += tile[i] > key;
    }
    if (j < C)
      write_out<kMode>(out0, out1, out2, row, m, rank, v, g, j == 0, lse);
  }
}

// The lanes a row of C candidates takes in merge_small (a power of two), or
// 0 for merge_large.
int lanes_of(int C) {
  if (C > 32) return 0;
  int G = 1;
  while (G < C) G <<= 1;
  return G;
}

// The (grid, block) of a merge of R rows of C candidates: merge_small's
// 32 / G rows a warp, kSmallWarps warps a block, or merge_large's block a
// row.
void merge_grid(int R, int C, dim3& grid, dim3& block) {
  const int G = lanes_of(C);
  if (G == 0) {
    grid = dim3(R);
    block = dim3(kLargeThreads);
    return;
  }
  const int rows = kSmallWarps * (32 / G);
  grid = dim3((R + rows - 1) / rows);
  block = dim3(32 * kSmallWarps);
}

template <int kMode>
void launch_mode(const float* rec, void* o0, void* o1, void* o2, int R, int n,
                 int m, int v_local, cudaStream_t s) {
  dim3 grid, block;
  merge_grid(R, n * m, grid, block);
  switch (lanes_of(n * m)) {
#define CIC_LANES(G)                                                     \
  case G:                                                                \
    merge_small<G, kMode><<<grid, block, 0, s>>>(rec, o0, o1, o2, R, n, m, \
                                                 v_local);               \
    return;
    CIC_LANES(1)
    CIC_LANES(2)
    CIC_LANES(4)
    CIC_LANES(8)
    CIC_LANES(16)
    CIC_LANES(32)
#undef CIC_LANES
    default:
      merge_large<kMode><<<grid, block, 0, s>>>(rec, o0, o1, o2, R, n, m,
                                                v_local);
  }
}

// Nothing: the launch alone, as head_merge launches its kernel (the floor
// the merge is timed against).
__global__ void merge_floor(const float* rec, void* out0, void* out1,
                            void* out2, int R, int n, int m, int v_local) {}

bool valid_args(int R, int n, int m, int v_local, int mode) {
  return R >= 1 && n >= 1 && m >= 1 && v_local >= m &&
         (long long)n * v_local - 1 <= INT_MAX &&
         (long long)n * m <= INT_MAX && 2LL * m + 1 <= INT_MAX &&
         (mode == kBeam || (m == 1 && (mode == kGreedy || mode == kArgmax)));
}

}  // namespace

// rec: f32 [n, R, W] (W = 2m + 1; 2 in the argmax mode).  Outputs by mode:
// beam (0) out0 vals f32 [R, m], out1 idx int32 [R, m], out2 lse f32 [R];
// greedy (1) out0 it int32 [R], out1 lp f32 [R]; argmax (2) out0 ids int64
// [R].  Unused outputs may be NULL.
CIC_EXPORT int cic_head_merge(const void* rec, void* out0, void* out1,
                              void* out2, int R, int n, int m, int v_local,
                              int mode, void* stream) {
  if (!valid_args(R, n, m, v_local, mode)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rec);
  if (mode == kBeam)
    launch_mode<kBeam>(r, out0, out1, out2, R, n, m, v_local, s);
  else if (mode == kGreedy)
    launch_mode<kGreedy>(r, out0, out1, out2, R, n, m, v_local, s);
  else
    launch_mode<kArgmax>(r, out0, out1, out2, R, n, m, v_local, s);
  return (int)cudaGetLastError();
}

// An empty kernel on cic_head_merge's grid and block for the same
// arguments.
CIC_EXPORT int cic_head_merge_floor(const void* rec, void* out0, void* out1,
                                    void* out2, int R, int n, int m,
                                    int v_local, int mode, void* stream) {
  if (!valid_args(R, n, m, v_local, mode)) return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  merge_grid(R, n * m, grid, block);
  merge_floor<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), out0, out1, out2, R, n, m, v_local);
  return (int)cudaGetLastError();
}
