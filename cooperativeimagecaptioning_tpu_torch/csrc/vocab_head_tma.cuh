// Tensor-core first pass of the two vocabulary heads, for bfloat16 inputs:
// vocab_partials_tma (instantiated in logit_head_tma.cu and
// beam_head_tma.cu).
//
// It replaces, for bf16, the bodies of the Pallas kernels
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas
//   cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py::greedy_head_pallas_resident
//   cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py::beam_head_pallas
// (and, on a vocab slice, the per-shard kernel of beam_head_sharded and
// greedy_head_sharded), which compute logits = h @ W + b ([R,H] x [H,V],
// f32 accumulation) in their own bodies and reduce each row without writing
// the [R,V] logits.
//
// What bounds it on the H100: operations, 2*R*H*V = 5.0 / 9.9 / 39.8 / 79.6
// GFLOP at R = 512 / 1024 / 4096 / 8192 (H=512, V=9488), against 9.7 MB of
// W.  In practice L2 does: a block owns 128 rows and one vocab split, keeps
// its rows resident and streams the split's W once, so over the grid
// (`mma_split`: splits in units of 128 columns, one wave of the 132 SMs)
//     R      row tiles x splits   a block takes in         all blocks
//     512        4 x 25 = 100     128 KB h + 384 KB W        52.0 MB
//     1024       8 x 15 = 120     128 KB + 640 KB            93.5 MB
//     4096      32 x  4 = 128     128 KB + 2432 KB          327.7 MB
//     8192      64 x  2 = 128     128 KB + 4864 KB          638.6 MB
// in 12 / 20 / 76 / 152 ring stages of 32 KB (the h rows arrive with the
// first tile's stages).  A block's products alone take 42.5 us at R=4096
// (128 x 2432 x 512 x 2 operations at 989/132 TFLOP/s an SM); the loads
// alone, with no product or fold, 35 us (327.7 MB from L2 at ~9.4 TB/s;
// head_bench.py's probes, PERF.md).  Splits in 64-column units would
// put 120 blocks on the card at R=512, but read h 30 times instead of 25
// (54.6 MB).
//
// Design (a TMA ring, a producer warpgroup, consumers on wgmma).
//   * A block is two consumer warpgroups (64 rows each) and one producer
//     warpgroup, which gives its registers back (setmaxnreg).  The
//     producer's first thread issues every copy, by TMA
//     (cp.async.bulk.tensor): the block's h rows [128 x H] as boxes of [128
//     rows x 64 k] (K-major, 128-byte swizzle), which stay resident; and W
//     through a ring of stages of [256 k x 64 columns] (128 k where H > 512
//     leaves too little room), as W lies ([H, V], V contiguous: MN-major,
//     128-byte swizzle, read by wgmma through the transposed-B form of the
//     descriptor; no transposed copy of W exists anywhere).  Rows >= R, k
//     >= H and columns >= V arrive as zeros (TMA's out-of-bounds fill).
//     The h boxes of a ring step arrive on the full barrier of the first
//     tile's stage, so the first products start before all of h is in.
//   * Each stage has a full barrier (the producer's expect_tx and the
//     copies' bytes) and an empty barrier (one arrival a consumer warp).
//     The producer refills a stage once its empty barrier completes: no
//     block-wide barrier, and the loads run as many stages ahead as the
//     ring holds (3 at H=512: the ring takes what the resident rows leave
//     of the 227 KB).
//   * A consumer warpgroup issues, per stage, sixteen wgmma.mma_async
//     m64n64k16 (bf16 in, f32 accumulators in registers), k16 slices in
//     ascending k into one accumulator set, from zero at a tile's first
//     slice, so the f32 logits do not depend on the schedule.  It keeps
//     kTmaAhead steps in flight behind the one just issued and releases
//     each stage as its products complete.
//   * Lists of up to 4: two accumulator sets of 32 registers alternate by
//     column tile.  Tile t's first kTmaAhead steps are issued in straight
//     code, one wgmma_wait<kTmaAhead> leaves only them in flight, and the
//     epilogue of tile t - 1 runs beside them (fold_tma: fold_tile's
//     arithmetic, with the bias, the columns >= V masked, one rescale of
//     the streaming log-sum-exp a tile; see there for its pushes).  A fold
//     placed by a runtime step count overlapped nothing (ptxas cannot count
//     the groups in flight there), nor did one spread over the next tile's
//     steps.  Lists of 8 and 16 fold each tile after its products: their
//     lists take the second set's registers (ptxas holds every thread to
//     the launch's 168, setmaxnreg or not).
//   * The fold reads its accumulator set and never writes it: an
//     instruction other than wgmma that writes an accumulator register
//     while products are in flight makes ptxas serialize every wgmma of
//     the kernel (its C7515).
//   * The accumulator layout is the split-TF32 pass's: a thread holds rows
//     16 w + lane/4 (+ 8) and columns 8 j + 2 (lane%4) + {0,1} of each
//     tile, with its rows' state in registers across the split; after the
//     last tile the quad merge by shuffles and pop-the-winner rounds
//     (write_quad_partials, vocab_head_epilogue.cuh) writes the (row,
//     split) partial in the FMA pass's format, for the heads' merge kernels
//     (logit_head.cu, beam_head.cu).
//   * A barrier wait that lasts seconds traps (mbar_wait_or_trap): the
//     launch fails with an error instead of holding the card.
// Ties go to the lower id at every level through cic::before.
// h's tensor map is encoded on every call; W's is cached, keyed by every
// argument of the encoding (cic::WeightMaps).
// Measured and not taken (PERF.md; head_bench.py --plans times the
// variants of head_bench_plans.cu): 64- and 128-deep stages (more steps,
// each with a fixed cost); two blocks of a cluster sharing W's stages by
// TMA multicast (2.5x slower); the two consumer warpgroups in ping-pong by
// column tile, each for all 128 rows (10% slower at R=4096); m64n128
// accumulator sets (416-576 bytes spilled, 7% slower at R=4096).
//
// Needs H % 64 == 0, H <= kTmaMaxDepth, V % 8 == 0, split_cols a multiple
// of the tile and 16-byte aligned h, W and b; the Python wrappers route
// every other bf16 shape to the FMA pass (vocab_head.cuh).
#pragma once

#include "hopper.cuh"
#include "vocab_head_epilogue.cuh"

namespace {

constexpr int kTmaRows = 128;        // rows a block: two warpgroups of 64
constexpr int kTmaCols = 64;         // columns a tile: one wgmma n
constexpr int kTmaBoxK = 64;         // k of an h box: H is a multiple
constexpr int kTmaDepth = 256;       // k a ring stage (128 where H > 512)
constexpr int kTmaAhead = 1;         // steps in flight during a fold
constexpr int kTmaMaxDepth = 640;    // largest H whose rows fit beside a ring
constexpr int kTmaMaxStages = 16;
constexpr int kTmaThreads = 384;     // two consumer warpgroups, a producer
constexpr int kTmaHBoxBytes = 16384;  // [128 rows x 64 k] bf16
constexpr int kTmaBlockSmem = 232448;  // the most a block may ask for
constexpr int kTmaProducerRegs = 40;  // setmaxnreg
constexpr int kTmaConsumerRegs = 232;

static_assert(2 * 128 * kTmaConsumerRegs + 128 * kTmaProducerRegs <= 65536,
              "the registers of an SM");

// A schedule of the pass: KS k a ring stage (a multiple of 64), AHEAD
// steps' products in flight behind the one just issued, SETS accumulator
// sets (2: tile t - 1 folded while tile t's first AHEAD steps' products
// run; 1: each tile folded after its products, none in flight).  The heads
// run TmaHead<KK>; head_bench.py times others.
template <int KS, int AHEAD, int SETS>
struct TmaPlan {
  static constexpr int kDepth = KS;
  static constexpr int kAhead = AHEAD;
  static constexpr int kSets = SETS;
  static constexpr int kStageBytes = KS * 128;  // [KS k x 64 columns]
  static constexpr int kHBoxes = KS / 64;       // h boxes a step
  static_assert(KS % 64 == 0 && AHEAD >= 1 && AHEAD <= 7, "a schedule");
  static_assert(SETS == 1 || SETS == 2, "one or two accumulator sets");
};
// Two sets for lists of up to 4; lists of 8 and 16 take the registers of
// the second set (ptxas holds every thread to the launch's 168 registers,
// setmaxnreg or not: two sets spilled at 8).
template <int KK>
using TmaHead = TmaPlan<kTmaDepth, kTmaAhead, KK <= 4 ? 2 : 1>;

// k blocks of a tile (ring steps), h boxes resident, stages of the ring and
// dynamic shared memory (1024 bytes of slack to align the boxes, the
// resident rows, the ring, a full and an empty barrier a stage) at depth H.
template <class P> __host__ __device__ int tma_steps(int H) {
  return (H + P::kDepth - 1) / P::kDepth;
}
template <class P> int tma_stages(int H) {
  const int rows = tma_steps<P>(H) * P::kHBoxes * kTmaHBoxBytes;
  const int fit = (kTmaBlockSmem - 1024 - rows) / (P::kStageBytes + 16);
  return fit < kTmaMaxStages ? fit : kTmaMaxStages;
}
template <class P> size_t tma_smem(int H) {
  return 1024 + (size_t)tma_steps<P>(H) * P::kHBoxes * kTmaHBoxBytes +
         (size_t)tma_stages<P>(H) * (P::kStageBytes + 16);
}

// fold_tile (vocab_head_epilogue.cuh) on a tile's accumulators, which it
// reads but never writes (an instruction other than wgmma that writes an
// accumulator register while products are in flight makes ptxas serialize
// every wgmma of the kernel: its C7515): the logits (bias added, columns
// >= c_end masked) into a copy once, then each row's tile maximum, the
// exponentials in four chains and one rescale of the log-sum-exp -- the
// same operations in the same order a row as fold_tile.  The pushes differ
// in order, not in result: a top-KK list under cic::before, a strict total
// order, ends the same whatever order its candidates come in.  fold_tile's
// pushes are a chain of compares, one logit after another, the longest
// part of its fold.  Here a logit is pushed only if it comes before the
// best last entry of the quad's four lists of its row -- each list holds
// KK of the row's logits, so no logit after that entry is among the row's
// top KK, and leaving it out changes no merged result; a warp none of
// whose rows' tile maximum comes before that entry pushes nothing; and a
// list of one or two takes the best one or two of the tile's logits,
// found by a tree of compares, in at most that many pushes.
template <int KK, bool THR>
__device__ __forceinline__ void fold_tma(const float (&acc)[kTmaCols / 2],
                                         const __nv_bfloat16* __restrict__ b,
                                         int cbase, int c_end,
                                         float (&tv)[2][KK], int (&ti)[2][KK],
                                         float (&m)[2], float (&s)[2],
                                         const float (&thv)[2],
                                         const int (&thi)[2]) {
  constexpr int NT = kTmaCols / 8;  // n8 blocks a tile
  float x[4 * NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = cbase + 8 * j;
    const float2 bv =
        col < c_end ? bias_pair(b, col) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[4 * j + q] = col < c_end ? acc[4 * j + q] + (q & 1 ? bv.y : bv.x)
                                 : -CUDART_INF_F;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float tm[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                   -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j)
      tm[j & 3] = fmaxf(tm[j & 3], fmaxf(x[4 * j + 2 * hf],
                                         x[4 * j + 2 * hf + 1]));
    const float tmax = fmaxf(fmaxf(tm[0], tm[1]), fmaxf(tm[2], tm[3]));
    if (tmax > -CUDART_INF_F) {
      const float mn = fmaxf(m[hf], tmax);
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sum[j & 3] += expf(x[4 * j + 2 * hf] - mn) +
                      expf(x[4 * j + 2 * hf + 1] - mn);
      s[hf] = s[hf] * expf(m[hf] - mn) +
              ((sum[0] + sum[1]) + (sum[2] + sum[3]));
      m[hf] = mn;
    }
    // the best last entry of the quad's four lists: no logit after it is
    // among the row's top KK
    float lv = tv[hf][KK - 1];
    int li = ti[hf][KK - 1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(cic::kFullMask, lv, off);
      const int oi = __shfl_xor_sync(cic::kFullMask, li, off);
      if (cic::before(ov, oi, lv, li)) {
        lv = ov;
        li = oi;
      }
    }
    if (!__any_sync(cic::kFullMask, !(tmax < lv))) continue;
    if constexpr (KK <= 2 && !THR) {
      // the tile's best two (x, col) in cic::before order: each n8
      // block's pair sorted, then the pairs merged in a tree
      float v1[NT], v2[NT];
      int i1[NT], i2[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float x0 = x[4 * j + 2 * hf], x1 = x[4 * j + 2 * hf + 1];
        const int c0 = cbase + 8 * j;
        const bool lead = cic::before(x0, c0, x1, c0 + 1);
        v1[j] = lead ? x0 : x1;
        i1[j] = lead ? c0 : c0 + 1;
        v2[j] = lead ? x1 : x0;
        i2[j] = lead ? c0 + 1 : c0;
      }
#pragma unroll
      for (int w = 1; w < NT; w *= 2) {
#pragma unroll
        for (int q = 0; q + w < NT; q += 2 * w) {
          const bool a = cic::before(v1[q], i1[q], v1[q + w], i1[q + w]);
          // the second: the loser of the firsts against the winner's own
          // second
          const float loser_v = a ? v1[q + w] : v1[q];
          const int loser_i = a ? i1[q + w] : i1[q];
          const float next_v = a ? v2[q] : v2[q + w];
          const int next_i = a ? i2[q] : i2[q + w];
          const bool c = cic::before(next_v, next_i, loser_v, loser_i);
          v1[q] = a ? v1[q] : v1[q + w];
          i1[q] = a ? i1[q] : i1[q + w];
          v2[q] = c ? next_v : loser_v;
          i2[q] = c ? next_i : loser_i;
        }
      }
      if (i1[0] < c_end && cic::before(v1[0], i1[0], lv, li))
        topk_push<KK>(tv[hf], ti[hf], v1[0], i1[0]);
      if (KK == 2 && i2[0] < c_end && cic::before(v2[0], i2[0], lv, li))
        topk_push<KK>(tv[hf], ti[hf], v2[0], i2[0]);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cbase + 8 * j + e;
          const float xv = x[4 * j + 2 * hf + e];
          if (col < c_end && cic::before(xv, col, lv, li) &&
              cic::before(xv, col, tv[hf][KK - 1], ti[hf][KK - 1]) &&
              (!THR || cic::before(thv[hf], thi[hf], xv, col)))
            topk_push<KK>(tv[hf], ti[hf], xv, col);
        }
      }
    }
  }
}

// THR: a later round of the beam head, with per-row thresholds (a separate
// instantiation, so that every other launch compiles as it did without).
template <int KK, bool THR, class P>
__global__ void __launch_bounds__(kTmaThreads, 1)
vocab_partials_tma(const __grid_constant__ CUtensorMap map_h,
                   const __grid_constant__ CUtensorMap map_w,
                   const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ part_val, int* __restrict__ part_id,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   int R, int H, int V, int splits, int split_cols,
                   int stages, const float* __restrict__ thr_v,
                   const int* __restrict__ thr_i) {
  constexpr int NA = kTmaCols / 2;  // accumulators a thread a set
  extern __shared__ uint8_t tma_smem_raw[];
  const uint32_t raw = cic::smem_u32(tma_smem_raw);
  const uint32_t hs = (raw + 1023u) & ~1023u;  // resident h boxes
  const int ksteps = tma_steps<P>(H);
  const uint32_t ring = hs + ksteps * P::kHBoxes * kTmaHBoxBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      tma_smem_raw + (ring - raw) + (size_t)stages * P::kStageBytes);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = blockIdx.x * kTmaRows;
  const int split = blockIdx.y;
  const int c_begin = split * split_cols;
  const int c_end = min(V, c_begin + split_cols);
  const int tiles = (c_end - c_begin + kTmaCols - 1) / kTmaCols;
  // step g: k block g % ksteps of tile g / ksteps
  const int total = tiles * ksteps;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      cic::mbar_init(full + s, 1);
      cic::mbar_init(empty + s, 8);  // one arrival a consumer warp
    }
    cic::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer warpgroup: its first thread loads step g into stage
    // g % stages once the stage's previous step (g - stages) is released
    cic::setmaxnreg_dec<kTmaProducerRegs>();
    if (tid == 256) {
      int s = 0, t = 0, kb = 0;
      uint32_t phase = 0;
      for (int g = 0; g < total; ++g) {
        if (g >= stages) cic::mbar_wait_or_trap(empty + s, phase ^ 1u);
        cic::mbar_expect_tx(full + s, P::kStageBytes +
                                          (t == 0 ? P::kHBoxes * kTmaHBoxBytes
                                                  : 0));
        cic::tma_load_2d(ring + s * P::kStageBytes, &map_w,
                         c_begin + t * kTmaCols, kb * P::kDepth, full + s);
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < P::kHBoxes; ++i)
            cic::tma_load_2d(hs + (kb * P::kHBoxes + i) * kTmaHBoxBytes,
                             &map_h, kb * P::kDepth + 64 * i, r0, full + s);
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
        if (++kb == ksteps) {
          kb = 0;
          ++t;
        }
      }
    }
    return;
  }

  cic::setmaxnreg_inc<kTmaConsumerRegs>();
  const int wg = warp >> 2;
  // the thread's two rows: r0 + 16 * warp + lane / 4 (+ 8)
  const int row0 = r0 + 16 * warp + (lane >> 2);
  float tv[2][KK];
  int ti[2][KK];
  float m[2], s[2];
  float thv[2];  // THR: the thread's two rows' thresholds
  int thi[2];
  row_state_init<KK, THR>(tv, ti, m, s, thv, thi, row0, R, thr_v, thr_i);
  // from zero at a tile's first slice (wgmma's scale-d), so never set
  float acc0[NA], acc1[NA];

  const uint32_t a_base = hs + wg * 64 * 128;  // the warpgroup's 64 rows
  int cs = 0;            // the stage consumed next
  uint32_t cphase = 0;   // and the parity of its fill
  int rs = 0;            // the stage released next
  int issued = 0;        // steps issued
  int released = 0;      // steps released

  // Step kb of a tile into `acc`: wait for the stage, issue its products
  // (A: 16 k are 32 bytes along a swizzled 128-byte row of an h box, 8
  // rows 1024 bytes; B: 16 k are 16 rows of 128 bytes, 8 k 1024 bytes).
  auto issue = [&](float (&acc)[NA], int kb) {
    cic::mbar_wait_or_trap(full + cs, cphase);
    const uint32_t st = ring + cs * P::kStageBytes;
    cic::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::kDepth / 16; ++kk) {
      const int k = kb * P::kDepth + 16 * kk;
      const uint32_t a = a_base + (k >> 6) * kTmaHBoxBytes + (k & 63) * 2;
      cic::wgmma_m64n64k16(acc, cic::mma_desc(a, 16, 1024),
                           cic::mma_desc(st + kk * 2048, P::kStageBytes,
                                         1024),
                           (kb | kk) != 0);
    }
    cic::wgmma_commit();
    if (++cs == stages) {
      cs = 0;
      cphase ^= 1u;
    }
    ++issued;
  };
  // After a wgmma_wait<n>: release the stages of every step but the newest
  // n, in order.
  auto release = [&](int n) {
    for (; released < issued - n; ++released) {
      if (lane == 0) cic::mbar_arrive(empty + rs);
      if (++rs == stages) rs = 0;
    }
  };
  // The fold of tile t from `acc`, whose products are complete.
  auto fold_tile_of = [&](float (&acc)[NA], int t) {
#pragma unroll
    for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    fold_tma<KK, THR>(acc, b, c_begin + t * kTmaCols + 2 * (lane & 3), V, tv,
                      ti, m, s, thv, thi);
  };

  if constexpr (P::kSets == 1) {
    for (int t = 0; t < tiles; ++t) {
      for (int kb = 0; kb < ksteps; ++kb) {
        issue(acc0, kb);
        cic::wgmma_wait<P::kAhead>();
        release(P::kAhead);
      }
      cic::wgmma_wait<0>();
      release(0);
      fold_tile_of(acc0, t);
    }
  } else {
    // Tile t into one set while tile t - 1, in the other, is folded: tile
    // t's first kAhead steps are issued in straight-line code, one
    // wgmma_wait<kAhead> then leaves only them in flight (tile t - 1's
    // products are complete), and the fold runs beside them.  (A fold
    // placed by a runtime step count, after a wait that follows each step,
    // overlapped nothing: ptxas cannot count the groups in flight there.)
    // The launcher holds ksteps >= kAhead.
    auto tile = [&](float (&cur)[NA], float (&prev)[NA], int t) {
#pragma unroll
      for (int kb = 0; kb < P::kAhead; ++kb) issue(cur, kb);
      cic::wgmma_wait<P::kAhead>();
      release(P::kAhead);
      if (t > 0) fold_tile_of(prev, t - 1);
      for (int kb = P::kAhead; kb < ksteps; ++kb) {
        issue(cur, kb);
        cic::wgmma_wait<P::kAhead>();
        release(P::kAhead);
      }
    };
    int t = 0;
    for (; t + 1 < tiles; t += 2) {
      tile(acc0, acc1, t);
      tile(acc1, acc0, t + 1);
    }
    if (t < tiles) {
      tile(acc0, acc1, t);
      cic::wgmma_wait<0>();
      fold_tile_of(acc0, t);
    } else {
      cic::wgmma_wait<0>();
      fold_tile_of(acc1, t - 1);
    }
  }

  write_quad_partials<KK>(tv, ti, m, s, row0, R, lane, splits, split,
                          part_val, part_id, part_m, part_s);
}

cic::WeightMaps tma_weight_maps;

template <int KK, bool THR = false, class P = TmaHead<KK>>
int launch_vocab_partials_tma(const void* h, const void* w, const void* b,
                              float* part_val, int* part_id, float* part_m,
                              float* part_s, int R, int H, int V, int splits,
                              int split_cols, cudaStream_t stream,
                              const float* thr_v = nullptr,
                              const int* thr_i = nullptr) {
  if (H < kTmaBoxK || H % kTmaBoxK != 0 || H > kTmaMaxDepth || V % 8 != 0 ||
      split_cols % kTmaCols != 0 ||
      ((uintptr_t)h | (uintptr_t)w | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // The schedule has to fit the ring beside the rows: two sets hold up to
  // 2 kAhead stages unreleased before their wait and need kAhead steps a
  // tile, one set kAhead + 1 stages.  Otherwise stages of half the depth
  // (H > 512 at 256), then one set.
  const int stages = tma_stages<P>(H);
  if (P::kSets == 2 ? tma_steps<P>(H) < P::kAhead || stages < 2 * P::kAhead
                    : stages < P::kAhead + 2) {
    if constexpr (P::kDepth > 128)
      return launch_vocab_partials_tma<
          KK, THR, TmaPlan<P::kDepth / 2, P::kAhead, P::kSets>>(
          h, w, b, part_val, part_id, part_m, part_s, R, H, V, splits,
          split_cols, stream, thr_v, thr_i);
    else if constexpr (P::kSets == 2)
      return launch_vocab_partials_tma<
          KK, THR, TmaPlan<P::kDepth, P::kAhead, 1>>(
          h, w, b, part_val, part_id, part_m, part_s, R, H, V, splits,
          split_cols, stream, thr_v, thr_i);
    else
      return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map_h, map_w;
  if (!cic::encode_bf16_map(&map_h, h, R, H, 64, kTmaRows,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !tma_weight_maps.get(&map_w, w, H, V, 64, P::kDepth,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tma_smem<P>(H);
  const cudaError_t e = cudaFuncSetAttribute(
      vocab_partials_tma<KK, THR, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (R + kTmaRows - 1) / kTmaRows;
  vocab_partials_tma<KK, THR, P>
      <<<dim3(row_tiles, splits), kTmaThreads, smem, stream>>>(
          map_h, map_w, static_cast<const __nv_bfloat16*>(b), part_val,
          part_id, part_m, part_s, R, H, V, splits, split_cols, stages, thr_v,
          thr_i);
  return (int)cudaGetLastError();
}

}  // namespace
