// Schedules of the heads' bf16 first pass (vocab_head_tma.cuh) for
// head_bench.py --plans, which compiles this file once a plan, in parallel:
//   nvcc <the package's flags> -shared -I<package>/csrc -DPLAN=<n> ...
// Each library exports bench_partials: the first pass alone (no merge) of
// plan PLAN with a top-KK list, KK 1 or 2, on the caller's stream; it
// returns a cudaError_t.  Not part of the package: the heads run TmaHead.
//   0-6   the package's kernel under TmaPlan schedules;
//   7, 8  ping-pong (pingpong_partials below), 256- and 128-deep stages;
//   9, 10 m64n128 accumulator sets (wide_partials below): 128-deep stages
//         one step ahead, 64-deep stages two steps ahead.
// Plans 7-10 give the same partials as the package's pass, up to the
// rounding of one more log-sum-exp merge in the ping-pong.
#include <type_traits>

#include "vocab_head_tma.cuh"

#ifndef PLAN
#define PLAN 0
#endif

namespace {

// wgmma m64n128k16, bf16 in, f32 accumulators (64 a thread); A K-major, B
// MN-major, as cic::wgmma_m64n64k16.
#define CIC_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : CIC_ACC8(0), CIC_ACC8(8), CIC_ACC8(16), CIC_ACC8(24), CIC_ACC8(32),
        CIC_ACC8(40), CIC_ACC8(48), CIC_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef CIC_ACC8

// Named barriers of 256 threads (the two consumer warpgroups; 0 is
// __syncthreads): one side arrives, the other waits.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// The layout both plans share: 1024 bytes of slack, the block's h rows
// [128 x H] resident (boxes of [128 rows x 64 k]), a ring of `stages`
// stages of `stage_bytes`, a full and an empty barrier a stage, and one
// barrier for h.
inline int bench_stages(int h_bytes, int stage_bytes) {
  const int fit = (kTmaBlockSmem - 1024 - 16 - h_bytes) / (stage_bytes + 16);
  return fit < kTmaMaxStages ? fit : kTmaMaxStages;
}

// (b) Ping-pong: consumer warpgroup w takes column tiles w, w + 2, ...
// of 64 columns, each for all 128 rows (two m64n64k16 a k16 slice into
// 64 accumulators a thread), and keeps the state of the thread's four rows
// over the split.  Named barriers order the warpgroups' products: a
// warpgroup issues tile t's after the other has issued tile t - 1's, then
// waits for them and folds tile t while the other's products run.  The
// ring is the package's (stages of [KS k x 64 columns], full and empty
// barriers, one producer thread); h arrives whole on a barrier of its own
// (both warpgroups need every k block from their first tile).  At the end
// warpgroup 1 hands its rows' state through shared memory to warpgroup 0,
// which merges it (log-sum-exp pairwise, lists by pushes) and writes the
// partials.
template <int KK, int KS>
__global__ void __launch_bounds__(kTmaThreads, 1)
pingpong_partials(const __grid_constant__ CUtensorMap map_h,
                  const __grid_constant__ CUtensorMap map_w,
                  const __nv_bfloat16* __restrict__ b,
                  float* __restrict__ part_val, int* __restrict__ part_id,
                  float* __restrict__ part_m, float* __restrict__ part_s,
                  int R, int H, int V, int splits, int split_cols,
                  int stages) {
  constexpr int NA = kTmaCols / 2;
  constexpr int kStageBytes = KS * 128;
  constexpr int kHBoxes = KS / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cic::smem_u32(smem_raw);
  const uint32_t hs = (raw + 1023u) & ~1023u;
  const int ksteps = (H + KS - 1) / KS;
  const uint32_t ring = hs + ksteps * kHBoxes * kTmaHBoxBytes;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring_ptr + (size_t)stages * kStageBytes);
  uint64_t* empty = full + stages;
  uint64_t* hbar = empty + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = blockIdx.x * kTmaRows;
  const int split = blockIdx.y;
  const int c_begin = split * split_cols;
  const int c_end = min(V, c_begin + split_cols);
  const int tiles = (c_end - c_begin + kTmaCols - 1) / kTmaCols;
  const int total = tiles * ksteps;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      cic::mbar_init(full + s, 1);
      cic::mbar_init(empty + s, 4);  // one arrival a warp of a warpgroup
    }
    cic::mbar_init(hbar, 1);
    cic::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    cic::setmaxnreg_dec<kTmaProducerRegs>();
    if (tid == 256) {
      cic::mbar_expect_tx(hbar, ksteps * kHBoxes * kTmaHBoxBytes);
      for (int i = 0; i < ksteps * kHBoxes; ++i)
        cic::tma_load_2d(hs + i * kTmaHBoxBytes, &map_h, 64 * i, r0, hbar);
      int s = 0, t = 0, kb = 0;
      uint32_t phase = 0;
      for (int g = 0; g < total; ++g) {
        if (g >= stages) cic::mbar_wait_or_trap(empty + s, phase ^ 1u);
        cic::mbar_expect_tx(full + s, kStageBytes);
        cic::tma_load_2d(ring + s * kStageBytes, &map_w,
                         c_begin + t * kTmaCols, kb * KS, full + s);
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
  const int lt = tid & 127;
  // the thread's rows: r0 + 64 p + 16 (warp % 4) + lane / 4 (+ 8)
  const int row_base = r0 + 16 * (warp & 3) + (lane >> 2);
  float tv[2][2][KK];
  int ti[2][2][KK];
  float m[2][2], s[2][2];
  float thv[2];
  int thi[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    row_state_init<KK, false>(tv[p], ti[p], m[p], s[p], thv, thi,
                              row_base + 64 * p, R, nullptr, nullptr);
  float acc[2][NA];
  cic::mbar_wait_or_trap(hbar, 0);

  for (int t = wg; t < tiles; t += 2) {
    if (t >= 2 || wg == 1) named_sync(2 + wg);  // the other issued t - 1
    int g = t * ksteps;
    for (int kb = 0; kb < ksteps; ++kb, ++g) {
      const int st_i = g % stages;
      cic::mbar_wait_or_trap(full + st_i, (g / stages) & 1u);
      const uint32_t st = ring + st_i * kStageBytes;
      cic::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const int k = kb * KS + 16 * kk;
        const uint64_t db = cic::mma_desc(st + kk * 2048, kStageBytes, 1024);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t a =
              hs + p * 64 * 128 + (k >> 6) * kTmaHBoxBytes + (k & 63) * 2;
          cic::wgmma_m64n64k16(acc[p], cic::mma_desc(a, 16, 1024), db,
                               (kb | kk) != 0);
        }
      }
      cic::wgmma_commit();
      cic::wgmma_wait<1>();
      if (kb > 0 && lane == 0) cic::mbar_arrive(empty + (g - 1) % stages);
    }
    if (t + 1 < tiles) named_arrive(3 - wg);  // the other may issue t + 1
    cic::wgmma_wait<0>();
    if (lane == 0) cic::mbar_arrive(empty + (g - 1) % stages);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(acc[p][i])::"memory");
      fold_tma<KK, false>(acc[p], b, c_begin + t * kTmaCols + 2 * (lane & 3),
                          V, tv[p], ti[p], m[p], s[p], thv, thi);
    }
  }

  // warpgroup 1's state into the ring (both are done with it), then merged
  // by the thread of warpgroup 0 that holds the same rows
  float* xs = reinterpret_cast<float*>(ring_ptr);
  constexpr int kF = 2 * KK + 2;  // floats a row
  named_sync(1);
  if (wg == 1) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* o = xs + ((p * 2 + hf) * kF) * 128 + lt;
        o[0] = m[p][hf];
        o[128] = s[p][hf];
#pragma unroll
        for (int j = 0; j < KK; ++j) {
          o[(2 + j) * 128] = tv[p][hf][j];
          o[(2 + KK + j) * 128] = __int_as_float(ti[p][hf][j]);
        }
      }
  }
  named_sync(1);
  if (wg == 1) return;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* o = xs + ((p * 2 + hf) * kF) * 128 + lt;
      cic::lse_merge(m[p][hf], s[p][hf], o[0], o[128]);
#pragma unroll
      for (int j = 0; j < KK; ++j) {
        const float v = o[(2 + j) * 128];
        const int i = __float_as_int(o[(2 + KK + j) * 128]);
        if (cic::before(v, i, tv[p][hf][KK - 1], ti[p][hf][KK - 1]))
          topk_push<KK>(tv[p][hf], ti[p][hf], v, i);
      }
    }
    write_quad_partials<KK>(tv[p], ti[p], m[p], s[p], row_base + 64 * p, R,
                            lane, splits, split, part_val, part_id, part_m,
                            part_s);
  }
}

// (c) Column tiles of 128: each consumer warpgroup keeps its 64 rows, as
// the package's pass does, with two m64n128 accumulator sets (64 registers
// each) in turn, tile t - 1 folded (two halves of 64 columns) beside tile
// t's first AHEAD steps.  A stage is [KS k x 128 columns]: two boxes of 64
// columns, one after the other (the descriptor's leading byte offset).
template <int KK, int KS, int AHEAD>
__global__ void __launch_bounds__(kTmaThreads, 1)
wide_partials(const __grid_constant__ CUtensorMap map_h,
              const __grid_constant__ CUtensorMap map_w,
              const __nv_bfloat16* __restrict__ b,
              float* __restrict__ part_val, int* __restrict__ part_id,
              float* __restrict__ part_m, float* __restrict__ part_s, int R,
              int H, int V, int splits, int split_cols, int stages) {
  constexpr int kCols = 128;
  constexpr int NA = kCols / 2;
  constexpr int kBoxBytes = KS * 128;
  constexpr int kStageBytes = 2 * kBoxBytes;
  constexpr int kHBoxes = KS / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cic::smem_u32(smem_raw);
  const uint32_t hs = (raw + 1023u) & ~1023u;
  const int ksteps = (H + KS - 1) / KS;
  const uint32_t ring = hs + ksteps * kHBoxes * kTmaHBoxBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (ring - raw) +
                                               (size_t)stages * kStageBytes);
  uint64_t* empty = full + stages;
  uint64_t* hbar = empty + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = blockIdx.x * kTmaRows;
  const int split = blockIdx.y;
  const int c_begin = split * split_cols;
  const int c_end = min(V, c_begin + split_cols);
  const int tiles = (c_end - c_begin + kCols - 1) / kCols;
  const int total = tiles * ksteps;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      cic::mbar_init(full + s, 1);
      cic::mbar_init(empty + s, 8);
    }
    cic::mbar_init(hbar, 1);
    cic::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    cic::setmaxnreg_dec<kTmaProducerRegs>();
    if (tid == 256) {
      cic::mbar_expect_tx(hbar, ksteps * kHBoxes * kTmaHBoxBytes);
      for (int i = 0; i < ksteps * kHBoxes; ++i)
        cic::tma_load_2d(hs + i * kTmaHBoxBytes, &map_h, 64 * i, r0, hbar);
      int s = 0, t = 0, kb = 0;
      uint32_t phase = 0;
      for (int g = 0; g < total; ++g) {
        if (g >= stages) cic::mbar_wait_or_trap(empty + s, phase ^ 1u);
        cic::mbar_expect_tx(full + s, kStageBytes);
        const uint32_t st = ring + s * kStageBytes;
        const int c = c_begin + t * kCols;
        cic::tma_load_2d(st, &map_w, c, kb * KS, full + s);
        cic::tma_load_2d(st + kBoxBytes, &map_w, c + 64, kb * KS, full + s);
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
  const int row0 = r0 + 16 * warp + (lane >> 2);
  float tv[2][KK];
  int ti[2][KK];
  float m[2], s[2];
  float thv[2];
  int thi[2];
  row_state_init<KK, false>(tv, ti, m, s, thv, thi, row0, R, nullptr,
                            nullptr);
  float acc0[NA], acc1[NA];
  const uint32_t a_base = hs + wg * 64 * 128;
  int cs = 0, rs = 0, issued = 0, released = 0;
  uint32_t cphase = 0;
  cic::mbar_wait_or_trap(hbar, 0);

  auto issue = [&](float (&acc)[NA], int kb) {
    cic::mbar_wait_or_trap(full + cs, cphase);
    const uint32_t st = ring + cs * kStageBytes;
    cic::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const int k = kb * KS + 16 * kk;
      const uint32_t a = a_base + (k >> 6) * kTmaHBoxBytes + (k & 63) * 2;
      wgmma_m64n128k16(acc, cic::mma_desc(a, 16, 1024),
                       cic::mma_desc(st + kk * 2048, kBoxBytes, 1024),
                       (kb | kk) != 0);
    }
    cic::wgmma_commit();
    if (++cs == stages) {
      cs = 0;
      cphase ^= 1u;
    }
    ++issued;
  };
  auto release = [&](int n) {
    for (; released < issued - n; ++released) {
      if (lane == 0) cic::mbar_arrive(empty + rs);
      if (++rs == stages) rs = 0;
    }
  };
  auto fold = [&](float (&acc)[NA], int t) {
#pragma unroll
    for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
    for (int half = 0; half < 2; ++half)
      fold_tma<KK, false>(
          *reinterpret_cast<const float(*)[kTmaCols / 2]>(acc + 32 * half), b,
          c_begin + t * kCols + 64 * half + 2 * (lane & 3), V, tv, ti, m, s,
          thv, thi);
  };
  auto tile = [&](float (&cur)[NA], float (&prev)[NA], int t) {
#pragma unroll
    for (int kb = 0; kb < AHEAD; ++kb) issue(cur, kb);
    cic::wgmma_wait<AHEAD>();
    release(AHEAD);
    if (t > 0) fold(prev, t - 1);
    for (int kb = AHEAD; kb < ksteps; ++kb) {
      issue(cur, kb);
      cic::wgmma_wait<AHEAD>();
      release(AHEAD);
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
    fold(acc0, t);
  } else {
    cic::wgmma_wait<0>();
    fold(acc1, t - 1);
  }
  write_quad_partials<KK>(tv, ti, m, s, row0, R, lane, splits, split,
                          part_val, part_id, part_m, part_s);
}

// Launch one of the two kernels above: KS k a stage, `cols` columns a
// tile (64: ping-pong; 128: wide), W's boxes [KS k x 64 columns].
template <class Kernel>
int launch_bench(Kernel kernel, int ks, int cols, int min_stages,
                 const void* h, const void* w, const void* b,
                 float* part_val, int* part_id, float* part_m, float* part_s,
                 int R, int H, int V, int splits, int split_cols,
                 cudaStream_t stream) {
  if (H % 64 != 0 || H > kTmaMaxDepth || V % 8 != 0 ||
      split_cols % cols != 0 ||
      ((uintptr_t)h | (uintptr_t)w | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int ksteps = (H + ks - 1) / ks;
  const int h_bytes = ksteps * (ks / 64) * kTmaHBoxBytes;
  const int stage_bytes = ks * 2 * cols;
  const int stages = bench_stages(h_bytes, stage_bytes);
  if (stages < min_stages) return (int)cudaErrorInvalidValue;
  CUtensorMap map_h, map_w;
  if (!cic::encode_bf16_map(&map_h, h, R, H, 64, kTmaRows,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !tma_weight_maps.get(&map_w, w, H, V, 64, ks,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      1024 + (size_t)h_bytes + (size_t)stages * (stage_bytes + 16) + 16;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((R + kTmaRows - 1) / kTmaRows, splits), kTmaThreads, smem,
           stream>>>(map_h, map_w, static_cast<const __nv_bfloat16*>(b),
                     part_val, part_id, part_m, part_s, R, H, V, splits,
                     split_cols, stages);
  return (int)cudaGetLastError();
}

template <int KK>
int bench_launch(const void* h, const void* w, const void* b, float* pv,
                 int* pi, float* pm, float* ps, int R, int H, int V,
                 int splits, int split_cols, cudaStream_t s) {
#if PLAN <= 6
  using P = std::conditional_t<
      PLAN == 0, TmaHead<KK>,
      std::conditional_t<
          PLAN == 1, TmaPlan<128, 2, 2>,
          std::conditional_t<
              PLAN == 2, TmaPlan<128, 3, 2>,
              std::conditional_t<
                  PLAN == 3, TmaPlan<256, 1, 2>,
                  std::conditional_t<
                      PLAN == 4, TmaPlan<128, 2, 1>,
                      std::conditional_t<PLAN == 5, TmaPlan<64, 6, 2>,
                                         TmaPlan<256, 1, 1>>>>>>>;
  return launch_vocab_partials_tma<KK, false, P>(h, w, b, pv, pi, pm, ps, R,
                                                 H, V, splits, split_cols, s);
#elif PLAN <= 8
  constexpr int KS = PLAN == 7 ? 256 : 128;
  return launch_bench(pingpong_partials<KK, KS>, KS, kTmaCols, 2, h, w, b,
                      pv, pi, pm, ps, R, H, V, splits, split_cols, s);
#else
  constexpr int KS = PLAN == 9 ? 128 : 64;
  constexpr int AHEAD = PLAN == 9 ? 1 : 2;
  return launch_bench(wide_partials<KK, KS, AHEAD>, KS, 128, 2 * AHEAD, h, w,
                      b, pv, pi, pm, ps, R, H, V, splits, split_cols, s);
#endif
}

}  // namespace

CIC_EXPORT int bench_partials(int kk, const void* h, const void* w,
                              const void* b, void* part_val, void* part_id,
                              void* part_m, void* part_s, int R, int H, int V,
                              int splits, int split_cols, void* stream) {
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_id);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk == 1)
    return bench_launch<1>(h, w, b, pv, pi, pm, ps, R, H, V, splits,
                           split_cols, s);
  if (kk == 2)
    return bench_launch<2>(h, w, b, pv, pi, pm, ps, R, H, V, splits,
                           split_cols, s);
  return (int)cudaErrorInvalidValue;
}
