// Fused maxout-LSTM cell in bfloat16 on wgmma (forward only): kernel F's
// bf16 pass, cell_wgmma_kernel.
//
// Replaces, for bf16, the Pallas kernel
//   cooperativeimagecaptioning_tpu/ops/pallas/cell_step.py::_cell_pallas
// and computes what cell_step.cu's kernels compute (see there): per row b
// and hidden column j the five gate sums of xt Wi + bi + h Wh + bh (+ att Wc
// + bc on gates 3 and 4), f32 accumulation, then i, f, o = sigmoid, g =
// max(s3, s4), c' = f c + i g, h' = o tanh(c'), written in bf16.
//
// What bounds it on the H100: operations, 2*B*(D*5H + H*5H + H*2H) = 3.2
// GFLOP at B=512 (D = H = 512), 0.0033 ms at 989 TFLOP/s, over 6.3 MB of
// weights and 3 kB of inputs a row.  What holds it back in practice is the
// traffic from L2: every block reads its rows once and the weights of its j
// once, so a tile of R rows x J j reads, over a grid of ceil(B/R) x H/J
// blocks, the rows H/J times and the weights ceil(B/R) times:
//     B      R x J     blocks   rows from L2   weights from L2   total
//     512    64 x 32     128       25.2 MB         50.3 MB        75.5 MB
//     512    64 x 64      64       12.6            50.3           62.9
//     512   128 x 32      64       25.2            25.2           50.3
//     1024   64 x 32     256       50.3           101            151
//     1024  128 x 32     128       50.3            50.3          101
//     4096   64 x 32    1024      201             403            604
//     4096  128 x 32     512      201             201            403
//     4096  128 x 64     256      101             201            302
// Measured on the H100 (cell_bench.py, PERF.md PR 19), a block's time
// follows the bytes it takes in, ~0.3 us a ring stage plus the stage's
// bytes at ~60 GB/s an SM: at B=512 the 128 blocks of 64 x 32 beat the 64
// blocks of the larger tiles, which leave half the SMs idle; once 64 x 32
// needs more than one wave of the 132 SMs the 128-row tiles, which read the
// weights half as often, win.  The wrapper's `wgmma_tile` picks the tile so.
// 64-wide j tiles would read less again, but their 2 x 160 registers a
// thread (below) do not fit.  Two variants were measured and dropped: the
// weight tiles shared by a cluster of two blocks along the rows (TMA
// multicast, each block loading every other gate's tile into both) was
// 1.5x slower, and the rows' fragments in registers (wgmma's A from
// registers, loaded once a slice for all five gates) was no faster at 64
// rows and spilled at 128.
//
// Design.
//   * A block is WG consumer warpgroups (64 rows each) and one producer
//     warpgroup.  It owns R = 64 WG rows x 32 hidden columns j with all five
//     gates of those j: for gate g the columns g H + j0 .. + 32 of each Wi
//     / Wh row (Wc: gates 3 and 4, columns (g - 3) H + j0).
//   * The reduction walks xt Wi, h Wh and (with attention) att Wc as one
//     sequence of 64-deep steps.  Each step's tiles go through a ring of
//     shared-memory stages filled by TMA (cp.async.bulk.tensor): the rows'
//     [R x 64 k] tile, K-major with the 128-byte swizzle, and one [64 k x
//     32 j] tile a gate, MN-major with the 64-byte swizzle, straight from W
//     as it lies ([K, 5H] row-major; no transposed copy).  Rows past B and
//     k past D or H arrive as zeros (TMA's out-of-bounds fill), so any B
//     takes the kernel.  One thread of the producer waits for a stage to be
//     empty, announces its bytes on the stage's `full` barrier and issues
//     the 1 + 5 (or 1 + 2) loads; the ring has as many stages as fit the
//     227 KB of a block (8 or 6), so the loads run that far ahead of the
//     products.
//   * A consumer warpgroup waits for the stage and issues, for each 16-deep
//     slice and each gate, one wgmma.mma_async m64n32k16 (bf16 in, f32 out)
//     into that gate's stage partial (from zero at the first slice): five
//     partial sets with one fragment layout.  It waits for them, releases
//     the stage on its `empty` barrier and adds the partials to its totals
//     in f32, rounding to nearest.  The tensor cores round a sum toward
//     zero at its accumulator's scale; summed over all 1536 k in their
//     accumulators, that bias put one bf16 output in a million a rounding
//     step (1/32 at |c'| >= 4) off the plain version, while 64-deep
//     partials keep it at a 64-deep sum's scale, as the mma.sync kernel
//     this one replaced kept its partials.
//     The attention product's steps feed gates 3 and 4 only.
//   * While one warpgroup adds, the other's products run, and the loads of
//     later steps stay in flight throughout.
//   * The partials and totals are 2 x 80 registers a thread.  With two
//     consumer warpgroups the producer's warpgroup gives registers back
//     (setmaxnreg 40) and the consumers take 232: ptxas then reports 168
//     registers and no spills, where a producer of one warp (288 threads)
//     spilled 32 bytes.
//   * A thread's partials and totals hold rows 16 w + lane / 4 (+ 8) of its
//     warp w of the warpgroup and, in every gate, the columns 8 i + 2 (lane
//     % 4) (+ 1) of each n8 block i: every gate of a (row, j) in one
//     thread, so the epilogue (biases, the gates, c', h') runs on the
//     registers and only h' and c' leave the SM.
//   * A barrier wait that lasts seconds (a fault of the tensor maps, which
//     would otherwise leave the warps spinning) traps: the launch fails
//     with an error instead of holding the card.
// The tensor maps of the three row inputs are encoded on every call (their
// addresses change from step to step); those of the weights are cached,
// keyed by every argument of the encoding (address, shape, box): a map
// holds no data, so an update of the weights in place leaves it right, and
// a new tensor at an old address with another shape gets a map of its own.
// The encoder is the driver's cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (hopper.cuh): nothing links libcuda.
#include <type_traits>

#include "cell_step.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kGates = cic::kCellGates;
constexpr int kWgmmaDepth = 64;     // k a ring stage: a 128-byte bf16 row
constexpr int kWgmmaRowsWg = 64;    // rows a consumer warpgroup
constexpr int kWgmmaCols = 32;      // j a block: a 64-byte bf16 weight row
constexpr int kWgmmaMaxStages = 8;
constexpr int kBlockSmem = 232448;  // the most a block may ask for
constexpr int kProducerRegs = 40;   // setmaxnreg with two consumers
constexpr int kConsumerRegs = 232;

// A block of WG consumer warpgroups (64 rows each) and a producer
// warpgroup.
template <int WG>
struct Tile {
  static constexpr int kRows = kWgmmaRowsWg * WG;
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr int kABytes = kRows * kWgmmaDepth * 2;      // [R x 64 k]
  static constexpr int kWBytes = kWgmmaDepth * kWgmmaCols * 2;  // [64 k x 32]
  static constexpr int kStageBytes = kABytes + kGates * kWBytes;
  // 1024 bytes to align the ring, and a full and an empty barrier a stage
  static constexpr int kFit = (kBlockSmem - 1024) / (kStageBytes + 16);
  static constexpr int kStages =
      kFit < kWgmmaMaxStages ? kFit : kWgmmaMaxStages;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + 16 * kStages;
};

static_assert(Tile<2>::kStages >= 3, "a ring of at least three stages");
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the registers of an SM");

using Acc = float[kGates][kWgmmaCols / 2];

// The products of one ring stage for gates G0..4 into `part`: for each
// 16-deep slice kk, the rows' A descriptor (K-major, 128-byte swizzle: 16 k
// are 32 bytes along a row, 8 rows 1024 bytes) and per gate its weight
// tile's B descriptor (MN-major, 64-byte swizzle: 16 k are 16 rows of 64
// bytes, 8 k one 512-byte swizzle atom); the first slice starts from zero.
template <int G0>
__device__ __forceinline__ void stage_products(Acc& part, uint32_t a0,
                                               uint32_t w0) {
  constexpr uint32_t kWBytes = kWgmmaDepth * kWgmmaCols * 2;
#pragma unroll
  for (int kk = 0; kk < kWgmmaDepth / 16; ++kk) {
    const uint64_t da = cic::mma_desc(a0 + kk * 32, 16, 1024);
#pragma unroll
    for (int g = G0; g < kGates; ++g)
      cic::wgmma_m64n32k16(
          part[g], da,
          cic::mma_desc(w0 + g * kWBytes + kk * 16 * (kWgmmaCols * 2),
                        kWBytes, 512, 2),
          kk != 0);
  }
}

template <int WG>
__global__ void __launch_bounds__(Tile<WG>::kThreads, 1)
cell_wgmma_kernel(const __grid_constant__ CUtensorMap map_xt,
                  const __grid_constant__ CUtensorMap map_h,
                  const __grid_constant__ CUtensorMap map_att,
                  const __grid_constant__ CUtensorMap map_wi,
                  const __grid_constant__ CUtensorMap map_wh,
                  const __grid_constant__ CUtensorMap map_wc,
                  const bf16* __restrict__ c, const bf16* __restrict__ bi,
                  const bf16* __restrict__ bh, const bf16* __restrict__ bc,
                  bf16* __restrict__ h_out, bf16* __restrict__ c_out, int B,
                  int D, int H) {
  using T = Tile<WG>;
  extern __shared__ uint8_t cell_wgmma_smem[];
  const uint32_t raw = cic::smem_u32(cell_wgmma_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      cell_wgmma_smem + (ring - raw) + (size_t)T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * T::kRows;
  const int j0 = blockIdx.x * kWgmmaCols;
  const int n0 = (D + kWgmmaDepth - 1) / kWgmmaDepth;
  const int n1 = (H + kWgmmaDepth - 1) / kWgmmaDepth;
  const int total = n0 + n1 + (bc != nullptr ? n1 : 0);

  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      cic::mbar_init(full + s, 1);
      cic::mbar_init(empty + s, 4 * WG);  // one arrival a consumer warp
    }
    cic::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * WG) {
    // the producer warpgroup: its first thread loads step t into stage
    // t % kStages once the stage's previous step (t - kStages) is released
    if constexpr (WG > 1) cic::setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * WG) {
      for (int t = 0; t < total; ++t) {
        const int s = t % T::kStages;
        if (t >= T::kStages)
          cic::mbar_wait_or_trap(empty + s, (t / T::kStages - 1) & 1);
        const CUtensorMap* ma = &map_xt;
        const CUtensorMap* mw = &map_wi;
        int k0 = t * kWgmmaDepth, g0 = 0;
        if (t >= n0 + n1) {
          ma = &map_att;
          mw = &map_wc;
          k0 = (t - n0 - n1) * kWgmmaDepth;
          g0 = 3;
        } else if (t >= n0) {
          ma = &map_h;
          mw = &map_wh;
          k0 = (t - n0) * kWgmmaDepth;
        }
        const uint32_t a_st = ring + s * T::kStageBytes;
        cic::mbar_expect_tx(full + s,
                            T::kABytes + (kGates - g0) * T::kWBytes);
        cic::tma_load_2d(a_st, ma, k0, m0, full + s);
        for (int g = g0; g < kGates; ++g)
          cic::tma_load_2d(a_st + T::kABytes + g * T::kWBytes, mw,
                           (g - g0) * H + j0, k0, full + s);
      }
    }
    return;
  }

  if constexpr (WG > 1) cic::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  Acc acc, part;
#pragma unroll
  for (int g = 0; g < kGates; ++g)
#pragma unroll
    for (int i = 0; i < kWgmmaCols / 2; ++i) acc[g][i] = part[g][i] = 0.0f;

  // step t: wait for its stage, its products into the partials, wait for
  // them, release the stage, add the partials to the totals
  auto step = [&](auto g0_const, int t) {
    constexpr int G0 = decltype(g0_const)::value;
    const int s = t % T::kStages;
    cic::mbar_wait_or_trap(full + s, (t / T::kStages) & 1);
    const uint32_t st = ring + s * T::kStageBytes;
    cic::wgmma_fence();
    stage_products<G0>(part, st + wg * (kWgmmaRowsWg * 128), st + T::kABytes);
    cic::wgmma_commit();
    cic::wgmma_wait<0>();
    if (lane == 0) cic::mbar_arrive(empty + s);
#pragma unroll
    for (int g = G0; g < kGates; ++g)
#pragma unroll
      for (int i = 0; i < kWgmmaCols / 2; ++i) acc[g][i] += part[g][i];
  };
  int t = 0;
  for (; t < n0 + n1; ++t) step(std::integral_constant<int, 0>{}, t);
  for (; t < total; ++t) step(std::integral_constant<int, 3>{}, t);

  // epilogue: acc[g][4 i + 2 hf + e] is row row0 + 8 hf, column j + e of
  // gate g (j = j0 + 8 i + 2 (lane % 4))
  const int row0 = m0 + wg * kWgmmaRowsWg + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < kWgmmaCols / 8; ++i) {
    const int j = j0 + 8 * i + 2 * (lane & 3);
    if (j >= H) continue;  // H is even: j + 1 < H too
    float bias[2][kGates];
    cic::gate_bias(bi, bh, bc, H, j, bias[0]);
    cic::gate_bias(bi, bh, bc, H, j + 1, bias[1]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 8 * hf;
      if (row >= B) continue;
      const size_t o = (size_t)row * H + j;
      const float2 cv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(c + o));
      bf16 hn[2], cn[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[kGates];
#pragma unroll
        for (int g = 0; g < kGates; ++g)
          x[g] = acc[g][4 * i + 2 * hf + e] + bias[e][g];
        cic::cell_out(x, e ? cv.y : cv.x, &hn[e], &cn[e]);
      }
      *reinterpret_cast<__nv_bfloat162*>(h_out + o) =
          __halves2bfloat162(hn[0], hn[1]);
      *reinterpret_cast<__nv_bfloat162*>(c_out + o) =
          __halves2bfloat162(cn[0], cn[1]);
    }
  }
}

// --- tensor maps -----------------------------------------------------------

// A row input [B, K]: boxes of rows x 64 k, 128-byte swizzle.
bool rows_map(CUtensorMap* map, const void* p, int B, int K, int rows) {
  return cic::encode_bf16_map(map, p, B, K, kWgmmaDepth, rows,
                              CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

cic::WeightMaps weight_maps;

// A weight [K, N]: boxes of 64 k x 32 columns, 64-byte swizzle; from the
// cache when a map of the same arguments was encoded.
bool weight_map(CUtensorMap* map, const void* p, int K, int N) {
  return weight_maps.get(map, p, K, N, kWgmmaCols, kWgmmaDepth,
                         CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

template <int WG>
int launch(const void* xt, const void* h, const void* c, const void* att,
           const void* wi, const void* bi, const void* wh, const void* bh,
           const void* wc, const void* bc, void* h_out, void* c_out, int B,
           int D, int H, cudaStream_t stream) {
  using T = Tile<WG>;
  CUtensorMap m_xt, m_h, m_att, m_wi, m_wh, m_wc;
  if (!rows_map(&m_xt, xt, B, D, T::kRows) ||
      !rows_map(&m_h, h, B, H, T::kRows) ||
      !weight_map(&m_wi, wi, D, kGates * H) ||
      !weight_map(&m_wh, wh, H, kGates * H))
    return (int)cudaErrorInvalidValue;
  if (att != nullptr) {
    if (!rows_map(&m_att, att, B, H, T::kRows) ||
        !weight_map(&m_wc, wc, H, 2 * H))
      return (int)cudaErrorInvalidValue;
  } else {  // not read: the FC cell has no third product
    m_att = m_h;
    m_wc = m_wh;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      cell_wgmma_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H + kWgmmaCols - 1) / kWgmmaCols,
                  (B + T::kRows - 1) / T::kRows);
  cell_wgmma_kernel<WG><<<grid, T::kThreads, T::kSmem, stream>>>(
      m_xt, m_h, m_att, m_wi, m_wh, m_wc, static_cast<const bf16*>(c),
      static_cast<const bf16*>(bi), static_cast<const bf16*>(bh),
      static_cast<const bf16*>(bc), static_cast<bf16*>(h_out),
      static_cast<bf16*>(c_out), B, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

int cic::cell_wgmma(const void* xt, const void* h, const void* c,
                    const void* att, const void* wi, const void* bi,
                    const void* wh, const void* bh, const void* wc,
                    const void* bc, void* h_out, void* c_out, int B, int D,
                    int H, int rows, int cols, cudaStream_t stream) {
  if (cols != kWgmmaCols) return (int)cudaErrorInvalidValue;
  if (rows == kWgmmaRowsWg)
    return launch<1>(xt, h, c, att, wi, bi, wh, bh, wc, bc, h_out, c_out, B,
                     D, H, stream);
  if (rows == 2 * kWgmmaRowsWg)
    return launch<2>(xt, h, c, att, wi, bi, wh, bh, wc, bc, h_out, c_out, B,
                     D, H, stream);
  return (int)cudaErrorInvalidValue;
}
