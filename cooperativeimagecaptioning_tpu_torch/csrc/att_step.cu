// Fused additive attention for one Att2in2 decode step (forward only), in
// three context layouts.
//
// Replaces the Pallas kernels of
//   cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:
//   _attention_pallas         b-major context   att_emb [B,K,H], p_att [B,K,A]
//   _attention_pallas_kmajor  K-major context   att_emb_t [K,B,H], p_att_t [K,B,A]
//   _attention_pallas_q       int8 context      emb_q, p_q int8 [B,K,*] with
//                                               f32 scales [B,K] per (row, slot)
// Per batch row b:
//   att_h  = h[b] @ W_h2att + b_h2att                              [A]
//   s[k]   = tanh(p_att[b,k] + att_h) . w_alpha + b_alpha          [K]
//   w      = softmax(s); with a mask: w = w * mask, w = w / sum(w)
//   out[b] = sum_k w[k] * att_emb[b,k]                             [H]
// The mask is applied after the softmax and the weights renormalized, as in
// the reference (not -inf masking); with no mask there is no renormalization.
// The mask is [B,K] in every layout.  The int8 kernel dequantizes in
// registers: p_att[b,k,a] = float(p_q[b,k,a]) * p_scale[b,k], and the scale
// of att_emb is folded into the weight after mask and renormalization
// (ws[k] = w[k] * emb_scale[b,k]; out = sum_k ws[k] * float(emb_q[b,k])).
//
// What bounds it on the H100: streaming the context.  Each step reads
// att_emb [B,K,H] and p_att [B,K,A] once -- at K=36, H=A=512 in bf16 that is
// 72 KiB per row, 37 MiB at B=512 (half of that in int8, plus 288 bytes of
// scales per row) -- against ~2*K*(H+A) flops per row for scores and output,
// far below the card's flop/byte balance.  The [B,A] x [A,H] product for
// att_h is small (W_h2att is 512 KiB in bf16 and stays in L2 across blocks).
//
// Design: one block of 256 threads owns kRows batch rows.  It computes their
// att_h into shared memory from W_h2att (an FMA loop, W read coalesced along
// A), then streams each (row, k) slot of p_att once with one warp per slot,
// keeping the [K] scores, the softmax and the mask in shared memory -- the
// [B,K,A] tanh intermediate never leaves the SM -- and finally streams
// att_emb once for the weighted sum.  K is a runtime argument up to kMaxK.
// The three kernels share the att_h and softmax stages; the b-major and
// K-major kernels are one template that differs only in where slot (b, k)
// lies ((b*K + k) against (k*B + b): in the K-major layout the kRows rows of
// a block are one contiguous chunk per slot), and the int8 kernel reads each
// slot with one 16-byte load per lane (16 values).
// Simple first: no TMA / async copies yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;    // batch rows per block
constexpr int kMaxK = 64;   // attention slots the softmax stage holds

struct BMajor {  // slot (b, k) of a [B, K, *] context
  static __device__ __forceinline__ size_t slot(int b, int k, int B, int K) {
    return (size_t)b * K + k;
  }
};
struct KMajor {  // slot (b, k) of a [K, B, *] context
  static __device__ __forceinline__ size_t slot(int b, int k, int B, int K) {
    return (size_t)k * B + b;
  }
};

// Shared memory of a block: hs [kRows,H], ah [kRows,A], was [A],
// sc [kRows,kMaxK].
inline size_t smem_floats(int H, int A) {
  return (size_t)kRows * H + (size_t)kRows * A + A + (size_t)kRows * kMaxK;
}

// att_h = h @ W_h2att + b_h2att for the block's rows, and w_alpha, into
// shared memory.  Ends with a barrier.
template <typename T>
__device__ __forceinline__ void block_att_h(
    const T* __restrict__ h, const T* __restrict__ wh,
    const T* __restrict__ bh, const T* __restrict__ wa, float* hs, float* ah,
    float* was, int b0, int B, int H, int A) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kRows * H; i += kThreads) {
    const int r = i / H;
    hs[i] = (b0 + r < B) ? cic::to_f32(h[(size_t)(b0 + r) * H + (i - r * H)])
                         : 0.0f;
  }
  for (int a = tid; a < A; a += kThreads) was[a] = cic::to_f32(wa[a]);
  __syncthreads();

  for (int a = tid; a < A; a += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float w = cic::to_f32(wh[(size_t)k * A + a]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
    }
    const float bias = cic::to_f32(bh[a]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) ah[r * A + a] = acc[r] + bias;
  }
  __syncthreads();
}

// softmax over K of the block's scores (then mask and renormalize, then the
// optional per-slot scale [B,K] of a quantized att_emb): one warp per row,
// in place.  Ends with a barrier.
__device__ __forceinline__ void block_softmax(
    float* sc, const float* __restrict__ mask,
    const float* __restrict__ scale, int b0, int B, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kWarps) {
    if (b0 + r >= B) continue;
    float* srow = sc + r * kMaxK;
    const int k0 = lane, k1 = lane + 32;
    const float s0 = k0 < K ? srow[k0] : -CUDART_INF_F;
    const float s1 = k1 < K ? srow[k1] : -CUDART_INF_F;
    const float mx = cic::warp_max(fmaxf(s0, s1));
    const float e0 = k0 < K ? expf(s0 - mx) : 0.0f;
    const float e1 = k1 < K ? expf(s1 - mx) : 0.0f;
    const float tot = cic::warp_sum(e0 + e1);
    float w0 = e0 / tot, w1 = e1 / tot;
    if (mask != nullptr) {
      const float* mrow = mask + (size_t)(b0 + r) * K;
      w0 = k0 < K ? w0 * mrow[k0] : 0.0f;
      w1 = k1 < K ? w1 * mrow[k1] : 0.0f;
      const float tot2 = cic::warp_sum(w0 + w1);
      w0 /= tot2;
      w1 /= tot2;
    }
    if (scale != nullptr) {
      const float* zrow = scale + (size_t)(b0 + r) * K;
      if (k0 < K) w0 *= zrow[k0];
      if (k1 < K) w1 *= zrow[k1];
    }
    if (k0 < K) srow[k0] = w0;
    if (k1 < K) srow[k1] = w1;
  }
  __syncthreads();
}

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ h, const T* __restrict__ emb,
                 const T* __restrict__ patt, const T* __restrict__ wh,
                 const T* __restrict__ bh, const T* __restrict__ wa,
                 const T* __restrict__ ba, const float* __restrict__ mask,
                 T* __restrict__ out, int B, int K, int H, int A) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;              // [kRows, H]   h rows (f32)
  float* ah = hs + kRows * H;    // [kRows, A]   att_h
  float* was = ah + kRows * A;   // [A]          w_alpha
  float* sc = was + A;           // [kRows, kMaxK] scores, then weights

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kRows;

  block_att_h(h, wh, bh, wa, hs, ah, was, b0, B, H, A);

  // scores: one warp per (row, slot); p_att streamed once
  const float b_alpha = cic::to_f32(ba[0]);
  for (int p = warp; p < kRows * K; p += kWarps) {
    const int r = p / K;
    const int k = p - r * K;
    if (b0 + r >= B) continue;
    const T* prow = patt + Layout::slot(b0 + r, k, B, K) * A;
    float s = 0.0f;
    for (int a = lane; a < A; a += 32)
      s = fmaf(tanhf(cic::to_f32(prow[a]) + ah[r * A + a]), was[a], s);
    s = cic::warp_sum(s);
    if (lane == 0) sc[r * kMaxK + k] = s + b_alpha;
  }
  __syncthreads();

  block_softmax(sc, mask, nullptr, b0, B, K);

  // out = sum_k w_k * att_emb[b, k]; att_emb streamed once
  for (int i = tid; i < kRows * H; i += kThreads) {
    const int r = i / H;
    const int c = i - r * H;
    if (b0 + r >= B) continue;
    const float* wrow = sc + r * kMaxK;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(wrow[k],
                 cic::to_f32(emb[Layout::slot(b0 + r, k, B, K) * H + c]), acc);
    out[(size_t)(b0 + r) * H + c] = cic::from_f32<T>(acc);
  }
}

// The 16 int8 values of one 16-byte load, as floats.
__device__ __forceinline__ void unpack16(const int4& v, float* f) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)(signed char)((w[i] >> (8 * j)) & 0xff);
  }
}

// int8 context (b-major).  H and A are multiples of 16 and the int8 rows
// 16-byte aligned (the wrapper checks), so a lane loads 16 values at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_q_kernel(const T* __restrict__ h, const int8_t* __restrict__ emb_q,
                   const float* __restrict__ emb_scale,
                   const int8_t* __restrict__ p_q,
                   const float* __restrict__ p_scale,
                   const T* __restrict__ wh, const T* __restrict__ bh,
                   const T* __restrict__ wa, const T* __restrict__ ba,
                   const float* __restrict__ mask, T* __restrict__ out, int B,
                   int K, int H, int A) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* ah = hs + kRows * H;
  float* was = ah + kRows * A;
  float* sc = was + A;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kRows;

  block_att_h(h, wh, bh, wa, hs, ah, was, b0, B, H, A);

  // scores: one warp per (row, slot); p_q streamed once, 16 bytes a lane,
  // dequantized in registers with the slot's scale
  const float b_alpha = cic::to_f32(ba[0]);
  for (int p = warp; p < kRows * K; p += kWarps) {
    const int r = p / K;
    const int k = p - r * K;
    if (b0 + r >= B) continue;
    const size_t slot = (size_t)(b0 + r) * K + k;
    const int8_t* prow = p_q + slot * A;
    const float ps = p_scale[slot];
    float s = 0.0f;
    for (int a0 = lane * 16; a0 < A; a0 += 32 * 16) {
      float q[16];
      unpack16(*reinterpret_cast<const int4*>(prow + a0), q);
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const float4 av = *reinterpret_cast<const float4*>(ah + r * A + a0 + j);
        const float4 wv = *reinterpret_cast<const float4*>(was + a0 + j);
        s = fmaf(tanhf(q[j] * ps + av.x), wv.x, s);
        s = fmaf(tanhf(q[j + 1] * ps + av.y), wv.y, s);
        s = fmaf(tanhf(q[j + 2] * ps + av.z), wv.z, s);
        s = fmaf(tanhf(q[j + 3] * ps + av.w), wv.w, s);
      }
    }
    s = cic::warp_sum(s);
    if (lane == 0) sc[r * kMaxK + k] = s + b_alpha;
  }
  __syncthreads();

  // weights, with the att_emb scale folded in: ws[k] = w[k] * emb_scale[b,k]
  block_softmax(sc, mask, emb_scale, b0, B, K);

  // out = sum_k ws_k * float(emb_q[b, k]); emb_q streamed once, each thread
  // 16 neighbouring columns of one row
  const int chunks = H / 16;
  for (int i = tid; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c0 = (i - r * chunks) * 16;
    if (b0 + r >= B) continue;
    const int8_t* erow = emb_q + (size_t)(b0 + r) * K * H + c0;
    const float* wrow = sc + r * kMaxK;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float q[16];
      unpack16(*reinterpret_cast<const int4*>(erow + (size_t)k * H), q);
      const float w = wrow[k];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(w, q[j], acc[j]);
    }
    T* orow = out + (size_t)(b0 + r) * H + c0;
#pragma unroll
    for (int j = 0; j < 16; ++j) orow[j] = cic::from_f32<T>(acc[j]);
  }
}

// Raise the kernel's dynamic shared memory limit where the block needs more
// than the 48 KiB every kernel may use.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename Layout>
int launch(const void* h, const void* emb, const void* patt, const void* wh,
           const void* bh, const void* wa, const void* ba, const void* mask,
           void* out, int B, int K, int H, int A, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(H, A);
  cudaError_t e = allow_smem(attention_kernel<T, Layout>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + kRows - 1) / kRows);
  attention_kernel<T, Layout><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(emb),
      static_cast<const T*>(patt), static_cast<const T*>(wh),
      static_cast<const T*>(bh), static_cast<const T*>(wa),
      static_cast<const T*>(ba), static_cast<const float*>(mask),
      static_cast<T*>(out), B, K, H, A);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_q(const void* h, const void* emb_q, const void* emb_scale,
             const void* p_q, const void* p_scale, const void* wh,
             const void* bh, const void* wa, const void* ba, const void* mask,
             void* out, int B, int K, int H, int A, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(H, A);
  cudaError_t e = allow_smem(attention_q_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + kRows - 1) / kRows);
  attention_q_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const int8_t*>(emb_q),
      static_cast<const float*>(emb_scale), static_cast<const int8_t*>(p_q),
      static_cast<const float*>(p_scale), static_cast<const T*>(wh),
      static_cast<const T*>(bh), static_cast<const T*>(wa),
      static_cast<const T*>(ba), static_cast<const float*>(mask),
      static_cast<T*>(out), B, K, H, A);
  return (int)cudaGetLastError();
}

}  // namespace

CIC_EXPORT int cic_attention(const void* h, const void* emb, const void* patt,
                             const void* wh, const void* bh, const void* wa,
                             const void* ba, const void* mask, void* out,
                             int B, int K, int H, int A, int is_bf16,
                             void* stream) {
  if (K < 1 || K > kMaxK || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, BMajor>(h, emb, patt, wh, bh, wa, ba, mask,
                                         out, B, K, H, A, s);
  return launch<float, BMajor>(h, emb, patt, wh, bh, wa, ba, mask, out, B, K,
                               H, A, s);
}

// emb and patt K-major: [K, B, H] and [K, B, A]; mask [B, K].
CIC_EXPORT int cic_attention_kmajor(const void* h, const void* emb,
                                    const void* patt, const void* wh,
                                    const void* bh, const void* wa,
                                    const void* ba, const void* mask,
                                    void* out, int B, int K, int H, int A,
                                    int is_bf16, void* stream) {
  if (K < 1 || K > kMaxK || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, KMajor>(h, emb, patt, wh, bh, wa, ba, mask,
                                         out, B, K, H, A, s);
  return launch<float, KMajor>(h, emb, patt, wh, bh, wa, ba, mask, out, B, K,
                               H, A, s);
}

// emb_q, p_q int8 [B, K, H] and [B, K, A]; emb_scale, p_scale f32 [B, K].
CIC_EXPORT int cic_attention_q(const void* h, const void* emb_q,
                               const void* emb_scale, const void* p_q,
                               const void* p_scale, const void* wh,
                               const void* bh, const void* wa, const void* ba,
                               const void* mask, void* out, int B, int K,
                               int H, int A, int is_bf16, void* stream) {
  if (K < 1 || K > kMaxK || B < 1 || H % 16 != 0 || A % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_q<__nv_bfloat16>(h, emb_q, emb_scale, p_q, p_scale, wh, bh,
                                   wa, ba, mask, out, B, K, H, A, s);
  return launch_q<float>(h, emb_q, emb_scale, p_q, p_scale, wh, bh, wa, ba,
                         mask, out, B, K, H, A, s);
}
