// K1: fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel`
// (multi_modal_foundation_model_tpu/ops/attention.py:144, launched by
// `_mha_impl`, :349-391): the eval forward (dropout 0, no lse) and the
// training forward (probability dropout, row statistic `lse` for K2).
//
// What it computes (the function, not the TPU blocking), per batch b and
// head h, on natural-layout (B, T, H*D) q/k/v:
//   s[q,k] = (q * scale) . k + (static[q,k] | key_pad[b,k] ? 0 : -1e30)
//   p[q,k] = exp(s[q,k] - m[q]),  l[q] = sum_k p[q,k]
//   o[q]   = sum_k p[q,k] keep[q,k] / (1 - rate) v[k] / l[q]
//   lse[q] = max(m[q], -1e6) + log(l[q])                (optional, f32)
// As in JAX (:196, :206-216), l sums the UNDROPPED probabilities and only
// the numerator sees the dropped ones. keep[q,k] is a Philox draw keyed by
// the seed with counter (b, h, q, k) alone (philox.cuh), so K2 replays it
// at its own tiling; keep iff bits > uint32(rate * (2^32 - 1)), JAX's test.
// The bias is the finite -1e30 of the JAX package, never -inf: in f32
// -1e30 + q.k rounds to -1e30, so a fully-masked row sees equal scores and
// comes out as the mean of V (of the kept V with dropout), as in JAX. All
// math is f32; inputs are f32 or bf16 and the output has the inputs' type.
//
// What bounds it on the H100: at the main path's shapes (Tq = Tk = 200,
// H = 8, D = 32) each (b, h) pair reads 3 x 200 x 32 values and does
// 4 x 200 x 200 x 32 flops, ~67 flops per byte in f32: above the f32 CUDA
// core ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/B), so the two products
// bound it, not device memory. The TPU kernel held all heads of a batch
// block in VMEM and ran one stacked softmax; here blocks run in parallel on
// 132 SMs with no order, so nothing carries between them and the design is
// the simplest one that keeps every score out of device memory:
//   - one block per (batch, head, 64-query tile), one thread per query row;
//   - the thread keeps q * scale and its output accumulator (D floats each)
//     in registers;
//   - K_h and V_h stream through shared memory in tiles of 32 keys (every
//     thread reads the same key row: a broadcast, no bank conflicts), with
//     an online softmax that rescales the accumulator once per tile;
//   - the static | key_pad attend flags of the tile are staged in shared
//     memory with a padded row (33 ints) so the per-thread reads do not
//     conflict;
//   - with dropout, the thread draws its row's 32 keep bits of the tile
//     with 8 Philox calls (4 words each) into one register.
// q, k and v each take a batch stride and a row stride (elements) with
// unit stride inside the row, so the column views of a fused QKV product
// (row stride 3*H*D) need no copy. The output is contiguous (B, Tq, H*D).
// Scalar f32 FMAs on the CUDA cores, not the tensor cores: making it fast
// (wgmma on bf16 tiles, TMA staging) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kHeadDim = 32;    // D of the reference model (H=256, 8 heads)
constexpr int kQTile = 64;      // query rows per block (one thread each)
constexpr int kKTile = 32;      // keys per shared-memory tile
constexpr float kNegInf = -1e30f;   // ops/attention.py NEG_INF
constexpr float kLseFloor = -1e6f;  // ops/attention.py _LSE_FLOOR

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kQTile)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ key_pad,
                const int* __restrict__ static_mask, T* __restrict__ out,
                float* __restrict__ lse, int Tq, int Tk, int H,
                long long q_sb, long long q_st, long long k_sb,
                long long k_st, long long v_sb, long long v_st, float scale,
                unsigned seed, unsigned threshold, float keep_scale) {
  constexpr int D = kHeadDim;
  __shared__ float ks[kKTile][D];
  __shared__ float vs[kKTile][D];
  __shared__ int att[kQTile][kKTile + 1];

  const int n_qtiles = (Tq + kQTile - 1) / kQTile;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kQTile;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const bool valid = row < Tq;

  float qr[D], acc[D];
  {
    const T* qp = q + b * q_sb + (long long)(valid ? row : 0) * q_st + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = to_f32(qp[d]) * scale;
      acc[d] = 0.f;
    }
  }
  float m = -INFINITY, l = 0.f;

  const T* kb = k + b * k_sb + h * D;
  const T* vb = v + b * v_sb + h * D;
  const int* pad = key_pad + (long long)b * Tk;

  for (int k0 = 0; k0 < Tk; k0 += kKTile) {
    const int nk = min(kKTile, Tk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKTile * D; i += kQTile) {
      const int j = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        kv = to_f32(kb[(long long)(k0 + j) * k_st + d]);
        vv = to_f32(vb[(long long)(k0 + j) * v_st + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    for (int i = tid; i < kQTile * kKTile; i += kQTile) {
      const int r = i / kKTile, j = i % kKTile;
      const int qrow = q0 + r, key = k0 + j;
      int a = 0;
      if (qrow < Tq && key < Tk)
        a = (static_mask[(long long)qrow * Tk + key] != 0) | (pad[key] != 0);
      att[r][j] = a;
    }
    __syncthreads();
    const uint32_t keep =
        kDropout ? mmfm::keep_bits32(seed, threshold, b, h, row, k0) : ~0u;

    float s[kKTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      dot += att[tid][j] ? 0.f : kNegInf;
      s[j] = j < nk ? dot : -INFINITY;  // keys past Tk carry no weight
      tile_max = fmaxf(tile_max, s[j]);
    }
    // nk >= 1, so tile_max and m_new are finite; the first tile's
    // correction is exp(-inf) = 0
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      const float p = j < nk ? expf(s[j] - m_new) : 0.f;
      l += p;  // the undropped probability
      const float pd =
          kDropout ? ((keep >> j) & 1u ? p * keep_scale : 0.f) : p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pd, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (!valid) return;
  const float inv_l = 1.f / l;
  T* op = out + ((long long)b * Tq + row) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv_l);
  if (lse != nullptr)
    lse[((long long)b * H + h) * Tq + row] = fmaxf(m, kLseFloor) + logf(l);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* key_pad, const int* static_mask, void* out,
                   float* lse, int B, int Tq, int Tk, int H, long long q_sb,
                   long long q_st, long long k_sb, long long k_st,
                   long long v_sb, long long v_st, float scale,
                   unsigned seed, unsigned threshold, float keep_scale,
                   int dropout, cudaStream_t stream) {
  const int n_qtiles = (Tq + kQTile - 1) / kQTile;
  const dim3 grid((unsigned)B * n_qtiles, H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (dropout)
    attn_fwd_kernel<T, true><<<grid, kQTile, 0, stream>>>(
        qp, kp, vp, key_pad, static_mask, op, lse, Tq, Tk, H, q_sb, q_st,
        k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale);
  else
    attn_fwd_kernel<T, false><<<grid, kQTile, 0, stream>>>(
        qp, kp, vp, key_pad, static_mask, op, lse, Tq, Tk, H, q_sb, q_st,
        k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 32. lse may be null.
// Strides in elements. dropout != 0 drops p[q,k] unless its Philox bits
// exceed `threshold` and scales survivors by `keep_scale`.
// Returns the launch's cudaGetLastError() (0 = ok).
extern "C" int mmfm_attention_fwd(
    const void* q, const void* k, const void* v, const int* key_pad,
    const int* static_mask, void* out, float* lse, int B, int Tq, int Tk,
    int H, int D, long long q_sb, long long q_st, long long k_sb,
    long long k_st, long long v_sb, long long v_st, float scale,
    unsigned seed, unsigned threshold, float keep_scale, int dropout,
    int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != kHeadDim) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, key_pad, static_mask, out, lse, B, Tq,
                              Tk, H, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                              scale, seed, threshold, keep_scale, dropout, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        q, k, v, key_pad, static_mask, out, lse, B, Tq, Tk, H, q_sb, q_st,
        k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale, dropout,
        s);
  return (int)cudaErrorInvalidValue;
}
