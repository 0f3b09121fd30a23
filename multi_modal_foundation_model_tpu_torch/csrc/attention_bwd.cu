// K2: fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel`
// (multi_modal_foundation_model_tpu/ops/attention.py:221, launched by
// `_flash_mha_bwd`, :418-453). Given K1's operands, the output gradient g
// and K1's row statistic lse = max(m, -1e6) + log(l), per (b, h):
//   s   = (q * scale) . k + bias              (bias as in K1: 0 or -1e30)
//   pn  = exp(s - lse)                        (the softmax probabilities)
//   ms  = keep / (1 - rate)                   (K1's Philox mask, replayed)
//   pd  = pn * ms,   dpn = (g . v) * ms
//   ds  = pn * (dpn - sum_k dpn * pn)
//   dq  = ds . k * scale,   dk = ds^T . (q * scale),   dv = pd^T . g
// A fully-masked query row (a padded trial under the decoder's pad-only
// mask) has lse = -1e6 + log(Tk) and scores of -1e30, so pn = 0 there and
// the row gets ZERO gradient, the contract of the JAX kernel (:57-63).
//
// What bounds it on the H100: five (Tq x Tk x D) products per (b, h),
// 10 B H Tq Tk D flops, ~100 flops per byte moved in f32 at the main
// path's shapes (Tq = Tk = 200, H = 8, D = 32): the products bound it.
// The TPU kernel ran a whole batch block per sequential grid step with two
// (GB, H*Tq, Tk) VMEM scratch stacks; nothing like it fits an SM, and
// blocks run in no order, so the design here is two passes with no atomics
// (bit-reproducible from run to run), each the shape of K1:
//   Pass A, one block per (batch, head, 64-query tile), one thread per
//     query row holding q * scale, g and its dq accumulator in registers;
//     K/V stream through shared memory in 32-key tiles. A first sweep over
//     the keys sums rowsum = sum_k dpn * pn; a second computes ds and
//     accumulates dq. rowsum goes to a small (B, H, Tq) f32 buffer.
//   Pass B, one block per (batch, head, 64-key tile), one thread per key
//     row holding k, v and its dk, dv accumulators (128 floats) in
//     registers; q * scale, g, lse and rowsum stream through shared memory
//     in 32-query tiles.
// Pass A recomputes s and g . v twice and pass B once more: 9 products
// where the bound counts 5. Dropout bits are recomputed with the same
// Philox counter (b, h, q, k) as K1 (philox.cuh): pass A draws the 4 keys
// of one counter per call, inside its key loop, pass B one word per
// (query, key). (Gathering a 32-key tile's bits into one register up front,
// as K1 does, read back wrong bits in this kernel on the H100 with nvcc
// 12.8; drawing per 4 keys reads back right: tests/test_torch_kernels.py.)
// q, k, v and g take batch and row strides (the fused-QKV column views go in
// without a copy); dq, dk, dv are written contiguous. q, k, v and g share
// one dtype, f32 or bf16; all math is f32 (bf16 values are widened as they
// load) and dq, dk, dv come out in that dtype, as JAX's out_shape (:444-446)
// gives them. lse and the rowsum scratch stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kHeadDim = 32;        // D of the reference model
constexpr int kRows = 64;           // rows per block (one thread each)
constexpr int kTile = 32;           // streamed rows per shared-memory tile
constexpr float kNegInf = -1e30f;   // ops/attention.py NEG_INF

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

// Pass A: rowsum and dq for 64 query rows of one (b, h).
template <typename T, bool kDropout>
__global__ void __launch_bounds__(kRows)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const int* __restrict__ key_pad,
                   const int* __restrict__ static_mask,
                   const float* __restrict__ lse, T* __restrict__ dq,
                   float* __restrict__ rowsum, int Tq, int Tk, int H,
                   long long q_sb, long long q_st, long long k_sb,
                   long long k_st, long long v_sb, long long v_st,
                   long long g_sb, long long g_st, float scale,
                   unsigned seed, unsigned threshold, float keep_scale) {
  constexpr int D = kHeadDim;
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][D];
  __shared__ int att[kRows][kTile + 1];

  const int n_qtiles = (Tq + kRows - 1) / kRows;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const bool valid = row < Tq;
  const int r = valid ? row : 0;

  float qr[D], gr[D], acc[D];
  {
    const T* qp = q + b * q_sb + (long long)r * q_st + h * D;
    const T* gp = g + b * g_sb + (long long)r * g_st + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = to_f32(qp[d]) * scale;
      gr[d] = to_f32(gp[d]);
      acc[d] = 0.f;
    }
  }
  const float row_lse = lse[((long long)b * H + h) * Tq + r];
  const T* kb = k + b * k_sb + h * D;
  const T* vb = v + b * v_sb + h * D;
  const int* pad = key_pad + (long long)b * Tk;

  float dsum = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < Tk; k0 += kTile) {
      const int nk = min(kTile, Tk - k0);
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < kTile * D; i += kRows) {
        const int j = i / D, d = i % D;
        float kv = 0.f, vv = 0.f;
        if (j < nk) {
          kv = to_f32(kb[(long long)(k0 + j) * k_st + d]);
          vv = to_f32(vb[(long long)(k0 + j) * v_st + d]);
        }
        ks[j][d] = kv;
        vs[j][d] = vv;
      }
      for (int i = tid; i < kRows * kTile; i += kRows) {
        const int rr = i / kTile, j = i % kTile;
        const int qrow = q0 + rr, key = k0 + j;
        int a = 0;
        if (qrow < Tq && key < Tk)
          a = (static_mask[(long long)qrow * Tk + key] != 0) | (pad[key] != 0);
        att[rr][j] = a;
      }
      __syncthreads();

      uint32_t keep4 = 0xFu;  // keep bits of keys k0 + (j & ~3) .. + 3
      for (int j = 0; j < nk; ++j) {
        if (kDropout && (j & 3) == 0)
          keep4 = mmfm::keep_bits4(seed, threshold, b, h, r, (k0 + j) >> 2);
        float s = 0.f, dpd = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], ks[j][d], s);
          dpd = fmaf(gr[d], vs[j][d], dpd);
        }
        s += att[tid][j] ? 0.f : kNegInf;
        const float pn = expf(s - row_lse);
        const float dpn =
            kDropout ? ((keep4 >> (j & 3)) & 1u ? dpd * keep_scale : 0.f)
                     : dpd;
        if (sweep == 0) {
          dsum = fmaf(dpn, pn, dsum);
        } else {
          const float ds = pn * (dpn - dsum);
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
        }
      }
    }
  }

  if (!valid) return;
  T* op = dq + ((long long)b * Tq + row) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * scale);
  rowsum[((long long)b * H + h) * Tq + row] = dsum;
}

// Pass B: dk and dv for 64 key rows of one (b, h).
template <typename T, bool kDropout>
__global__ void __launch_bounds__(kRows)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const int* __restrict__ key_pad,
                     const int* __restrict__ static_mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ rowsum, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, int H,
                     long long q_sb, long long q_st, long long k_sb,
                     long long k_st, long long v_sb, long long v_st,
                     long long g_sb, long long g_st, float scale,
                     unsigned seed, unsigned threshold, float keep_scale) {
  constexpr int D = kHeadDim;
  __shared__ float qs[kTile][D];
  __shared__ float gs[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float sum_s[kTile];
  __shared__ int att[kTile][kRows];

  const int n_ktiles = (Tk + kRows - 1) / kRows;
  const int b = blockIdx.x / n_ktiles;
  const int key0 = (blockIdx.x % n_ktiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int key = key0 + tid;
  const bool valid = key < Tk;
  const int kk = valid ? key : 0;

  float kr[D], vr[D], dka[D], dva[D];
  {
    const T* kp = k + b * k_sb + (long long)kk * k_st + h * D;
    const T* vp = v + b * v_sb + (long long)kk * v_st + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = to_f32(kp[d]);
      vr[d] = to_f32(vp[d]);
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
  }
  const int key_attend = key_pad[(long long)b * Tk + kk] != 0;
  const T* qb = q + b * q_sb + h * D;
  const T* gb = g + b * g_sb + h * D;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* sb = rowsum + ((long long)b * H + h) * Tq;

  for (int q0 = 0; q0 < Tq; q0 += kTile) {
    const int nq = min(kTile, Tq - q0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * D; i += kRows) {
      const int j = i / D, d = i % D;
      float qv = 0.f, gv = 0.f;
      if (j < nq) {
        qv = to_f32(qb[(long long)(q0 + j) * q_st + d]) * scale;
        gv = to_f32(gb[(long long)(q0 + j) * g_st + d]);
      }
      qs[j][d] = qv;
      gs[j][d] = gv;
    }
    if (tid < kTile) {
      lse_s[tid] = tid < nq ? lb[q0 + tid] : 0.f;
      sum_s[tid] = tid < nq ? sb[q0 + tid] : 0.f;
    }
    for (int i = tid; i < kTile * kRows; i += kRows) {
      const int j = i / kRows, c = i % kRows;
      const int qrow = q0 + j, kcol = key0 + c;
      int a = 0;
      if (qrow < Tq && kcol < Tk)
        a = static_mask[(long long)qrow * Tk + kcol] != 0;
      att[j][c] = a;
    }
    __syncthreads();

    for (int j = 0; j < nq; ++j) {
      float s = 0.f, dpd = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[j][d], kr[d], s);
        dpd = fmaf(gs[j][d], vr[d], dpd);
      }
      s += (att[j][tid] | key_attend) ? 0.f : kNegInf;
      const float pn = expf(s - lse_s[j]);
      float ms = 1.f;
      if (kDropout)
        ms = mmfm::keep_one(seed, threshold, b, h, q0 + j, kk) ? keep_scale
                                                               : 0.f;
      const float pd = pn * ms;
      const float ds = pn * (dpd * ms - sum_s[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(pd, gs[j][d], dva[d]);
        dka[d] = fmaf(ds, qs[j][d], dka[d]);
      }
    }
  }

  if (!valid) return;
  const long long o = ((long long)b * Tk + key) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[o + d] = from_f32<T>(dka[d]);
    dv[o + d] = from_f32<T>(dva[d]);
  }
}

template <typename T, bool kDropout>
cudaError_t launch(const void* q_, const void* k_, const void* v_,
                   const void* g_, const int* key_pad, const int* static_mask,
                   const float* lse, float* rowsum, void* dq_, void* dk_,
                   void* dv_, int B, int Tq, int Tk, int H, long long q_sb,
                   long long q_st, long long k_sb, long long k_st,
                   long long v_sb, long long v_st, long long g_sb,
                   long long g_st, float scale, unsigned seed,
                   unsigned threshold, float keep_scale,
                   cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* g = static_cast<const T*>(g_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  const dim3 grid_a((unsigned)B * ((Tq + kRows - 1) / kRows), H);
  attn_bwd_dq_kernel<T, kDropout><<<grid_a, kRows, 0, stream>>>(
      q, k, v, g, key_pad, static_mask, lse, dq, rowsum, Tq, Tk, H, q_sb,
      q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed, threshold,
      keep_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_b((unsigned)B * ((Tk + kRows - 1) / kRows), H);
  attn_bwd_dkdv_kernel<T, kDropout><<<grid_b, kRows, 0, stream>>>(
      q, k, v, g, key_pad, static_mask, lse, rowsum, dk, dv, Tq, Tk, H, q_sb,
      q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed, threshold,
      keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk, dv); D must be 32.
// Strides in elements; dq (B, Tq, H*D), dk and dv (B, Tk, H*D) contiguous;
// rowsum is (B, H, Tq) f32 scratch written by pass A and read by pass B.
// Returns the first launch error (0 = ok).
extern "C" int mmfm_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const int* key_pad, const int* static_mask, const float* lse,
    float* rowsum, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
    int H, int D, long long q_sb, long long q_st, long long k_sb,
    long long k_st, long long v_sb, long long v_st, long long g_sb,
    long long g_st, float scale, unsigned seed, unsigned threshold,
    float keep_scale, int dropout, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != kHeadDim) return (int)cudaErrorInvalidValue;
#define MMFM_K2_LAUNCH(T, DROP)                                            \
  launch<T, DROP>(q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, \
                  B, Tq, Tk, H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb,   \
                  g_st, scale, seed, threshold, keep_scale, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = dropout ? MMFM_K2_LAUNCH(float, true) : MMFM_K2_LAUNCH(float, false);
  else if (dtype == 1)
    err = dropout ? MMFM_K2_LAUNCH(__nv_bfloat16, true)
                  : MMFM_K2_LAUNCH(__nv_bfloat16, false);
#undef MMFM_K2_LAUNCH
  return (int)err;
}
