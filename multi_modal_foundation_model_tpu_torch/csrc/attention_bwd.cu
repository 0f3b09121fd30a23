// K2: fused multi-head attention backward for Hopper (sm_90a), on the
// tensor cores in f32 (3xTF32) and bf16: this file is the C entry,
// mmfm_attention_bwd, which launches the wgmma kernels (TMA tiles, the
// keep bits drawn apart) of the library's head width: at 16, 32 and 64
// bf16 of attention_bwd_bf16.cuh and f32 of attention_bwd_f32.cuh, at 128
// bf16 of attention_bwd_bf16_d128.cuh and f32 of attention_bwd_f32_d128.cuh.
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
// The TPU kernel ran a whole batch block per sequential grid step with two
// (GB, H*Tq, Tk) VMEM scratch stacks; nothing like it fits an SM, and
// blocks run in no order, so every K2 here takes two passes with no
// atomics (bit-reproducible from run to run), after a kernel that draws
// the keep bits (attn_bwd_keep_kernel, with dropout):
//   Pass A, one block per (batch, 64-query tile) and group of heads:
//     rowsum = sum_k dpn * pn, ds and dq. rowsum goes to a small (B, H, Tq)
//     f32 buffer.
//   Pass B, one block per (batch, 64-key tile) and group of heads: dk and
//     dv, with q * scale, g, lse and rowsum over the queries.
//
// f32 (3xTF32): the f32 contract, the plain version's f32 math, with no
// bf16 rounding anywhere (q * scale stays f32). Every product is three
// TF32 wgmma products of operands split into hi = tf32(x) and lo = tf32(x
// - hi), each k-step's three summed from zero before an f32 add (the
// tensor cores truncate their sums; attention_bwd_f32.cuh notes the
// accuracy on the H100). pn = ex2.approx.ftz((s - lse) * log2(e))
// (fast_exp2: ~2 ulp; results below 2^-126 flush to 0, where exp(s - lse)
// adds nothing at the gate): the subtraction before the base-2 scale
// keeps the argument's rounding relative to s - lse, not to s.
//
// bf16: the arithmetic of JAX's K2 on its own hardware (dots_dtype = bf16,
// :431): qs = bf16(f32(q) * scale), k, v, g in bf16; the five products
// take bf16 operands and accumulate in f32 (wgmma); ds and pd are rounded
// to bf16 before the dq, dk and dv products.
//
// The operands' data pointers and batch and row strides must be 16-byte
// aligned (TMA), which the wrapper checks.
//
// Head width: this file is compiled once a width, as its own library, at
// D = MMFM_HEAD_DIM (32 unless defined; attention_bwd_d{16,64,128}.cu
// define it and include this file), as K1's. The wrapper pads any other D
// up to 128 with zero columns per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef MMFM_HEAD_DIM
#define MMFM_HEAD_DIM 32
#endif

#include "philox.cuh"
#if MMFM_HEAD_DIM <= 64
#include "attention_bwd_bf16.cuh"
#include "attention_bwd_f32.cuh"
#else
#include "attention_bwd_bf16_d128.cuh"
#include "attention_bwd_f32_d128.cuh"
#endif

// dtype: 0 = float32 (3xTF32), 1 = bfloat16, for q, k, v, g, dq, dk, dv;
// D must be this library's MMFM_HEAD_DIM; data pointers and batch and row
// strides of q, k, v, g
// 16-byte aligned. Strides in elements; dq (B, Tq, H*D), dk and dv
// (B, Tk, H*D) contiguous. The f32 scratch holds rowsum (B, H, Tq), written
// by pass A and read by pass B, then, 16-byte aligned, the mask bytes the
// passes read, B * H * ceil(Tk / 8) * keep_row(Tq) bytes
// (ops/attention.py::_k2_scratch_floats). b_off and h_off
// offset the (b, h) of the dropout bits as K1's do.
// Returns the first launch error (0 = ok).
extern "C" int mmfm_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const int* key_pad, const int* static_mask, const float* lse,
    float* rowsum, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
    int H, int D, long long q_sb, long long q_st, long long k_sb,
    long long k_st, long long v_sb, long long v_st, long long g_sb,
    long long g_st, float scale, const long long* seed, unsigned threshold,
    float keep_scale, int dropout, int b_off, int h_off, int dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != MMFM_HEAD_DIM) return (int)cudaErrorInvalidValue;
#define MMFM_K2_WG(DROP)                                                     \
  mmfm::k2wg::launch<DROP, MMFM_HEAD_DIM>(                                   \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
#define MMFM_K2_TF(DROP)                                                     \
  mmfm::k2tf::launch<DROP, MMFM_HEAD_DIM>(                                   \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
#define MMFM_K2_T128(DROP)                                                   \
  mmfm::k2t128::launch<DROP>(                                                \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
#define MMFM_K2_B128(DROP)                                                   \
  mmfm::k2b128::launch<DROP>(                                                \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
  cudaError_t err = cudaErrorInvalidValue;
#if MMFM_HEAD_DIM <= 64
  if (dtype == 0)
    err = dropout ? MMFM_K2_TF(true) : MMFM_K2_TF(false);
  else if (dtype == 1)
    err = dropout ? MMFM_K2_WG(true) : MMFM_K2_WG(false);
#else
  if (dtype == 0)
    err = dropout ? MMFM_K2_T128(true) : MMFM_K2_T128(false);
  else if (dtype == 1)
    err = dropout ? MMFM_K2_B128(true) : MMFM_K2_B128(false);
#endif
#undef MMFM_K2_B128
#undef MMFM_K2_T128
#undef MMFM_K2_TF
#undef MMFM_K2_WG
  return (int)err;
}
