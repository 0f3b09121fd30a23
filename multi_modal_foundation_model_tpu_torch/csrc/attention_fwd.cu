// K1: fused multi-head attention forward for Hopper (sm_90a), on the
// tensor cores' wgmma with TMA-fed tiles, in f32 (3xTF32) and bf16. Each
// width and dtype runs a kernel of its own header:
//   f32  at 16, 32, 64: attention_fwd_f32.cuh (k1tf, attn_fwd_tf_kernel)
//   f32  at 128:        attention_fwd_f32_d128.cuh (k1t128, the output
//                       product taken transposed)
//   bf16 at 16, 32, 64: attention_fwd_bf16.cuh (k1wg, attn_fwd_wg_kernel)
//   bf16 at 128:        attention_fwd_bf16_d128.cuh (k1b128, rows of two
//                       swizzle atoms)
// With dropout each first draws the keep bits in a kernel of their own
// (attention_fwd_bf16.cuh, attn_fwd_keep_kernel) into the scratch.
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
// The seed is read from device memory (an entry of the training step's seed
// table, ops/attention.py), never passed by value, so a CUDA graph of the
// step draws each replay's own key.
// The bias is the finite -1e30 of the JAX package, never -inf: in f32
// -1e30 + q.k rounds to -1e30, so a fully-masked row sees equal scores and
// comes out as the mean of V (of the kept V with dropout), as in JAX, with
// lse = -1e6 + log(Tk). Keys past Tk carry no weight. q, k and v each take
// a batch stride and a row stride (elements) with unit stride inside the
// row, so the column views of a fused QKV product (row stride 3*H*D) need
// no copy; TMA needs their data pointers and strides 16-byte aligned,
// which the wrapper checks. The output is contiguous (B, Tq, H*D) in the
// inputs' type.
//
// Head width: the kernels are templates on D, and this file is compiled
// once a width, as its own library: here at D = MMFM_HEAD_DIM (32 unless
// defined), and at 16, 64 and 128 by attention_fwd_d{16,64,128}.cu, which
// define it and include this file, so the widths build in parallel. The
// wrapper (ops/attention.py) pads any other D up to 128 with zero columns
// per head.
//
// f32 (3xTF32): the f32 contract, the plain version's f32 math, with no
// bf16 rounding anywhere. q * scale is multiplied in f32; every operand x
// of a product splits into hi = tf32(x) and lo = tf32(x - hi) (mma_tf32.cuh
// split_tf32: to nearest, ties away), and each k-step of 8 is three TF32
// products (al . bh, ah . bl, ah . bh) summed from zero on the tensor
// cores and added in f32 (the tensor cores truncate their sums, so nothing
// is chained into a running sum). s is the
// f32 K2's own product on the same operands, so K2 recomputes the very
// scores that K1 summarised into lse. The output is stored as f32.
//
// bf16: the arithmetic of JAX's K1 on its own hardware, where
// DEFAULT-precision f32 dots feed the matrix unit bf16 operands
// (:189-191, :213-216):
//   s  = bf16(f32(q) * scale) . k + bias     (f32 sums)
//   pd = bf16(keep ? p / (1 - rate) : 0)     (JAX scales before the dot,
//                                             :207-208; bf16(p) at rate 0)
//   o  = (pd . v) / l                        (f32 sums), bf16 out
// with m, l and lse in f32 and the natural log, so the lse is the one
// the bf16 K2 recomputes its probabilities against (its exp(s - lse) rows
// sum to 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef MMFM_HEAD_DIM
#define MMFM_HEAD_DIM 32
#endif

#if MMFM_HEAD_DIM <= 64
#include "attention_fwd_bf16.cuh"
#include "attention_fwd_f32.cuh"
#else
#include "attention_fwd_bf16_d128.cuh"
#include "attention_fwd_f32_d128.cuh"
#endif

// dtype: 0 = float32 (3xTF32), 1 = bfloat16, for q, k, v and out; D must
// be this library's MMFM_HEAD_DIM; data pointers and batch and row strides
// of q, k, v 16-byte aligned. lse may be null. Strides in elements.
// scratch: with dropout, the keep bytes, B * H * ceil(Tk / 8) * (Tq rounded
// up to 16), 16-byte aligned (ops/attention.py::_k1_scratch_bytes); unread
// otherwise (may be null). dropout != 0 drops p[q,k]
// unless its Philox bits exceed `threshold` and scales survivors by
// `keep_scale`; the bits of (b, h) are drawn as those of (b + b_off,
// h + h_off), so a rank holding a slice of the batch (data parallel) and
// of the heads (tensor parallel) draws its slice of the whole call's bits.
// Returns the launch's cudaGetLastError() (0 = ok).
extern "C" int mmfm_attention_fwd(
    const void* q, const void* k, const void* v, const int* key_pad,
    const int* static_mask, void* out, float* lse, void* scratch, int B,
    int Tq, int Tk, int H, int D, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale,
    const long long* seed, unsigned threshold, float keep_scale, int dropout,
    int b_off, int h_off, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != MMFM_HEAD_DIM) return (int)cudaErrorInvalidValue;
#define MMFM_K1_TF(DROP)                                                     \
  mmfm::k1tf::launch<DROP, MMFM_HEAD_DIM>(                                   \
      q, k, v, key_pad, static_mask, out, lse, scratch, B, Tq, Tk, H, q_sb,  \
      q_st, k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale,      \
      b_off, h_off, s)
#define MMFM_K1_WG(DROP)                                                     \
  mmfm::k1wg::launch<DROP, MMFM_HEAD_DIM>(                                   \
      q, k, v, key_pad, static_mask, out, lse, scratch, B, Tq, Tk, H, q_sb,  \
      q_st, k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale,      \
      b_off, h_off, s)
#define MMFM_K1_T128(DROP)                                                   \
  mmfm::k1t128::launch<DROP>(                                                \
      q, k, v, key_pad, static_mask, out, lse, scratch, B, Tq, Tk, H, q_sb,  \
      q_st, k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale,      \
      b_off, h_off, s)
#define MMFM_K1_B128(DROP)                                                   \
  mmfm::k1b128::launch<DROP>(                                                \
      q, k, v, key_pad, static_mask, out, lse, scratch, B, Tq, Tk, H, q_sb,  \
      q_st, k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale,      \
      b_off, h_off, s)
  cudaError_t err = cudaErrorInvalidValue;
#if MMFM_HEAD_DIM <= 64
  if (dtype == 0)
    err = dropout ? MMFM_K1_TF(true) : MMFM_K1_TF(false);
  else if (dtype == 1)
    err = dropout ? MMFM_K1_WG(true) : MMFM_K1_WG(false);
#else
  if (dtype == 0)
    err = dropout ? MMFM_K1_T128(true) : MMFM_K1_T128(false);
  else if (dtype == 1)
    err = dropout ? MMFM_K1_B128(true) : MMFM_K1_B128(false);
#endif
#undef MMFM_K1_B128
#undef MMFM_K1_T128
#undef MMFM_K1_WG
#undef MMFM_K1_TF
  return (int)err;
}
