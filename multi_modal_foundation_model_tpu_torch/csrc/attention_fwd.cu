// K1: fused multi-head attention forward for Hopper (sm_90a), on the
// tensor cores in f32 (3xTF32) and bf16. bf16 at head widths 16, 32 and 64
// runs the wgmma kernel of attention_fwd_bf16.cuh (whole key row, one
// sweep, TMA tiles), bf16 at 128 that of attention_fwd_bf16_d128.cuh (rows
// of two swizzle atoms), f32 at 128 the wgmma kernel of
// attention_fwd_f32_d128.cuh (3xTF32, the output product transposed); f32
// at 16-64 runs the mma.sync kernel of this file
// (attn_fwd_tc_kernel<float, kDropout, D>).
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
// no copy. The output is contiguous (B, Tq, H*D) in the inputs' type.
//
// The mma.sync kernel (attn_fwd_tc_kernel<T, kDropout, D>; Tc<T, D> in
// tc_traits.cuh holds what the operand type changes) is built for f32 at
// D = 16, 32 and 64 only. Its design is
// K2 pass A's: four warps a block, each holding 16 query rows of q * scale
// as mma A fragments in registers; K_h and V_h stream through shared memory
// in 64-key tiles by cp.async (16 B a copy, tail rows zero-filled; one
// buffer, below), each thread readying the
// chunks it copied once they land, before the tile's barrier; an online
// softmax over the tiles rescales
// the O accumulator per tile, the row max and sum reduced across each quad
// by shuffles; the S accumulators become the A fragments of pd . v in
// registers. p = ex2.approx((s - m) * log2(e)) (fast_exp2; s - m first, so
// a fully-masked row's -1e30 - -1e30 is exactly 0); m, l, the division
// and lse in f32. A block walks up to all H heads of its (batch, 64-query
// tile): it builds its rows' attend bits from the int32 static mask and the
// key pad once, one byte per (row, 4 keys), shared by its heads (read per
// (b, h) block, the mask was the bf16 K2's largest cost), and with dropout
// draws each head's keep bits (one keep_bits4 call per (row, 4 keys), for
// every key: a fully-masked row keeps its dropout) into a second buffer, a
// slice with each tile of the head before, so the draws run beside the
// products. Any Tq and Tk from 1 up (each bit buffer grows by 1 KB per 64
// keys); the operands' data pointers and batch and row strides must be
// 16-byte aligned (cp.async), which the wrapper checks.
//
// Head width: the kernel is a template on D, and this file is compiled
// once a width, as its own library: here at D = MMFM_HEAD_DIM (32 unless
// defined), and at 16, 64 and 128 by attention_fwd_d{16,64,128}.cu, which
// define it and include this file, so the widths build in parallel. The
// wrapper (ops/attention.py) pads any other D up to 128 with zero columns
// per head. What grows with D: the q fragments (D / 2 registers in f32),
// the O accumulators (D / 2), the tiles' pitch (D + 4 floats) and so the
// shared memory. At D = 128 this library builds the two wgmma kernels
// alone: the mma.sync kernel's f32 q fragments took ~128 registers there
// and its split k and v tiles 135 KB (one block of 4 warps an SM). The
// D = 32 instantiations are the code they were before D became a
// parameter (the same ptxas registers, spills and shared memory).
//
// f32 (3xTF32, mma_tf32.cuh): the f32 contract, the plain version's f32
// math, with no bf16 rounding anywhere. q * scale is multiplied in f32 and
// split into hi = tf32(x) and lo = tf32(x - hi) A fragments (load_a_tf32,
// as K2's pass A); a landed k or v tile is split into hi and lo planes of
// (64, 36) floats in shared memory (land_split); s = (q * scale) . k is
// mma_rows_3x and pd . v mma_cols_3x, which splits the pd accumulator in
// registers: each k-step of 8 three mma.sync.m16n8k8 TF32 products (al.bh,
// ah.bl, ah.bh) summed from zero and added in f32 (mma_3xtf32: the tensor
// cores truncate their sums, so nothing is chained into a running sum).
// These are K2 pass A's products on K2's operands, so K2 recomputes the
// very scores that K1 summarised into lse. The output is stored as f32.
// What bounds it on the H100 at the training step's shape (B = 256, Tq =
// Tk = 200, H = 8, D = 32): the two products at 3 terms each, 3 x 4 B H Tq
// Tk D TF32 operations at 495 TFLOP/s, 0.064 ms, against 0.063 ms of bytes
// (q, k, v and the masks in; out and lse written; 3.35 TB/s); at the
// eval's B = 320, 0.079 ms against 0.078 ms. On the CUDA cores (67 TFLOP/s
// f32) the same products need 0.157 ms and 0.196 ms. Beside the products:
// the exps (B H Tq Tk, 82 M at B = 256) and, with dropout, the Philox
// draws (one call per 4 scores). Shared memory: the hi/lo planes of one
// (64, 36) f32 tile for K and one for V, 36 KB, plus 4.25 KB a bit buffer
// at Tk = 200 (two with dropout): ~45 KB. Registers: the q fragments' hi
// and lo planes (32), the S accumulators (32), the O accumulators (16) and
// each k-step's split pd (8); ptxas -v: 127 with and without dropout, no
// spills, so 4 blocks an SM. Double-buffered, the tiles took ~81 KB (2
// blocks an SM) and the kernel 16-20% longer,
// though each copy overlapped the last tile's products; B fragments split
// in registers instead of hi/lo planes were slower again
// (scripts/torch_k1_variants.py, Tc<T, D>::kFwdBufs).
//
// bf16 (attention_fwd_bf16.cuh at 16-64, attention_fwd_bf16_d128.cuh at
// 128, both on wgmma): the arithmetic of JAX's K1 on its own hardware,
// where DEFAULT-precision f32 dots feed the matrix unit bf16 operands
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

#include "philox.cuh"
#include "tc_traits.cuh"
#if MMFM_HEAD_DIM <= 64
#include "attention_fwd_bf16.cuh"
#else
#include "attention_fwd_bf16_d128.cuh"
#include "attention_fwd_f32_d128.cuh"
#endif

namespace {

using namespace mmfm;

// out (and lse) for 64 query rows of one b and heads [h0, h0 + hpb).
template <typename T, bool kDropout, int D>
__global__ void __launch_bounds__(kTcThreads)
attn_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ key_pad,
                   const int* __restrict__ static_mask, T* __restrict__ out,
                   float* __restrict__ lse, int Tq, int Tk, int H, int hpb,
                   long long q_sb, long long q_st, long long k_sb,
                   long long k_st, long long v_sb, long long v_st,
                   float scale, const long long* __restrict__ seed_ptr,
                   unsigned threshold, float keep_scale, int b_off,
                   int h_off, bool vec) {
  using Ops = Tc<T, D>;
  // the Philox key: the low 32 bits of the step's seed-table entry
  const unsigned seed = kDropout ? (unsigned)__ldg(seed_ptr) : 0u;
  constexpr int kPer = 16 / sizeof(T);             // elements a copy
  constexpr int kBufs = Ops::kFwdBufs;             // k/v tile buffers
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);              // [kBufs][kElems]
  T* vs = ks + kBufs * Ops::kElems;                // [kBufs][kElems]
  // [n_buf][64][bstride]: this head's bytes, and the next head's being
  // drawn (dropout only)
  unsigned char* bits = reinterpret_cast<unsigned char*>(vs +
                                                         kBufs * Ops::kElems);

  const int n_qtiles = (Tq + kTcRows - 1) / kTcRows;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTcRows;
  const int h0 = blockIdx.y * hpb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_kt = (Tk + kTcRows - 1) / kTcRows;
  // 16 groups of 4 keys a tile, + 4 bytes so that rows 8 apart in a warp's
  // byte reads fall on distinct banks
  const int bstride = n_kt * 16 + 4;
  const int n_items = kTcRows * bstride;
  const int chunk = (n_items + n_kt - 1) / n_kt;

  // tile idx = (head - h0) * n_kt + t of the block's walk. The chunk index
  // c is unsigned, so c / kChunks and c % kChunks are a shift and a mask:
  // with an int, ptxas took 126 registers for the bf16 K1 with dropout
  // where the bf16-only kernel had 96 (scripts/torch_k1_variants.py)
  auto load_tile = [&](int idx, int buf) {
    const int h = h0 + idx / n_kt;
    const int k0 = (idx % n_kt) * kTcRows;
    const T* kb = k + b * k_sb + h * D;
    const T* vb = v + b * v_sb + h * D;
    for (unsigned c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int r = c / Ops::kChunks, ch = (c % Ops::kChunks) * kPer;
      const int key = k0 + r;
      const bool ok = key < Tk;
      const long long row = ok ? key : 0;
      const int at = buf * Ops::kElems + r * Ops::kPitch + ch;
      cp_async16(smem_u32(ks + at), kb + row * k_st + ch, ok);
      cp_async16(smem_u32(vs + at), vb + row * v_st + ch, ok);
    }
    cp_async_commit();
  };
  // the chunks this thread copied into buffer buf, readied in place
  auto land_tile = [&](int buf) {
    for (unsigned c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int at = buf * Ops::kElems + (c / Ops::kChunks) * Ops::kPitch +
                     (c % Ops::kChunks) * kPer;
      Ops::template land<false>(ks + at, 1.f);
      Ops::template land<false>(vs + at, 1.f);
    }
  };
  load_tile(0, 0);

  // keep bits of (row r, keys [k0, k0 + 4)) in head h: every key of a real
  // row, masked or not (a fully-masked row is the mean of the kept V)
  auto keep_of = [&](int h, int r, int k0) -> unsigned {
    return q0 + r < Tq && k0 < Tk
               ? keep_nibble<kDropout>(seed, threshold, b + b_off, h + h_off,
                                       q0 + r, k0)
               : 0u;
  };
  const int* pad = key_pad + (long long)b * Tk;
  for (int i = tid; i < n_items; i += kTcThreads) {
    const int r = i / bstride, k0 = (i - r * bstride) * 4;
    bits[i] = (unsigned char)(attend_nibble(static_mask, pad, Tq, Tk, q0 + r,
                                            k0, vec) |
                              keep_of(h0, r, k0));
  }

  const int row0 = q0 + warp * 16;
  const bool active = row0 < Tq;  // else the warp only helps with copies
  for (int h = h0; h < h0 + hpb; ++h) {
    const int cur = kDropout ? (h - h0) & 1 : 0;
    const unsigned char* brow =
        bits + cur * n_items + (warp * 16 + gid) * bstride;
    typename Ops::Frags qa;
    // the running row max and the thread's share of the row sum, for rows
    // gid and gid + 8 of the warp's 16
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float oacc[D / 8][4] = {};
    if (active)
      Ops::template load<true>(qa, q + b * q_sb + h * D, q_st, row0, Tq,
                               lane, scale);

    for (int t = 0; t < n_kt; ++t) {
      const int idx = (h - h0) * n_kt + t, buf = idx % kBufs;
      if (kBufs == 1 && idx > 0) {
        __syncthreads();  // the last readers of the one buffer are done
        load_tile(idx, 0);
      }
      cp_async_wait_all();
      land_tile(buf);
      __syncthreads();  // tile idx (and the bits) in; the last readers done
      if (kBufs == 2 && idx + 1 < hpb * n_kt) load_tile(idx + 1, buf ^ 1);
      if (kDropout && h + 1 < h0 + hpb) {
        // a slice of the next head's keep bits, into the other buffer (its
        // readers finished with the last head), interleaved with this
        // head's tiles so the Philox draws overlap the products
        const unsigned char* src = bits + cur * n_items;
        unsigned char* dst = bits + (cur ^ 1) * n_items;
        const int end = min(n_items, (t + 1) * chunk);
        for (int i = t * chunk + tid; i < end; i += kTcThreads) {
          const int r = i / bstride, k0 = (i - r * bstride) * 4;
          dst[i] = (unsigned char)((src[i] & 0xF0u) | keep_of(h + 1, r, k0));
        }
      }
      if (!active) continue;
      const int k0 = t * kTcRows;
      const int n_valid = min(kTcRows, Tk - k0);
      const T* kt = ks + buf * Ops::kElems;
      const T* vt = vs + buf * Ops::kElems;

      float sacc[8][4] = {};
      Ops::rows(sacc, qa, kt, lane, n_valid);
      // the bias, and -inf past Tk; the tile's row max
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = k0 + nt * 8 + tig * 2;   // and key + 1: one group
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const unsigned byte = brow[hh * 8 * bstride + (key >> 2)];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = hh * 2 + e;
            float s = sacc[nt][i];
            if (!((byte >> (4 + (key & 3) + e)) & 1u)) s = kNegInf;
            if (key + e >= Tk) s = -INFINITY;
            sacc[nt][i] = s;
            tmax[hh] = fmaxf(tmax[hh], s);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {             // the quad holds one row
        tmax[hh] = fmaxf(tmax[hh],
                         __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
        tmax[hh] = fmaxf(tmax[hh],
                         __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
        // n_valid >= 1, so the new max is finite; the first tile's
        // correction is exp2(-inf) = 0
        const float m_new = fmaxf(m[hh], tmax[hh]);
        corr[hh] = fast_exp2((m[hh] - m_new) * kLog2e);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        oacc[dt][0] *= corr[0];
        oacc[dt][1] *= corr[0];
        oacc[dt][2] *= corr[1];
        oacc[dt][3] *= corr[1];
      }
      // p = exp(s - m) (s - m first: a fully-masked row's -1e30 - -1e30 is
      // exactly 0), summed undropped; the A operand of pd . v is pd
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = k0 + nt * 8 + tig * 2;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          unsigned byte = 0xFu;
          if (kDropout)
            byte = brow[hh * 8 * bstride + (key >> 2)];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = hh * 2 + e;
            const float p = fast_exp2((sacc[nt][i] - m[hh]) * kLog2e);
            l[hh] += p;
            float pd = p;
            if (kDropout)
              pd = (byte >> ((key & 3) + e)) & 1u ? p * keep_scale : 0.f;
            sacc[nt][i] = pd;
          }
        }
      }
      Ops::cols(oacc, sacc, vt, lane, n_valid);
    }

    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int row = row0 + gid + 8 * hh;
      if (row >= Tq) continue;
      T* op = out + ((long long)b * Tq + row) * H * D + h * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        Ops::store2(op + dt * 8 + tig * 2, oacc[dt][2 * hh] / l[hh],
                    oacc[dt][2 * hh + 1] / l[hh]);
      if (lse != nullptr && tig == 0)
        lse[((long long)b * H + h) * Tq + row] =
            fmaxf(m[hh], kLseFloor) + logf(l[hh]);
    }
  }
}

template <typename T, bool kDropout, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* key_pad, const int* static_mask, void* out,
                      float* lse, int B, int Tq, int Tk, int H,
                      long long q_sb, long long q_st, long long k_sb,
                      long long k_st, long long v_sb, long long v_st,
                      float scale, const long long* seed,
                      unsigned threshold, float keep_scale, int b_off,
                      int h_off, cudaStream_t stream) {
  const int n_qt = (Tq + kTcRows - 1) / kTcRows;
  const int n_kt = (Tk + kTcRows - 1) / kTcRows;
  const size_t n_buf = kDropout ? 2 : 1;   // bit buffers
  const size_t smem =
      2 * Tc<T, D>::kFwdBufs * Tc<T, D>::kElems * sizeof(T) +
      n_buf * kTcRows * (n_kt * 16 + 4);
  const cudaError_t err =
      allow_smem(attn_fwd_tc_kernel<T, kDropout, D>, smem);
  if (err != cudaSuccess) return err;
  const bool vec = Tk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(key_pad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(static_mask) % 16 == 0;
  const int hpb = heads_per_block(B, n_qt, H);
  const dim3 grid((unsigned)B * n_qt, H / hpb);
  attn_fwd_tc_kernel<T, kDropout, D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_pad, static_mask, static_cast<T*>(out),
      lse, Tq, Tk, H, hpb, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale, seed,
      threshold, keep_scale, b_off, h_off, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (3xTF32), 1 = bfloat16, for q, k, v and out; D must
// be this library's MMFM_HEAD_DIM; data pointers and batch and row strides
// of q, k, v 16-byte
// aligned. lse may be null. Strides in elements. scratch: with dropout,
// the wgmma kernels' keep bytes (bf16 at every width, f32 at 128), B * H *
// ceil(Tk / 8) * (Tq rounded up to 16), 16-byte aligned
// (ops/attention.py::_k1_scratch_bytes, by k1_route); unread otherwise (may
// be null). dropout != 0 drops p[q,k]
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
#define MMFM_K1_LAUNCH(T, DROP)                                              \
  launch_tc<T, DROP, MMFM_HEAD_DIM>(                                         \
      q, k, v, key_pad, static_mask, out, lse, B, Tq, Tk, H, q_sb, q_st,     \
      k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale, b_off,     \
      h_off, s)
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
    err = dropout ? MMFM_K1_LAUNCH(float, true) : MMFM_K1_LAUNCH(float, false);
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
#undef MMFM_K1_LAUNCH
  return (int)err;
}
