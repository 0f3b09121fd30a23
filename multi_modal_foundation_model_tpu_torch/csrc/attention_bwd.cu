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
// The TPU kernel ran a whole batch block per sequential grid step with two
// (GB, H*Tq, Tk) VMEM scratch stacks; nothing like it fits an SM, and
// blocks run in no order, so both designs here take two passes with no
// atomics (bit-reproducible from run to run):
//   Pass A, one block per (batch, head, 64-query tile): a first sweep over
//     the keys sums rowsum = sum_k dpn * pn, a second computes ds and
//     accumulates dq. rowsum goes to a small (B, H, Tq) f32 buffer.
//   Pass B, one block per (batch, head, 64-key tile): dk and dv, with
//     q * scale, g, lse and rowsum streamed over the queries.
// Pass A recomputes s and g . v twice and pass B once more: 9 products
// where the bound counts 5. Dropout bits are recomputed with the same
// Philox counter (k/4, q, h, b) as K1 (philox.cuh).
// q, k, v and g take batch and row strides (the fused-QKV column views go in
// without a copy); dq, dk, dv are written contiguous, in the operands' dtype
// (JAX's out_shape, :444-446). lse and the rowsum scratch stay f32.
//
// f32 (the scalar kernels, attn_bwd_dq_kernel / attn_bwd_dkdv_kernel): one
// thread per row holding its operands and accumulators in registers, the
// other side streamed through shared memory in 32-row tiles, f32 FMAs on
// the CUDA cores. What bounds it on the H100: the five products, 10 B H Tq
// Tk D flops at 67 TFLOP/s f32 (0.391 ms at the training step's B = 256,
// Tq = Tk = 200, H = 8, D = 32). Pass A draws the 4 keys of one Philox
// counter per call inside its key loop, pass B one word per (query, key).
// (Gathering a 32-key tile's bits into one register up front, as K1 does,
// read back wrong bits in this kernel on the H100 with nvcc 12.8; drawing
// per 4 keys reads back right: tests/test_torch_kernels.py.)
//
// bf16 (the tensor-core kernels, attn_bwd_dq_tc_kernel /
// attn_bwd_dkdv_tc_kernel): the arithmetic of JAX's K2 on its own hardware
// (dots_dtype = bf16, :431): qs = bf16(f32(q) * scale), k, v, g in bf16;
// the five products take bf16 operands and accumulate in f32
// (mma.sync.m16n8k16 through inline PTX); ds and pd are rounded to bf16
// before the dq, dk and dv products. Four warps a block, each owning 16
// rows of its side: its two bf16 operands (q*scale and g, or k and v) are
// mma A fragments in registers; the other side streams through shared
// memory in 64-row tiles by cp.async (16 B a copy, double-buffered, tail
// rows zero-filled) and is read by ldmatrix (.trans for the second
// product's B operand). The s and g.v accumulators turn into the bf16 A
// fragments of the next product in registers, never touching memory.
// Pass A draws the keep bits of its 64 query rows against every key into
// shared memory, one keep_bits4 call per (query, 4 keys) spread over its
// threads, next to the attend bits of the mask (one byte per (row, 4 keys):
// keep in the low nibble, attend in the high one), reads them in both
// sweeps, and writes each head's bytes out to the scratch after rowsum
// (B H Tq Tk / 4 bytes, rows padded to 64 keys: 26 MB at the training
// step's shape); pass B streams its 16 bytes a query with the query tiles.
// So each 4 scores cost one Philox call in all, and the (Tq, Tk) int32
// static mask is read by pass A alone. A block walks through up to all H
// heads of its (batch, row tile): pass A reads the static mask once for
// all of them (read per (b, h) block, it was the kernel's largest cost) and
// redraws only the keep bits per head, into a second buffer, a slice with
// each tile of the head before, so that the draws run beside the products.
// What bounds it on the H100:
// bytes, 0.0554 ms at the training step's shape (q, g, k, v, lse in, dq,
// dk, dv out, 3.35 TB/s), where the products need 0.047 ms at 989 TFLOP/s
// bf16; the expected limiters are the Philox draws (26 M calls) and the
// exps (3 x 82 M), not the products. D = 32 only; the operands' data
// pointers and strides must be 16-byte aligned (cp.async), which the
// wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "philox.cuh"

namespace {

using namespace mmfm;

constexpr int kRows = 64;           // rows per block (one thread each)
constexpr int kTile = 32;           // streamed rows per shared-memory tile

// the scalar kernels run f32 only (bf16 takes the tensor-core kernels)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (their building blocks: mma_bf16.cuh)
// ---------------------------------------------------------------------------

// Pass A (bf16, tensor cores): rowsum and dq for 64 query rows of one b and
// heads [h0, h0 + hpb); and each head's mask bytes (attend and keep bits)
// for pass B, in mask_out[b][h][q][n_kt * 16].
template <bool kDropout>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const int* __restrict__ key_pad,
                      const int* __restrict__ static_mask,
                      const float* __restrict__ lse, bf16* __restrict__ dq,
                      float* __restrict__ rowsum,
                      uint32_t* __restrict__ mask_out, int Tq, int Tk, int H,
                      int hpb, long long q_sb, long long q_st, long long k_sb,
                      long long k_st, long long v_sb, long long v_st,
                      long long g_sb, long long g_st, float scale,
                      unsigned seed, unsigned threshold, float keep_scale,
                      bool vec) {
  constexpr int D = kHeadDim;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);        // [2][64][kLd]
  bf16* vs = ks + 2 * kTileElems;                  // [2][64][kLd]
  // [2][64][bstride]: this head's bytes, and the next head's being drawn
  unsigned char* bits = smem + kTileBytes;

  const int n_qtiles = (Tq + kTcRows - 1) / kTcRows;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTcRows;
  const int h0 = blockIdx.y * hpb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_kt = (Tk + kTcRows - 1) / kTcRows;
  const int n_t = 2 * n_kt;      // tiles a head: sweep 1, then sweep 2
  // 16 groups of 4 keys a tile, + 4 bytes so that rows 8 apart in a warp's
  // byte reads fall on distinct banks
  const int bstride = n_kt * 16 + 4;
  const int n_items = kTcRows * bstride;
  const int chunk = (n_items + n_t - 1) / n_t;

  // tile idx = (head - h0) * n_t + t of the block's walk
  auto load_tile = [&](int idx, int buf) {
    const int h = h0 + idx / n_t;
    const int k0 = (idx % n_t % n_kt) * kTcRows;
    const bf16* kb = k + b * k_sb + h * D;
    const bf16* vb = v + b * v_sb + h * D;
    for (int c = tid; c < kTcRows * 4; c += kTcThreads) {
      const int r = c >> 2, ch = (c & 3) * 8;
      const int key = k0 + r;
      const bool ok = key < Tk;
      const long long row = ok ? key : 0;
      cp_async16(smem_u32(ks + buf * kTileElems + r * kLd + ch),
                 kb + row * k_st + ch, ok);
      cp_async16(smem_u32(vs + buf * kTileElems + r * kLd + ch),
                 vb + row * v_st + ch, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  const int* pad = key_pad + (long long)b * Tk;
  for (int i = tid; i < kTcRows * bstride; i += kTcThreads) {
    const int r = i / bstride, k0 = (i - r * bstride) * 4;
    const unsigned att =
        attend_nibble(static_mask, pad, Tq, Tk, q0 + r, k0, vec);
    bits[i] = (unsigned char)(att ? att | keep_nibble<kDropout>(
                                              seed, threshold, b, h0, q0 + r,
                                              k0)
                                  : 0u);
  }

  const int row0 = q0 + warp * 16;
  const bool active = row0 < Tq;  // else the warp only helps with copies
  for (int h = h0; h < h0 + hpb; ++h) {
    const int cur = kDropout ? (h - h0) & 1 : 0;
    const unsigned char* brow =
        bits + cur * n_items + (warp * 16 + gid) * bstride;
    uint32_t qa[2][4], ga[2][4];
    float lse2[2], rs[2] = {0.f, 0.f};
    float dqa[4][4] = {};
    if (active) {
      load_a_frags<true>(qa, q + b * q_sb + h * D, q_st, row0, Tq, lane,
                         scale);
      load_a_frags<false>(ga, g + b * g_sb + h * D, g_st, row0, Tq, lane,
                          1.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + gid + 8 * hh;
        lse2[hh] = row < Tq ? lse[((long long)b * H + h) * Tq + row] * kLog2e
                            : 0.f;
      }
    }

    for (int t = 0; t < n_t; ++t) {
      const int idx = (h - h0) * n_t + t, buf = idx & 1;
      cp_async_wait_all();
      __syncthreads();  // tile idx (and the bits) in; the last readers done
      if (idx + 1 < hpb * n_t) load_tile(idx + 1, buf ^ 1);
      if (t == 0) {
        // this head's bytes, complete since the barrier, out for pass B
        const int words = n_kt * 4;        // of a row
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(bits + cur * n_items);
        for (int i = tid; i < kTcRows * words; i += kTcThreads) {
          const int r = i / words, w = i - r * words;
          if (q0 + r < Tq)
            mask_out[(((long long)b * H + h) * Tq + q0 + r) * words + w] =
                src[r * (bstride / 4) + w];
        }
      }
      if (kDropout && h + 1 < h0 + hpb) {
        // a slice of the next head's keep bits, into the other buffer (its
        // readers finished with the last head), interleaved with this
        // head's tiles so the Philox draws overlap the products
        const unsigned char* src = bits + cur * n_items;
        unsigned char* dst = bits + (cur ^ 1) * n_items;
        const int end = min(n_items, (t + 1) * chunk);
        for (int i = t * chunk + tid; i < end; i += kTcThreads) {
          const unsigned att = src[i] & 0xF0u;
          const int r = i / bstride, k0 = (i - r * bstride) * 4;
          dst[i] = (unsigned char)(att ? att | keep_nibble<kDropout>(
                                                   seed, threshold, b, h + 1,
                                                   q0 + r, k0)
                                       : 0u);
        }
      }
      if (!active) continue;
      const bool sweep2 = t >= n_kt;
      const int k0 = (t % n_kt) * kTcRows;
      const int n_valid = min(kTcRows, Tk - k0);
      const bf16* kt = ks + buf * kTileElems;
      const bf16* vt = vs + buf * kTileElems;

      float sacc[8][4] = {}, dacc[8][4] = {};
      mma_rows(sacc, qa, kt, lane, n_valid);
      mma_rows(dacc, ga, vt, lane, n_valid);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= n_valid) break;
        const int key = k0 + nt * 8 + tig * 2;   // and key + 1: one group
        const int sh = key & 3;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const unsigned byte = brow[hh * 8 * bstride + (key >> 2)];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = hh * 2 + e;
            const float pn =
                (byte >> (4 + sh + e)) & 1u
                    ? fast_exp2(fmaf(sacc[nt][i], kLog2e, -lse2[hh]))
                    : 0.f;
            float dpn = dacc[nt][i];
            if (kDropout)
              dpn = (byte >> (sh + e)) & 1u ? dpn * keep_scale : 0.f;
            if (!sweep2)
              rs[hh] = fmaf(dpn, pn, rs[hh]);
            else
              sacc[nt][i] = pn * (dpn - rs[hh]);   // ds
          }
        }
      }
      if (t == n_kt - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {        // the quad holds one row
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
        }
      }
      if (sweep2) mma_cols(dqa, sacc, kt, lane, n_valid);
    }

    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + gid + 8 * hh;
      if (row >= Tq) continue;
      bf16* op = dq + ((long long)b * Tq + row) * H * D + h * D;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt)
        *reinterpret_cast<uint32_t*>(op + dt * 8 + tig * 2) =
            pack_bf16(dqa[dt][2 * hh] * scale, dqa[dt][2 * hh + 1] * scale);
      if (tig == 0) rowsum[((long long)b * H + h) * Tq + row] = rs[hh];
    }
  }
}

// Pass B (bf16, tensor cores): dk and dv for 64 key rows of one b and heads
// [h0, h0 + hpb). The attend and keep bits come from pass A (mask_in), 16
// bytes a query for the block's 64 keys, streamed with the query tiles: no
// Philox draws and no mask reads here.
template <bool kDropout>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ g,
                        const uint32_t* __restrict__ mask_in,
                        const float* __restrict__ lse,
                        const float* __restrict__ rowsum,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq,
                        int Tk, int H, int hpb, long long q_sb, long long q_st,
                        long long k_sb, long long k_st, long long v_sb,
                        long long v_st, long long g_sb, long long g_st,
                        float scale, float keep_scale) {
  constexpr int D = kHeadDim;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [2][64][kLd]
  bf16* gs = qs + 2 * kTileElems;                  // [2][64][kLd]
  float* lse_s = reinterpret_cast<float*>(smem + kTileBytes);  // [2][64]
  float* sum_s = lse_s + 2 * kTcRows;                          // [2][64]
  // [2][64][4] words: one byte per (query, 4 of the block's keys)
  uint32_t* bits = reinterpret_cast<uint32_t*>(sum_s + 2 * kTcRows);

  const int n_ktiles = (Tk + kTcRows - 1) / kTcRows;
  const int b = blockIdx.x / n_ktiles;
  const int kt = blockIdx.x % n_ktiles;
  const int key0 = kt * kTcRows;
  const int h0 = blockIdx.y * hpb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_qt = (Tq + kTcRows - 1) / kTcRows;
  const int words = n_ktiles * 4;  // of a mask_in row

  // tile idx = (head - h0) * n_qt + t of the block's walk
  auto load_tile = [&](int idx, int buf) {
    const int h = h0 + idx / n_qt;
    const int q0 = (idx % n_qt) * kTcRows;
    const bf16* qb = q + b * q_sb + h * D;
    const bf16* gb = g + b * g_sb + h * D;
    for (int c = tid; c < kTcRows * 4; c += kTcThreads) {
      const int r = c >> 2, ch = (c & 3) * 8;
      const int qrow = q0 + r;
      const bool ok = qrow < Tq;
      const long long row = ok ? qrow : 0;
      cp_async16(smem_u32(qs + buf * kTileElems + r * kLd + ch),
                 qb + row * q_st + ch, ok);
      cp_async16(smem_u32(gs + buf * kTileElems + r * kLd + ch),
                 gb + row * g_st + ch, ok);
    }
    const int r = tid & (kTcRows - 1);
    const bool ok = q0 + r < Tq;
    const long long row = ((long long)b * H + h) * Tq + (ok ? q0 + r : 0);
    if (tid < kTcRows) {
      cp_async4(smem_u32(lse_s + buf * kTcRows + r), lse + row, ok);
      cp_async16(smem_u32(bits + (buf * kTcRows + r) * 4),
                 mask_in + row * words + kt * 4, ok);
    } else {
      cp_async4(smem_u32(sum_s + buf * kTcRows + r), rowsum + row, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  const int kr0 = key0 + warp * 16;
  const bool active = kr0 < Tk;   // else the warp only helps with copies
  // the bit of keys gid, gid + 8 in this warp's 4 bytes of a query's 16
  const int sh0 = 8 * (gid >> 2) + (gid & 3);
  for (int h = h0; h < h0 + hpb; ++h) {
    uint32_t ka[2][4], va[2][4];
    float dka[4][4] = {}, dva[4][4] = {};
    if (active) {
      load_a_frags<false>(ka, k + b * k_sb + h * D, k_st, kr0, Tk, lane, 1.f);
      load_a_frags<false>(va, v + b * v_sb + h * D, v_st, kr0, Tk, lane, 1.f);
    }

    for (int t = 0; t < n_qt; ++t) {
      const int idx = (h - h0) * n_qt + t, buf = idx & 1;
      cp_async_wait_all();
      __syncthreads();  // tile idx in; the last tile's readers done
      if (idx + 1 < hpb * n_qt) load_tile(idx + 1, buf ^ 1);
      bf16* qt = qs + buf * kTileElems;
      const bf16* gt = gs + buf * kTileElems;
      const uint32_t* bw = bits + buf * kTcRows * 4 + warp;
      const int n_valid = min(kTcRows, Tq - t * kTcRows);
      // qs = bf16(f32(q) * scale), in place
      for (int c = tid; c < kTcRows * 4; c += kTcThreads) {
        uint4* p = reinterpret_cast<uint4*>(qt + (c >> 2) * kLd + (c & 3) * 8);
        uint4 w = *p;
        w.x = scale_bf16x2(w.x, scale);
        w.y = scale_bf16x2(w.y, scale);
        w.z = scale_bf16x2(w.z, scale);
        w.w = scale_bf16x2(w.w, scale);
        *p = w;
      }
      __syncthreads();
      if (!active) continue;

      // s^T and (g . v)^T: rows the warp's 16 keys, columns the 64 queries
      float sacc[8][4] = {}, dacc[8][4] = {};
      mma_rows(sacc, ka, qt, lane, n_valid);
      mma_rows(dacc, va, gt, lane, n_valid);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= n_valid) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = nt * 8 + tig * 2 + e;
          const uint32_t word = bw[ql * 4];
          const float lse2 = lse_s[buf * kTcRows + ql] * kLog2e;
          const float rsum = sum_s[buf * kTcRows + ql];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = hh * 2 + e;
            const int sh = sh0 + 16 * hh;
            const float pn = (word >> (sh + 4)) & 1u
                                 ? fast_exp2(fmaf(sacc[nt][i], kLog2e, -lse2))
                                 : 0.f;
            float ms = 1.f;
            if (kDropout) ms = (word >> sh) & 1u ? keep_scale : 0.f;
            sacc[nt][i] = pn * ms;                              // pd
            dacc[nt][i] = pn * (dacc[nt][i] * ms - rsum);       // ds
          }
        }
      }
      mma_cols(dva, sacc, gt, lane, n_valid);
      mma_cols(dka, dacc, qt, lane, n_valid);
    }

    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kr0 + gid + 8 * hh;
      if (key >= Tk) continue;
      const long long o = ((long long)b * Tk + key) * H * D + h * D;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        const int d = dt * 8 + tig * 2;
        *reinterpret_cast<uint32_t*>(dk + o + d) =
            pack_bf16(dka[dt][2 * hh], dka[dt][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + d) =
            pack_bf16(dva[dt][2 * hh], dva[dt][2 * hh + 1]);
      }
    }
  }
}


template <bool kDropout>
cudaError_t launch_tc(const void* q_, const void* k_, const void* v_,
                      const void* g_, const int* key_pad,
                      const int* static_mask, const float* lse, float* rowsum,
                      void* dq_, void* dk_, void* dv_, int B, int Tq, int Tk,
                      int H, long long q_sb, long long q_st, long long k_sb,
                      long long k_st, long long v_sb, long long v_st,
                      long long g_sb, long long g_st, float scale,
                      unsigned seed, unsigned threshold, float keep_scale,
                      cudaStream_t stream) {
  const bf16* q = static_cast<const bf16*>(q_);
  const bf16* k = static_cast<const bf16*>(k_);
  const bf16* v = static_cast<const bf16*>(v_);
  const bf16* g = static_cast<const bf16*>(g_);
  const int n_qt = (Tq + kTcRows - 1) / kTcRows;
  const int n_kt = (Tk + kTcRows - 1) / kTcRows;
  const size_t n_buf = kDropout ? 2 : 1;   // pass A's bit buffers
  const size_t smem_a = kTileBytes + n_buf * kTcRows * (n_kt * 16 + 4);
  const size_t smem_b = kTileBytes + 4 * kTcRows * sizeof(float) +
                        2 * kTcRows * 16;
  // pass A's mask bytes for pass B, (B, H, Tq, n_kt * 16), after rowsum in
  // the scratch, 16-byte aligned
  const uintptr_t tail =
      reinterpret_cast<uintptr_t>(rowsum + (size_t)B * H * Tq);
  uint32_t* mask = reinterpret_cast<uint32_t*>((tail + 15) & ~uintptr_t(15));
  cudaError_t err = allow_smem(attn_bwd_dq_tc_kernel<kDropout>, smem_a);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkdv_tc_kernel<kDropout>, smem_b);
  if (err != cudaSuccess) return err;
  const bool vec = Tk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(key_pad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(static_mask) % 16 == 0;
  const int hpb_a = heads_per_block(B, n_qt, H);
  const dim3 grid_a((unsigned)B * n_qt, H / hpb_a);
  attn_bwd_dq_tc_kernel<kDropout><<<grid_a, kTcThreads, smem_a, stream>>>(
      q, k, v, g, key_pad, static_mask, lse, static_cast<bf16*>(dq_), rowsum,
      mask, Tq, Tk, H, hpb_a, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale,
      seed, threshold, keep_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hpb_b = heads_per_block(B, n_kt, H);
  const dim3 grid_b((unsigned)B * n_kt, H / hpb_b);
  attn_bwd_dkdv_tc_kernel<kDropout><<<grid_b, kTcThreads, smem_b, stream>>>(
      q, k, v, g, mask, lse, rowsum, static_cast<bf16*>(dk_),
      static_cast<bf16*>(dv_), Tq, Tk, H, hpb_b, q_sb, q_st, k_sb, k_st, v_sb,
      v_st, g_sb, g_st, scale, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the scalar kernels), 1 = bfloat16 (the tensor-core
// kernels: data pointers and strides 16-byte aligned) for q, k, v, g, dq,
// dk, dv; D must be 32.
// Strides in elements; dq (B, Tq, H*D), dk and dv (B, Tk, H*D) contiguous;
// rowsum is (B, H, Tq) f32 scratch written by pass A and read by pass B;
// for bf16 it must also hold, after those floats and 16-byte aligned, pass
// A's mask bytes for pass B: B * H * Tq * ceil(Tk / 64) * 16 bytes
// (ops/attention.py::_k2_scratch_floats).
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
#undef MMFM_K2_LAUNCH
#define MMFM_K2_LAUNCH_TC(DROP)                                              \
  launch_tc<DROP>(q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, \
                  B, Tq, Tk, H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb,    \
                  g_st, scale, seed, threshold, keep_scale, s)
  else if (dtype == 1)
    err = dropout ? MMFM_K2_LAUNCH_TC(true) : MMFM_K2_LAUNCH_TC(false);
#undef MMFM_K2_LAUNCH_TC
  return (int)err;
}
