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
// comes out as the mean of V (of the kept V with dropout), as in JAX, with
// lse = -1e6 + log(Tk). Keys past Tk carry no weight. q, k and v each take
// a batch stride and a row stride (elements) with unit stride inside the
// row, so the column views of a fused QKV product (row stride 3*H*D) need
// no copy. The output is contiguous (B, Tq, H*D) in the inputs' type.
//
// f32 (the scalar kernel, attn_fwd_kernel): f32 math on the CUDA cores.
// At the main path's shapes (Tq = Tk = 200, H = 8, D = 32) each (b, h)
// pair reads 3 x 200 x 32 values and does 4 x 200 x 200 x 32 flops, ~67
// flops per byte in f32: above the f32 ridge (67 TFLOP/s over 3.35 TB/s =
// 20 flop/B), so the two products bound it. One block per (batch, head,
// 64-query tile), one thread per query row holding q * scale and its
// output accumulator in registers; K_h and V_h stream through shared
// memory in tiles of 32 keys (a broadcast read) with an online softmax that
// rescales the accumulator once per tile; the tile's attend flags are
// staged in shared memory; with dropout the thread draws its row's 32 keep
// bits of the tile with 8 Philox calls.
//
// bf16 (the tensor-core kernel, attn_fwd_tc_kernel): the arithmetic of
// JAX's K1 on its own hardware, where DEFAULT-precision f32 dots feed the
// matrix unit bf16 operands (:189-191, :213-216):
//   s  = bf16(f32(q) * scale) . k + bias     (mma.sync m16n8k16, f32 sums)
//   pd = bf16(keep ? p / (1 - rate) : 0)     (JAX scales before the dot,
//                                             :207-208; bf16(p) at rate 0)
//   o  = (pd . v) / l                        (mma.sync, f32 sums), bf16 out
// with m, l and lse in f32 and the natural log, so the lse is the one
// the bf16 K2 recomputes its probabilities against (attention_bwd.cu: its
// exp(s - lse) rows sum to 1). What bounds it on the H100: bytes, 0.039
// ms at the eval's B = 320 (q, k, v in, out written; the masks once),
// where the products need 0.013 ms at 989 TFLOP/s bf16; the expected
// limiters are the exps (B H Tq Tk, 102 M at B = 320) and, with dropout,
// the Philox draws (one call per 4 scores, 20 M at B = 256), not the
// products. The design is K2 pass A's (attention_bwd.cu, mma_bf16.cuh):
// four warps a block, each holding 16 query rows of q * scale as bf16 A
// fragments in registers; K_h and V_h stream through shared memory in
// 64-key tiles by cp.async (double-buffered, tail rows zero-filled,
// padded rows), read by ldmatrix (.trans for pd . v); an online softmax
// over the tiles rescales the O accumulator per tile, the row max and sum
// reduced across each quad by shuffles; the S accumulators become the A
// fragments of pd . v in registers. A block walks up to all H heads of
// its (batch, 64-query tile): it builds its rows' attend bits from the
// int32 static mask and the key pad once, one byte per (row, 4 keys),
// shared by its heads (read per (b, h) block, the mask was the bf16 K2's
// largest cost), and with dropout draws each head's keep bits (one
// keep_bits4 call per (row, 4 keys), for every key: a fully-masked row
// keeps its dropout) into a second buffer, a slice with each tile of the
// head before, so the draws run beside the products. Any Tq and Tk from 1
// up (shared memory grows by 2 KB a buffer per 64 keys); D = 32 only; the
// operands' data pointers and strides must be 16-byte aligned (cp.async),
// which the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "philox.cuh"

namespace {

using namespace mmfm;

constexpr int kQTile = 64;      // query rows per block (one thread each)
constexpr int kKTile = 32;      // keys per shared-memory tile
constexpr float kLseFloor = -1e6f;  // ops/attention.py _LSE_FLOOR

// the scalar kernel runs f32 only (bf16 takes the tensor-core kernel)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (its building blocks: mma_bf16.cuh)
// ---------------------------------------------------------------------------

// out (and lse) for 64 query rows of one b and heads [h0, h0 + hpb).
template <bool kDropout>
__global__ void __launch_bounds__(kTcThreads)
attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const int* __restrict__ key_pad,
                   const int* __restrict__ static_mask,
                   bf16* __restrict__ out, float* __restrict__ lse, int Tq,
                   int Tk, int H, int hpb, long long q_sb, long long q_st,
                   long long k_sb, long long k_st, long long v_sb,
                   long long v_st, float scale, unsigned seed,
                   unsigned threshold, float keep_scale, bool vec) {
  constexpr int D = kHeadDim;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);        // [2][64][kLd]
  bf16* vs = ks + 2 * kTileElems;                  // [2][64][kLd]
  // [n_buf][64][bstride]: this head's bytes, and the next head's being
  // drawn (dropout only)
  unsigned char* bits = smem + kTileBytes;

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

  // tile idx = (head - h0) * n_kt + t of the block's walk
  auto load_tile = [&](int idx, int buf) {
    const int h = h0 + idx / n_kt;
    const int k0 = (idx % n_kt) * kTcRows;
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

  // keep bits of (row r, keys [k0, k0 + 4)) in head h: every key of a real
  // row, masked or not (a fully-masked row is the mean of the kept V)
  auto keep_of = [&](int h, int r, int k0) -> unsigned {
    return q0 + r < Tq && k0 < Tk
               ? keep_nibble<kDropout>(seed, threshold, b, h, q0 + r, k0)
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
    uint32_t qa[2][4];
    // the running row max and the thread's share of the row sum, for rows
    // gid and gid + 8 of the warp's 16
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float oacc[4][4] = {};
    if (active)
      load_a_frags<true>(qa, q + b * q_sb + h * D, q_st, row0, Tq, lane,
                         scale);

    for (int t = 0; t < n_kt; ++t) {
      const int idx = (h - h0) * n_kt + t, buf = idx & 1;
      cp_async_wait_all();
      __syncthreads();  // tile idx (and the bits) in; the last readers done
      if (idx + 1 < hpb * n_kt) load_tile(idx + 1, buf ^ 1);
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
      const bf16* kt = ks + buf * kTileElems;
      const bf16* vt = vs + buf * kTileElems;

      float sacc[8][4] = {};
      mma_rows(sacc, qa, kt, lane, n_valid);
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
      for (int dt = 0; dt < 4; ++dt) {
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
      mma_cols(oacc, sacc, vt, lane, n_valid);
    }

    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int row = row0 + gid + 8 * hh;
      if (row >= Tq) continue;
      bf16* op = out + ((long long)b * Tq + row) * H * D + h * D;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt)
        *reinterpret_cast<uint32_t*>(op + dt * 8 + tig * 2) =
            pack_bf16(oacc[dt][2 * hh] / l[hh],
                      oacc[dt][2 * hh + 1] / l[hh]);
      if (lse != nullptr && tig == 0)
        lse[((long long)b * H + h) * Tq + row] =
            fmaxf(m[hh], kLseFloor) + logf(l[hh]);
    }
  }
}

template <bool kDropout>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* key_pad, const int* static_mask, void* out,
                      float* lse, int B, int Tq, int Tk, int H,
                      long long q_sb, long long q_st, long long k_sb,
                      long long k_st, long long v_sb, long long v_st,
                      float scale, unsigned seed, unsigned threshold,
                      float keep_scale, cudaStream_t stream) {
  const int n_qt = (Tq + kTcRows - 1) / kTcRows;
  const int n_kt = (Tk + kTcRows - 1) / kTcRows;
  const size_t n_buf = kDropout ? 2 : 1;   // bit buffers
  const size_t smem = kTileBytes + n_buf * kTcRows * (n_kt * 16 + 4);
  const cudaError_t err = allow_smem(attn_fwd_tc_kernel<kDropout>, smem);
  if (err != cudaSuccess) return err;
  const bool vec = Tk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(key_pad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(static_mask) % 16 == 0;
  const int hpb = heads_per_block(B, n_qt, H);
  const dim3 grid((unsigned)B * n_qt, H / hpb);
  attn_fwd_tc_kernel<kDropout><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), key_pad, static_mask,
      static_cast<bf16*>(out), lse, Tq, Tk, H, hpb, q_sb, q_st, k_sb, k_st,
      v_sb, v_st, scale, seed, threshold, keep_scale, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (the tensor-core
// kernel: data pointers and strides 16-byte aligned); D must be 32. lse
// may be null. Strides in elements. dropout != 0 drops p[q,k] unless its
// Philox bits exceed `threshold` and scales survivors by `keep_scale`.
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
    return (int)(dropout ? launch_tc<true> : launch_tc<false>)(
        q, k, v, key_pad, static_mask, out, lse, B, Tq, Tk, H, q_sb, q_st,
        k_sb, k_st, v_sb, v_st, scale, seed, threshold, keep_scale, s);
  return (int)cudaErrorInvalidValue;
}
