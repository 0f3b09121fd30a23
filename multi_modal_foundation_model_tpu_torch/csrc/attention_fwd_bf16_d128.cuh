// K1 in bf16 at head width 128 for Hopper (sm_90a): wgmma over the whole
// key row, 256-byte rows landed by TMA as two 128-byte swizzle atoms, the
// keep bits drawn apart. Included by attention_fwd.cu, which launches it
// for bf16 at head width 128 (and the widths 65-127 the wrapper pads to
// it); 16-64 run attention_fwd_bf16.cuh.
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` with bf16 dots
// (multi_modal_foundation_model_tpu/ops/attention.py:144, launched by
// `_mha_impl`, :349-391) under the bf16 contract of attention_fwd_bf16.cuh:
//   qs = bf16(f32(q) * scale)
//   s  = qs . k^T, -1e30 where not attended, -inf past Tk   (f32 sums)
//   p  = exp(s - m) (s - m first), l = sum_k p (undropped)
//   pd = bf16(keep ? p * keep_scale : 0)
//   o  = (pd . v) / l, stored in bf16;  lse = max(m, -1e6) + log(l), f32
// (o as (pd . v) * (1 / l): one f32 rounding more than a division, far
// below out's bf16 rounding)
// keep is K1's Philox draw (counter (k / 4, q, h + h_off, b + b_off), keyed
// by the low 32 bits of the seed-table entry read on the device), drawn
// first by attn_fwd_keep_kernel (attention_fwd_bf16.cuh) into the
// wrapper's scratch; the bf16 K2 at 128 (attention_bwd_bf16_d128.cuh)
// recomputes these probabilities against this lse and draws these bits
// again. No atomics; a launch is bit-equal to the next.
//
// What bounds it on the H100 at the width row's shape (B = 16, 2 heads of
// 128, Tq = Tk = 200, dropout 0.4, lse): bytes, 0.00202 ms (q, k, v and
// the masks read once, out and lse written once, 3.35 TB/s), where the two
// products need 0.00066 ms at 989 TFLOP/s; at B = 256, 0.0319 ms. The grid
// at B = 16 is 128 blocks (one wave on 132 SMs, a tile a block), so a
// block's serial chain -- its loads, the k-steps of s, the masks and exps,
// the output k-steps, the stores -- sets the time.
//
// The design is the bf16 K2 at 128's pass A (attention_bwd_bf16_d128.cuh)
// without dP:
// - Rows of two atoms. Every tile lands as two TMA boxes of 64 columns
//   (CU_TENSOR_MAP_SWIZZLE_128B, wg::tensor_map at a box width of 64), a
//   box a block of 1 KB-aligned memory. s = qs . k^T takes its first four
//   k-steps of 16 from the first box of q and k and the last four from the
//   second, each k-step 32 bytes into the atom, as the D = 64 kernel does
//   within its one atom.
// - A block per (batch, 64 query rows) and group of heads, two warpgroups
//   (256 threads); warpgroup i takes keys [104 i, 104 i + 104) of a chunk
//   of 208, so s is one m64n104k16 wgmma a k-step, 52 f32 registers a
//   thread, both operands K-major from shared memory.
// - One sweep: up to 208 keys (every attention of the model has 200) the
//   row max and sum are those of the whole key row at once: a quad's
//   shuffles, then the two warpgroups' values exchanged in shared memory
//   (the sums added in that order); longer rows take chunks of 208 with
//   the online rescale between them.
// - The output product takes pd from the accumulators as A fragments in
//   registers (wg::to_frags) and v as B, MN-major, a box at a time: two
//   m64n64k16 wgmmas a k-step, one a box of 64 columns of D, so every B
//   operand lies in one atom and the descriptors are the D = 64 kernel's
//   (wg::desc<128>); o over all of D is 64 f32 registers a thread.
// - Combining the halves: at a head's end each warpgroup hands the other
//   the half of D the other stores (warpgroup 1 its columns [0, 64),
//   warpgroup 0 its [64, 128)) through shared memory, f32 [64][128]; each
//   adds warpgroup 0's partial and warpgroup 1's in that order, multiplies
//   by 1 / l and stores its half, 4 bytes a thread at a time (staged in
//   shared memory and stored 16 bytes a thread, out was no faster:
//   scripts/torch_k1_variants.py, stores_staged); warpgroup 0 writes the
//   lse.
// - Shared memory (Layout): q 16 KB, the k chunk 52 KB, the v chunk 54 KB
//   (8 zero rows a box, which the last k-step of warpgroup 1's output
//   product reads times zero pd), the keep bytes, the exchange 32 KB and
//   the row maxima and sums: 161,416 bytes. A second stage of operands
//   does not fit in 232,448 bytes a block, so there is one stage and the
//   next tile's copies are issued in two parts as its buffers free up: q
//   (with a head's first chunk), k and the keep bytes once s is read, v
//   once the output products are read. One mbarrier, whose expected bytes
//   the first part sets. q is scaled to bf16(q * scale) in place once it
//   lands.
// - The attend bits (the static mask OR the key pad) are read once a block
//   where the row is one chunk and kept in registers for every head it
//   walks; all of a thread's loads of them are issued at once, their
//   indices clamped into the masks (guarded by the bounds, such loads took
//   a quarter of the bf16 K2 at 128).
// - Grid: wg::walk_heads sizes heads a block to whole waves (at B = 16 one
//   head a block, 128 blocks; at B = 256 two).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_bf16.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace mmfm {
namespace k1b128 {

// the whole-key-row tiling of the D <= 64 kernels (kThreads, kRows, kCols,
// kChunk, kBRows, kAcc, kSteps, kBits, kKeepBytes, kKeepBuf, to_frags, ...)
using namespace wg;
using k1wg::Args;

constexpr int kD = 128;                           // the head width
constexpr int kBox = 64;                          // bf16 a box row: an atom
constexpr int kAtom = 128;                        // bytes a box row

// The dynamic shared memory of a block, in bytes: q (two boxes of 64
// rows), the k chunk (two boxes of 208 rows), the v chunk (two boxes of 216
// rows: 8 zero rows each), the keep bytes, the exchange of the output
// halves (f32 [64][128]), the row maxima and sums (f32 [2][64] each) and
// the mbarrier.
struct Layout {
  static constexpr int kQBox = align1k(kRows * kAtom);
  static constexpr int kKBox = align1k(kChunk * kAtom);
  static constexpr int kVBox = align1k(kBRows * kAtom);
  static constexpr int kK = 2 * kQBox;
  static constexpr int kV = kK + 2 * kKBox;
  static constexpr int kStage = kV + 2 * kVBox;   // q, k, v
  static constexpr int kKeep = kStage;
  static constexpr int kXchg = kKeep + kKeepBuf;
  static constexpr int kMax = kXchg + kRows * kD * 4;
  static constexpr int kSum = kMax + 2 * kRows * 4;
  static constexpr int kBar = kSum + 2 * kRows * 4;
  static constexpr int kBytes = kBar + 8 + 1024;  // + the alignment
  static_assert(kBytes <= 232448, "a block's shared memory on the H100");
  static_assert(kBytes + kStage > 232448, "one stage only");
};

// out (and lse) for 64 query rows of one b and heads [h0, h0 + hpb)
template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_wg128_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap keep_map,
                          const Args a) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const xchg = reinterpret_cast<float*>(sm + L::kXchg);
  float* const rmax = reinterpret_cast<float*>(sm + L::kMax);
  float* const rsum = reinterpret_cast<float*>(sm + L::kSum);
  const uint32_t bar = base + L::kBar;
  const uint32_t Q = base, K = base + L::kK, V = base + L::kV;

  const int n_qt = (a.Tq + kRows - 1) / kRows;
  const int b = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int h0 = blockIdx.y * a.hpb;
  const int tid = threadIdx.x, wgi = tid >> 7, t128 = tid & 127;
  const int w = t128 >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int lr = 16 * w + g;               // this thread's rows: + 0, + 8
  const int row0 = q0 + lr;
  const bool live = q0 + 16 * w < a.Tq;    // the warp has rows to compute
  const int n_ch = (a.Tk + kChunk - 1) / kChunk;
  const int n_tiles = a.hpb * n_ch;

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  // the 8 rows past each of v's boxes, which the last k-step of warpgroup
  // 1's output product reads (times zero pd), zeroed once
  constexpr int kPad = 8 * kAtom / 16;     // 16-byte words of 8 rows
  for (int i = tid; i < 2 * kPad; i += kThreads) {
    const int off = L::kV + (i / kPad) * L::kVBox + kChunk * kAtom +
                    (i % kPad) * 16;
    *reinterpret_cast<uint4*>(sm + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_shared();
  __syncthreads();

  // Tile t = (head, chunk) of the block's walk into the one stage. Part 1
  // (parts & 1): the barrier's expected bytes, q with a head's first
  // chunk, k and the keep bytes, whose buffers are free once s is read;
  // part 2 (parts & 2): v, free once the output products are read. Each
  // operand lands as two boxes of 64 columns.
  auto issue = [&](int t, int parts) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    const bool rows = ch == 0;
    const int c1 = ch * kChunk;
    if (parts & 1) {
      mbar_expect(bar, (rows ? kRows * 2 * kD : 0) + 2 * kChunk * 2 * kD +
                           (kDropout ? kKeepBytes : 0));
      if (kDropout)
        tma_load(base + L::kKeep, &keep_map, bar, q0, ch * (kChunk / 8),
                 b * a.H + h);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c0 = h * kD + kBox * hf;
        if (rows) tma_load(Q + hf * L::kQBox, &q_map, bar, c0, q0, b);
        tma_load(K + hf * L::kKBox, &k_map, bar, c0, c1, b);
      }
    }
    if (parts & 2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        tma_load(V + hf * L::kVBox, &v_map, bar, h * kD + kBox * hf, c1, b);
    }
  };
  if (tid == 0) issue(0, 3);

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]. Every load is issued
  // (indices clamped into the masks), so that they are in flight together.
  auto attend = [&](int ch, uint32_t (&m)[2]) {
    m[0] = m[1] = 0u;
    const int cb = ch * kChunk + wgi * kCols + 2 * c;
#pragma unroll
    for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int k = cb + 8 * j + e, q = row0 + 8 * hh;
          const int qc = min(q, a.Tq - 1), kc = min(k, a.Tk - 1);
          const int on = __ldg(a.static_mask + (long long)qc * a.Tk + kc) |
                         __ldg(a.key_pad + (long long)b * a.Tk + kc);
          if (q < a.Tq && k < a.Tk && on != 0) m[hh] |= 1u << (2 * j + e);
        }
  };

  // the keep bits of this thread's elements, in attend's order, from the
  // stage's [26 key bytes][64 queries]: keys 104 wgi + 8 j + 2 c + e are
  // bits 2 c + e of byte 13 wgi + j of the query's column
  auto load_keep = [&](const unsigned char* mk, uint32_t (&keep)[2]) {
    keep[0] = keep[1] = 0u;
#pragma unroll
    for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t byte =
            mk[((kCols / 8) * wgi + j) * kRows + lr + 8 * hh];
        keep[hh] |= (byte >> (2 * c) & 3u) << (2 * j);
      }
  };

  uint32_t att[2] = {0u, 0u};
  if (n_ch == 1) attend(0, att);
  // the row max and this thread's share of the row sum, rows + 0 and + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // o's columns [0, 64) and [64, 128) over this warpgroup's keys
  float o1[32] = {}, o2[32] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    const bool last = ch == n_ch - 1, more = t + 1 < n_tiles;
    if (n_ch > 1) attend(ch, att);
    if (ch == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m[hh] = -INFINITY;
        l[hh] = 0.f;
      }
    }

    // the tile landed; with a head's first chunk, q scaled to bf16(q *
    // scale) in place
    mbar_wait(bar, t & 1);
    if (ch == 0) {
      for (int i = tid * 16; i < 2 * L::kQBox; i += kThreads * 16) {
        uint4* pq = reinterpret_cast<uint4*>(sm + i);
        uint4 x = *pq;
        x.x = scale_bf16x2(x.x, a.scale);
        x.y = scale_bf16x2(x.y, a.scale);
        x.z = scale_bf16x2(x.z, a.scale);
        x.w = scale_bf16x2(x.w, a.scale);
        *pq = x;
      }
      fence_async_shared();
      __syncthreads();
    }

    // s = qs . k^T over this warpgroup's 104 keys: k-steps 0-3 of D in the
    // first box of each operand, 4-7 in the second
    const uint32_t kw = K + wgi * kCols * kAtom;
    float s[kAcc] = {};
    hold(s);
    fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      mma_ss_n104(s, desc_add(desc<kAtom>(Q + (kk >> 2) * L::kQBox),
                              32 * (kk & 3)),
                  desc_add(desc<kAtom>(kw + (kk >> 2) * L::kKBox),
                           32 * (kk & 3)),
                  kk);
    commit();
    // the keep bits while the product runs
    uint32_t keep[2] = {~0u, ~0u};
    if (kDropout) load_keep(sm + L::kKeep, keep);
    wait<0>();
    hold(s);

    // A warp whose 16 rows lie past Tq (three of the four of the last row
    // tile at 200 queries) skips the softmax: its q rows landed as zeros,
    // so its s and pd are zero, and its outputs are never stored.
    const int kb0 = ch * kChunk + wgi * kCols + 2 * c;  // element (0, 0, 0)
    if (live) {
      // the bias, -inf past Tk; the row's max over this warpgroup's keys
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            float x = s[i];
            if (!(att[hh] >> (2 * j + e) & 1u)) x = kNegInf;
            if (kb0 + 8 * j + e >= a.Tk) x = -INFINITY;
            s[i] = x;
            cmax[hh] = fmaxf(cmax[hh], x);
          }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {           // the quad holds one row
        cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 1));
        cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 2));
        if (c == 0) rmax[wgi * kRows + lr + 8 * hh] = cmax[hh];
      }
    }
    // both warpgroups' row maxima in; q, k and the keep bytes are read
    __syncthreads();
    if (tid == 0 && more) issue(t + 1, 1);
    if (live) {
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // the chunk starts below Tk, so the new max is finite; the first
        // chunk's correction is exp2(-inf) = 0
        const float m_new =
            fmaxf(m[hh], fmaxf(rmax[lr + 8 * hh], rmax[kRows + lr + 8 * hh]));
        corr[hh] = fast_exp2((m[hh] - m_new) * kLog2e);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      }
      if (ch > 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          o1[i] *= corr[(i >> 1) & 1];
          o2[i] *= corr[(i >> 1) & 1];
        }
      }
      // p = exp(s - m) (s - m first: a fully-masked row's -1e30 - -1e30 is
      // exactly 0), summed undropped; pd in its place
#pragma unroll
      for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const float p = fast_exp2((s[i] - m[hh]) * kLog2e);
            l[hh] += p;
            float pd = p;
            if (kDropout)
              pd = keep[hh] >> (2 * j + e) & 1u ? p * a.keep_scale : 0.f;
            s[i] = pd;
          }
    }

    // o += pd . v over this warpgroup's 104 keys, a box of 64 columns of D
    // at a time
    uint32_t f[kSteps][4];
    to_frags(f, s);
    hold(f);
    fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t vr = V + (wgi * kCols + 16 * kk) * kAtom;
      mma_rs_n64(o1, f[kk], desc<kAtom>(vr), ch > 0 || kk > 0);
      mma_rs_n64(o2, f[kk], desc<kAtom>(vr + L::kVBox), ch > 0 || kk > 0);
    }
    commit();
    wait<0>();
    hold(o1);
    hold(o2);
    hold(f);

    if (last) {
      // the row sums, and the half of o the other warpgroup stores
      if (live) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
          if (c == 0) rsum[wgi * kRows + lr + 8 * hh] = l[hh];
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        xchg[(32 * wgi + i) * 128 + t128] = wgi == 0 ? o2[i] : o1[i];
    }
    // v is read, and the halves handed over
    __syncthreads();
    if (tid == 0 && more) issue(t + 1, 2);
    if (last && live) {
      // warpgroup 0's partial plus warpgroup 1's, times 1 / l (divided by
      // l, each element, the kernel took 3-7% longer): warpgroup 0 stores
      // columns [0, 64), warpgroup 1 [64, 128)
      const float* other = xchg + (wgi == 0 ? 32 : 0) * 128 + t128;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= a.Tq) continue;
        const float sum = rsum[lr + 8 * hh] + rsum[kRows + lr + 8 * hh];
        const float inv = 1.f / sum;
        bf16* op = a.out + ((long long)b * a.Tq + row) * a.H * kD + h * kD +
                   kBox * wgi;
#pragma unroll
        for (int nt = 0; nt < kBox / 8; ++nt) {
          const int i = 4 * nt + 2 * hh;
          const float x0 = other[i * 128], x1 = other[(i + 1) * 128];
          const float s0 = wgi == 0 ? o1[i] + x0 : x0 + o2[i];
          const float s1 = wgi == 0 ? o1[i + 1] + x1 : x1 + o2[i + 1];
          *reinterpret_cast<uint32_t*>(op + 8 * nt + 2 * c) =
              pack_bf16(s0 * inv, s1 * inv);
        }
        if (a.lse != nullptr && wgi == 0 && c == 0)
          a.lse[((long long)b * a.H + h) * a.Tq + row] =
              fmaxf(m[hh], kLseFloor) + logf(sum);
      }
    }
  }
}

// The keep draws (with dropout) and the kernel on the stream: operands as
// mmfm_attention_fwd takes them (attention_fwd.cu) at head width 128; with
// dropout the scratch holds the keep bytes (B, H, ceil(Tk / 8),
// keep_row(Tq)) (ops/attention.py::_k1_scratch_bytes).
template <bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* key_pad, const int* static_mask, void* out,
                   float* lse, void* scratch, int B, int Tq, int Tk, int H,
                   long long q_sb, long long q_st, long long k_sb,
                   long long k_st, long long v_sb, long long v_st,
                   float scale, const long long* seed, unsigned threshold,
                   float keep_scale, int b_off, int h_off,
                   cudaStream_t stream) {
  const int hidden = H * kD;
  const int kb_n = (Tk + 7) / 8, tq16 = keep_row(Tq);
  uint32_t* keep = static_cast<uint32_t*>(scratch);
  // boxes of 64 columns (one 128-byte swizzle atom) of the 128 of a head
  CUtensorMap q_map, k_map, v_map, keep_map{};
  if (!tensor_map(&q_map, q, hidden, Tq, B, q_st, q_sb, kBox, kRows) ||
      !tensor_map(&k_map, k, hidden, Tk, B, k_st, k_sb, kBox, kChunk) ||
      !tensor_map(&v_map, v, hidden, Tk, B, v_st, v_sb, kBox, kChunk))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kDropout) {
    if (keep == nullptr ||
        !byte_map(&keep_map, keep, tq16, kb_n, B * H, kRows, kChunk / 8))
      return cudaErrorInvalidValue;
    const long long n = (long long)B * H * kb_n * (tq16 / 4);
    k1wg::attn_fwd_keep_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                 stream>>>(keep, seed, threshold, H, Tq,
                                           kb_n, tq16, b_off, h_off, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto* kernel = attn_fwd_wg128_kernel<kDropout>;
  err = allow_smem(kernel, Layout::kBytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kRows - 1) / kRows;
  const Args args{static_cast<bf16*>(out),
                  lse,
                  key_pad,
                  static_mask,
                  Tq,
                  Tk,
                  H,
                  walk_heads(B, n_qt, H),
                  scale,
                  keep_scale};
  kernel<<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, Layout::kBytes,
           stream>>>(q_map, k_map, v_map, keep_map, args);
  return cudaGetLastError();
}

}  // namespace k1b128
}  // namespace mmfm
