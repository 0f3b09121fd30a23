// K1 in bf16 for Hopper (sm_90a): wgmma over the whole key row, a one-sweep
// softmax, tiles fed by TMA. Included by attention_fwd.cu, which launches
// it for bf16 at head widths 16, 32 and 64 (bf16 at 128 runs
// attention_fwd_bf16_d128.cuh, f32 at 16-64 attention_fwd_f32.cuh, f32 at
// 128 attention_fwd_f32_d128.cuh); its attn_fwd_keep_kernel draws the keep
// bits of every K1.
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` with bf16 dots
// (multi_modal_foundation_model_tpu/ops/attention.py:144, launched by
// `_mha_impl`, :349-391): the function of the mma.sync kernel it replaced,
// with its rounding points:
//   qs = bf16(f32(q) * scale)
//   s  = qs . k^T, -1e30 where not attended, -inf past Tk   (f32 sums)
//   p  = exp(s - m) (s - m first), l = sum_k p (undropped)
//   pd = bf16(keep ? p * keep_scale : 0)
//   o  = (pd . v) / l, stored in bf16;  lse = max(m, -1e6) + log(l), f32
// keep is K1's Philox draw (counter (k / 4, q, h + h_off, b + b_off), keyed
// by the low 32 bits of the seed-table entry read on the device,
// philox.cuh), so the bf16 K2 recomputes these very probabilities against
// this lse, and replays these bits.
//
// What bounds it on the H100 at the training step's shape (B = 256, Tq =
// Tk = 200, H = 8, D = 32, dropout 0.4, lse): bytes, 0.0319 ms (q, k, v
// and the masks read once, out and lse written once, 3.35 TB/s), where the
// two products need 0.0106 ms at 989 TFLOP/s; in practice the CUDA cores'
// work per score (the exp, the masks, dropout) and the Philox draws (B H
// Tq Tk / 4 = 20 M calls of ten rounds).
//
// The design is the bf16 K2's pass A (attention_bwd_bf16.cuh) without dP:
// - A block per (batch, 64 query rows) and group of heads, two warpgroups
//   (256 threads); warpgroup i takes keys [104 i, 104 i + 104) of a chunk
//   of 208, so s is one m64n104k16 wgmma a k-step, 52 f32 registers a
//   thread, the q tile and the k chunk both read from shared memory,
//   K-major.
// - One sweep: up to 208 keys (every attention of the model has 200) the
//   row max and sum are those of the whole key row at once: a quad's
//   shuffles, then the two warpgroups' values exchanged in shared memory
//   (the sums added in that order); no rescale of O. Longer rows take
//   chunks of 208 with the online rescale between them.
// - The output product takes pd from the accumulators as A fragments in
//   registers (wg::to_frags, wg::mma_rs) and the v chunk as B, MN-major
//   (the same tile read transposed). The two warpgroups' 64 x D partial
//   outputs are added in shared memory in that order, divided by l and
//   stored by warpgroup 0.
// - Copies: the q tile (64 x D) and the k and v chunks (208 x D, rows past
//   the end landing as zeros; keys past Tk are masked by index) arrive by
//   TMA on an mbarrier, in two stages across the (head, chunk) tiles the
//   block walks: the next tile's loads are in flight while this one is
//   computed. q is scaled to bf16(q * scale) in place once it lands.
// - Dropout: a first kernel (attn_fwd_keep_kernel) draws every keep bit
//   once, at full occupancy, into bytes mask[b][h][k / 8][q] (bit k % 8) in
//   the wrapper's scratch, the layout and draws of the bf16 K2's keep
//   kernel (philox.cuh keep_word); each stage brings its 64 x 26 bytes by
//   TMA with the operands. (scripts/torch_k1_variants.py times the draws
//   made inside this kernel instead, between the wgmma issue and its wait.)
//   The bits are K1's own: K2 draws the same bits again.
// - The attend bits (the static mask OR the key pad) are read once a block
//   and kept in registers for every head it walks.
// - Two blocks an SM up to D = 32 (at most 128 registers a thread: s, O's
//   D / 2 and the pd fragments), one at 64; heads a block sized to whole
//   waves of SMs x blocks an SM (wg::walk_heads).
// - Deterministic: every sum in a fixed order, no atomics; a launch is
//   bit-equal to the next.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "philox.cuh"
#include "wgmma_bf16.cuh"

namespace mmfm {
namespace k1wg {

using namespace wg;

// blocks an SM the registers allow (s, O and the pd fragments)
template <int D>
constexpr int kBlocksPerSm = D <= 32 ? 2 : 1;

// the dynamic shared memory of a block at head width D, in bytes
template <int D>
struct Layout {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kA = align1k(kRows * kRowBytes);   // the q tile
  static constexpr int kB = align1k(kBRows * kRowBytes);  // a k or v chunk
  static constexpr int kStage = kA + 2 * kB;              // q, k, v
  static constexpr int kKeep = 2 * kStage;  // a stage's keep bytes, two
  static constexpr int kXchg = kKeep + 2 * kKeepBuf;      // f32 [D / 2][128]
  static constexpr int kMax = kXchg + (D / 2) * 128 * 4;  // f32 [2][64]
  static constexpr int kSum = kMax + 2 * kRows * 4;       // f32 [2][64]
  static constexpr int kBar = kSum + 2 * kRows * 4;       // two mbarriers
  static constexpr int kBytes = kBar + 16 + 1024;         // + the alignment
};

struct Args {
  bf16* out;
  float* lse;             // or null
  const int* key_pad;
  const int* static_mask;
  int Tq, Tk, H, hpb;
  float scale, keep_scale;
};

// The keep bytes of K1's dropout, mask[b][h][kb][q] for kb < ceil(Tk / 8)
// and q < tq16 = Tq rounded up to 16 (0 past Tq): a thread draws 4
// queries' bytes (philox.cuh keep_word) and writes them as one word.
__global__ void __launch_bounds__(256)
    attn_fwd_keep_kernel(uint32_t* __restrict__ mask,
                         const long long* __restrict__ seed_ptr,
                         unsigned threshold, int H, int Tq, int kb_n,
                         int tq16, int b_off, int h_off, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int words = tq16 / 4;
  const long long rest = i / words;
  const int bh = (int)(rest / kb_n);
  mask[i] = keep_word((unsigned)__ldg(seed_ptr), threshold, bh / H + b_off,
                      bh % H + h_off, (int)(i % words), (int)(rest % kb_n),
                      Tq);
}

// out (and lse) for 64 query rows of one b and heads [h0, h0 + hpb)
template <bool kDropout, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<D>)
    attn_fwd_wg_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap keep_map,
                       const Args a) {
  using L = Layout<D>;
  constexpr int kRB = L::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const xchg = reinterpret_cast<float*>(sm + L::kXchg);
  float* const rmax = reinterpret_cast<float*>(sm + L::kMax);
  float* const rsum = reinterpret_cast<float*>(sm + L::kSum);
  const uint32_t bar0 = base + L::kBar;

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
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    fence_mbar_init();
  }
  // the 8 rows past each v chunk, which the last k-step of the output
  // product reads (times zero pd), zeroed once
  constexpr int kPad = 8 * kRB / 16;       // 16-byte words of 8 rows
  for (int i = tid; i < 2 * kPad; i += kThreads) {
    const int off = (i / kPad) * L::kStage + L::kA + L::kB + kChunk * kRB +
                    (i % kPad) * 16;
    *reinterpret_cast<uint4*>(sm + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_shared();
  __syncthreads();

  // tile t = (head, chunk) of the block's walk, into stage t & 1
  auto issue = [&](int t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    const uint32_t st = base + (t & 1) * L::kStage;
    const uint32_t bar = bar0 + 8 * (t & 1);
    mbar_expect(bar, kRows * kRB + 2 * kChunk * kRB +
                         (kDropout ? kKeepBytes : 0));
    if (kDropout)
      tma_load(base + L::kKeep + (t & 1) * kKeepBuf, &keep_map, bar, q0,
               ch * (kChunk / 8), b * a.H + h);
    tma_load(st, &q_map, bar, h * D, q0, b);
    tma_load(st + L::kA, &k_map, bar, h * D, ch * kChunk, b);
    tma_load(st + L::kA + L::kB, &v_map, bar, h * D, ch * kChunk, b);
  };
  if (tid == 0) issue(0);

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]
  auto attend = [&](int ch, uint32_t (&m)[2]) {
    m[0] = m[1] = 0u;
    const int cb = ch * kChunk + wgi * kCols + 2 * c;
#pragma unroll
    for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = cb + 8 * j + e, q = row0 + 8 * hh;
          if (q < a.Tq && key < a.Tk &&
              (__ldg(a.static_mask + (long long)q * a.Tk + key) |
               __ldg(a.key_pad + (long long)b * a.Tk + key)) != 0)
            m[hh] |= 1u << (2 * j + e);
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

  // tile t's stage made ready for its products, before the barrier that
  // starts the tile: its copies landed, q * scale rounded to bf16 in place
  auto prepare = [&](int t) {
    mbar_wait(bar0 + 8 * (t & 1), (t >> 1) & 1);
    unsigned char* qt = sm + (t & 1) * L::kStage;
    for (int i = tid * 16; i < kRows * kRB; i += kThreads * 16) {
      uint4* p = reinterpret_cast<uint4*>(qt + i);
      uint4 x = *p;
      x.x = scale_bf16x2(x.x, a.scale);
      x.y = scale_bf16x2(x.y, a.scale);
      x.z = scale_bf16x2(x.z, a.scale);
      x.w = scale_bf16x2(x.w, a.scale);
      *p = x;
    }
    fence_async_shared();
  };

  uint32_t att[2] = {0u, 0u};
  if (n_ch == 1) attend(0, att);
  // the row max and this thread's share of the row sum, rows + 0 and + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 2] = {};
  prepare(0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    const uint32_t st = base + (t & 1) * L::kStage;
    // stage (t + 1) & 1 held tile t - 1, whose readers are done
    if (tid == 0 && t + 1 < n_tiles) issue(t + 1);
    if (n_ch > 1) attend(ch, att);
    if (ch == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m[hh] = -INFINITY;
        l[hh] = 0.f;
      }
    }

    // s = qs . k^T over this warpgroup's 104 keys
    const uint32_t bk = st + L::kA + wgi * kCols * kRB;
    const uint32_t bv = bk + L::kB;
    float s[kAcc] = {};
    hold(s);
    fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n104(s, desc_add(desc<kRB>(st), 32 * kk),
                  desc_add(desc<kRB>(bk), 32 * kk), kk);
    commit();
    // the keep bits while the product runs
    uint32_t keep[2] = {~0u, ~0u};
    if (kDropout) load_keep(sm + L::kKeep + (t & 1) * kKeepBuf, keep);
    wait<0>();
    hold(s);

    // A warp whose 16 rows lie past Tq (three of the four of the last row
    // tile at 200 queries) skips the softmax: its q rows landed as zeros,
    // and its outputs are never stored.
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
    __syncthreads();   // both warpgroups' row maxima in
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
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
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

    // o += pd . v over this warpgroup's 104 keys
    uint32_t f[kSteps][4];
    to_frags(f, s);
    hold(f);
    fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      mma_rs(o, f[kk], desc_add(desc<kRB>(bv), kk * 16 * kRB),
             ch > 0 || kk > 0);
    commit();
    wait<0>();
    hold(o);
    hold(f);

    if (ch == n_ch - 1) {
      // the row sums and outputs: warpgroup 0's plus warpgroup 1's, the
      // quotient stored by warpgroup 0
      if (live) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
          if (c == 0) rsum[wgi * kRows + lr + 8 * hh] = l[hh];
        }
      }
      if (wgi == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) xchg[i * 128 + t128] = o[i];
      }
      __syncthreads();
      if (wgi == 0 && live) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 8 * hh;
          if (row >= a.Tq) continue;
          const float sum = rsum[lr + 8 * hh] + rsum[kRows + lr + 8 * hh];
          bf16* op = a.out + ((long long)b * a.Tq + row) * a.H * D + h * D;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            const int i = 4 * nt + 2 * hh;
            *reinterpret_cast<uint32_t*>(op + 8 * nt + 2 * c) =
                pack_bf16((o[i] + xchg[i * 128 + t128]) / sum,
                          (o[i + 1] + xchg[(i + 1) * 128 + t128]) / sum);
          }
          if (a.lse != nullptr && c == 0)
            a.lse[((long long)b * a.H + h) * a.Tq + row] =
                fmaxf(m[hh], kLseFloor) + logf(sum);
        }
      }
    }
    // the next tile's stage made ready; the barrier ends this tile (its
    // stage's readers are done) and starts the next
    if (t + 1 < n_tiles) prepare(t + 1);
    __syncthreads();
  }
}

// The keep draws (with dropout) and the kernel on the stream: operands as
// mmfm_attention_fwd takes them (attention_fwd.cu); with dropout the
// scratch holds the keep bytes (B, H, ceil(Tk / 8), keep_row(Tq))
// (ops/attention.py::_k1_scratch_bytes).
template <bool kDropout, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* key_pad, const int* static_mask, void* out,
                   float* lse, void* scratch, int B, int Tq, int Tk, int H,
                   long long q_sb, long long q_st, long long k_sb,
                   long long k_st, long long v_sb, long long v_st,
                   float scale, const long long* seed, unsigned threshold,
                   float keep_scale, int b_off, int h_off,
                   cudaStream_t stream) {
  const int hidden = H * D;
  const int kb_n = (Tk + 7) / 8, tq16 = keep_row(Tq);
  uint32_t* keep = static_cast<uint32_t*>(scratch);
  CUtensorMap q_map, k_map, v_map, keep_map{};
  if (!tensor_map(&q_map, q, hidden, Tq, B, q_st, q_sb, D, kRows) ||
      !tensor_map(&k_map, k, hidden, Tk, B, k_st, k_sb, D, kChunk) ||
      !tensor_map(&v_map, v, hidden, Tk, B, v_st, v_sb, D, kChunk))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kDropout) {
    if (keep == nullptr ||
        !byte_map(&keep_map, keep, tq16, kb_n, B * H, kRows, kChunk / 8))
      return cudaErrorInvalidValue;
    const long long n = (long long)B * H * kb_n * (tq16 / 4);
    attn_fwd_keep_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        keep, seed, threshold, H, Tq, kb_n, tq16, b_off, h_off, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = Layout<D>::kBytes;
  auto* kernel = attn_fwd_wg_kernel<kDropout, D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that two blocks fit beside each other
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // the blocks an SM these registers and this shared memory allow, asked
  // once an instantiation
  static const int per_sm = [&] {
    int n = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
    return n;
  }();
  const int n_qt = (Tq + kRows - 1) / kRows;
  const Args args{static_cast<bf16*>(out),
                  lse,
                  key_pad,
                  static_mask,
                  Tq,
                  Tk,
                  H,
                  walk_heads(B, n_qt, H, per_sm),
                  scale,
                  keep_scale};
  kernel<<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, smem, stream>>>(
      q_map, k_map, v_map, keep_map, args);
  return cudaGetLastError();
}

}  // namespace k1wg
}  // namespace mmfm
