// K1 in f32 at head widths 16, 32 and 64 for Hopper (sm_90a): 3xTF32 on wgmma
// over a chunk of keys at a time, one warpgroup a block and two blocks an SM,
// tiles fed by TMA, the keep bits drawn apart. Included by attention_fwd.cu,
// which launches it for f32 at head widths 16, 32 and 64 (and 8 and 24, which
// the wrapper pads to 16 and 32); f32 at 128 runs attention_fwd_f32_d128.cuh.
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` with f32 dots
// (multi_modal_foundation_model_tpu/ops/attention.py:144, launched by
// `_mha_impl`, :349-391) under the f32 contract of attention_fwd.cu:
//   s  = (q * scale) . k^T, -1e30 where not attended, -inf past Tk
//   p  = exp(s - m), l = sum_k p (undropped)
//   o  = (sum_k p keep / (1 - rate) v) / l;  lse = max(m, -1e6) + log(l)
// q * scale stays f32, nothing is rounded to bf16; every product is
// 3xTF32, hi = tf32(x) and lo = tf32(x - hi) (mma_tf32.cuh split_tf32,
// rounded by integer ops to the bits of cvt.rna), every k-step's three
// terms summed from zero on the tensor cores and then added in f32, k-steps
// in order. s is taken exactly as the f32 K2 at these widths
// recomputes it: both take the split and the k-steps of s from
// tiles_f32.cuh, so K2's exp(s - lse) rows sum to 1. The keep bits are
// K1's Philox draws (counter (k / 4, q, h + h_off, b + b_off), the key read
// from the seed table on the device), drawn first by attn_fwd_keep_kernel
// (attention_fwd_bf16.cuh) into bytes mask[b][h][k / 8][q], the layout the
// f32 K2 replays. No atomics: a launch is bit-equal to the next.
//
// What bounds it on the H100 at the training step's shape (B = 256, Tq =
// Tk = 200, H = 8, D = 32, dropout 0.4, lse): the two products at three
// TF32 terms each, 0.064 ms at 495 TFLOP/s, against 0.063 ms of bytes (q,
// k, v and the masks in, out and lse written, 3.35 TB/s); at the eval's
// B = 320, 0.079 ms. Beside them, per score: the exp, the masks and
// dropout, and with dropout the keep draws (B H Tq Tk / 4 Philox calls).
//
// The design is the f32 K2's pass A (attention_bwd_f32.cuh,
// attn_bwd_dq_tf_kernel) without dP, on one warpgroup a block:
// - A block (128 threads) per (batch, 64 query rows) and group of heads,
//   over a chunk of keys at a time (Layout<D>::kChunk: 104 at D = 16 and
//   32, the model's 200 keys in two; 56 at 64), two blocks an SM. s is one
//   m64n104k8 (m64n56k8) wgmma a term and k-step, q * scale's hi and lo
//   planes against k's, both from shared memory, two k-steps in flight
//   (their terms alternating, wgmma_tf32.cuh mma3_ss2), each waited for
//   before its sum is added (ptxas serializes wgmmas whose accumulators are
//   read inside a pipeline stage, its note C7514). Pass A's two warpgroups
//   a block over 208 keys, one block an SM, read 0.50 ms at the eval's B =
//   320 and 0.49 at the training step's B = 256 where this reads 0.42 and
//   0.44 (scripts/torch_k1_variants.py --other, H100): every phase of a
//   block (split, s, softmax, o) waits on the last, and a second block an SM
//   runs its phases beside them. Its 165 KB of shared memory left room for
//   one block; 104 keys a block take 91 KB.
// - o = pd . v takes pd from the s accumulators as A fragments in
//   registers (wgtf::to_frags_tf32, hi and lo split there) and v's
//   transposed hi and lo planes as B, four k-steps in flight (two at 64;
//   kGroup, wgmma_tf32.cuh mma3_rs_g; two at 32 took the kernel 1-3%
//   longer); the groups past Tk are left out. out = o times 1 / l
//   (dividing each element took the bf16 K1 at 128 3-7% longer).
// - Shared memory (Layout): q's natural hi and lo planes (64 rows), k's
//   (a chunk's rows), the landed v chunk and v's transposed hi and lo
//   planes: 48.0 KB at D = 16, 91.0 KB at 32, 110.1 KB at 64, two blocks
//   an SM at each. TF32 wgmma takes no transposed operand, so v is split
//   into transposed planes once a chunk (the f32 K1 at 128 splits v in
//   registers for o^T = v^T . pd^T instead, which needs D >= 64 rows of
//   o^T a warpgroup).
// - The split of a landed tile into TF32 planes, and of pd into its
//   fragments, rounds by integer ops (tiles_f32.cuh, wgtf::to_frags_tf32;
//   by cvt.rna the kernel took 8-10% longer).
// - One stage: q (with a head's first chunk), the k and v chunks (natural
//   f32, rows past the end as zeros) and the keep bytes arrive by TMA on an
//   mbarrier; the block splits them, then takes s; the next tile's copies
//   are issued once s and the keep bits are read, so they land while this
//   tile's softmax and output product run.
// - Softmax: an online rescale of o and l between chunks, the row max of
//   a chunk from the quad's shuffles. p = ex2.approx((s - m) log2(e)), s - m
//   first (a fully-masked row's -1e30 - -1e30 is exactly 0).
// - The attend bits (the static mask OR the key pad): every load issued,
//   indices clamped into the masks (loads guarded by the bounds cost the
//   bf16 K2 at 128 a quarter of its time), read once a block where a row
//   has at most two chunks and kept in registers for every head the block
//   walks. The keep bits: the chunk's 64 x kChunk / 8 bytes, read while s
//   runs.
// - Heads a block are sized to whole waves of the SMs x 2 blocks
//   (wg::walk_heads).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_bf16.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"
#include "tiles_f32.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace mmfm {
namespace k1tf {

using wg::align1k;
using wg::kRows;

constexpr int kThreads = 128;        // one warpgroup a block
constexpr int kBlocksPerSm = 2;      // two independent blocks an SM

// k-steps of the output product in flight together at head width D (their
// temporaries take G D / 2 registers a thread)
template <int D>
constexpr int kGroup = D <= 32 ? 4 : 2;

// The dynamic shared memory of a block at head width D, in bytes: q's hi
// and lo planes (64 rows), k's (a chunk's rows), the v chunk as it lands,
// v's transposed hi and lo planes, the keep bytes, the mbarrier.
template <int D>
struct Layout {
  static constexpr int kChunk = D <= 32 ? 104 : 56;   // keys at once
  static constexpr int kAcc = kChunk / 2;  // f32 a thread of a 64 x kChunk s
  static constexpr int kN8 = kChunk / 8;   // n8 blocks = output k-steps
  static constexpr int kW = f32t::Rows<D>::kW;
  static constexpr int kHalves = f32t::Rows<D>::kHalves;
  static constexpr int kRowB = f32t::Rows<D>::kRowB;
  static constexpr int kHalfA = align1k(kRows * kRowB);
  static constexpr int kHalfB = align1k(kChunk * kRowB);
  static constexpr int kA = kHalves * kHalfA;   // a q plane
  static constexpr int kB = kHalves * kHalfB;   // a k plane, the landed v
  static constexpr int kT = (kChunk + 31) / 32 * D * 128;  // a v^T plane
  static constexpr int kK = 2 * kA;             // k's hi, then lo
  static constexpr int kV = kK + 2 * kB;        // v as it lands
  static constexpr int kVT = kV + kB;           // v^T hi, then lo
  static constexpr int kKeep = kVT + 2 * kT;
  static constexpr int kKeepBytes = kRows * (kChunk / 8);
  static constexpr int kBar = kKeep + (kKeepBytes + 127) / 128 * 128;
  static constexpr int kBytes = kBar + 8 + 1024;           // + the alignment
  // two blocks an SM: 233,472 bytes of shared memory, 1 KB of it reserved
  // a block
  static_assert(kBlocksPerSm * (kBytes + 1024) <= 233472,
                "two blocks' shared memory on an H100 SM");
  static_assert(kChunk % 8 == 0 && kChunk <= 256, "k-steps of 8, a TMA box");
};

struct Args {
  float* out;
  float* lse;             // or null
  const int* key_pad;
  const int* static_mask;
  int Tq, Tk, H, hpb;
  float scale, keep_scale;
};

// o += pd . v over GN k-steps [kk0, kk0 + GN) of the chunk's keys: pd's hi
// and lo A fragments from the accumulators s (to_frags_tf32, split by
// integer ops), v's transposed planes at vt (lo t_lo further) as B; each
// k-step from zero into its temporary, their terms issued round-robin
// (wgtf::mma3_rs_g), waited for, then added to o in f32 in k order
template <int GN, int D, int N>
__device__ __forceinline__ void out_steps(float (&o)[D / 2],
                                          const float (&s)[N], int kk0,
                                          uint32_t vt, int t_lo) {
  float t[GN][D / 2];
  uint32_t fh[GN][4], fl[GN][4];
  uint64_t bh[GN], bl[GN];
#pragma unroll
  for (int j = 0; j < GN; ++j) {
    wgtf::to_frags_tf32(s, kk0 + j, fh[j], fl[j]);
    bh[j] = f32t::tr<D>(vt, kk0 + j);
    bl[j] = f32t::tr<D>(vt + t_lo, kk0 + j);
  }
  wg::fence();
  wgtf::mma3_rs_g(t, fh, fl, bh, bl);
  wg::commit();
  wg::wait<0>();
#pragma unroll
  for (int j = 0; j < GN; ++j) {
    wg::hold(t[j]);
    wgtf::hold(fh[j]);
    wgtf::hold(fl[j]);
  }
#pragma unroll
  for (int j = 0; j < GN; ++j)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += t[j][i];
}

// out (and lse) for 64 query rows of one b and heads [h0, h0 + hpb)
template <bool kDropout, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_fwd_tf_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap keep_map,
                       const Args a) {
  using L = Layout<D>;
  constexpr int kChunk = L::kChunk, kAcc = L::kAcc, kN8 = L::kN8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t bar = base + L::kBar;

  const int n_qt = (a.Tq + kRows - 1) / kRows;
  const int b = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int h0 = blockIdx.y * a.hpb;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int lr = 16 * w + g;               // this thread's rows: + 0, + 8
  const int row0 = q0 + lr;
  const bool live = q0 + 16 * w < a.Tq;    // the warp has rows to compute
  const int n_ch = (a.Tk + kChunk - 1) / kChunk;
  const int n_tiles = a.hpb * n_ch;

  if (tid == 0) {
    wg::mbar_init(bar, 1);
    wg::fence_mbar_init();
  }
  __syncthreads();

  // tile t = (head, chunk) of the block's walk: its k and v chunks and keep
  // bytes, and with a head's first chunk the head's q tile, raw f32 into
  // the hi planes (v into its landing region)
  auto issue = [&](int t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    const bool first = ch == 0;
    wg::mbar_expect(bar, ((first ? kRows : 0) + 2 * kChunk) * D * 4 +
                             (kDropout ? L::kKeepBytes : 0));
    if (kDropout)
      wg::tma_load(base + L::kKeep, &keep_map, bar, q0, ch * (kChunk / 8),
                   b * a.H + h);
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf) {
      const int c0 = h * D + L::kW * hf;
      if (first) wg::tma_load(base + hf * L::kHalfA, &q_map, bar, c0, q0, b);
      wg::tma_load(base + L::kK + hf * L::kHalfB, &k_map, bar, c0,
                   ch * kChunk, b);
      wg::tma_load(base + L::kV + hf * L::kHalfB, &v_map, bar, c0,
                   ch * kChunk, b);
    }
  };
  if (tid == 0) issue(0);

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]. Every load is
  // issued (indices clamped into the masks), so that they are in flight
  // together rather than one branch at a time.
  auto attend = [&](int ch, uint32_t (&m)[2]) {
    m[0] = m[1] = 0u;
    const int cb = ch * kChunk + 2 * c;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = cb + 8 * j + e, q = row0 + 8 * hh;
          const int qc = min(q, a.Tq - 1), kc = min(key, a.Tk - 1);
          const int on = __ldg(a.static_mask + (long long)qc * a.Tk + kc) |
                         __ldg(a.key_pad + (long long)b * a.Tk + kc);
          if (q < a.Tq && key < a.Tk && on != 0) m[hh] |= 1u << (2 * j + e);
        }
  };

  // the keep bits of this thread's elements, in attend's order, from the
  // chunk's [kChunk / 8 key bytes][64 queries]: keys 8 j + 2 c + e are
  // bits 2 c + e of byte j of the query's column
  auto load_keep = [&](uint32_t (&keep)[2]) {
    const unsigned char* mk = sm + L::kKeep;
    keep[0] = keep[1] = 0u;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t byte = mk[j * kRows + lr + 8 * hh];
        keep[hh] |= (byte >> (2 * c) & 3u) << (2 * j);
      }
  };

  // the attend bits, read once a block where the row has at most two
  // chunks (the model's 200 keys at D <= 32)
  uint32_t att0[2] = {0u, 0u}, att1[2] = {0u, 0u};
  const bool held = n_ch <= 2;
  if (held) {
    attend(0, att0);
    if (n_ch == 2) attend(1, att1);
  }
  // the running row max and this thread's share of the row sum, rows + 0
  // and + 8; o
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 2];
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    uint32_t att[2];
    if (held) {
      att[0] = ch ? att1[0] : att0[0];
      att[1] = ch ? att1[1] : att0[1];
    } else {
      attend(ch, att);
    }
    if (ch == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m[hh] = -INFINITY;
        l[hh] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    }

    // the tile landed; its planes made (q * scale with a head's first
    // chunk), then visible to the tensor cores
    wg::mbar_wait(bar, t & 1);
    if (ch == 0)
      f32t::split<D, kRows, true, true, false, kThreads>(
          sm, L::kHalfA, L::kA, nullptr, 0, a.scale, tid);
    f32t::split<D, kChunk, false, true, false, kThreads>(
        sm + L::kK, L::kHalfB, L::kB, nullptr, 0, 1.f, tid);
    f32t::split<D, kChunk, false, false, true, kThreads>(
        sm + L::kV, L::kHalfB, 0, sm + L::kVT, L::kT, 1.f, tid);
    wg::fence_async_shared();
    __syncthreads();

    // s = (q * scale) . k^T over the chunk's keys, two k-steps of D a
    // group, each from zero (the first into s, the others into tmp[0],
    // tmp[1]), added in f32 in order: attn_bwd_dq_tf_kernel's s
    const uint32_t qa = base, kb = base + L::kK;
    float s[kAcc];
    uint32_t keep[2] = {~0u, ~0u};
    {
      float tmp[2][kAcc];
#pragma unroll
      for (int gi = 0; gi < D / 16; ++gi) {
        wg::fence();
        if (gi == 0)
          f32t::step3x2<D>(s, tmp[1], qa, L::kHalfA, L::kA, kb, L::kHalfB,
                           L::kB, 0, 0);
        else
          f32t::step3x2<D>(tmp[0], tmp[1], qa, L::kHalfA, L::kA, kb,
                           L::kHalfB, L::kB, 0, 2 * gi);
        wg::commit();
        // the keep bits while the first group runs
        if (gi == 0 && kDropout) load_keep(keep);
        wg::wait<0>();
        wg::hold(s);
        wg::hold(tmp[1]);
        if (gi > 0) {
          wg::hold(tmp[0]);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) s[i] += tmp[0][i];
        }
#pragma unroll
        for (int i = 0; i < kAcc; ++i) s[i] += tmp[1][i];
      }
    }
    // s and the keep bytes are read: the next tile's copies land while
    // this one's softmax and output product run
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) issue(t + 1);

    // A warp whose 16 rows lie past Tq skips the softmax: its q rows landed
    // as zeros, and its outputs are never stored.
    if (live) {
      // the bias, -inf past Tk; the row's max over the chunk (the quad
      // holds one row)
      const int kb0 = ch * kChunk + 2 * c;   // element (0, 0, 0)
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kN8; ++j)
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
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 1));
        cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 2));
        // the chunk starts below Tk, so the new max is finite; the first
        // chunk's correction is exp2(-inf) = 0
        const float m_new = fmaxf(m[hh], cmax[hh]);
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
      for (int j = 0; j < kN8; ++j)
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

    // o += pd . v over the chunk's keys: kGroup<D> k-steps of 8 keys a
    // group, each from zero into its temporary, their terms issued
    // round-robin, then added in f32 in order; the groups past Tk (pd = 0
    // there) left out
    {
      constexpr int G = kGroup<D>, kFull = kN8 / G, kTail = kN8 % G;
      const uint32_t vt = base + L::kVT;
      const int n_ks = min(kN8, (a.Tk - ch * kChunk + 7) / 8);
#pragma unroll
      for (int gi = 0; gi < kFull; ++gi) {
        if (gi * G >= n_ks) break;
        out_steps<G, D>(o, s, gi * G, vt, L::kT);
      }
      if (kTail > 0 && kFull * G < n_ks)
        out_steps<(kTail > 0 ? kTail : 1), D>(o, s, kFull * G, vt, L::kT);
    }

    if (ch == n_ch - 1 && live) {
      // the row sums (the quad's), out = o / l as o times 1 / l
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
        const int row = row0 + 8 * hh;
        if (row >= a.Tq) continue;
        const float inv = 1.f / l[hh];
        float* op = a.out + ((long long)b * a.Tq + row) * a.H * D + h * D;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const int i = 4 * nt + 2 * hh;
          *reinterpret_cast<float2*>(op + 8 * nt + 2 * c) =
              make_float2(o[i] * inv, o[i + 1] * inv);
        }
        if (a.lse != nullptr && c == 0)
          a.lse[((long long)b * a.H + h) * a.Tq + row] =
              fmaxf(m[hh], kLseFloor) + logf(l[hh]);
      }
    }
    // this tile's readers of the v^T planes are done
    __syncthreads();
  }
}

// The keep draws (with dropout) and the kernel on the stream: operands as
// mmfm_attention_fwd takes them (attention_fwd.cu) at head width D; with
// dropout the scratch holds the keep bytes (B, H, ceil(Tk / 8),
// keep_row(Tq)) (ops/attention.py::_k1_scratch_bytes).
template <bool kDropout, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* key_pad, const int* static_mask, void* out,
                   float* lse, void* scratch, int B, int Tq, int Tk, int H,
                   long long q_sb, long long q_st, long long k_sb,
                   long long k_st, long long v_sb, long long v_st,
                   float scale, const long long* seed, unsigned threshold,
                   float keep_scale, int b_off, int h_off,
                   cudaStream_t stream) {
  using L = Layout<D>;
  const int hidden = H * D;
  const int kb_n = (Tk + 7) / 8, tq16 = wg::keep_row(Tq);
  uint32_t* keep = static_cast<uint32_t*>(scratch);
  CUtensorMap q_map, k_map, v_map, keep_map{};
  using wgtf::tensor_map_f32;
  if (!tensor_map_f32(&q_map, q, hidden, Tq, B, q_st, q_sb, D, kRows) ||
      !tensor_map_f32(&k_map, k, hidden, Tk, B, k_st, k_sb, D, L::kChunk) ||
      !tensor_map_f32(&v_map, v, hidden, Tk, B, v_st, v_sb, D, L::kChunk))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kDropout) {
    if (keep == nullptr || !wg::byte_map(&keep_map, keep, tq16, kb_n, B * H,
                                         kRows, L::kChunk / 8))
      return cudaErrorInvalidValue;
    const long long n = (long long)B * H * kb_n * (tq16 / 4);
    k1wg::attn_fwd_keep_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                 stream>>>(keep, seed, threshold, H, Tq,
                                           kb_n, tq16, b_off, h_off, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto* kernel = attn_fwd_tf_kernel<kDropout, D>;
  err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that two blocks fit beside each other
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kRows - 1) / kRows;
  const Args args{static_cast<float*>(out), lse, key_pad, static_mask,
                  Tq, Tk, H, wg::walk_heads(B, n_qt, H, kBlocksPerSm),
                  scale, keep_scale};
  kernel<<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, L::kBytes,
           stream>>>(q_map, k_map, v_map, keep_map, args);
  return cudaGetLastError();
}

}  // namespace k1tf
}  // namespace mmfm
