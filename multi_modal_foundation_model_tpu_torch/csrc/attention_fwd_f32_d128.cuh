// K1 in f32 at head width 128 for Hopper (sm_90a): 3xTF32 on wgmma, tiles
// fed by TMA, the keep bits drawn apart, and the output product taken
// transposed so that no operand needs a transposed copy. Included by
// attention_fwd.cu, which launches it for f32 at head width 128 (and the
// widths 65-127 the wrapper pads to it); f32 at 16-64 runs
// attention_fwd_f32.cuh, bf16 attention_fwd_bf16.cuh (16-64) and
// attention_fwd_bf16_d128.cuh (128).
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` with f32 dots
// (multi_modal_foundation_model_tpu/ops/attention.py:144, launched by
// `_mha_impl`, :349-391) under the f32 contract of attention_fwd.cu:
//   s  = (q * scale) . k^T, -1e30 where not attended, -inf past Tk
//   p  = exp(s - m), l = sum_k p (undropped)
//   o  = (sum_k p keep / (1 - rate) v) / l;  lse = max(m, -1e6) + log(l)
// q * scale stays f32, nothing is rounded to bf16; every product is 3xTF32, hi
// = tf32(x) and lo = tf32(x - hi) (mma_tf32.cuh split_tf32), every k-step's
// three terms summed from zero on the tensor cores and then added in f32,
// k-steps in order. s is taken exactly as the f32 K2 at 128 recomputes it
// (attention_bwd_f32_d128.cuh, pass A: the same m64n64k8 products of the same
// splits of q * scale and k, the same order), so K2's exp(s - lse) rows sum to
// 1. The keep bits are K1's Philox draws (counter (k / 4, q, h + h_off, b +
// b_off), the key read from the seed table on the device),
// drawn first by attn_fwd_keep_kernel (attention_fwd_bf16.cuh) into bytes
// mask[b][h][k / 8][q], the layout the f32 K2 at 128 replays. No atomics:
// a launch is bit-equal to the next.
//
// What bounds it on the H100 at the width row's shape (B = 16, 2 heads,
// Tq = Tk = 200): the two products at three TF32 terms each, 0.00397 ms at
// 495 TFLOP/s; the bytes (q, k, v, out, lse, the masks) take 0.0011 ms.
// The grid is 128 blocks (one wave on 132 SMs), so a block's serial chain
// -- a chunk's loads, its split, the k-steps of s, the exp and masks, the
// k-steps of o -- sets the time.
//
// Online softmax over chunks of 128 keys, not one sweep: a whole row of
// 200 keys as k's hi and lo planes is 200 KB, which leaves no room for v
// and pd in the 227 KB of a block. So the block takes 128 keys at a time
// (200 = 128 + 72: one rescale of o); up to 128 keys it is one sweep.
//
// The design:
// - A block per (batch, 64 query rows) and group of heads, two warpgroups
//   (256 threads, one block an SM). Warpgroup i computes s over keys
//   [64 i, 64 i + 64) of the chunk: one m64n64k8 wgmma a term (a narrow
//   m64n32k8 ran far below the rate of m64n64k8 in the f32 K2 at 128),
//   the A operand q * scale read a k-step at a time from the raw q tile
//   into registers and split there, the B operand k's hi and lo planes.
// - The row max is exchanged between the warpgroups in shared memory;
//   each then writes its pd as hi and lo planes in the layout its s
//   accumulator holds (rows the queries, K the keys), over its own rows of
//   the k hi plane, which only its own s read. (Each warpgroup keeping its
//   own softmax statistics and o over all of D until a head's end, so that
//   the two need not meet every chunk, read 25% longer at B = 16 with
//   dropout and 9% without on the H100: scripts/torch_k1_variants.py
//   --other.)
// - o is taken transposed, o^T = v^T . pd^T: warpgroup i owns rows [64 i,
//   64 i + 64) of D (m64n64k8 over the 64 queries), its A operand read from
//   the raw v tile with the indices exchanged and split in registers, its
//   B the pd planes. No tile is transposed, and v is never split into
//   planes. The rescale of o by exp(m_old - m) is per query, a column of
//   o^T: read from shared memory.
// - Sums: each output element is one running f32 sum of k-steps of 8 keys
//   in order, chunk after chunk (rescaled between chunks), each k-step's
//   three terms from zero (v_lo . pd_hi, v_hi . pd_lo, v_hi . pd_hi:
//   tests/tf32_emulation.py, k1_wgmma128).
//   s over D likewise. A group holds two independent k-steps
//   (wgmma_tf32.cuh, mma3_rs2), waited for before their sums are added: with
//   one k-step in flight while the last one's sum was added (wait_group 1),
//   ptxas serialized the wgmmas (its C7514 note), as it does when other
//   instructions read an accumulator inside a pipeline stage. The next
//   group's A elements are read while a group runs.
// - Shared memory (Layout): two k regions of 64 KB, a v tile of 64 KB and
//   the q tile, 32 KB, all raw f32 as TMA lands them (rows past the end as
//   zeros), 128-byte swizzled column blocks of 32 floats. Chunk t's k lands
//   in region t & 1, a column block (8 KB of q with the head's first chunk,
//   16 KB of k) on an mbarrier of its own, and is split in place (hi) with
//   its lo plane in the other region, each block's rows by its warpgroup
//   while the score products of the block before run; pd then goes over
//   the hi plane. The next chunk's k is issued once both warpgroups' s are
//   done (its region held this chunk's lo plane), the next chunk's v once
//   the output product is done (the first chunk's once the first column
//   block has landed), the next head's q with its first k. 232,232 bytes a
//   block.
// - The keep bytes of a chunk (64 queries x 16 bytes) come by TMA on its
//   k's first column block's mbarrier, issued once the last chunk's are
//   read, and are read into registers after s; the attend bits (the
//   static mask OR the key pad) are read once a block for up to two chunks
//   (256 keys), by coalesced loads into a table of bytes in shared memory
//   and from there into registers, kept for every head the block walks.
// - The output is staged as rows of out in shared memory (over the last
//   pd planes) and stored in 16-byte pieces.
// - Heads a block are sized to whole waves of the SMs (wg::walk_heads).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_bf16.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace mmfm {
namespace k1t128 {

using wg::kRows;
using wg::kThreads;

constexpr int kD = 128;             // the head width
constexpr int kBlk = 32;            // floats a plane row: one 128-byte atom
constexpr int kHalf = 64;           // keys a warpgroup takes of a chunk
constexpr int kChunk = 2 * kHalf;   // keys a block takes at once
constexpr int kSteps = kChunk / 8;  // k-steps of the output product
constexpr int kAcc = kHalf / 2;     // f32 a thread of a 64 x 64 sum
constexpr int kN8 = kHalf / 8;      // n8 blocks of a warpgroup's keys

// The dynamic shared memory of a block, in bytes: the two k regions (a
// chunk's 128 rows in 4 column blocks of 32 floats; a warpgroup's 64 rows
// are the second half of each block for warpgroup 1), the v tile (the
// same shape), the q tile (64 rows), the keep bytes, the row maxima of
// both warpgroups, the correction (later the row sums) a query, the
// mbarriers.
struct Layout {
  static constexpr int kBlkK = kChunk * 128;        // a column block
  static constexpr int kR = kD / kBlk * kBlkK;      // a k region
  static constexpr int kHalfOff = kHalf * 128;      // warpgroup 1's rows
  static constexpr int kV = 2 * kR;
  static constexpr int kQ = kV + kR;
  static constexpr int kBlkQ = kRows * 128;
  static constexpr int kKeep = kQ + kD / kBlk * kBlkQ;
  static constexpr int kKeepBytes = kRows * (kChunk / 8);
  static constexpr int kMax = kKeep + kKeepBytes;   // f32 [2][64]
  static constexpr int kCorr = kMax + 2 * kRows * 4;   // f32 [64]
  static constexpr int kBar = kCorr + kRows * 4;    // five mbarriers
  static constexpr int kBytes = kBar + 40 + 1024;   // + the alignment
  static_assert(kBytes <= 232448, "a block's shared memory on the H100");
};

struct Args {
  float* out;
  float* lse;             // or null
  const int* key_pad;
  const int* static_mask;
  int Tq, Tk, H, hpb;
  float scale, keep_scale;
  bool vec;               // Tk % 4 == 0 and 16-byte aligned masks
};

// out's rows staged in shared memory: a pitch of 132 floats puts the
// threads' writes of a warp on distinct banks
constexpr int kStagePitch = kD + 4;

// the 128 threads of warpgroup wgi (named barrier 1 + wgi)
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

// out (and lse) for 64 query rows of one b and heads [h0, h0 + hpb)
template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_tf128_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap keep_map,
                          const Args a) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const rmax = reinterpret_cast<float*>(sm + L::kMax);
  float* const corr_s = reinterpret_cast<float*>(sm + L::kCorr);
  // k's column block hf (with q's, and block 0 with the keep bytes) on
  // bar_k + 8 hf, v on bar_v
  const uint32_t bar_k = base + L::kBar, bar_v = bar_k + 8 * (kD / kBlk);

  const int n_qt = (a.Tq + kRows - 1) / kRows;
  const int b = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int h0 = blockIdx.y * a.hpb;
  const int tid = threadIdx.x, wgi = tid >> 7, t128 = tid & 127;
  const int w = t128 >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int lr = 16 * w + g;               // this thread's rows: + 0, + 8
  const int n_ch = (a.Tk + kChunk - 1) / kChunk;
  const int n_tiles = a.hpb * n_ch;

  if (tid == 0) {
    for (int hf = 0; hf < kD / kBlk; ++hf) wg::mbar_init(bar_k + 8 * hf, 1);
    wg::mbar_init(bar_v, 1);
    wg::fence_mbar_init();
  }
  __syncthreads();

  // chunk t = (head, chunk) of the block's walk: its k into region t & 1
  // with its keep bytes, and with a head's first chunk the head's q tile
  auto region = [](int t) { return (uint32_t)((t & 1) * L::kR); };
  auto issue_k = [&](int t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    const bool first = ch == 0;
#pragma unroll
    for (int hf = 0; hf < kD / kBlk; ++hf) {
      const uint32_t bar = bar_k + 8 * hf;
      const int c0 = h * kD + kBlk * hf;
      wg::mbar_expect(bar, (first ? kRows * kBlk * 4 : 0) +
                               kChunk * kBlk * 4 +
                               (kDropout && hf == 0 ? L::kKeepBytes : 0));
      if (first)
        wg::tma_load(base + L::kQ + hf * L::kBlkQ, &q_map, bar, c0, q0, b);
      wg::tma_load(base + region(t) + hf * L::kBlkK, &k_map, bar, c0,
                   ch * kChunk, b);
    }
  };
  // chunk t's keep bytes, counted on column block 0's mbarrier (whose
  // expected bytes issue_k set)
  auto issue_keep = [&](int t) {
    wg::tma_load(base + L::kKeep, &keep_map, bar_k, q0,
                 t % n_ch * (kChunk / 8), b * a.H + h0 + t / n_ch);
  };
  auto issue_v = [&](int t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    wg::mbar_expect(bar_v, kChunk * kD * 4);
#pragma unroll
    for (int hf = 0; hf < kD / kBlk; ++hf)
      wg::tma_load(base + L::kV + hf * L::kBlkK, &v_map, bar_v,
                   h * kD + kBlk * hf, ch * kChunk, b);
  };
  if (tid == 0) {
    issue_k(0);
    if (kDropout) issue_keep(0);
  }

  // This warpgroup's 64 rows of column block hf (128 rows x 32 floats,
  // 128-byte swizzled) of a landed k tile at hi, split in place: hi stays,
  // lo goes to the same place in region lo. A thread takes 4 floats of a
  // row, a warp 32 rows of the same 4 columns (the 16-byte accesses of 8
  // rows fall on distinct banks); the loads of its kU chunks are in flight
  // together.
  auto split = [&](unsigned char* hi, unsigned char* lo, int hf) {
    constexpr int kCh = kBlk / 4, kN = kHalf * kCh, kU = kN / 128;
#pragma unroll
    for (int i0 = t128; i0 < kN; i0 += kU * 128) {
      float4 x[kU];
      int off[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * 128;
        const int r = kHalf * wgi + i % kHalf, lc = i / kHalf;
        off[u] = hf * L::kBlkK + r * 128 + ((lc ^ (r & 7)) << 4);
        x[u] = *reinterpret_cast<const float4*>(hi + off[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        uint32_t h4[4], l4[4];
        split_tf32(x[u].x, h4[0], l4[0]);
        split_tf32(x[u].y, h4[1], l4[1]);
        split_tf32(x[u].z, h4[2], l4[2]);
        split_tf32(x[u].w, h4[3], l4[3]);
        *reinterpret_cast<uint4*>(hi + off[u]) =
            make_uint4(h4[0], h4[1], h4[2], h4[3]);
        *reinterpret_cast<uint4*>(lo + off[u]) =
            make_uint4(l4[0], l4[1], l4[2], l4[3]);
      }
    }
  };

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]. Every load is issued
  // (indices clamped into the masks), so that they are in flight together.
  auto attend = [&](int ch, uint32_t (&m)[2]) {
    m[0] = m[1] = 0u;
    const int cb = ch * kChunk + wgi * kHalf + 2 * c;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = cb + 8 * j + e, q = q0 + lr + 8 * hh;
          const int qc = min(q, a.Tq - 1), kc = min(key, a.Tk - 1);
          const int on = __ldg(a.static_mask + (long long)qc * a.Tk + kc) |
                         __ldg(a.key_pad + (long long)b * a.Tk + kc);
          if (q < a.Tq && key < a.Tk && on != 0) m[hh] |= 1u << (2 * j + e);
        }
  };

  // the keep bits of this thread's elements, in attend's order, from the
  // chunk's [16 key bytes][64 queries]: keys 64 wgi + 8 j + 2 c + e are
  // bits 2 c + e of byte 8 wgi + j of the query's column
  auto load_keep = [&](uint32_t (&keep)[2]) {
    const unsigned char* mk = sm + L::kKeep;
    keep[0] = keep[1] = 0u;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t byte = mk[(kN8 * wgi + j) * kRows + lr + 8 * hh];
        keep[hh] |= (byte >> (2 * c) & 3u) << (2 * j);
      }
  };

  // The raw q elements of k-step kk: rows lr (+ 8), columns 8 kk + c (+ 4),
  // in the m16n8k8 A fragment's order
  auto q_a = [&](int kk, float (&x)[4]) {
    const unsigned char* p =
        sm + L::kQ + (kk >> 2) * L::kBlkQ + lr * 128 + c * 4;
    const int lc = 2 * (kk & 3);
    x[0] = *reinterpret_cast<const float*>(p + ((lc ^ g) << 4));
    x[1] = *reinterpret_cast<const float*>(p + 1024 + ((lc ^ g) << 4));
    x[2] = *reinterpret_cast<const float*>(p + (((lc + 1) ^ g) << 4));
    x[3] = *reinterpret_cast<const float*>(p + 1024 + (((lc + 1) ^ g) << 4));
  };
  // The raw A elements of k-step ks of the output product: rows d = 64 wgi
  // + 16 w + g (+ 8) of D, k = the chunk's keys 8 ks + c (+ 4), read from
  // the v tile at (row key, column d)
  const unsigned char* const v_at =
      sm + L::kV + (2 * wgi + (w >> 1)) * L::kBlkK + (g & 3) * 4;
  const int d_lc = 4 * (w & 1) + (g >> 2);
  auto v_a = [&](int ks, float (&x)[4]) {
    const unsigned char* p = v_at + (8 * ks + c) * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lc = d_lc + 2 * (i & 1), k4 = 4 * (i >> 1);
      x[i] = *reinterpret_cast<const float*>(p + k4 * 128 +
                                             ((lc ^ (c + k4)) << 4));
    }
  };
  auto cut = [](const float (&x)[4], float mul, uint32_t (&hi)[4],
                uint32_t (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i] * mul, hi[i], lo[i]);
  };
  // B descriptor of k-step kk (8 columns of the head) of a k plane (this
  // warpgroup's 64 keys), and of k-step ks (8 of the chunk's keys) of the
  // pd hi plane of region r (lo: 2 column blocks further)
  auto k_desc = [&](uint32_t plane, int kk) {
    return wg::desc<128>(plane + (kk >> 2) * L::kBlkK + 32 * (kk & 3));
  };
  auto pd_desc = [&](uint32_t r, int ks) {
    const int kb = ks >> 2;
    return wg::desc<128>(r + (kb & 1) * L::kBlkK + (kb >> 1) * L::kHalfOff +
                         32 * (ks & 3));
  };

  // the attend bits of both chunks, read once a block where the row has
  // at most two (chunk ch at bits [16 ch, 16 ch + 16)): the block's 64 rows
  // x 256 keys as bytes of 8 keys, built from coalesced loads of the masks
  // in the k region that the first chunk's lo plane takes later, then each
  // thread's bits gathered from there (read by each thread for its own
  // elements, two loads an element, the kernel took ~3% longer at B = 16:
  // scripts/torch_k1_variants.py)
  uint32_t att_all[2] = {0u, 0u};
  const bool held = n_ch <= 2;
  if (held) {
    unsigned char* const tab = sm + region(1);
    const int* const pad = a.key_pad + (long long)b * a.Tk;
    if (a.vec) {
      // warp tid / 32 takes rows [8 (tid / 32), + 8), a lane keys [8 lane,
      // 8 lane + 8): 16-byte loads at indices clamped into the masks, so
      // that they need no branch and can all be in flight together
      const int r0 = 8 * (tid >> 5), k0 = 8 * lane;
      const bool in0 = k0 < a.Tk, in1 = k0 + 4 < a.Tk;
      const int ka = in0 ? k0 : 0, kb = in1 ? k0 + 4 : 0;
      const int4 pa = __ldg(reinterpret_cast<const int4*>(pad + ka));
      const int4 pb = __ldg(reinterpret_cast<const int4*>(pad + kb));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int* const row =
            a.static_mask + (long long)min(q0 + r0 + r, a.Tq - 1) * a.Tk;
        const int4 sa = __ldg(reinterpret_cast<const int4*>(row + ka));
        const int4 sb = __ldg(reinterpret_cast<const int4*>(row + kb));
        uint32_t byte = 0u;
        if (in0)
          byte |= (uint32_t)((sa.x | pa.x) != 0) |
                  (uint32_t)((sa.y | pa.y) != 0) << 1 |
                  (uint32_t)((sa.z | pa.z) != 0) << 2 |
                  (uint32_t)((sa.w | pa.w) != 0) << 3;
        if (in1)
          byte |= (uint32_t)((sb.x | pb.x) != 0) << 4 |
                  (uint32_t)((sb.y | pb.y) != 0) << 5 |
                  (uint32_t)((sb.z | pb.z) != 0) << 6 |
                  (uint32_t)((sb.w | pb.w) != 0) << 7;
        tab[(r0 + r) * 32 + lane] =
            (unsigned char)(q0 + r0 + r < a.Tq ? byte : 0u);
      }
    } else {
      for (int i = tid; i < kRows * 32; i += kThreads) {
        const int q = q0 + (i >> 5), k0 = 8 * (i & 31);
        tab[i] = (unsigned char)(
            attend_nibble(a.static_mask, pad, a.Tq, a.Tk, q, k0, false) >> 4 |
            attend_nibble(a.static_mask, pad, a.Tq, a.Tk, q, k0 + 4, false));
      }
    }
    __syncthreads();
    for (int ch = 0; ch < n_ch; ++ch)
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t byte =
              tab[(lr + 8 * hh) * 32 + 2 * kN8 * ch + kN8 * wgi + j];
          att_all[hh] |= (byte >> (2 * c) & 3u) << (2 * kN8 * ch + 2 * j);
        }
    __syncthreads();   // read before the first split writes there
  }
  // the running row max and this thread's share of the row sum, rows + 0
  // and + 8; o^T: element (d row hh, n8 block j, column e) is o[4 j + 2 hh
  // + e], d = 64 wgi + 16 w + g + 8 hh, query 8 j + 2 c + e
  float m[2], l[2], o[kAcc];
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    uint32_t att[2];
    if (held) {
      att[0] = att_all[0] >> (2 * kN8 * ch) & 0xFFFFu;
      att[1] = att_all[1] >> (2 * kN8 * ch) & 0xFFFFu;
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
      for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
    }
    const uint32_t r_hi = base + region(t), r_lo = base + region(t + 1);

    // s = (q * scale) . k^T over this warpgroup's 64 keys, a k-step of 8 of
    // D at a time: two k-steps a group, each from zero (the first into acc,
    // the others into tmp[0], tmp[1]), their terms alternating (mma3_rs2),
    // added in f32 in order (attn_bwd_dq_tf128_kernel's sums); each group
    // waited for (wait_group 0) before its sums are added, as ptxas
    // serializes wgmmas whose accumulators other instructions read inside a
    // pipeline stage. The chunk's k lands a column block (4 k-steps) at a
    // time; this warpgroup's rows of the next block are split into hi and lo
    // planes while a group of the last one runs.
    const uint32_t khi = r_hi + wgi * L::kHalfOff;
    const uint32_t klo = r_lo + wgi * L::kHalfOff;
    float acc[kAcc];
    {
      float tmp[2][kAcc], x[2][4];
      uint32_t fh[2][4], fl[2][4];
      wg::mbar_wait(bar_k, t & 1);
      split(sm + region(t), sm + region(t + 1), 0);
      // the first chunk's v once its first column block is in (beside the
      // k and q tiles it took the kernel ~3% longer:
      // scripts/torch_k1_variants.py)
      if (t == 0 && tid == 0) issue_v(0);
      wg::fence_async_shared();
      wg_sync(wgi);
#pragma unroll
      for (int gi = 0; gi < kD / 16; ++gi) {
        const int kk = 2 * gi, nb = gi / 2 + 1;
        q_a(kk, x[0]);
        q_a(kk + 1, x[1]);
        cut(x[0], a.scale, fh[0], fl[0]);
        cut(x[1], a.scale, fh[1], fl[1]);
        wg::fence();
        if (gi == 0)
          wgtf::mma3_rs2(acc, fh[0], fl[0], k_desc(khi, kk), k_desc(klo, kk),
                         tmp[1], fh[1], fl[1], k_desc(khi, kk + 1),
                         k_desc(klo, kk + 1));
        else
          wgtf::mma3_rs2(tmp[0], fh[0], fl[0], k_desc(khi, kk),
                         k_desc(klo, kk), tmp[1], fh[1], fl[1],
                         k_desc(khi, kk + 1), k_desc(klo, kk + 1));
        wg::commit();
        // the next column block split while the products run
        if (gi % 2 == 0 && nb < kD / kBlk) {
          wg::mbar_wait(bar_k + 8 * nb, t & 1);
          split(sm + region(t), sm + region(t + 1), nb);
        }
        wg::wait<0>();
        wg::hold(acc);
        wg::hold(tmp[1]);
        wgtf::hold(fh[0]);
        wgtf::hold(fl[0]);
        wgtf::hold(fh[1]);
        wgtf::hold(fl[1]);
        if (gi > 0) {
          wg::hold(tmp[0]);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] += tmp[0][i];
        }
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += tmp[1][i];
        if (gi % 2 == 1 && nb < kD / kBlk) {
          // column block nb's planes visible to this warpgroup's products
          wg::fence_async_shared();
          wg_sync(wgi);
        }
      }
    }

    // the bias, -inf past Tk; the row's max over this warpgroup's keys
    const int kb0 = ch * kChunk + wgi * kHalf + 2 * c;   // element (0, 0, 0)
    {
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            float x = acc[i];
            if (!(att[hh] >> (2 * j + e) & 1u)) x = kNegInf;
            if (kb0 + 8 * j + e >= a.Tk) x = -INFINITY;
            acc[i] = x;
            cmax[hh] = fmaxf(cmax[hh], x);
          }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {           // the quad holds one row
        cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 1));
        cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 2));
        if (c == 0) rmax[wgi * kRows + lr + 8 * hh] = cmax[hh];
      }
    }
    // both warpgroups' row maxima in; both are done with s, so the region
    // of this chunk's lo plane may take the next chunk's k
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) issue_k(t + 1);
    // the keep bits, read now that s's temporaries are dead (read while s
    // ran, they were live through it: 100 bytes of spills against 32, at
    // the same speed: scripts/torch_k1_variants.py)
    uint32_t keep[2] = {~0u, ~0u};
    if (kDropout) load_keep(keep);

    // the chunk starts below Tk, so the new max is finite; the first
    // chunk's correction is exp2(-inf) = 0. p = exp(s - m) (s - m first: a
    // fully-masked row's -1e30 - -1e30 is exactly 0), summed undropped; pd
    // into the pd planes over this warpgroup's rows of the k hi plane
    {
      float* const p_hi = reinterpret_cast<float*>(sm + region(t));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = lr + 8 * hh;
        const float m_new =
            fmaxf(m[hh], fmaxf(rmax[r], rmax[kRows + r]));
        const float corr = fast_exp2((m[hh] - m_new) * kLog2e);
        m[hh] = m_new;
        l[hh] *= corr;
        if (wgi == 0 && c == 0) corr_s[r] = corr;
      }
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const float p = fast_exp2((acc[i] - m[hh]) * kLog2e);
            l[hh] += p;
            pd[e] = p;
            if (kDropout)
              pd[e] = keep[hh] >> (2 * j + e) & 1u ? p * a.keep_scale : 0.f;
          }
          // (row r, key kc = 64 wgi + 8 j + 2 c) of the chunk: column
          // block kb = kc / 32 sits at (kb & 1) blocks and (kb >> 1) =
          // wgi halves of the region
          const int r = lr + 8 * hh, kc = 8 * (j & 3) + 2 * c;
          const int o_ = ((j >> 2) * L::kBlkK + wgi * L::kHalfOff + r * 128 +
                          (((kc >> 2) ^ (r & 7)) << 4) + (kc & 3) * 4) / 4;
          uint32_t h0_, l0_, h1_, l1_;
          split_tf32(pd[0], h0_, l0_);
          split_tf32(pd[1], h1_, l1_);
          *reinterpret_cast<uint2*>(p_hi + o_) = make_uint2(h0_, h1_);
          *reinterpret_cast<uint2*>(p_hi + 2 * L::kBlkK / 4 + o_) =
              make_uint2(l0_, l1_);
        }
    }
    // the pd planes and the corrections visible to both warpgroups; the
    // keep bytes are read, so the next chunk's may land
    wg::fence_async_shared();
    __syncthreads();
    if (kDropout && tid == 0 && t + 1 < n_tiles) issue_keep(t + 1);

    // o^T = o^T corr + v^T . pd^T over the chunk's keys, this warpgroup's
    // 64 rows of D: two k-steps of 8 keys a group, each from zero into its
    // temporary, their terms alternating (mma3_rs2), then added in f32 in
    // order; the next pair's v elements read while the group runs. The
    // k-steps past the chunk's last key are left out (they add zeros).
    wg::mbar_wait(bar_v, t & 1);
    if (ch > 0) {
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const float2 cr =
            *reinterpret_cast<const float2*>(corr_s + 8 * j + 2 * c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          o[4 * j + 2 * hh] *= cr.x;
          o[4 * j + 2 * hh + 1] *= cr.y;
        }
      }
    }
    {
      const int n_ks = min(kSteps, (a.Tk - ch * kChunk + 7) / 8);
      float to[2][kAcc], x[2][4] = {};
      uint32_t fh[2][4], fl[2][4];
      v_a(0, x[0]);
      if (n_ks > 1) v_a(1, x[1]);
      cut(x[0], 1.f, fh[0], fl[0]);
      cut(x[1], 1.f, fh[1], fl[1]);
#pragma unroll
      for (int ks = 0; ks < kSteps; ks += 2) {
        if (ks >= n_ks) break;
        const bool pair = ks + 1 < n_ks;
        wg::fence();
        if (pair)
          wgtf::mma3_rs2(to[0], fh[0], fl[0], pd_desc(r_hi, ks),
                         pd_desc(r_hi + 2 * L::kBlkK, ks), to[1], fh[1],
                         fl[1], pd_desc(r_hi, ks + 1),
                         pd_desc(r_hi + 2 * L::kBlkK, ks + 1));
        else
          wgtf::mma3_rs(to[0], fh[0], fl[0], pd_desc(r_hi, ks),
                        pd_desc(r_hi + 2 * L::kBlkK, ks));
        wg::commit();
        if (ks + 2 < n_ks) v_a(ks + 2, x[0]);
        if (ks + 3 < n_ks) v_a(ks + 3, x[1]);
        wg::wait<0>();
        wg::hold(to[0]);
        wg::hold(to[1]);
        wgtf::hold(fh[0]);
        wgtf::hold(fl[0]);
        wgtf::hold(fh[1]);
        wgtf::hold(fl[1]);
        cut(x[0], 1.f, fh[0], fl[0]);
        cut(x[1], 1.f, fh[1], fl[1]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) o[i] += to[0][i];
        if (pair) {
#pragma unroll
          for (int i = 0; i < kAcc; ++i) o[i] += to[1][i];
        }
      }
    }
    // the pd planes and the v tile are read: the next chunk's v may land,
    // and its split may write over this chunk's pd
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) issue_v(t + 1);

    if (ch == n_ch - 1) {
      // the row sums: warpgroup 0's plus warpgroup 1's (through the row
      // maxima's buffer), then the quotient a query (through the
      // corrections' buffer) and lse
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
        if (wgi == 1 && c == 0) rmax[lr + 8 * hh] = l[hh];
      }
      __syncthreads();
      if (wgi == 0 && c == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = lr + 8 * hh, row = q0 + r;
          const float sum = l[hh] + rmax[r];
          corr_s[r] = sum;
          if (a.lse != nullptr && row < a.Tq)
            a.lse[((long long)b * a.H + h) * a.Tq + row] =
                fmaxf(m[hh], kLseFloor) + logf(sum);
        }
      }
      __syncthreads();
      // o^T / l staged as out's rows (64 queries x 128 columns) over the pd
      // planes, whose readers are done, then stored in 16-byte pieces
      float* const stage = reinterpret_cast<float*>(sm + region(t));
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * j + 2 * c + e;
          const float sum = corr_s[q];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            stage[q * kStagePitch + 64 * wgi + lr + 8 * hh] =
                o[4 * j + 2 * hh + e] / sum;
        }
      __syncthreads();
#pragma unroll
      for (int i = tid; i < kRows * kD / 4; i += kThreads) {
        const int q = i / (kD / 4), c4 = 4 * (i % (kD / 4)), row = q0 + q;
        if (row < a.Tq)
          *reinterpret_cast<float4*>(a.out + ((long long)b * a.Tq + row) *
                                                 a.H * kD + h * kD + c4) =
              *reinterpret_cast<const float4*>(stage + q * kStagePitch + c4);
      }
      // the stage read before the next chunk's split writes there
      if (t + 1 < n_tiles) __syncthreads();
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
  const int kb_n = (Tk + 7) / 8, tq16 = wg::keep_row(Tq);
  uint32_t* keep = static_cast<uint32_t*>(scratch);
  CUtensorMap q_map, k_map, v_map, keep_map{};
  using wgtf::tensor_map_f32;
  if (!tensor_map_f32(&q_map, q, hidden, Tq, B, q_st, q_sb, kD, kRows) ||
      !tensor_map_f32(&k_map, k, hidden, Tk, B, k_st, k_sb, kD, kChunk) ||
      !tensor_map_f32(&v_map, v, hidden, Tk, B, v_st, v_sb, kD, kChunk))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kDropout) {
    if (keep == nullptr || !wg::byte_map(&keep_map, keep, tq16, kb_n, B * H,
                                         kRows, kChunk / 8))
      return cudaErrorInvalidValue;
    const long long n = (long long)B * H * kb_n * (tq16 / 4);
    k1wg::attn_fwd_keep_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                 stream>>>(keep, seed, threshold, H, Tq,
                                           kb_n, tq16, b_off, h_off, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto* kernel = attn_fwd_tf128_kernel<kDropout>;
  err = allow_smem(kernel, Layout::kBytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kRows - 1) / kRows;
  const bool vec = Tk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(key_pad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(static_mask) % 16 == 0;
  const Args args{static_cast<float*>(out), lse, key_pad, static_mask,
                  Tq, Tk, H, wg::walk_heads(B, n_qt, H), scale, keep_scale,
                  vec};
  kernel<<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, Layout::kBytes,
           stream>>>(q_map, k_map, v_map, keep_map, args);
  return cudaGetLastError();
}

}  // namespace k1t128
}  // namespace mmfm
