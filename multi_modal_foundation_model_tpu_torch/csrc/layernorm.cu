// K3 / K4: LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_ln_fwd_kernel` (K3) and `_ln_bwd_kernel`
// (K4) of multi_modal_foundation_model_tpu/ops/layernorm.py:100 and :109
// (launched by `_pallas_ln_fwd`, :150-168, and `_pallas_ln_bwd`,
// :171-202). Per row of H values, all math in f32:
//   mu = mean(x),  var = relu(mean(x^2) - mu^2)      (fast variance, as
//   rsigma = rsqrt(var + eps)                        flax's LayerNorm)
//   K3:  y = (x - mu) * (rsigma * scale) + bias
//   K4:  xhat = (x - mu) * rsigma,  dxhat = g * scale
//        dx = rsigma * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//        dscale = sum_rows g * xhat,  dbias = sum_rows g
// x, y, g and dx share one dtype (f32 or bf16); scale and bias are f32, and
// so are dscale and dbias. The statistics are the fast-variance formula on
// purpose: torch's two-pass variance differs in the last bits.
//
// What bounds it on the H100: a handful of flops per value, so device
// memory does (3.35 TB/s). K3 reads x once and writes y once; K4 reads x
// and g once and writes dx once (the statistics are recomputed from x,
// not saved, as on the TPU). Both keep every row in registers:
//   - one warp per row; a lane holds up to kEpl = H/32 (rounded up to a
//     power of two) values of the row, loaded and stored 16 bytes at a time
//     (V values per access, the lanes on neighbouring addresses);
//   - the row sums go through warp shuffles (a butterfly, so every lane
//     holds the same bits of the sum).
// K3 is one block of 8 warps per 8 rows and runs near its byte bound.
//
// K4 also sums dscale and dbias over the rows. JAX adds each grid step's
// sum into one (1, H) block it revisits, which is right only because TPU
// grid steps run in order (:121-130). Blocks on Hopper run in no order, so
// K4 has two kernels and no atomics, and dscale and dbias are the same
// bits on every launch:
//   pass 1 (ln_bwd_dx_kernel): the rows are cut into `grid` tiles of
//     contiguous rows, one block of 8 warps a tile. The wrapper sizes the
//     grid to the card (ops/layernorm.py `_k4_plan`): a block an SM at
//     least, where there are as many rows, and never more blocks than the
//     SMs hold at once, so no partial second wave. Warp w walks rows w,
//     w + 8, ... of its tile in order; the next row's x and g are loaded
//     before a row is reduced, and wait as raw 16-byte words until then.
//     It writes dx and keeps its columns' sums of g * xhat and g in
//     registers (xhat in f32, never rounded to bf16); the 8 warps' sums are
//     added in warp order through shared memory into one row of an f32
//     (2, grid, H) scratch;
//   pass 2 (ln_bwd_colsum_kernel): each column's `grid` partial rows are
//     summed over 2H/8 blocks: 32 splits each add every 32nd row in order,
//     then the splits are added in order.
// On the H100 at 51,200 x 256 (the B=256 step), bf16 pass 1 moves its bytes
// at ~80% of the card's rate, and with every load served from L1 it still
// takes over half its time: the arithmetic and shuffles of a row, over the
// 24 warps an SM holds, are a limit next to memory. The first design took
// 1.7x as long there and 3.8x at the B=16 step's 3,200 rows: a fixed 128
// rows a block left 4/5 of the SMs idle at 3,200 rows and 4 blocks to a
// second wave at 51,200, and a warp waited a whole memory round trip a row
// (PERF.md; scripts/torch_k4_variants.py times the variants).
// Nothing depends on the data or on a host read, so the pair can be
// captured in a CUDA graph. Any row count works (the tiles differ by one
// row at most; nothing is padded).
//
// Widths. A lane holds kEpl values of its row in kEpl / kV accesses of kV
// values each; kV is as wide as the row's byte alignment allows (H a
// multiple of kV, at most 16 bytes), down to 1, and the lanes past H hold
// zeros and store nothing. The wrapper's planner (ops/layernorm.py
// `ln_plan`) picks the variant, kEpl and kV for a width and dtype:
//   - a row a warp (this file as it stands, H from 1 to 1024): kEpl = H/32
//     rounded up to a power of two; at a multiple of 32 the layout the
//     kernels had when they took only those widths (at H = 256 the same
//     code);
//   - a row a block of 8 warps (layernorm_wide.cu: this file with
//     MMFM_LN_WIDE, 1024 < H <= 4096): a thread holds kEpl = 8 or 16 values
//     (chunk j at columns (thread + 256 j) kV), the row sums go through the
//     warp shuffles and then over the 8 warps in order through shared
//     memory (block_sums), so no row is read twice. K4's pass 1 walks its
//     tile one row at a time with the whole block, and each thread keeps
//     the column sums of its own columns, which it writes straight into
//     the partial rows (no reduction buffer: at 4096 columns the warp
//     variant's would need 128 KB).
// Pass 2 covers 2H / 8 columns a block, rounded up: past 2H its threads
// read and write the wrapper's padding (mmfm_layernorm_bwd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kWarps = 8;                    // warps per block
constexpr int kThreads = kWarps * 32;
// the widest row: a row a warp, a row a block
constexpr int kMaxH = 1024;
constexpr int kMaxWideH = 4096;
constexpr int kSplits = 32;                  // K4 pass 2: splits a column
constexpr int kSplitCols = kThreads / kSplits;  // K4 pass 2: columns a block
constexpr int kSplitLoads = 8;               // K4 pass 2: loads in flight

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

// V values of type T moved as one aligned access (at most 16 bytes)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = to_f32(pk.v[e]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  Pack<T, V> pk;
#pragma unroll
  for (int e = 0; e < V; ++e) pk.v[e] = from_f32<T>(in[e]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// V f32 values (scale, bias) in accesses of at most 16 bytes
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  constexpr int kStep = V < 4 ? V : 4;
#pragma unroll
  for (int i = 0; i < V; i += kStep) load_vec<float, kStep>(p + i, out + i);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// a lane's share of a row: kNc chunks of kV values, chunk j at columns
// (lane + kLanes j) * kV (kLanes 32 for a row a warp, 256 for a row a
// block); H is a multiple of kV, and a chunk past H holds zeros and is
// never stored
template <typename T, int kEpl, int kV>
struct Layout {
  static_assert(kV * sizeof(T) <= 16 && kEpl % kV == 0, "vector width");
  static constexpr int kNc = kEpl / kV;
};

template <typename T, int kEpl, int kV, int kLanes = 32>
__device__ __forceinline__ void load_row(const T* row, int H, int lane,
                                         float* v) {
  using L = Layout<T, kEpl, kV>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + kLanes * j) * kV;
    if (c0 < H) {
      load_vec<T, kV>(row + c0, v + j * kV);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) v[j * kV + e] = 0.f;
    }
  }
}

template <typename T, int kEpl, int kV, int kLanes = 32>
__device__ __forceinline__ void load_params(const float* p, int H, int lane,
                                            float* v) {
  using L = Layout<T, kEpl, kV>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + kLanes * j) * kV;
    if (c0 < H) {
      load_f32<kV>(p + c0, v + j * kV);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) v[j * kV + e] = 0.f;
    }
  }
}

template <typename T, int kEpl, int kV, int kLanes = 32>
__device__ __forceinline__ void store_row(T* row, int H, int lane,
                                          const float* v) {
  using L = Layout<T, kEpl, kV>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + kLanes * j) * kV;
    if (c0 < H) store_vec<T, kV>(row + c0, v + j * kV);
  }
}

// the sum and the sum of squares of a row held across the warp (zeros past
// H add nothing)
template <int kEpl>
__device__ __forceinline__ void row_sums(const float* v, float& s,
                                         float& ss) {
  s = 0.f;
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < kEpl; ++i) {
    s += v[i];
    ss = fmaf(v[i], v[i], ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
}

// mu and rsigma of a row held across the warp
template <int kEpl>
__device__ __forceinline__ void row_stats(const float* v, int H, float eps,
                                          float& mu, float& rsigma) {
  float s, ss;
  row_sums<kEpl>(v, s, ss);
  mu = s / (float)H;
  const float var = fmaxf(ss / (float)H - mu * mu, 0.f);
  rsigma = rsqrtf(var + eps);
}

// K3: one warp per row
template <typename T, int kEpl, int kV>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, int rows,
              int H, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[kEpl], w[kEpl], b[kEpl];
  load_row<T, kEpl, kV>(x + row * H, H, lane, v);
  float mu, rsigma;
  row_stats<kEpl>(v, H, eps, mu, rsigma);
  load_params<T, kEpl, kV>(scale, H, lane, w);
  load_params<T, kEpl, kV>(bias, H, lane, b);
#pragma unroll
  for (int i = 0; i < kEpl; ++i) v[i] = (v[i] - mu) * (rsigma * w[i]) + b[i];
  store_row<T, kEpl, kV>(y + row * H, H, lane, v);
}

// the sums of a and b over the block's threads, the same bits in every
// thread: each warp's by shuffles, then the 8 warps' in order through
// red[phase]; callers alternate phase, so a buffer is written again only
// after a barrier that every reader of it has passed
__device__ __forceinline__ void block_sums(float& a, float& b,
                                           float2 (&red)[2][kWarps],
                                           int phase) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) red[phase][threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 t = red[phase][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    t.x += red[phase][w].x;
    t.y += red[phase][w].y;
  }
  a = t.x;
  b = t.y;
}

// K3 for a row wider than a warp holds: one block per row
template <typename T, int kEpl, int kV>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel_wide(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   int rows, int H, float eps) {
  __shared__ float2 red[2][kWarps];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  float v[kEpl], w[kEpl], b[kEpl];
  load_row<T, kEpl, kV, kThreads>(x + row * H, H, tid, v);
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kEpl; ++i) {
    s += v[i];
    ss = fmaf(v[i], v[i], ss);
  }
  block_sums(s, ss, red, 0);
  const float mu = s / (float)H;
  const float rsigma = rsqrtf(fmaxf(ss / (float)H - mu * mu, 0.f) + eps);
  load_params<T, kEpl, kV, kThreads>(scale, H, tid, w);
  load_params<T, kEpl, kV, kThreads>(bias, H, tid, b);
#pragma unroll
  for (int i = 0; i < kEpl; ++i) v[i] = (v[i] - mu) * (rsigma * w[i]) + b[i];
  store_row<T, kEpl, kV, kThreads>(y + row * H, H, tid, v);
}

// an unsigned word of 2, 4, 8 or 16 bytes
template <int kBytes> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// K4 pass 1: a lane's share of one row of x or g as loaded, kNc accesses
// of kV values (a chunk past H holds zeros and is never stored), kept as
// raw words until the row is reduced. Kept as kV values of T, a bf16
// access is split into its values right after its load, and the warp waits
// for the load there instead of a row later (pass 1 ~20% slower in bf16 at
// 51,200 x 256, and 91 registers where 80 give 3 blocks an SM).
template <typename T, int kEpl, int kV>
struct RawRow {
  using P = Pack<T, kV>;
  using W = typename Word<sizeof(P)>::type;
  W c[Layout<T, kEpl, kV>::kNc];
};

template <typename T, int kEpl, int kV, int kLanes = 32>
__device__ __forceinline__ void fetch_row(const T* row, int H, int lane,
                                          RawRow<T, kEpl, kV>& r) {
  using L = Layout<T, kEpl, kV>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + kLanes * j) * kV;
    using W = typename RawRow<T, kEpl, kV>::W;
    r.c[j] = c0 < H ? *reinterpret_cast<const W*>(row + c0) : W{};
  }
}

template <typename T, int kEpl, int kV>
__device__ __forceinline__ void unpack_row(const RawRow<T, kEpl, kV>& r,
                                           float* v) {
  using L = Layout<T, kEpl, kV>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    typename RawRow<T, kEpl, kV>::P pk;
    memcpy(&pk, &r.c[j], sizeof(pk));
#pragma unroll
    for (int e = 0; e < kV; ++e) v[j * kV + e] = to_f32(pk.v[e]);
  }
}

// one accumulator's column sums over a block's warps, added in warp order,
// into one row of the partial sums
template <typename T, int kEpl, int kV>
__device__ __forceinline__ void block_sum(const float (&acc)[kEpl],
                                          float (&red)[kWarps][kMaxH],
                                          float* part, int H, int lane,
                                          int warp) {
  using L = Layout<T, kEpl, kV>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + 32 * j) * kV;
    if (c0 < H) {
#pragma unroll
      for (int e = 0; e < kV; ++e) red[warp][c0 + e] = acc[j * kV + e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float s = red[0][c];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s += red[wi][c];
    part[c] = s;
  }
  __syncthreads();
}

// K4 pass 1: dx for one tile of rows, and the tile's column sums of
// g * xhat and g into row blockIdx.x of parts (2, gridDim.x, H). Up to 128
// registers at H <= 256 (2 blocks an SM at least): left free, ptxas took 80
// for f32 and spilled. Its four means are products with 1 / H, the bits of a
// division where H is a power of two.
template <typename T, int kEpl, int kV>
__global__ void __launch_bounds__(kThreads, kEpl <= 8 ? 2 : 1)
ln_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ parts, int rows, int rows_per_tile,
                 int H, float eps) {
  __shared__ float red[kWarps][kMaxH];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // tile t: rows_per_tile rows, one more for the first rows % grid tiles
  const int t = blockIdx.x;
  const int longer = rows - rows_per_tile * (int)gridDim.x;
  const int begin = t * rows_per_tile + min(t, longer);
  const int end = begin + rows_per_tile + (t < longer);
  const float inv_h = 1.f / (float)H;
  float w[kEpl], acc_ds[kEpl], acc_db[kEpl];
  load_params<T, kEpl, kV>(scale, H, lane, w);
#pragma unroll
  for (int i = 0; i < kEpl; ++i) acc_ds[i] = acc_db[i] = 0.f;

  // warp w's rows: begin + w, + kWarps, ... (the block's 8 warps on 8
  // neighbouring rows); the next row's x and g are on their way while a
  // row is reduced and stored
  RawRow<T, kEpl, kV> xr, gr;
  int row = begin + warp;
  if (row < end) {
    fetch_row<T, kEpl, kV>(x + (long long)row * H, H, lane, xr);
    fetch_row<T, kEpl, kV>(g + (long long)row * H, H, lane, gr);
  }
  for (; row < end; row += kWarps) {
    float xv[kEpl], gv[kEpl];
    unpack_row<T, kEpl, kV>(xr, xv);
    unpack_row<T, kEpl, kV>(gr, gv);
    if (row + kWarps < end) {
      const long long next = (long long)(row + kWarps) * H;
      fetch_row<T, kEpl, kV>(x + next, H, lane, xr);
      fetch_row<T, kEpl, kV>(g + next, H, lane, gr);
    }
    float s, ss;
    row_sums<kEpl>(xv, s, ss);
    const float mu = s * inv_h;
    const float rsigma = rsqrtf(fmaxf(ss * inv_h - mu * mu, 0.f) + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      // xhat; past H, g = scale = 0, so the padding adds nothing below
      xv[i] = (xv[i] - mu) * rsigma;
      const float dxhat = gv[i] * w[i];
      m1 += dxhat;
      m2 = fmaf(dxhat, xv[i], m2);
    }
    m1 = warp_sum(m1) * inv_h;
    m2 = warp_sum(m2) * inv_h;
    float out[kEpl];
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      out[i] = rsigma * (gv[i] * w[i] - m1 - xv[i] * m2);
      acc_ds[i] = fmaf(gv[i], xv[i], acc_ds[i]);
      acc_db[i] += gv[i];
    }
    store_row<T, kEpl, kV>(dx + (long long)row * H, H, lane, out);
  }

  float* part = parts + (long long)blockIdx.x * H;
  block_sum<T, kEpl, kV>(acc_ds, red, part, H, lane, warp);
  block_sum<T, kEpl, kV>(acc_db, red, part + (long long)gridDim.x * H, H,
                         lane, warp);
}

// K4 pass 1 for a row wider than a warp holds: the block walks its tile
// one row at a time, each thread holding kEpl values of the row (the next
// row's x and g loaded while a row is reduced, as raw words), the row's
// sums over the block (block_sums); each thread keeps the column sums of
// its own columns and writes them into row blockIdx.x of parts (2,
// gridDim.x, H).
template <typename T, int kEpl, int kV>
__global__ void __launch_bounds__(kThreads, 1)
ln_bwd_dx_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ parts, int rows, int rows_per_tile,
                      int H, float eps) {
  __shared__ float2 red[2][kWarps];
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int longer = rows - rows_per_tile * (int)gridDim.x;
  const int begin = t * rows_per_tile + min(t, longer);
  const int end = begin + rows_per_tile + (t < longer);
  const float inv_h = 1.f / (float)H;
  float w[kEpl], acc_ds[kEpl], acc_db[kEpl];
  load_params<T, kEpl, kV, kThreads>(scale, H, tid, w);
#pragma unroll
  for (int i = 0; i < kEpl; ++i) acc_ds[i] = acc_db[i] = 0.f;

  RawRow<T, kEpl, kV> xr, gr;
  if (begin < end) {
    fetch_row<T, kEpl, kV, kThreads>(x + (long long)begin * H, H, tid, xr);
    fetch_row<T, kEpl, kV, kThreads>(g + (long long)begin * H, H, tid, gr);
  }
  for (int row = begin; row < end; ++row) {
    float xv[kEpl], gv[kEpl];
    unpack_row<T, kEpl, kV>(xr, xv);
    unpack_row<T, kEpl, kV>(gr, gv);
    if (row + 1 < end) {
      const long long next = (long long)(row + 1) * H;
      fetch_row<T, kEpl, kV, kThreads>(x + next, H, tid, xr);
      fetch_row<T, kEpl, kV, kThreads>(g + next, H, tid, gr);
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      s += xv[i];
      ss = fmaf(xv[i], xv[i], ss);
    }
    block_sums(s, ss, red, 0);
    const float mu = s * inv_h,
                rsigma = rsqrtf(fmaxf(ss * inv_h - mu * mu, 0.f) + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      // xhat; past H, g = scale = 0, so the padding adds nothing below
      xv[i] = (xv[i] - mu) * rsigma;
      const float dxhat = gv[i] * w[i];
      m1 += dxhat;
      m2 = fmaf(dxhat, xv[i], m2);
    }
    block_sums(m1, m2, red, 1);
    m1 *= inv_h;
    m2 *= inv_h;
    float out[kEpl];
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      out[i] = rsigma * (gv[i] * w[i] - m1 - xv[i] * m2);
      acc_ds[i] = fmaf(gv[i], xv[i], acc_ds[i]);
      acc_db[i] += gv[i];
    }
    store_row<T, kEpl, kV, kThreads>(dx + (long long)row * H, H, tid, out);
  }

  float* part_ds = parts + (long long)blockIdx.x * H;
  float* part_db = part_ds + (long long)gridDim.x * H;
#pragma unroll
  for (int j = 0; j < Layout<T, kEpl, kV>::kNc; ++j) {
    const int c0 = (tid + kThreads * j) * kV;
    if (c0 < H) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        part_ds[c0 + e] = acc_ds[j * kV + e];
        part_db[c0 + e] = acc_db[j * kV + e];
      }
    }
  }
}

// K4 pass 2: dscale and dbias (out, (2, H)) from the n_parts partial rows of
// each, in a fixed order: split s adds rows s, s + kSplits, ... in order,
// then the splits are added in order. A block takes kSplitCols neighbouring
// columns of out (of dscale, dbias or both), a thread one split of one
// column, loading kSplitLoads of its rows at a time: one batch
// up to 256 partial rows. (An unrolled loop leaves a remainder whose loads
// wait one by one: 2.2 us at 134 rows against 1.5 at 256.)
__global__ void __launch_bounds__(kThreads)
ln_bwd_colsum_kernel(const float* __restrict__ parts, float* __restrict__ out,
                     int n_parts, int H) {
  __shared__ float s[kSplits][kSplitCols];
  const int c = threadIdx.x % kSplitCols;
  const int split = threadIdx.x / kSplitCols;
  const int col = blockIdx.x * kSplitCols + c;
  const int which = col >= H;                  // 0: dscale, 1: dbias
  const float* p = parts + (long long)which * n_parts * H + (col - which * H);
  float a = 0.f;
  for (int i0 = split; i0 < n_parts; i0 += kSplitLoads * kSplits) {
    float v[kSplitLoads];
#pragma unroll
    for (int k = 0; k < kSplitLoads; ++k) {
      const int i = i0 + k * kSplits;
      v[k] = i < n_parts ? p[(long long)i * H] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kSplitLoads; ++k) a += v[k];
  }
  s[split][c] = a;
  __syncthreads();
  if (threadIdx.x < kSplitCols) {
    float t = s[0][c];
#pragma unroll
    for (int i = 1; i < kSplits; ++i) t += s[i][c];
    out[col] = t;
  }
}

// The variant this library holds: a row a warp, or (MMFM_LN_WIDE, the
// library of layernorm_wide.cu) a row a block.
#ifndef MMFM_LN_WIDE
constexpr int kRowThreads = 32;
constexpr int kWidest = kMaxH;
#define MMFM_LN_FWD_KERNEL ln_fwd_kernel
#define MMFM_LN_BWD_KERNEL ln_bwd_dx_kernel
#else
constexpr int kRowThreads = kThreads;
constexpr int kWidest = kMaxWideH;
#define MMFM_LN_FWD_KERNEL ln_fwd_kernel_wide
#define MMFM_LN_BWD_KERNEL ln_bwd_dx_wide_kernel
#endif

template <typename T, int kEpl, int kV>
struct Fwd {
  static cudaError_t run(const void* x, const float* scale, const float* bias,
                         void* y, int rows, int H, float eps,
                         cudaStream_t stream) {
    // rows a block: 8 a row a warp, 1 a row a block
    constexpr int kRows = kThreads / kRowThreads;
    const unsigned blocks = (unsigned)((rows + kRows - 1) / kRows);
    MMFM_LN_FWD_KERNEL<T, kEpl, kV><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, H,
        eps);
    return cudaGetLastError();
  }
};

template <typename T, int kEpl, int kV>
struct Bwd {
  static cudaError_t run(const void* x, const float* scale, const void* g,
                         void* dx, float* out, float* parts, int grid,
                         int rows_per_tile, int rows, int H, float eps,
                         cudaStream_t stream) {
    MMFM_LN_BWD_KERNEL<T, kEpl, kV><<<(unsigned)grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<const T*>(g),
        static_cast<T*>(dx), parts, rows, rows_per_tile, H, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ln_bwd_colsum_kernel<<<(unsigned)((2 * H + kSplitCols - 1) / kSplitCols),
                           kThreads, 0, stream>>>(parts, out, grid, H);
    return cudaGetLastError();
  }
};

template <typename T, int kEpl, int kV>
struct BwdBlocksPerSm {
  static cudaError_t run(int* blocks) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, MMFM_LN_BWD_KERNEL<T, kEpl, kV>, kThreads, 0);
  }
};

// the instantiation of kEpl values a lane and vector width vec
template <typename T, int kEpl, template <typename, int, int> class Launch,
          typename... A>
cudaError_t by_vec(int vec, A... args) {
  if (vec == 1) return Launch<T, kEpl, 1>::run(args...);
  if constexpr (kEpl >= 2) {
    if (vec == 2) return Launch<T, kEpl, 2>::run(args...);
  }
  if constexpr (kEpl >= 4 && 4 * sizeof(T) <= 16) {
    if (vec == 4) return Launch<T, kEpl, 4>::run(args...);
  }
  if constexpr (kEpl >= 8 && 8 * sizeof(T) <= 16) {
    if (vec == 8) return Launch<T, kEpl, 8>::run(args...);
  }
  return cudaErrorInvalidValue;
}

template <typename T, template <typename, int, int> class Launch,
          typename... A>
cudaError_t by_plan(int epl, int vec, A... args) {
#ifndef MMFM_LN_WIDE
  if (epl == 1) return by_vec<T, 1, Launch>(vec, args...);
  if (epl == 2) return by_vec<T, 2, Launch>(vec, args...);
  if (epl == 4) return by_vec<T, 4, Launch>(vec, args...);
  if (epl == 8) return by_vec<T, 8, Launch>(vec, args...);
  if (epl == 16) return by_vec<T, 16, Launch>(vec, args...);
  if (epl == 32) return by_vec<T, 32, Launch>(vec, args...);
#else
  if (epl == 8) return by_vec<T, 8, Launch>(vec, args...);
  if (epl == 16) return by_vec<T, 16, Launch>(vec, args...);
#endif
  return cudaErrorInvalidValue;
}

// A plan (epl values a lane, vector width vec) this library runs for rows
// of H values of `bytes` each: H within the variant's widths, vec a power
// of two dividing H and epl, at most 16 bytes, and the lanes' chunks
// covering the row (by_plan refuses an epl it has no instantiation of).
bool plan_ok(int H, int epl, int vec, int bytes) {
  return bytes > 0 && H >= 1 && H <= kWidest && vec >= 1 &&
         (vec & (vec - 1)) == 0 && vec * bytes <= 16 && H % vec == 0 &&
         epl % vec == 0 && (long long)kRowThreads * epl >= H;
}

int dtype_bytes(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

// Blocks of K4's pass 1 (x and g of dtype, width H, the plan's epl and vec)
// that one SM holds at once: the wrapper's plan keeps the grid within this
// times the SM count. -1 on an error.
extern "C" int mmfm_layernorm_bwd_blocks_per_sm(int H, int epl, int vec,
                                                int dtype) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (plan_ok(H, epl, vec, dtype_bytes(dtype))) {
    if (dtype == 0) err = by_plan<float, BwdBlocksPerSm>(epl, vec, &n);
    if (dtype == 1)
      err = by_plan<__nv_bfloat16, BwdBlocksPerSm>(epl, vec, &n);
  }
  return err == cudaSuccess ? n : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (x and y). x and y contiguous (rows, H),
// 16-byte aligned; scale and bias f32 (H,), 16-byte aligned; epl and vec
// the planner's (ops/layernorm.py ln_plan). Returns the launch's
// cudaGetLastError() (0 = ok).
extern "C" int mmfm_layernorm_fwd(const void* x, const float* scale,
                                  const float* bias, void* y, int rows, int H,
                                  int epl, int vec, float eps, int dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(H, epl, vec, dtype_bytes(dtype)) || rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)by_plan<float, Fwd>(epl, vec, x, scale, bias, y, rows, H,
                                    eps, s);
  return (int)by_plan<__nv_bfloat16, Fwd>(epl, vec, x, scale, bias, y, rows,
                                          H, eps, s);
}

// dtype, epl and vec as above for x, g and dx, all contiguous (rows, H) and
// 16-byte aligned; scale f32 (H,); out f32: dscale (H), then dbias (H),
// padded to a multiple of 8 floats; parts f32 scratch of (2, grid, H)
// followed by 8 floats: pass 2's blocks cover 8 columns of out each, so
// where 2H is not a multiple of 8 the last block's threads past 2H read
// within the 8 floats after parts and write the padding of out. The rows
// are cut into grid tiles of rows_per_tile = rows / grid rows (the first
// rows % grid tiles one more), one a block of pass 1: grid must be 1 to
// rows.
extern "C" int mmfm_layernorm_bwd(const void* x, const float* scale,
                                  const void* g, void* dx, float* out,
                                  float* parts, int grid, int rows_per_tile,
                                  int rows, int H, int epl, int vec,
                                  float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(H, epl, vec, dtype_bytes(dtype)) || rows <= 0 || grid <= 0 ||
      grid > rows || rows_per_tile != rows / grid)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)by_plan<float, Bwd>(epl, vec, x, scale, g, dx, out, parts,
                                    grid, rows_per_tile, rows, H, eps, s);
  return (int)by_plan<__nv_bfloat16, Bwd>(epl, vec, x, scale, g, dx, out,
                                          parts, grid, rows_per_tile, rows,
                                          H, eps, s);
}
