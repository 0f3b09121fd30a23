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
// not saved, as on the TPU). The design keeps every row in registers:
//   - one warp per row; a lane holds up to kEpl = H/32 (rounded up to a
//     power of two) values of the row, loaded and stored 16 bytes at a time
//     (V values per access, the lanes on neighbouring addresses);
//   - the row sums go through warp shuffles (a butterfly, so every lane
//     holds the same bits of the sum);
// K4 also sums dscale and dbias over the rows. JAX adds each grid step's
// sum into one (1, H) block it revisits, which is right only because TPU
// grid steps run in order (:121-130). Blocks on Hopper run in no order, so
// K4 has two passes and no atomics, which makes dscale and dbias
// bit-reproducible from run to run:
//   pass 1 (ln_bwd_dx_kernel): a block of 8 warps walks kRowsPerBlock rows,
//     each warp its own rows in a fixed order, writing dx and keeping its
//     columns' sums of g * xhat and g in registers (xhat in f32, never
//     rounded to bf16); the 8 warps' sums are added in warp order through
//     shared memory into one row of an f32 (n_blocks, H) scratch per sum;
//   pass 2 (ln_bwd_dwdb_kernel): the scratch rows are summed over the
//     blocks in a fixed order.
// Any row count works (ragged blocks are masked; nothing is padded). H must
// be a multiple of 32 from 32 to 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                    // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;             // K4 pass 1
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxH = 1024;

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
// (lane + 32 j) * kV; a chunk past H holds zeros and is never stored
template <typename T, int kEpl>
struct Layout {
  static constexpr int kV = kEpl < 16 / (int)sizeof(T) ? kEpl
                                                        : 16 / (int)sizeof(T);
  static constexpr int kNc = kEpl / kV;
};

template <typename T, int kEpl>
__device__ __forceinline__ void load_row(const T* row, int H, int lane,
                                         float* v) {
  using L = Layout<T, kEpl>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + 32 * j) * L::kV;
    if (c0 < H) {
      load_vec<T, L::kV>(row + c0, v + j * L::kV);
    } else {
#pragma unroll
      for (int e = 0; e < L::kV; ++e) v[j * L::kV + e] = 0.f;
    }
  }
}

template <typename T, int kEpl>
__device__ __forceinline__ void load_params(const float* p, int H, int lane,
                                            float* v) {
  using L = Layout<T, kEpl>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + 32 * j) * L::kV;
    if (c0 < H) {
      load_f32<L::kV>(p + c0, v + j * L::kV);
    } else {
#pragma unroll
      for (int e = 0; e < L::kV; ++e) v[j * L::kV + e] = 0.f;
    }
  }
}

template <typename T, int kEpl>
__device__ __forceinline__ void store_row(T* row, int H, int lane,
                                          const float* v) {
  using L = Layout<T, kEpl>;
#pragma unroll
  for (int j = 0; j < L::kNc; ++j) {
    const int c0 = (lane + 32 * j) * L::kV;
    if (c0 < H) store_vec<T, L::kV>(row + c0, v + j * L::kV);
  }
}

// mu and rsigma of a row held across the warp (zeros past H add nothing)
template <int kEpl>
__device__ __forceinline__ void row_stats(const float* v, int H, float eps,
                                          float& mu, float& rsigma) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kEpl; ++i) {
    s += v[i];
    ss = fmaf(v[i], v[i], ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mu = s / (float)H;
  const float var = fmaxf(ss / (float)H - mu * mu, 0.f);
  rsigma = rsqrtf(var + eps);
}

// K3: one warp per row
template <typename T, int kEpl>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, int rows,
              int H, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[kEpl], w[kEpl], b[kEpl];
  load_row<T, kEpl>(x + row * H, H, lane, v);
  float mu, rsigma;
  row_stats<kEpl>(v, H, eps, mu, rsigma);
  load_params<T, kEpl>(scale, H, lane, w);
  load_params<T, kEpl>(bias, H, lane, b);
#pragma unroll
  for (int i = 0; i < kEpl; ++i) v[i] = (v[i] - mu) * (rsigma * w[i]) + b[i];
  store_row<T, kEpl>(y + row * H, H, lane, v);
}

// K4 pass 1: dx for kRowsPerBlock rows, and the block's column sums of
// g * xhat and g
template <typename T, int kEpl>
__global__ void __launch_bounds__(kThreads)
ln_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ part_dscale,
                 float* __restrict__ part_dbias, int rows, int H, float eps) {
  using L = Layout<T, kEpl>;
  __shared__ float sum_dscale[kMaxH];
  __shared__ float sum_dbias[kMaxH];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float w[kEpl], acc_ds[kEpl], acc_db[kEpl];
  load_params<T, kEpl>(scale, H, lane, w);
#pragma unroll
  for (int i = 0; i < kEpl; ++i) acc_ds[i] = acc_db[i] = 0.f;

  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    // the block's 8 warps take 8 neighbouring rows at a time
    const long long row = row0 + (long long)r * kWarps + warp;
    if (row >= rows) break;
    float xv[kEpl], gv[kEpl];
    load_row<T, kEpl>(x + row * H, H, lane, xv);
    load_row<T, kEpl>(g + row * H, H, lane, gv);
    float mu, rsigma;
    row_stats<kEpl>(xv, H, eps, mu, rsigma);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      // xhat; past H, g = scale = 0, so the padding adds nothing below
      xv[i] = (xv[i] - mu) * rsigma;
      const float dxhat = gv[i] * w[i];
      m1 += dxhat;
      m2 = fmaf(dxhat, xv[i], m2);
    }
    m1 = warp_sum(m1) / (float)H;
    m2 = warp_sum(m2) / (float)H;
    float out[kEpl];
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      out[i] = rsigma * (gv[i] * w[i] - m1 - xv[i] * m2);
      acc_ds[i] = fmaf(gv[i], xv[i], acc_ds[i]);
      acc_db[i] += gv[i];
    }
    store_row<T, kEpl>(dx + row * H, H, lane, out);
  }

  // the warps' column sums, added in warp order
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int j = 0; j < L::kNc; ++j) {
        const int c0 = (lane + 32 * j) * L::kV;
        if (c0 < H) {
#pragma unroll
          for (int e = 0; e < L::kV; ++e) {
            const int i = j * L::kV + e;
            sum_dscale[c0 + e] =
                wi == 0 ? acc_ds[i] : sum_dscale[c0 + e] + acc_ds[i];
            sum_dbias[c0 + e] =
                wi == 0 ? acc_db[i] : sum_dbias[c0 + e] + acc_db[i];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < H; c += kThreads) {
    part_dscale[(long long)blockIdx.x * H + c] = sum_dscale[c];
    part_dbias[(long long)blockIdx.x * H + c] = sum_dbias[c];
  }
}

// K4 pass 2: dscale and dbias from the pass-1 blocks' sums, in a fixed
// order. A block takes 32 columns; its 8 warps each sum every 8th block row
// and are then added in warp order.
__global__ void __launch_bounds__(kThreads)
ln_bwd_dwdb_kernel(const float* __restrict__ part_dscale,
                   const float* __restrict__ part_dbias,
                   float* __restrict__ dscale, float* __restrict__ dbias,
                   int n_parts, int H) {
  __shared__ float s_ds[kWarps][32];
  __shared__ float s_db[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (col < H) {
#pragma unroll 4
    for (int p = warp; p < n_parts; p += kWarps) {
      a += part_dscale[(long long)p * H + col];
      b += part_dbias[(long long)p * H + col];
    }
  }
  s_ds[warp][lane] = a;
  s_db[warp][lane] = b;
  __syncthreads();
  if (warp == 0 && col < H) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ta += s_ds[i][lane];
      tb += s_db[i][lane];
    }
    dscale[col] = ta;
    dbias[col] = tb;
  }
}

template <typename T, int kEpl>
cudaError_t fwd_launch(const void* x, const float* scale, const float* bias,
                       void* y, int rows, int H, float eps,
                       cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  ln_fwd_kernel<T, kEpl><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, H,
      eps);
  return cudaGetLastError();
}

template <typename T, int kEpl>
cudaError_t bwd_launch(const void* x, const float* scale, const void* g,
                       void* dx, float* part_dscale, float* part_dbias,
                       float* dscale, float* dbias, int rows, int H, float eps,
                       cudaStream_t stream) {
  const int n_parts = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_bwd_dx_kernel<T, kEpl><<<(unsigned)n_parts, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(g),
      static_cast<T*>(dx), part_dscale, part_dbias, rows, H, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_dwdb_kernel<<<(unsigned)((H + 31) / 32), kThreads, 0, stream>>>(
      part_dscale, part_dbias, dscale, dbias, n_parts, H);
  return cudaGetLastError();
}

// the instantiation whose kEpl (a power of two) covers H / 32 values a lane
template <typename T, template <typename, int> class Launch, typename... A>
cudaError_t by_width(int H, A... args) {
  const int epl = H / 32;
  if (epl <= 1) return Launch<T, 1>::run(args...);
  if (epl <= 2) return Launch<T, 2>::run(args...);
  if (epl <= 4) return Launch<T, 4>::run(args...);
  if (epl <= 8) return Launch<T, 8>::run(args...);
  if (epl <= 16) return Launch<T, 16>::run(args...);
  return Launch<T, 32>::run(args...);
}

template <typename T, int kEpl>
struct Fwd {
  static cudaError_t run(const void* x, const float* scale, const float* bias,
                         void* y, int rows, int H, float eps,
                         cudaStream_t stream) {
    return fwd_launch<T, kEpl>(x, scale, bias, y, rows, H, eps, stream);
  }
};

template <typename T, int kEpl>
struct Bwd {
  static cudaError_t run(const void* x, const float* scale, const void* g,
                         void* dx, float* part_dscale, float* part_dbias,
                         float* dscale, float* dbias, int rows, int H,
                         float eps, cudaStream_t stream) {
    return bwd_launch<T, kEpl>(x, scale, g, dx, part_dscale, part_dbias,
                               dscale, dbias, rows, H, eps, stream);
  }
};

bool width_ok(int H) { return H >= 32 && H <= kMaxH && H % 32 == 0; }

}  // namespace

// Rows per pass-1 block of K4: the scratch holds ceil(rows / this) rows of H.
extern "C" int mmfm_layernorm_bwd_rows_per_block() { return kRowsPerBlock; }

// dtype: 0 = float32, 1 = bfloat16 (x and y). x and y contiguous (rows, H),
// 16-byte aligned; scale and bias f32 (H,). Returns the launch's
// cudaGetLastError() (0 = ok).
extern "C" int mmfm_layernorm_fwd(const void* x, const float* scale,
                                  const float* bias, void* y, int rows, int H,
                                  float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!width_ok(H) || rows <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)by_width<float, Fwd>(H, x, scale, bias, y, rows, H, eps, s);
  if (dtype == 1)
    return (int)by_width<__nv_bfloat16, Fwd>(H, x, scale, bias, y, rows, H,
                                             eps, s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above for x, g and dx, all contiguous (rows, H) and 16-byte
// aligned; scale f32 (H,); part_dscale and part_dbias f32 scratch of
// (ceil(rows / rows_per_block), H); dscale and dbias f32 (H,).
extern "C" int mmfm_layernorm_bwd(const void* x, const float* scale,
                                  const void* g, void* dx, float* part_dscale,
                                  float* part_dbias, float* dscale,
                                  float* dbias, int rows, int H, float eps,
                                  int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!width_ok(H) || rows <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)by_width<float, Bwd>(H, x, scale, g, dx, part_dscale,
                                     part_dbias, dscale, dbias, rows, H, eps,
                                     s);
  if (dtype == 1)
    return (int)by_width<__nv_bfloat16, Bwd>(H, x, scale, g, dx, part_dscale,
                                             part_dbias, dscale, dbias, rows,
                                             H, eps, s);
  return (int)cudaErrorInvalidValue;
}
