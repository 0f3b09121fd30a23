// Fixed-order row sums for Hopper (sm_90a): the backward of a per-sample
// gather of session rows.
//
// A session-mixed batch gathers, for each sample b, row ids[b] of a stitched
// parameter stack (the tokenizers' (S, N, mult*H) kernels and (S, mult*H)
// biases, the head's (S, H, N) kernel and (S, N) bias, the session table).
// The gradient of the stack is then, for each session s,
//
//     out[s, :] = sum over b with ids[b] == s of g[b, :]        (f32)
//
// with exact zeros for the sessions absent from the batch. The JAX package
// computes it as XLA's scatter-add (the transpose of jnp.take,
// multi_modal_foundation_model_tpu/models/layers.py:651-658, :686-690); on
// the card torch's index_add_ would sum repeated ids with atomics, in an
// order that changes from run to run, and a CUDA-graph replay would no longer
// equal the eager step bit for bit. Here each output element is summed by one
// thread, over b in ascending order, from 0.0f: the same order as the plain
// version in ops/session_rows.py, so the two agree bit for bit.
//
// Layout: g (B, M) row-major, f32 or bf16 (read as f32); ids (B,) int64;
// out (S, M) f32. Grid (ceil(M / (256 * kVec)), S): a block owns kVec * 256
// consecutive columns of one session. Its first warp lists the batch rows of
// that session in shared memory, ascending (a ballot per 32 ids), so a
// thread then reads only its session's rows: over the grid, g is read once.
// kVec = 4 loads 16 bytes (f32) or 8 bytes (bf16) a row where M is a
// multiple of 4 and the pointers are aligned; kVec = 1 otherwise.
//
// What bounds it: the bytes (g read once, out written once: 16 x 1024 x 512
// f32 in and 10 x 1024 x 512 f32 out at the B = 16 step's tokenizer kernel,
// 53.5 MB). Nothing is computed but one add an element read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
session_rows_grad_kernel(const T* __restrict__ g,
                         const long long* __restrict__ ids, int n_rows,
                         long long m, float* __restrict__ out) {
  extern __shared__ int rows[];
  __shared__ int n_mine;
  const int s = blockIdx.y;
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    int c = 0;
    for (int base = 0; base < n_rows; base += 32) {
      const int b = base + (int)lane;
      const bool hit = b < n_rows && __ldg(ids + b) == (long long)s;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) rows[c + __popc(mask & ((1u << lane) - 1u))] = b;
      c += __popc(mask);
    }
    if (lane == 0) n_mine = c;
  }
  __syncthreads();
  const int n = n_mine;
  const long long e =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (e >= m) return;
  float* o = out + (long long)s * m + e;
  if constexpr (kVec == 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float4 v = load4(g + (long long)rows[i] * m + e);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(o) = acc;
  } else {
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) acc += load1(g + (long long)rows[i] * m + e);
    *o = acc;
  }
}

template <typename T>
int launch(const void* g, const long long* ids, int n_rows, int n_sessions,
           long long m, float* out, cudaStream_t stream) {
  const uintptr_t align = sizeof(T) * 4;
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_block = kThreads * (vec ? 4 : 1);
  const dim3 grid((unsigned)((m + per_block - 1) / per_block),
                  (unsigned)n_sessions);
  const size_t smem = sizeof(int) * (size_t)n_rows;
  const T* gt = static_cast<const T*>(g);
  if (vec)
    session_rows_grad_kernel<T, 4>
        <<<grid, kThreads, smem, stream>>>(gt, ids, n_rows, m, out);
  else
    session_rows_grad_kernel<T, 1>
        <<<grid, kThreads, smem, stream>>>(gt, ids, n_rows, m, out);
  return (int)cudaGetLastError();
}

}  // namespace

// g (n_rows, m) f32 (dtype 0) or bf16 (dtype 1), ids (n_rows,) int64, out
// (n_sessions, m) f32; n_rows <= 12288 (the row list's shared memory).
// Returns the cudaError of the launch (0: launched).
extern "C" int mmfm_session_rows_grad(const void* g, int dtype,
                                      const long long* ids, int n_rows,
                                      int n_sessions, long long m, float* out,
                                      cudaStream_t stream) {
  if (n_rows < 0 || n_rows > 12288 || n_sessions < 1 || n_sessions > 65535 ||
      m < 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  if (dtype == 0) return launch<float>(g, ids, n_rows, n_sessions, m, out,
                                       stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, ids, n_rows, n_sessions, m, out, stream);
  return (int)cudaErrorInvalidValue;
}
