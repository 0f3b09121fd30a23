// Philox draws keyed from the device: layer dropout's random bytes and the
// masker's uniforms, for Hopper (sm_90a).
//
// Replaces the TPU's own random bits of the JAX package's layer dropout
// (multi_modal_foundation_model_tpu/models/layers.py:227-240,
// `U8_DROPOUT_BITS`: one random byte an element, keep iff byte >= t) and the
// jax.random Bernoulli draws of its masker (ops/masking.py). The key is one
// entry of the training step's seed table (utils/rng.py), read from device
// memory, never passed by value: a CUDA graph of the step replayed with a new
// table draws what the eager step with those seeds draws, and a
// torch.utils.checkpoint recompute draws the forward's bits again.
//
// Element e of a draw under key s (64 bits) and stream c (a constant of the
// call site) comes from philox4x32_10(counter = (n lo, n hi, c, kind),
// key = (s lo, s hi)) (philox.cuh):
//   bytes    (kind 0): n = e / 16, byte e % 16 of the four output words, each
//                      word little-endian;
//   uniforms (kind 1): n = e / 4, word e % 4, u = (word >> 8) * 2^-24, so
//                      u lies in [0, 1) on 24 bits and f32 holds it exactly.
// ops/random.py draws the same bits with torch integer operations.
//
// What bounds it on the H100: the bytes written (one byte or one f32 an
// element; nothing is read but the key). Ten Philox rounds make 16 bytes,
// ~120 integer operations, far under the card's integer rate for that
// traffic. One thread makes one 16-byte block and stores it in one 16-byte
// store where the output is aligned; the ragged tail stores element by
// element. At the training step's sizes (a few hundred KB to 13 MB) a launch
// takes a few microseconds, about the launch cost itself.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using mmfm::Philox4;
using mmfm::philox4x32_10;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;   // grid-stride past this

__device__ __forceinline__ Philox4 draw(const long long* seed, long long n,
                                        unsigned stream, unsigned kind) {
  const unsigned long long s = (unsigned long long)__ldg(seed);
  return philox4x32_10((uint32_t)n, (uint32_t)((unsigned long long)n >> 32),
                       stream, kind, (uint32_t)s, (uint32_t)(s >> 32));
}

__global__ void __launch_bounds__(kThreads)
philox_u8_kernel(const long long* __restrict__ seed, unsigned stream,
                 uint8_t* __restrict__ out, long long n) {
  const long long n_blk = (n + 15) / 16;
  for (long long blk = (long long)blockIdx.x * kThreads + threadIdx.x;
       blk < n_blk; blk += (long long)gridDim.x * kThreads) {
    const Philox4 r = draw(seed, blk, stream, 0u);
    const long long e = blk * 16;
    uint8_t* o = out + e;
    if (e + 16 <= n && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<uint4*>(o) = make_uint4(r.x, r.y, r.z, r.w);
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 16 && e + j < n; ++j)
        o[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
philox_uniform_kernel(const long long* __restrict__ seed, unsigned stream,
                      float* __restrict__ out, long long n) {
  const long long n_blk = (n + 3) / 4;
  for (long long blk = (long long)blockIdx.x * kThreads + threadIdx.x;
       blk < n_blk; blk += (long long)gridDim.x * kThreads) {
    const Philox4 r = draw(seed, blk, stream, 1u);
    const float k = 1.0f / 16777216.0f;
    const float u[4] = {(r.x >> 8) * k, (r.y >> 8) * k, (r.z >> 8) * k,
                        (r.w >> 8) * k};
    const long long e = blk * 4;
    float* o = out + e;
    if (e + 4 <= n && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(u[0], u[1], u[2], u[3]);
    } else {
      for (int j = 0; j < 4 && e + j < n; ++j) o[j] = u[j];
    }
  }
}

unsigned grid_for(long long n_blk) {
  const long long g = (n_blk + kThreads - 1) / kThreads;
  return (unsigned)(g < kMaxBlocks ? (g > 0 ? g : 1) : kMaxBlocks);
}

}  // namespace

// seed: one int64 on the device (the table entry); n elements of out.
// Return the launch's cudaGetLastError() (0 = ok).
extern "C" int mmfm_philox_u8(const long long* seed, unsigned stream,
                              void* out, long long n, void* cuda_stream) {
  if (n <= 0) return 0;
  philox_u8_kernel<<<grid_for((n + 15) / 16), kThreads, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
      seed, stream, static_cast<uint8_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int mmfm_philox_uniform(const long long* seed, unsigned stream,
                                   float* out, long long n,
                                   void* cuda_stream) {
  if (n <= 0) return 0;
  philox_uniform_kernel<<<grid_for((n + 3) / 4), kThreads, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
      seed, stream, out, n);
  return (int)cudaGetLastError();
}
