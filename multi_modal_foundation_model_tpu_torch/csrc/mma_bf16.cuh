// Small building blocks of the attention kernels for Hopper (sm_90a):
// smem_u32, pack_bf16, scale_bf16x2, fast_exp2, the attend bits of 4 keys
// (attend_nibble, the f32 K1 at 128's table), allow_smem and the
// constants.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mmfm {

constexpr float kNegInf = -1e30f;   // ops/attention.py NEG_INF
constexpr float kLseFloor = -1e6f;  // ops/attention.py _LSE_FLOOR

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float mul) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16(f.x * mul, f.y * mul);
}

// 2^x on the MUFU (flushes results below 2^-126 to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The attend bits of 4 positions of the other side, p0 = k0 (bit 4 + i =
// static(q, k0 + i) | key_pad(k0 + i)), 0 past the ends. With vec (Tk % 4
// == 0 and 16-byte aligned masks) one 16-byte load of each mask.
__device__ __forceinline__ unsigned attend_nibble(
    const int* __restrict__ static_mask, const int* __restrict__ pad, int Tq,
    int Tk, int qrow, int k0, bool vec) {
  if (qrow >= Tq || k0 >= Tk) return 0u;
  const int* srow = static_mask + (long long)qrow * Tk;
  if (vec) {
    const int4 s4 = __ldg(reinterpret_cast<const int4*>(srow + k0));
    const int4 p4 = __ldg(reinterpret_cast<const int4*>(pad + k0));
    return (unsigned)((s4.x | p4.x) != 0) << 4 |
           (unsigned)((s4.y | p4.y) != 0) << 5 |
           (unsigned)((s4.z | p4.z) != 0) << 6 |
           (unsigned)((s4.w | p4.w) != 0) << 7;
  }
  unsigned byte = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + i;
    if (key < Tk && ((__ldg(srow + key) != 0) | (__ldg(pad + key) != 0)))
      byte |= 0x10u << i;
  }
  return byte;
}

// Dynamic shared memory above the default 48 KB needs an opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mmfm
