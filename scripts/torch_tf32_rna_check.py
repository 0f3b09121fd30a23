#!/usr/bin/env python3
"""The f32 kernels' TF32 split against ``cvt.rna``, on one NVIDIA GPU.

    python3 scripts/torch_tf32_rna_check.py

The f32 attention kernels split each operand x into TF32 hi and lo parts
with ``split_tf32`` (``csrc/mma_tf32.cuh``): hi = ``tf32_rna(x)`` (half
an ulp of tf32 added to the magnitude's bits, the low 13 cleared), lo the
same of x - hi with a signed min in front that keeps the canonical NaN a
NaN. This script builds a kernel that takes every one of the 2^32 f32 bit
patterns through both and through ``cvt.rna.tf32.f32`` (hi = cvt(x), lo =
cvt(x - hi)), and counts the patterns that fail: a finite x whose
``tf32_rna``, hi or lo bits differ from cvt.rna's; an infinite x whose hi
is not cvt.rna's or whose lo is not a NaN; a NaN x whose lo is not a NaN.
"A NaN" holds also as the tensor cores read the value (its low 13 bits
dropped): a NaN operand must give NaN products. It also counts, for
comparison, the NaN patterns whose hi by cvt.rna the tensor cores read as
no NaN. Prints one JSON line: the counts, the first failing pattern, if
any, and ``ok`` (none failed). Without CUDA it exits non-zero.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multi_modal_foundation_model_tpu_torch.ops import build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "mma_tf32.cuh"

using namespace mmfm;

__device__ uint32_t cvt_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ bool nan_bits(uint32_t b) {
  return isnan(__uint_as_float(b)) && isnan(__uint_as_float(b & 0xFFFFE000u));
}

// out: [0] finite patterns that fail, [1] non-finite ones, [2] NaN patterns
// whose hi by cvt.rna reads as no NaN, [3] the first failing pattern
__global__ void check(unsigned long long* out, unsigned long long start) {
  const unsigned long long i =
      start + (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t bits = (uint32_t)i;
  const float x = __uint_as_float(bits);
  const uint32_t ch = cvt_rna(x), cl = cvt_rna(x - __uint_as_float(ch));
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  bool ok;
  if (isfinite(x))
    ok = tf32_rna(x) == ch && hi == ch && lo == cl;
  else if (isinf(x))
    ok = hi == ch && nan_bits(lo);
  else
    ok = nan_bits(lo);
  if (!ok) {
    atomicAdd(out + (isfinite(x) ? 0 : 1), 1ull);
    atomicMin(out + 3, (unsigned long long)bits);
  }
  if (isnan(x) && !nan_bits(ch)) atomicAdd(out + 2, 1ull);
}

extern "C" int run(unsigned long long* host) {
  unsigned long long* out;
  cudaMalloc(&out, 4 * 8);
  const unsigned long long init[4] = {0ull, 0ull, 0ull, ~0ull};
  cudaMemcpy(out, init, sizeof init, cudaMemcpyHostToDevice);
  const unsigned long long step = 1ull << 30;
  for (unsigned long long s = 0; s < (1ull << 32); s += step)
    check<<<(unsigned)(step / 256), 256>>>(out, s);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(host, out, 4 * 8, cudaMemcpyDeviceToHost);
  cudaFree(out);
  return (int)err;
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tf32_rna_check: CUDA is not available", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "probe" / "tf32_rna"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "tf32_rna_check.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libtf32_rna_check.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                           "-I", str(build.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    fn.restype = ctypes.c_int
    res = (ctypes.c_ulonglong * 4)()
    rc = fn(res)
    finite, nonfinite, cvt_hi_no_nan, first = res
    ok = rc == 0 and finite == 0 and nonfinite == 0
    print(json.dumps(dict(phase="tf32_rna_check", cuda_rc=rc,
                          patterns=2 ** 32, failing_finite=finite,
                          failing_nonfinite=nonfinite,
                          nan_whose_cvt_hi_reads_no_nan=cvt_hi_no_nan,
                          first_failing=None if finite + nonfinite == 0
                          else hex(first), ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
