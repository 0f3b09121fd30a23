// K1, the attention forward, at head width D = 16: attention_fwd.cu
// compiled as a library of its own, so that the widths build in parallel
// (ops/build.py starts one nvcc a source).
#define MMFM_HEAD_DIM 16
#include "attention_fwd.cu"
