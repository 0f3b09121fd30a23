// K2, the attention backward, at head width D = 128: attention_bwd.cu
// compiled as a library of its own, so that the widths build in parallel
// (ops/build.py starts one nvcc a source).
#define MMFM_HEAD_DIM 128
#include "attention_bwd.cu"
