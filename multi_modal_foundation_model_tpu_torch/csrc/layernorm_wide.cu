// K3 and K4 for rows wider than a warp holds (1024 < H <= 4096): a row a
// block of 8 warps (ln_fwd_kernel_wide, ln_bwd_dx_wide_kernel), the
// library of layernorm.cu built with MMFM_LN_WIDE. The wrapper's planner
// (ops/layernorm.py ln_plan) sends those widths here.
#define MMFM_LN_WIDE 1
#include "layernorm.cu"
