#!/usr/bin/env python3
"""K4 (the LayerNorm backward) on one NVIDIA GPU: each of its kernels timed
apart, its registers and blocks an SM, the committed kernel beside design
variants of it and another checkout's K4.

    python3 scripts/torch_k4_variants.py [--parent OTHER_CHECKOUT]
                                         [--only NAME[,NAME...]]

Builds the committed ``csrc/layernorm.cu`` and variants of it (string
edits of the source into ``build/probe/k4_<name>/``, each edit checked to
apply exactly once) and, with ``--parent``, another checkout's (say the
parent commit's, unpacked by ``git archive``); ``--only`` keeps the named
builds. Every build gets one more export, ``mmfm_probe_blocks_per_sm``:
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the pass-1 kernel
``ln_bwd_dx_kernel<T, 8, 16 / sizeof(T)>`` (H = 256). A build that still has the two-pass
C interface of the first K4 (``mmfm_layernorm_bwd_rows_per_block``) is
driven through it here; the others are swapped in for
``ops.layernorm._lib`` and driven through ``layernorm_bwd``, so they need
its C interface (the plan's values a lane and vector width: a checkout
from before head-width and vector-width support takes neither).

At the two row counts of the training step, 3,200 x 256 (B=16) and
51,200 x 256 (B=256), f32 and bf16, each build is checked against
``layer_norm_bwd_reference`` with ``chip_smoke.k4_gates`` and timed with
``chip_smoke.device_ms_by_kernel`` (torch.profiler device time of every
kernel a call launches, over 20 calls), in the order of the list and then
reversed. Prints JSON lines: the card, each build's ``ptxas`` registers and
spills and its blocks an SM, each check, each timing with its bound.

The variants of the committed kernel:

- ``base``: the committed kernel: one slot a warp (the next row's x and g
  loaded while a row is reduced), held as raw 16-byte words; at least 2
  blocks an SM (``__launch_bounds__``: up to 128 registers); pass 2 in 32
  splits of 8 columns.
- ``ring_2``, ``ring_3``, ``ring_4``: a ring of 2, 3 or 4 slots a warp.
- ``packed_slot``, ``packed_ring_2``: the slots held as kV values of T
  instead of raw words (the first redesign's ring, which the compiler
  unpacked right after each load).
- ``ldg_nc``: x and g loaded through the read-only path (``__ldg``).
- ``div_h``: pass 1's four means of a row as divisions by H, not products
  with 1/H (the same bits at H = 256, a power of two).
- ``free_regs``, ``free_regs_div_h``: pass 1 without its launch bound of 2
  blocks an SM (ptxas then chose 80 registers for f32, with spills).
- ``min_blocks_3``, ``min_blocks_4``, ``ring_2_min_blocks_3``: pass 1
  bound to 3 or 4 blocks an SM; the plan follows the card's blocks an SM,
  so the grid grows with them.
- ``warps_4``: blocks of 4 warps (twice the blocks, the same warps an SM).
- ``warp_rows_4``, ``full_wave``, ``sm_grid`` (the plan alone): more
  blocks than SMs only while a warp keeps 4 rows (134 blocks of 3 rows a
  warp at 3,200 rows, where the plan takes 200 of 2); a full wave of
  blocks always (396 at 3,200 and 51,200 rows in bf16); one block an SM
  (132 tiles of 24 or 25 rows at 3,200, some warps 4 rows; 132 at
  51,200); ``parts_256``: the plan's grid cut to 256 blocks (one batch of
  pass 2: bf16 at 51,200 rows, 377 blocks otherwise).
- ``unrolled_pass2``: pass 2's loop as ``#pragma unroll 8`` over single
  loads (its remainder's loads wait one by one); ``split_loads_12``,
  ``split_loads_16``: pass 2 in batches of 12 or 16 loads (one batch up to
  384 or 512 partial rows).
- ``column_major``: the partial sums column-major (2 H, grid), and pass 2
  one warp a column: lane l adds entries l, l + 32, ... in order, a
  butterfly adds the lanes (coalesced reads, no shared memory, but
  strided writes at the end of pass 1).
- ``diag_hot_rows`` (a diagnosis, wrong on purpose: its check is printed,
  not enforced): every warp loads its tile's first row again and again,
  from L1, so the time left is the arithmetic, the shuffles and the
  stores. ``diag_no_store``: dx is not stored.
- ``ticket``: no second kernel; the last pass-1 block to finish (a ticket
  counter: ``__threadfence``, then ``atomicAdd`` on an int that it sets
  back to 0) sums the partial rows in block order, two splits of float4
  columns.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (operands, gates, timers, bounds)
from multi_modal_foundation_model_tpu_torch.ops import build  # noqa: E402
from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln  # noqa: E402

H = 256
ROWS = (cs.TRAIN_B * 200, cs.BIG_B * 200)       # 3,200 and 51,200 tokens
EPS = 1e-5

PROBE = '''
extern "C" int mmfm_probe_blocks_per_sm(int dtype) {
  int n = -1;
  if (dtype == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ln_bwd_dx_kernel<float, 8, 4>, kThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ln_bwd_dx_kernel<__nv_bfloat16, 8, 8>, kThreads, 0);
  return n;
}
'''

PIN = "__launch_bounds__(kThreads, kEpl <= 8 ? 2 : 1)\nln_bwd_dx_kernel"
SLOT_HEAD = """  RawRow<T, kEpl, kV> xr, gr;
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
"""
RING_HEAD = """  constexpr int kDepth = DEPTH;
  RawRow<T, kEpl, kV> xr[kDepth], gr[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int r = begin + warp + d * kWarps;
    if (r < end) {
      fetch_row<T, kEpl, kV>(x + (long long)r * H, H, lane, xr[d]);
      fetch_row<T, kEpl, kV>(g + (long long)r * H, H, lane, gr[d]);
    }
  }
  for (int r0 = begin + warp; r0 < end; r0 += kDepth * kWarps) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int row = r0 + d * kWarps;
    if (row >= end) break;
    float xv[kEpl], gv[kEpl];
    unpack_row<T, kEpl, kV>(xr[d], xv);
    unpack_row<T, kEpl, kV>(gr[d], gv);
    if (row + kDepth * kWarps < end) {
      const long long next = (long long)(row + kDepth * kWarps) * H;
      fetch_row<T, kEpl, kV>(x + next, H, lane, xr[d]);
      fetch_row<T, kEpl, kV>(g + next, H, lane, gr[d]);
    }
"""
STORE = "    store_row<T, kEpl, kV>(dx + (long long)row * H, H, lane, out);\n"


def ring(depth: int) -> list:
    """kDepth slots a warp: rows r .. r + kDepth - 1 in flight."""
    return [(SLOT_HEAD, RING_HEAD.replace("DEPTH", str(depth))),
            (STORE + "  }\n\n  float* part", STORE + "  }\n  }\n\n  float* part")]


TICKET_FINISH = """  block_sum<T, kEpl, kV>(acc_db, red, part + (long long)gridDim.x * H, H,
                         lane, warp);
  // the last block to finish sums the partial rows in block order: thread
  // t adds the float4 of columns 4 (t % 128) in rows t / 128, + 2, ..., and
  // the two splits are added in order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    float* flat = &red[0][0];
    const int n = gridDim.x;
    for (int q = threadIdx.x & 127; q * 4 < 2 * H; q += 128) {
      const int col = q * 4, which = col >= H;
      const float* pp = parts + (long long)which * n * H + (col - which * H);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = threadIdx.x >> 7; i < n; i += 2) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            pp + (long long)i * H));
        a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
      }
      *reinterpret_cast<float4*>(flat + (threadIdx.x >> 7) * 2 * H + col) = a;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * H; c += kThreads)
      (parts - 2 * H)[c] = flat[c] + flat[2 * H + c];
    if (threadIdx.x == 0) g_ticket = 0;
  }
"""

COLUMN_COLSUM = """__global__ void __launch_bounds__(kThreads)
ln_bwd_colsum_kernel(const float* __restrict__ parts, float* __restrict__ out,
                     int n_parts, int n_cols) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= n_cols) return;
  const float* p = parts + (long long)col * n_parts;
  float a = 0.f;
#pragma unroll 8
  for (int i = lane; i < n_parts; i += 32) a += p[i];
  a = warp_sum(a);
  if (lane == 0) out[col] = a;
}
"""


FETCH = "      const long long next = (long long)(row + kWarps) * H;"
LOAD = "    r.c[j] = c0 < H ? *reinterpret_cast<const W*>(row + c0) : W{};"
PIN_FREE = (PIN, PIN.replace("(kThreads, kEpl <= 8 ? 2 : 1)", "(kThreads)"))
PIN_3 = (PIN, PIN.replace("? 2 :", "? 3 :"))
PIN_4 = (PIN, PIN.replace("? 2 :", "? 4 :"))
DIV_H = [
    ("    const float mu = s * inv_h;\n"
     "    const float rsigma = rsqrtf(fmaxf(ss * inv_h - mu * mu, 0.f) + eps);",
     "    const float mu = s / (float)H;\n"
     "    const float rsigma = rsqrtf(fmaxf(ss / (float)H - mu * mu, 0.f) + eps);"),
    ("    m1 = warp_sum(m1) * inv_h;\n    m2 = warp_sum(m2) * inv_h;",
     "    m1 = warp_sum(m1) / (float)H;\n    m2 = warp_sum(m2) / (float)H;"),
]
PASS2_LOOP = """  for (int i0 = split; i0 < n_parts; i0 += kSplitLoads * kSplits) {
    float v[kSplitLoads];
#pragma unroll
    for (int k = 0; k < kSplitLoads; ++k) {
      const int i = i0 + k * kSplits;
      v[k] = i < n_parts ? p[(long long)i * H] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kSplitLoads; ++k) a += v[k];
  }
"""
COLSUM_START = "__global__ void __launch_bounds__(kThreads)\nln_bwd_colsum_kernel"
COLSUM_END = "    out[col] = t;\n  }\n}\n"

# name -> [(old, new)] edits of layernorm.cu, each old text present once;
# the checks of names starting "diag_" are printed and not enforced
VARIANTS: dict = {
    "base": [],
    "ring_2": ring(2),
    "ring_3": ring(3),
    "ring_4": ring(4),
    "packed_slot": [("  using W = typename Word<sizeof(P)>::type;",
                     "  using W = P;")],
    "packed_ring_2": ring(2) + [("  using W = typename Word<sizeof(P)>::type;",
                                 "  using W = P;")],
    "ldg_nc": [(LOAD, "    r.c[j] = c0 < H ? __ldg(reinterpret_cast<const W*>"
                      "(row + c0)) : W{};")],
    "div_h": DIV_H,
    "free_regs": [PIN_FREE],
    "free_regs_div_h": [PIN_FREE] + DIV_H,
    "min_blocks_3": [PIN_3],
    "min_blocks_4": [PIN_4],
    "ring_2_min_blocks_3": ring(2) + [PIN_3],
    "warps_4": [("constexpr int kWarps = 8; ", "constexpr int kWarps = 4; ")],
    "warp_rows_4": [],
    "full_wave": [],
    "sm_grid": [],
    "parts_256": [],
    "unrolled_pass2": [(PASS2_LOOP, """#pragma unroll 8
  for (int i = split; i < n_parts; i += kSplits) a += p[(long long)i * H];
""")],
    "split_loads_12": [("constexpr int kSplitLoads = 8; ",
                        "constexpr int kSplitLoads = 12; ")],
    "split_loads_16": [("constexpr int kSplitLoads = 8; ",
                        "constexpr int kSplitLoads = 16; ")],
    "column_major": [
        ("    part[c] = s;", "    part[(long long)c * gridDim.x] = s;"),
        ("  float* part = parts + (long long)blockIdx.x * H;",
         "  float* part = parts + blockIdx.x;"),
        ("  block_sum<T, kEpl, kV>(acc_db, red, part + (long long)gridDim.x * H,",
         "  block_sum<T, kEpl, kV>(acc_db, red, part + (long long)H * gridDim.x,"),
        (None, COLUMN_COLSUM),
        ("""    ln_bwd_colsum_kernel<<<(unsigned)((2 * H + kSplitCols - 1) / kSplitCols),
                           kThreads, 0, stream>>>(parts, out, grid, H);""",
         """    ln_bwd_colsum_kernel<<<(unsigned)(2 * H / kWarps), kThreads, 0,
                           stream>>>(parts, out, grid, 2 * H);"""),
    ],
    "diag_hot_rows": [(FETCH, FETCH.replace("(row + kWarps) * H",
                                            "(begin + warp) * H"))],
    "diag_no_store": [(STORE, "    if (out[0] == 12345.f) " + STORE[4:])],
    "ticket": [
        ("constexpr int kMaxH = 1024;\n",
         "constexpr int kMaxH = 1024;\n__device__ int g_ticket = 0;\n"),
        (TICKET_FINISH.split("  // the last")[0], TICKET_FINISH),
        ("""    ln_bwd_colsum_kernel<<<(unsigned)((2 * H + kSplitCols - 1) / kSplitCols),
                           kThreads, 0, stream>>>(parts, out, grid, H);
    return cudaGetLastError();""", "    (void)out;\n    return cudaSuccess;"),
    ],
}


def _at_least_4_rows(rows, n_sm, blocks_per_sm):
    """The plan with more blocks than SMs only while a warp keeps 4 rows."""
    wave = n_sm * blocks_per_sm
    warp_rows = max(-(-rows // (8 * wave)), min(4, rows // (8 * n_sm)), 1)
    grid = max(-(-rows // (8 * warp_rows)), min(rows, n_sm))
    return ln.K4Plan(grid, rows // grid, grid)


PLAN = ln._k4_plan                     # the committed plan


def _at_most_256(rows, n_sm, blocks_per_sm):
    """The plan, its grid cut to 256 blocks (pass 2's one batch) where it
    has more."""
    plan = PLAN(rows, n_sm, blocks_per_sm)
    grid = max(min(plan.grid, 256), min(rows, n_sm))
    return ln.K4Plan(grid, rows // grid, grid)


def _balanced(grid_of):
    """A plan of ``grid_of(rows, n_sm, blocks_per_sm)`` balanced tiles."""
    def plan(rows, n_sm, blocks_per_sm):
        grid = max(1, grid_of(rows, n_sm, blocks_per_sm))
        return ln.K4Plan(grid, rows // grid, grid)
    return plan


# name -> {attribute of ops.layernorm: value} while the variant runs
PLAN_ATTRS = {
    "warp_rows_4": {"_k4_plan": _at_least_4_rows},
    "full_wave": {"_k4_plan": _balanced(lambda r, n, k: min(r, n * k))},
    "sm_grid": {"_k4_plan": _balanced(lambda r, n, k: min(r, n))},
    "parts_256": {"_k4_plan": _at_most_256},
}


def emit(**record):
    print(json.dumps(record), flush=True)


def start_build(name: str, edits, src_dir: Path):
    """Write the edited source to build/probe/k4_<name>/ and start nvcc."""
    out = ROOT / "build" / "probe" / f"k4_{name}"
    out.mkdir(parents=True, exist_ok=True)
    text = (src_dir / "layernorm.cu").read_text()
    for old, new in edits:
        if old is None:                     # the whole pass-2 kernel
            a, b = text.index(COLSUM_START), text.index(COLSUM_END)
            old = text[a:b + len(COLSUM_END)]
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: an edit of layernorm.cu does not "
                               f"apply")
        text = text.replace(old, new)
    for hdr in src_dir.glob("*.cuh"):
        (out / hdr.name).write_text(hdr.read_text())
    (out / "layernorm.cu").write_text(text + PROBE)
    lib = out / "liblayernorm.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                             str(out / "layernorm.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def finish_build(name: str, proc, lib: Path):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    regs = {}
    for entry, spill, used, smem in re.findall(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores"
            r".*?Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) "
            r"bytes smem)?", log, re.S):
        key = re.search(r"ln_bwd_\w+?(?:EE|E)", entry)
        if key and ("Li8E" in entry or "dx_kernel" not in entry):
            regs[key.group(0)] = dict(registers=int(used),
                                      spill_bytes=int(spill),
                                      smem_bytes=int(smem or 0))
    cdll = ctypes.CDLL(str(lib))
    cdll.mmfm_probe_blocks_per_sm.argtypes = [ctypes.c_int]
    cdll.mmfm_probe_blocks_per_sm.restype = ctypes.c_int
    occ = {cs.dtype_name(dt): cdll.mmfm_probe_blocks_per_sm(code)
           for dt, code in ((torch.float32, 0), (torch.bfloat16, 1))}
    emit(phase="k4_variant_build", variant=name, ptxas=regs,
         blocks_per_sm=occ,
         sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
    return cdll


def two_pass_call(cdll):
    """K4 through the first design's C interface (pass 1 with a fixed 128
    rows a block, then the column sum), outputs allocated as its wrapper
    did."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = cdll.mmfm_layernorm_bwd
    fn.argtypes = [p] * 8 + [i, i, f, i, p]
    fn.restype = i
    cdll.mmfm_layernorm_bwd_rows_per_block.restype = i
    per_block = cdll.mmfm_layernorm_bwd_rows_per_block()
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def call(x, w, g, eps=EPS):
        rows, width = x.shape
        dev = x.device
        dx = torch.empty_like(x)
        dw = torch.empty(width, dtype=torch.float32, device=dev)
        db = torch.empty(width, dtype=torch.float32, device=dev)
        parts = torch.empty((2, -(-rows // per_block), width),
                            dtype=torch.float32, device=dev)
        rc = fn(x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr(), dw.data_ptr(),
                db.data_ptr(), rows, width, float(eps), codes[x.dtype],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K4 launch failed (cudaError {rc})")
        return dx, dw, db

    return call


def wrapper_call(cdll, attrs: dict):
    """K4 through ``ops.layernorm.layernorm_bwd`` with ``cdll`` as its
    library and ``attrs`` set on ``ops.layernorm``."""
    base = ln._lib()
    for sym in ("mmfm_layernorm_fwd", "mmfm_layernorm_bwd",
                "mmfm_layernorm_bwd_blocks_per_sm"):
        getattr(cdll, sym).argtypes = getattr(base, sym).argtypes
        getattr(cdll, sym).restype = getattr(base, sym).restype

    card: dict = {}                  # this build's own blocks an SM

    def call(x, w, g, eps=EPS):
        original = {k: getattr(ln, k) for k in ("_lib", "_K4_CARD", *attrs)}
        for k, v in dict(attrs, _lib=lambda variant="warp": cdll,
                         _K4_CARD=card).items():
            setattr(ln, k, v)
        try:
            return ln.layernorm_bwd(x, w, g, eps)
        finally:
            for k, v in original.items():
                setattr(ln, k, v)

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k4_variants: CUDA is not available", file=sys.stderr)
        return 2
    emit(phase="device", nvidia_smi=cs.nvidia_smi(),
         device=torch.cuda.get_device_name(0))
    args = sys.argv[1:]
    sources = {name: (edits, build.CSRC) for name, edits in VARIANTS.items()}
    if "--parent" in args:
        parent = Path(args[args.index("--parent") + 1]).resolve()
        sources["parent"] = ([], parent / build.CSRC.relative_to(ROOT))
    if "--only" in args:
        keep = args[args.index("--only") + 1].split(",")
        sources = {k: v for k, v in sources.items() if k in keep}
    # a variant of the plan alone runs on the committed kernel's build
    started = {name: start_build(name, edits, src)
               for name, (edits, src) in sources.items()
               if name not in PLAN_ATTRS}
    built = {name: finish_build(name, proc, lib)
             for name, (proc, lib) in started.items()}
    if any(name in PLAN_ATTRS for name in sources):
        built.setdefault("base", finish_build(
            "base", *start_build("base", [], build.CSRC)))
    calls = {}
    for name in sources:
        cdll = built["base" if name in PLAN_ATTRS else name]
        calls[name] = (two_pass_call(cdll)
                       if hasattr(cdll, "mmfm_layernorm_bwd_rows_per_block")
                       else wrapper_call(cdll, PLAN_ATTRS.get(name, {})))

    operands = {(dt, rows): cs._ln_operands(rows, H, dt, seed=5)
                for dt in cs.DTYPES for rows in ROWS}
    for name, call in calls.items():
        for (dt, rows), (x, w, _, dy) in operands.items():
            got = call(x, w, dy)
            again = call(x, w, dy)
            torch.cuda.synchronize()
            gates = cs.k4_gates(x, w, dy, got, again, cs.TOL[dt])
            emit(phase="k4_variant_check", variant=name,
                 dtype=cs.dtype_name(dt), shape=[rows, H], **gates)
            if not gates["ok"] and not name.startswith("diag_"):
                raise AssertionError(f"{name}: K4 disagrees with its plain "
                                     f"version ({rows}, {dt})")
    times: dict = {}
    order = list(calls)
    for sweep in (order, order[::-1]):
        for name in sweep:
            for (dt, rows), (x, w, _, dy) in operands.items():
                times.setdefault((name, dt, rows), []).append(
                    cs.device_ms_by_kernel(
                        lambda c=calls[name]: c(x, w, dy)))
    for (name, dt, rows), runs in times.items():
        totals = [sum(r.values()) for r in runs]
        bound = cs.k4_bound(rows, H, dt)
        emit(phase="k4_variant_time", variant=name, dtype=cs.dtype_name(dt),
             shape=[rows, H], by_kernel_in_order_and_reversed=runs,
             ms_in_order_and_reversed=totals, bound_ms=bound["bound_ms"],
             share_of_bound=[bound["bound_ms"] / t for t in totals],
             gb_per_s=[bound["bytes"] / t / 1e6 for t in totals])
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
