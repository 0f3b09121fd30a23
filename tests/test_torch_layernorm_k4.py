"""K4's grid and its fixed summation order, on the CPU.

K4 (``csrc/layernorm.cu``) runs on the card only. Two things around it are
held here:

- ``ops.layernorm._k4_plan``, the grid the wrapper gives the kernel: its
  tiles of contiguous rows cover every row exactly once, each tile holds a
  row, the grid is at least the SM count wherever there are that many
  rows and at most one wave of blocks, and there is a partial row of
  scratch for every block.
- The order in which the kernel sums dscale = sum g * xhat and dbias =
  sum g in f32, modelled in torch (``k4_column_sums``): within a lane,
  its warp's rows of a tile in order (an fma for g * xhat); the 8 warps'
  sums in warp order; then, in pass 2, split s of 32 adds the partial rows
  of blocks s, s + 32, ... in order and the splits are added in order. At the training
  step's 3,200 and 51,200 x 256 rows, with ``chip_smoke.py``'s operands
  (x ~ 2 N(0, 1) + 0.3, scale ~ 0.2 N(0, 1) + 1, g ~ N(0, 1), from a numpy
  seed), the model sits within 1e-5 normwise (max |a - b| <= 1e-5 max |b|)
  of an f64 sum and of ``layer_norm_bwd_reference``: the gate the card
  holds the kernel to. This is the summation-order counterpart of
  ``tests/tf32_emulation.py``.
"""

import numpy as np
import pytest
import torch

from multi_modal_foundation_model_tpu_torch.ops import layernorm as tln

EPS = 1e-5
WARPS = tln._K4_WARPS      # kWarps in csrc/layernorm.cu
SPLITS = 32                # kSplits in csrc/layernorm.cu (pass 2)


def _tiles(plan, rows):
    """The (begin, end) rows of each block's tile, as the kernel cuts them:
    rows_per_tile rows, one more for the first rows % grid tiles."""
    longer = rows - plan.rows_per_tile * plan.grid
    out = []
    for t in range(plan.grid):
        begin = t * plan.rows_per_tile + min(t, longer)
        out.append((begin, begin + plan.rows_per_tile + (t < longer)))
    return out


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("n_sm", [132, 114, 1])
@pytest.mark.parametrize("rows", [1, 31, 128, 3199, 3200, 51199, 51200])
def test_plan_covers_every_row_once_in_one_wave(rows, n_sm, blocks_per_sm):
    plan = tln._k4_plan(rows, n_sm, blocks_per_sm)
    tiles = _tiles(plan, rows)
    covered = np.zeros(rows, np.int64)
    for begin, end in tiles:
        assert begin < end                       # every tile holds a row
        covered[begin:end] += 1
    assert (covered == 1).all()
    assert plan.grid <= n_sm * blocks_per_sm     # no partial second wave
    if rows >= n_sm:
        assert plan.grid >= n_sm                 # every SM gets a block
    assert plan.parts >= plan.grid               # a partial row a block
    assert plan.rows_per_tile == rows // plan.grid
    # no warp gets more rows than one wave of blocks must give some warp
    most = -(-(-(-rows // plan.grid)) // WARPS)
    assert most == max(1, -(-rows // (WARPS * n_sm * blocks_per_sm)))


def test_plan_at_the_training_shapes_on_an_h100():
    """132 SMs: B=16's 3,200 rows in 200 tiles of 16 (2 rows a warp) with
    2 or 3 blocks an SM, in 132 of 24 or 25 (4 a warp at most) with one;
    B=256's 51,200 with 3 blocks an SM (bf16) in 377 tiles (17 rows a
    warp, as a full wave of 396 would give), with 2 (f32) in 256 of 200."""
    assert tln._k4_plan(3200, 132, 3) == tln.K4Plan(200, 16, 200)
    assert tln._k4_plan(3200, 132, 2) == tln.K4Plan(200, 16, 200)
    assert tln._k4_plan(3200, 132, 1) == tln.K4Plan(132, 24, 132)
    assert tln._k4_plan(51200, 132, 3) == tln.K4Plan(377, 135, 377)
    assert tln._k4_plan(51200, 132, 2) == tln.K4Plan(256, 200, 256)


def _fma(a, b, c):
    """f32 a * b + c with one rounding (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def k4_column_sums(x, w, g, plan, eps=EPS):
    """dscale and dbias (f32) summed in K4's order for the tiles of
    ``plan``: xhat in f32 from x (as the plain version computes it); per
    lane column, the rows w, w + 8, ... of a tile in order; the 8 warps'
    sums in warp order; pass 2's 32 splits, each over every 32nd block in
    order, added in order."""
    rows, H = x.shape
    x32, g32 = x.float(), g.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.relu((x32 * x32).mean(-1, keepdim=True) - mu * mu)
    xhat = (x32 - mu) * torch.rsqrt(var + eps)
    tiles = _tiles(plan, rows)
    per_warp = -(-max(e - b for b, e in tiles) // WARPS)
    # (grid, rows a warp, warp, H); padding rows have g = xhat = 0, which
    # add exact zeros
    shape = (plan.grid * per_warp * WARPS, H)
    gp = torch.zeros(shape)
    xp = torch.zeros(shape)
    idx = torch.cat([torch.arange(b, e) - b + t * per_warp * WARPS
                     for t, (b, e) in enumerate(tiles)])
    gp[idx], xp[idx] = g32, xhat
    gp = gp.view(plan.grid, per_warp, WARPS, H)
    xp = xp.view(plan.grid, per_warp, WARPS, H)
    acc_ds = torch.zeros(plan.grid, WARPS, H)
    acc_db = torch.zeros(plan.grid, WARPS, H)
    for j in range(per_warp):
        acc_ds = _fma(gp[:, j], xp[:, j], acc_ds)
        acc_db = acc_db + gp[:, j]
    sums = []
    for acc in (acc_ds, acc_db):
        part = acc[:, 0]
        for wi in range(1, WARPS):
            part = part + acc[:, wi]
        split = torch.zeros(SPLITS, H)
        for i in range(plan.grid):
            split[i % SPLITS] = split[i % SPLITS] + part[i]
        total = split[0]
        for k in range(1, SPLITS):
            total = total + split[k]
        sums.append(total)
    return sums[0], sums[1], xhat


def _normwise(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def _operands(rows, H, dtype, seed):
    """``chip_smoke._ln_operands``'s distributions, drawn with numpy; x
    and g rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(rows, H)) * 2.0 + 0.3).float()
    w = torch.from_numpy(rng.normal(size=H) * 0.2 + 1.0).float()
    g = torch.from_numpy(rng.normal(size=(rows, H))).float()
    return x.to(dtype), w, g.to(dtype)


@pytest.mark.parametrize("dtype,blocks_per_sm", [(torch.float32, 2),
                                                 (torch.bfloat16, 3)])
@pytest.mark.parametrize("rows", [3200, 51200])
def test_k4_summation_order_within_gate(rows, dtype, blocks_per_sm):
    torch.set_num_threads(1)
    H = 256
    x, w, g = _operands(rows, H, dtype, seed=rows)
    plan = tln._k4_plan(rows, 132, blocks_per_sm)
    ds, db, xhat = k4_column_sums(x, w, g, plan)
    exact_ds = (g.double() * xhat.double()).sum(0)
    exact_db = g.double().sum(0)
    assert _normwise(ds, exact_ds) <= 1e-5
    assert _normwise(db, exact_db) <= 1e-5
    _, ref_ds, ref_db = tln.layer_norm_bwd_reference(x, w, g, EPS)
    assert _normwise(ds, ref_ds) <= 1e-5
    assert _normwise(db, ref_db) <= 1e-5
