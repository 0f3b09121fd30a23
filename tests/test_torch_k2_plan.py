"""What the K2 wrapper decides on the host (``ops/attention.py``): which
kernel runs a dtype and head width (``k2_route``: the wgmma K2 for both
dtypes at every compiled width, bf16 of ``csrc/attention_bwd_bf16.cuh`` at
16, 32 and 64 and of ``csrc/attention_bwd_bf16_d128.cuh`` at 128, f32 of
``csrc/attention_bwd_f32.cuh`` and ``csrc/attention_bwd_f32_d128.cuh``),
and the scratch it needs (``_k2_scratch_floats``: rowsum, then the keep
bits the passes read). Held at head widths 8, 16, 24, 32, 64, 100 and 128
(8, 24 and 100 run their padded widths' kernels) and key lengths 1, 8, 200
(the model's), 256, 257 and 520 (past the 208 columns the wgmma kernel
takes at once, which the kernel splits into chunks itself). Mirrors of the
D = 128 kernels' shared-memory layouts hold them to the H100's 232,448
bytes a block. No card needed: the kernels themselves are held on the card
by ``tests/test_torch_kernels.py``."""

import pytest
import torch

from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

WIDTHS = [8, 16, 24, 32, 64, 100, 128]
LENGTHS = [1, 8, 200, 256, 257, 520]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("width", WIDTHS)
def test_k2_route_by_dtype_and_width(width, dtype):
    """Both dtypes take the wgmma kernel at every width: up to 64 since the
    bf16 and f32 K2's redesigns, at 128 (and the widths 65-127 padded to
    it) f32's of ``attention_bwd_f32_d128.cuh`` and bf16's of
    ``attention_bwd_bf16_d128.cuh``, which replaced the mma.sync pair; a
    padded width takes its compiled width's route."""
    assert tatt.k2_route(dtype, width) == "wgmma"
    assert tatt.k2_route(dtype, tatt.kernel_head_dim(width)) == "wgmma"


def test_k2_route_refuses_widths_above_128():
    with pytest.raises(ValueError, match="up to 128"):
        tatt.k2_route(torch.bfloat16, 129)


@pytest.mark.parametrize("tk", LENGTHS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k2_scratch_by_route(width, tk):
    """Each dtype's route's scratch: rowsum (B, H, Tq) f32, up to 12 bytes
    of alignment, then the keep bytes (B, H, ceil(Tk / 8), Tq rounded up to
    16) of the wgmma kernels (bf16 and f32 alike, at 128 as below it:
    ``attn_bwd_keep_kernel`` draws them for every one); at most 16 bytes
    more than that."""
    B, H, tq = 3, 4, 199                     # rows of 208 keep bytes
    for dtype in (torch.bfloat16, torch.float32):
        route = tatt.k2_route(dtype, width)
        assert route == "wgmma"
        n = tatt._k2_scratch_floats(B, H, tq, tk, route)
        rowsum = B * H * tq * 4
        mask = B * H * (-(-tk // 8)) * 208
        assert rowsum + 12 + mask <= 4 * n <= rowsum + mask + 32, dtype


def test_k2_scratch_refuses_an_unknown_route():
    """Only the wgmma kernels' scratch exists: the mma.sync pair's layout
    went with the pair."""
    for route in ("mma", "mma_sync"):
        with pytest.raises(ValueError, match="route"):
            tatt._k2_scratch_floats(1, 1, 8, 8, route)


# The D = 128 f32 kernel's layout (csrc/attention_bwd_f32_d128.cuh,
# k2t128::Layout<kPassB>): columns a warpgroup takes of s and dP in pass A
# (keys) and pass B (queries)
D128_COLS = {False: 32, True: 24}
SMEM_PER_BLOCK = 232448                  # the H100's, opted in


def _align1k(x: int) -> int:
    return (x + 1023) // 1024 * 1024


def d128_layout_bytes(pass_b: bool, cols: int = None) -> dict:
    """The offsets and total of ``k2t128::Layout<pass_b>``, byte for byte:
    the row tiles (q and g, or k and v: 64 rows of 128 f32, raw), the
    column planes (hi and lo of the chunk's two operands), the product
    planes (hi and lo of ds, and of pd in pass B: 64 rows of the chunk's
    columns in blocks of 32), the keep bytes, the row sums' exchange, pass
    B's column statistics, the mbarrier and the 1024 bytes of alignment."""
    cols = cols or D128_COLS[pass_b]
    chunk = 2 * cols
    row_tile = 4 * _align1k(64 * 128)
    col_plane = 4 * _align1k(chunk * 128)
    prod_plane = -(-chunk // 32) * _align1k(64 * 128)
    n_prod = 2 if pass_b else 1
    keep = 2 * row_tile + 4 * col_plane + 2 * n_prod * prod_plane
    keep_bytes = 64 * (chunk // 8)
    red = keep + -(-keep_bytes // 128) * 128
    stat = red + 2 * 64 * 4
    bar = stat + 2 * chunk * 4
    return dict(cols=cols, chunk=chunk, keep=keep, keep_bytes=keep_bytes,
                bytes=bar + 8 + 1024)


@pytest.mark.parametrize("pass_b", [False, True], ids=["pass_a", "pass_b"])
def test_k2_d128_layout_fits_a_block(pass_b):
    """Both passes of the D = 128 f32 kernel fit the H100's 232,448 bytes
    of shared memory a block: pass A with chunks of 64 keys (231,944
    bytes), pass B with chunks of 48 queries (231,688). A chunk of 8 more
    columns a warpgroup would not fit, and the keep bytes' box rows are a
    whole number of 16 bytes (a TMA box's inner size)."""
    got = d128_layout_bytes(pass_b)
    assert got["bytes"] == (231688 if pass_b else 231944)
    assert got["bytes"] <= SMEM_PER_BLOCK
    wider = d128_layout_bytes(pass_b, D128_COLS[pass_b] + 8)
    assert wider["bytes"] > SMEM_PER_BLOCK
    box_cols = got["chunk"] if pass_b else 64
    assert box_cols % 16 == 0 and got["keep"] % 1024 == 0



# The D = 128 bf16 kernel's layout (csrc/attention_bwd_bf16_d128.cuh,
# k2b128::Layout<kPassB>): every operand lands as two TMA boxes of 64
# columns (a 128-byte swizzle atom); a chunk is 208 columns
BF16_CHUNK = 208


def bf16_d128_layout_bytes(pass_b: bool) -> dict:
    """The offsets and total of ``k2b128::Layout<pass_b>``, byte for byte:
    the row tiles (q and g, or k and v: two boxes of 64 rows x 128 bytes),
    the column chunks (two boxes of the chunk's rows each: pass A's k and v
    with 8 zero rows, 216; pass B's qs and g, 208), pass B's product planes
    (ds and pd: 4 blocks of 64 rows x 64 columns), the keep bytes (a 128-byte
    multiple), pass A's dq exchange (64 f32 of 128 threads) and row sums,
    pass B's column statistics, the mbarrier and the 1024 bytes of
    alignment."""
    row_box = _align1k(64 * 128)
    col_box = _align1k((BF16_CHUNK if pass_b else BF16_CHUNK + 8) * 128)
    row_tile, col_chunk = 2 * row_box, 2 * col_box
    plane = 4 * row_box
    prod = 2 * row_tile + 2 * col_chunk
    keep = prod + (2 * plane if pass_b else 0)
    keep_bytes = 64 * (BF16_CHUNK // 8)
    xchg = keep + -(-keep_bytes // 128) * 128
    red = xchg + (0 if pass_b else 64 * 128 * 4)
    stat = red + (0 if pass_b else 2 * 64 * 4)
    bar = stat + (2 * BF16_CHUNK * 4 if pass_b else 0)
    return dict(stage=prod, keep=keep, xchg=xchg, bar=bar,
                bytes=bar + 8 + 1024)


@pytest.mark.parametrize("pass_b", [False, True], ids=["pass_a", "pass_b"])
def test_k2_bf16_d128_layout_fits_a_block(pass_b):
    """Both passes of the D = 128 bf16 kernel fit the H100's 232,448 bytes
    of shared memory a block with one stage (pass A 179,336 bytes, pass B
    209,160) and would not with a second stage of operands; every box and
    plane starts on a 1024-byte boundary (where TMA's and wgmma's 128-byte
    swizzles agree), the f32 exchange on 16 bytes and the mbarrier on 8."""
    got = bf16_d128_layout_bytes(pass_b)
    assert got["bytes"] == (209160 if pass_b else 179336)
    assert got["bytes"] <= SMEM_PER_BLOCK
    assert got["bytes"] + got["stage"] > SMEM_PER_BLOCK
    assert got["stage"] % 1024 == 0 and got["keep"] % 1024 == 0
    assert got["xchg"] % 16 == 0 and got["bar"] % 8 == 0
