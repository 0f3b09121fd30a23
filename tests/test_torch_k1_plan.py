"""What the K1 wrapper decides on the host (``ops/attention.py``): which
kernel runs a dtype and head width (``k1_route``: the wgmma bf16 K1 of
``csrc/attention_fwd_bf16.cuh`` at the compiled widths 16, 32 and 64 and
of ``csrc/attention_fwd_bf16_d128.cuh`` at 128, the wgmma f32 K1 of
``csrc/attention_fwd_f32_d128.cuh`` at 128, ``attn_fwd_tc_kernel`` of
``csrc/attention_fwd.cu`` for f32 up to 64), and the scratch each route
needs with dropout (``_k1_scratch_bytes``: the keep bits the wgmma
kernels' stages read). Held at head widths 8, 16, 24, 32, 64 and 128 (8
and 24 run their padded widths' kernels) and key lengths 1, 8, 200 (the
model's), 208 (the columns the wgmma kernel takes at once), 209, 256 and
520 (two and three chunks, which the kernel walks itself). A mirror of the
bf16 D = 128 kernel's shared-memory layout holds it to the H100's 232,448
bytes a block. No card needed: the kernels themselves are held on the card
by ``tests/test_torch_kernels.py``."""

import pytest
import torch

from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

WIDTHS = [8, 16, 24, 32, 64, 128]
LENGTHS = [1, 8, 200, 208, 209, 256, 520]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("width", WIDTHS)
def test_k1_route_by_dtype_and_width(width, dtype):
    """bf16 takes the wgmma kernel at every head width (up to 64
    ``attention_fwd_bf16.cuh``'s, at 128 ``attention_fwd_bf16_d128.cuh``'s,
    which replaced the mma.sync kernel there); f32 the mma.sync kernel up
    to 64 and the wgmma kernel at 128; a padded width takes its compiled
    width's route. K2 runs on wgmma at every width and dtype, so K1's route
    is K2's where K1 is on wgmma (bf16 everywhere, f32 at 128) and differs
    where K1 stays on mma.sync (f32 up to 64, which draws its keep bits
    inside the kernel for the wgmma K2's keep kernel to replay)."""
    wide = tatt.kernel_head_dim(width) == 128
    want = ("wgmma" if dtype == torch.bfloat16 or wide else "mma_sync")
    assert tatt.k1_route(dtype, width) == want
    assert tatt.k1_route(dtype, tatt.kernel_head_dim(width)) == want
    assert tatt.k2_route(dtype, width) == "wgmma"
    assert (tatt.k1_route(dtype, width)
            == tatt.k2_route(dtype, width)) == (want == "wgmma")


@pytest.mark.parametrize("width", WIDTHS)
def test_k1_f32_stays_on_mma_sync(width):
    """The f32 K1 stays ``attn_fwd_tc_kernel`` (3xTF32 on mma.sync, its
    keep bits drawn inside the kernel: no scratch) up to head width 64,
    and at 128 runs ``attn_fwd_tf128_kernel`` on wgmma, whose keep bits
    ``attn_fwd_keep_kernel`` draws first into the scratch: (B, H, ceil(Tk /
    8), Tq rounded up to 16) bytes, the f32 K2 at 128's layout."""
    route = tatt.k1_route(torch.float32, width)
    n = tatt._k1_scratch_bytes(3, 4, 200, 200, route)
    if width <= 64:
        assert route == "mma_sync" and n == 0
    else:
        assert route == "wgmma" == tatt.k2_route(torch.float32, width)
        assert n == 3 * 4 * 25 * 208


def test_k1_route_refuses_widths_above_128():
    with pytest.raises(ValueError, match="up to 128"):
        tatt.k1_route(torch.bfloat16, 129)


@pytest.mark.parametrize("tk", LENGTHS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k1_scratch_by_route(width, tk):
    """Each dtype's route's scratch: the keep bytes (B, H, ceil(Tk / 8), Tq
    rounded up to 16) of the wgmma kernels (bf16 at every width, the bf16
    kernel at 128 included; f32 at 128), a whole number of 16-byte rows;
    none for the mma.sync kernel (f32 up to 64), which draws inside."""
    B, H, tq = 3, 4, 199                     # rows of 208 keep bytes
    for dtype in (torch.bfloat16, torch.float32):
        route = tatt.k1_route(dtype, width)
        n = tatt._k1_scratch_bytes(B, H, tq, tk, route)
        wide = tatt.kernel_head_dim(width) == 128
        assert (route == "wgmma") == (dtype == torch.bfloat16 or wide)
        if route == "wgmma":
            assert n == B * H * (-(-tk // 8)) * 208
            assert n % 16 == 0
        else:
            assert n == 0


@pytest.mark.parametrize("tq", [1, 16, 17, 200])
def test_k1_scratch_rows_are_tq_rounded_to_16(tq):
    """A keep row holds Tq rounded up to 16 queries (the TMA copies' row
    stride), one row per (b, h, 8 keys)."""
    n = tatt._k1_scratch_bytes(2, 3, tq, 9, "wgmma")
    assert n == 2 * 3 * 2 * (-(-tq // 16) * 16)


def test_k1_scratch_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="route"):
        tatt._k1_scratch_bytes(1, 1, 8, 8, "mma")


SMEM_PER_BLOCK = 232448                  # the H100's shared memory a block
BF16_CHUNK = 208                         # keys a block takes at once


def _align1k(x: int) -> int:
    return -(-x // 1024) * 1024


def bf16_d128_layout_bytes() -> dict:
    """The offsets and total of ``k1b128::Layout``
    (``csrc/attention_fwd_bf16_d128.cuh``), byte for byte: q (two boxes of
    64 rows x 128 bytes), the k chunk (two boxes of 208 rows), the v chunk
    (two boxes of 216 rows: 8 zero rows each, read times zero pd by the
    last k-step of the second warpgroup's output product), the keep bytes
    (64 queries x 26 key bytes, a 128-byte multiple), the exchange of the
    output halves (64 f32 of 128 threads), the row maxima and sums (f32
    [2][64] each), the mbarrier and the 1024 bytes of alignment."""
    q_box = _align1k(64 * 128)
    k_box = _align1k(BF16_CHUNK * 128)
    v_box = _align1k((BF16_CHUNK + 8) * 128)
    k_at = 2 * q_box
    v_at = k_at + 2 * k_box
    stage = v_at + 2 * v_box
    keep = stage
    xchg = keep + -(-64 * (BF16_CHUNK // 8) // 128) * 128
    rmax = xchg + 64 * 128 * 4
    rsum = rmax + 2 * 64 * 4
    bar = rsum + 2 * 64 * 4
    return dict(k=k_at, v=v_at, stage=stage, keep=keep, xchg=xchg,
                rmax=rmax, rsum=rsum, bar=bar, bytes=bar + 8 + 1024)


def test_k1_bf16_d128_layout_fits_a_block():
    """The bf16 K1 at head width 128 fits the H100's 232,448 bytes of
    shared memory a block with one stage of operands (161,416 bytes) and
    would not with a second (q, k and v again: 124,928 bytes); every box
    starts on a 1024-byte boundary (where TMA's and wgmma's 128-byte
    swizzles agree), the f32 exchange and row statistics on 16 bytes and
    the mbarrier on 8."""
    got = bf16_d128_layout_bytes()
    assert got == dict(k=16384, v=69632, stage=124928, keep=124928,
                       xchg=126592, rmax=159360, rsum=159872, bar=160384,
                       bytes=161416)
    assert got["bytes"] <= SMEM_PER_BLOCK
    assert got["bytes"] + got["stage"] > SMEM_PER_BLOCK
    assert got["k"] % 1024 == 0 and got["v"] % 1024 == 0
    assert got["stage"] % 1024 == 0
    assert all(got[k] % 16 == 0 for k in ("xchg", "rmax", "rsum"))
    assert got["bar"] % 8 == 0
