"""What the K1 wrapper decides on the host (``ops/attention.py``): which
kernel runs a dtype and head width (``k1_route``: the wgmma bf16 K1 of
``csrc/attention_fwd_bf16.cuh`` at the compiled widths 16, 32 and 64 and
the wgmma f32 K1 of ``csrc/attention_fwd_f32_d128.cuh`` at 128,
``attn_fwd_tc_kernel`` of ``csrc/attention_fwd.cu`` for f32 up to 64 and
for bf16 at 128), and the scratch each route needs with dropout
(``_k1_scratch_bytes``: the keep bits the wgmma kernels' stages read).
Held at head widths 8, 16, 24, 32, 64 and 128 (8 and 24 run their padded
widths' kernels) and key lengths 1, 8, 200 (the model's), 208 (the
columns the wgmma kernel takes at once), 209, 256 and 520 (two and three
chunks, which the kernel walks itself). No card needed: the kernels
themselves are held on the card by ``tests/test_torch_kernels.py``."""

import pytest
import torch

from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

WIDTHS = [8, 16, 24, 32, 64, 128]
LENGTHS = [1, 8, 200, 208, 209, 256, 520]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("width", WIDTHS)
def test_k1_route_by_dtype_and_width(width, dtype):
    """bf16 takes the wgmma kernel up to head width 64 and the mma.sync
    kernel at 128; f32 the mma.sync kernel up to 64 and the wgmma kernel at
    128; a padded width takes its compiled width's route. K1's route is
    K2's in bf16 at every width and in f32 at 128; in f32 up to 64 K2 runs
    on wgmma while K1 stays on mma.sync."""
    wide = tatt.kernel_head_dim(width) == 128
    want = ("wgmma" if (dtype == torch.bfloat16) != wide else "mma_sync")
    assert tatt.k1_route(dtype, width) == want
    assert tatt.k1_route(dtype, tatt.kernel_head_dim(width)) == want
    if dtype == torch.bfloat16 or wide:
        assert tatt.k1_route(dtype, width) == tatt.k2_route(dtype, width)


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
    rounded up to 16) of the wgmma kernels (bf16 up to 64, f32 at 128), a
    whole number of 16-byte rows; none for the mma.sync kernel, which draws
    inside."""
    B, H, tq = 3, 4, 199                     # rows of 208 keep bytes
    for dtype in (torch.bfloat16, torch.float32):
        route = tatt.k1_route(dtype, width)
        n = tatt._k1_scratch_bytes(B, H, tq, tk, route)
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
