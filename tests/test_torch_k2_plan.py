"""What the K2 wrapper decides on the host (``ops/attention.py``): which
kernel runs a dtype and head width (``k2_route``: at the compiled widths
16, 32 and 64 the wgmma K2, bf16 of ``csrc/attention_bwd_bf16.cuh`` and
f32 of ``csrc/attention_bwd_f32.cuh``; at 128 the mma.sync pair of
``csrc/attention_bwd.cu``), and the scratch each route needs
(``_k2_scratch_floats``: rowsum, then the keep bits the passes read). Held at head widths 8, 16, 24, 32, 64 and
128 (8 and 24 run their padded widths' kernels) and key lengths 1, 8, 200
(the model's), 256, 257 and 520 (past the 208 columns the wgmma kernel
takes at once, which the kernel splits into chunks itself). No card
needed: the kernels themselves are held on the card by
``tests/test_torch_kernels.py``."""

import pytest
import torch

from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

WIDTHS = [8, 16, 24, 32, 64, 128]
LENGTHS = [1, 8, 200, 256, 257, 520]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("width", WIDTHS)
def test_k2_route_by_dtype_and_width(width, dtype):
    """Both dtypes take the wgmma kernel up to head width 64 (bf16 since
    the bf16 K2's redesign, f32 since the f32 one's), the mma.sync pair at
    128; a padded width takes its compiled width's route."""
    want = "wgmma" if width <= 64 else "mma_sync"
    assert tatt.k2_route(dtype, width) == want
    assert tatt.k2_route(dtype, tatt.kernel_head_dim(width)) == want


def test_k2_route_refuses_widths_above_128():
    with pytest.raises(ValueError, match="up to 128"):
        tatt.k2_route(torch.bfloat16, 129)


@pytest.mark.parametrize("tk", LENGTHS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k2_scratch_by_route(width, tk):
    """Each dtype's route's scratch: rowsum (B, H, Tq) f32, up to 12 bytes
    of alignment, then the keep bytes (B, H, ceil(Tk / 8), Tq rounded up to
    16) of the wgmma kernels (bf16 and f32 alike: ``attn_bwd_keep_kernel``
    draws them for both), or (B, H, Tq, ceil(Tk / 64) * 16) of the
    mma.sync pair; at most 16 bytes more than that."""
    B, H, tq = 3, 4, 199                     # rows of 208 keep bytes
    for dtype in (torch.bfloat16, torch.float32):
        route = tatt.k2_route(dtype, width)
        n = tatt._k2_scratch_floats(B, H, tq, tk, route)
        rowsum = B * H * tq * 4
        if route == "wgmma":
            mask = B * H * (-(-tk // 8)) * 208
        else:
            mask = B * H * tq * (-(-tk // 64)) * 16
        assert rowsum + 12 + mask <= 4 * n <= rowsum + mask + 32, dtype


def test_k2_scratch_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="route"):
        tatt._k2_scratch_floats(1, 1, 8, 8, "mma")
