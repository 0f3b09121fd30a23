"""What the K1 wrapper decides on the host (``ops/attention.py``): which
kernel runs a dtype and head width (``k1_route``: ``"wgmma"`` at every
width and dtype: the bf16 K1 of ``csrc/attention_fwd_bf16.cuh`` at the
compiled widths 16, 32 and 64 and of ``csrc/attention_fwd_bf16_d128.cuh``
at 128, the f32 K1 of ``csrc/attention_fwd_f32.cuh`` at 16-64 and of
``csrc/attention_fwd_f32_d128.cuh`` at 128), and the scratch it needs with
dropout (``_k1_scratch_bytes``: the keep bits the kernels' stages read).
Held at head widths 8, 16, 24, 32, 64 and 128 (8 and 24 run their padded
widths' kernels) and key lengths 1, 8, 200 (the model's), 208 (the
columns the wgmma kernels take at once), 209, 256 and 520 (two and three
chunks, which the kernels walk themselves). Mirrors of the bf16 D = 128
kernel's and the f32 16-64 kernel's shared-memory layouts hold them to
the H100's 232,448 bytes a block (the f32 one, two blocks to an SM's
233,472). No card needed: the kernels themselves
are held on the card by ``tests/test_torch_kernels.py``."""

import pytest
import torch

from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

WIDTHS = [8, 16, 24, 32, 64, 128]
LENGTHS = [1, 8, 200, 208, 209, 256, 520]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("width", WIDTHS)
def test_k1_route_by_dtype_and_width(width, dtype):
    """Both dtypes take the wgmma kernels at every head width (bf16 up to
    64 ``attention_fwd_bf16.cuh``'s, at 128 ``attention_fwd_bf16_d128.cuh``'s;
    f32 up to 64 ``attention_fwd_f32.cuh``'s, at 128
    ``attention_fwd_f32_d128.cuh``'s); a padded width takes its compiled
    width's route. K2 runs on wgmma at every width and dtype, so K1's route
    is K2's everywhere: both read the keep bits a kernel of their own drew."""
    assert tatt.k1_route(dtype, width) == "wgmma"
    assert tatt.k1_route(dtype, tatt.kernel_head_dim(width)) == "wgmma"
    assert tatt.k2_route(dtype, width) == "wgmma"
    assert tatt.k1_route(dtype, width) == tatt.k2_route(dtype, width)


@pytest.mark.parametrize("width", WIDTHS)
def test_k1_f32_runs_wgmma_at_every_width(width):
    """The f32 K1 runs on wgmma at every head width: ``attn_fwd_tf_kernel``
    up to 64 and ``attn_fwd_tf128_kernel`` at 128, whose keep bits
    ``attn_fwd_keep_kernel`` draws first into the scratch: (B, H, ceil(Tk /
    8), Tq rounded up to 16) bytes, the f32 K2's layout."""
    route = tatt.k1_route(torch.float32, width)
    n = tatt._k1_scratch_bytes(3, 4, 200, 200, route)
    assert route == "wgmma" == tatt.k2_route(torch.float32, width)
    assert n == 3 * 4 * 25 * 208


def test_k1_route_refuses_widths_above_128():
    with pytest.raises(ValueError, match="up to 128"):
        tatt.k1_route(torch.bfloat16, 129)


@pytest.mark.parametrize("tk", LENGTHS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k1_scratch_by_route(width, tk):
    """Each dtype's route's scratch: the keep bytes (B, H, ceil(Tk / 8), Tq
    rounded up to 16) of the wgmma kernels (both dtypes at every width), a
    whole number of 16-byte rows."""
    B, H, tq = 3, 4, 199                     # rows of 208 keep bytes
    for dtype in (torch.bfloat16, torch.float32):
        route = tatt.k1_route(dtype, width)
        n = tatt._k1_scratch_bytes(B, H, tq, tk, route)
        assert route == "wgmma"
        assert n == B * H * (-(-tk // 8)) * 208
        assert n % 16 == 0


@pytest.mark.parametrize("tq", [1, 16, 17, 200])
def test_k1_scratch_rows_are_tq_rounded_to_16(tq):
    """A keep row holds Tq rounded up to 16 queries (the TMA copies' row
    stride), one row per (b, h, 8 keys)."""
    n = tatt._k1_scratch_bytes(2, 3, tq, 9, "wgmma")
    assert n == 2 * 3 * 2 * (-(-tq // 16) * 16)


@pytest.mark.parametrize("route", ["mma", "mma_sync"])
def test_k1_scratch_refuses_an_unknown_route(route):
    """Only ``"wgmma"`` has a scratch: the retired ``"mma_sync"`` route, as
    any other name, raises ``ValueError``."""
    with pytest.raises(ValueError, match="route"):
        tatt._k1_scratch_bytes(1, 1, 8, 8, route)


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


def f32_layout_bytes(width: int, chunk: int = None) -> dict:
    """The offsets and total of ``k1tf::Layout<D>``
    (``csrc/attention_fwd_f32.cuh``), byte for byte: q's hi and lo planes
    (64 rows in column blocks of min(D, 32) floats, each block a 1024-byte
    multiple), k's (a chunk's rows: 104 at 16 and 32, 56 at 64, unless
    ``chunk`` is given), the v chunk as it lands (a k plane's size), v's
    transposed hi and lo planes (ceil(chunk / 32) groups of D rows of 128
    bytes), the keep bytes (64 queries x chunk / 8, a 128-byte multiple),
    the mbarrier and the 1024 bytes of alignment."""
    chunk = chunk or (104 if width <= 32 else 56)
    w = min(width, 32)
    halves = width // w
    plane_a = halves * _align1k(64 * 4 * w)
    plane_b = halves * _align1k(chunk * 4 * w)
    plane_t = -(-chunk // 32) * width * 128
    k_at = 2 * plane_a
    v_at = k_at + 2 * plane_b
    vt = v_at + plane_b
    keep = vt + 2 * plane_t
    bar = keep + -(-64 * (chunk // 8) // 128) * 128
    return dict(chunk=chunk, k=k_at, v=v_at, vt=vt, keep=keep, bar=bar,
                bytes=bar + 8 + 1024)


SMEM_PER_SM = 233472                     # the H100's shared memory an SM
RESERVED = 1024                          # reserved a block


@pytest.mark.parametrize("width,want", [
    (16, dict(chunk=104, k=8192, v=22528, vt=29696, keep=46080, bar=46976,
              bytes=48008)),
    (32, dict(chunk=104, k=16384, v=43008, vt=56320, keep=89088, bar=89984,
              bytes=91016)),
    (64, dict(chunk=56, k=32768, v=61440, vt=75776, keep=108544,
              bar=109056, bytes=110088))])
def test_k1_f32_layout_fits_a_block(width, want):
    """The f32 K1 at head widths 16-64 fits two blocks an SM in the H100's
    233,472 bytes of shared memory (1 KB reserved a block), which the
    kernel asks for (``kBlocksPerSm``) so that one block's split, softmax
    and products run beside the other's; at 64 a chunk of 104 keys (the
    16-32 chunk) would leave room for one block only, so 64 takes 56; every
    plane starts on a 1024-byte boundary (where TMA's and wgmma's swizzles
    agree) and the mbarrier on 8 bytes."""
    got = f32_layout_bytes(width)
    assert got == want
    assert 2 * (got["bytes"] + RESERVED) <= SMEM_PER_SM
    assert got["bytes"] <= SMEM_PER_BLOCK
    for at in ("k", "v", "vt", "keep"):
        assert got[at] % 1024 == 0, at
    assert got["bar"] % 8 == 0
    if width == 64:
        wide = f32_layout_bytes(64, chunk=104)
        assert 2 * (wide["bytes"] + RESERVED) > SMEM_PER_SM
        assert wide["bytes"] <= SMEM_PER_BLOCK
