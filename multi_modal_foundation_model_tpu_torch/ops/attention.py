"""Fused multi-head attention: the K1/K2 kernels for Hopper + plain versions.

Port of ``multi_modal_foundation_model_tpu/ops/attention.py``. What stays:

- **Natural layout.** q/k/v arrive as ``(B, T, H*D)`` exactly as the
  projections produce them; the kernels split heads themselves, and take a
  row stride so the column views of a fused QKV product need no copy.
- **Masks as (key_pad, static) decompositions.** Every mask the model uses
  is ``attend(b, q, k) = static(q, k) OR key_pad(b, k)`` (``MaskSpec``);
  the kernels rebuild the additive bias from a ``(B, Tk)`` and a
  ``(Tq, Tk)`` int32 array and never see a ``(B, Tq, Tk)`` tensor.
- **Finite NEG_INF.** ``-1e30`` instead of ``-inf``, so fully-masked rows
  (padded trials) come out uniform (the mean of V) instead of NaN, and the
  clamped ``lse = max(m, -1e6) + log(l)`` gives them ZERO gradient in the
  backward (JAX ``_attn_fwd_kernel`` docstring, :154-172).
- **Probability dropout inside the kernel, replayed by the backward.** JAX
  draws the TPU's own bits per grid step; here the keep decision of score
  (b, h, q, k) is Philox4x32-10 keyed by the call's seed with counter
  (k // 4, q, h, b) (``csrc/philox.cuh``), so K2 replays K1's mask at any
  tiling and ``philox_keep`` draws the same bits on any device. The seed
  is an entry of the step's seed table (``utils/rng.py``), a one-element
  int64 tensor the kernels read on the device, so a CUDA graph of the step
  replays with each step's own key. A rank holding a slice of the batch
  and of the heads (``parallel/``) passes their offsets ``(b0, h0)``
  (``draw_offset``) and draws the bits of (b + b0, h + h0): its slice of
  the single-process draw, where JAX folds the shard's coordinates into
  the seed (``_fold_shard_seed``, :515-525). JAX's
  threshold (keep iff bits > uint32(rate * (2^32 - 1)), :129-133) and
  normalisation (``l`` sums the undropped probabilities, the numerator the
  dropped ones scaled by 1/(1 - rate), :196, :206-216) carry over.

Dispatch (``multi_head_attention``): with an input that requires grad,
``_FlashAttention`` (the port of ``_flash_mha``'s custom VJP) runs K1 with
``lse`` forward and K2 backward on CUDA tensors, and the plain versions
(``attention_reference`` / ``attention_bwd_reference``) on CPU tensors or
with ``impl="xla"``. Without grad, CUDA tensors launch K1 alone and CPU
tensors take the plain forward. A CUDA tensor launches the kernel or
raises: there is no fallback. A full ``mask``/``bias`` takes the plain path
on either device, as in JAX; no module on the model's path passes one.

Head widths: JAX's kernels take any ``d_head = hidden // n_heads`` (its
``multi_head_attention``, :605-606). K1 and K2 are compiled at
``HEAD_DIMS`` = 16, 32, 64 and 128 (one library a width); any other width
up to 128 runs the next one up on operands whose heads are padded with
zero columns (``padded_attention_fwd`` / ``padded_attention_bwd``): the
zero columns add nothing to a score and give zero output and gradient
columns, which are dropped, and the scale stays the true width's. A
width above 128 raises ``ValueError``. Every K1 and K2 runs on Hopper's
wgmma with TMA tiles and a keep-bit kernel of its own (``k1_route``,
``k2_route``).

FLOP count (``utils/profiling.py``). A ``FlopCounterMode`` sees neither
K1 nor K2 (``ctypes`` launches), and on the plain path it would count the
backward's recompute of the scores. So while a dispatch mode is active
(``torch.utils.flop_counter.FlopCounterMode`` is one), the forward and
backward, kernel or plain, run as one operator each (``mmfm_attention::
fwd`` / ``bwd``), which the mode sees whole and counts by its registered
formula: the model's products, 4 B Tq Tk (H D) forward and 8 B Tq Tk
(H D) backward, H D the model's width (not the zero-padded one), masked
keys included as in a dense product. The mode runs the operator's body
with itself popped, so the products inside are not counted again.
Without a dispatch mode the same functions run directly: no launch, bit
or CUDA-graph capture depends on the counting.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .random import SeedLike, philox4x32_10, seed_tensor

NEG_INF = -1e30
# floor of the row max in the lse statistic: max(m, _LSE_FLOOR) + log(l).
# A raw m + log(l) is absorbed to m = -1e30 on fully-masked rows.
_LSE_FLOOR = -1e6

# launches of the K1 / K2 kernels, counted by their wrappers where they
# launch; K1_LSE_LAUNCHES counts the K1 launches that write the lse (the
# training forward, whose lse K2 reads), of those in K1_LAUNCHES
K1_LAUNCHES = 0
K1_LSE_LAUNCHES = 0
K2_LAUNCHES = 0

# the head widths K1 and K2 are compiled at: csrc/attention_{fwd,bwd}.cu at
# 32, and attention_{fwd,bwd}_d{16,64,128}.cu (one library a width)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF


class MaskSpec(NamedTuple):
    """attend(b, q, k) = static(q, k) OR key_pad(b, k).

    ``key_pad``: (B, Tk) or (B, 1, Tk) int, 1 = key attendable (None = none
    attendable through this term). ``static``: (Tq, Tk) shared across the
    batch (None = all-False).
    """

    key_pad: Optional[torch.Tensor] = None
    static: Optional[torch.Tensor] = None


def create_context_mask(context_forward: int, context_backward: int,
                        max_F: int, device=None) -> torch.Tensor:
    """(max_F, max_F) int32 mask: 1 iff token i may attend token j within
    the [i - backward, i + forward] window; -1 means unbounded that side."""
    if context_forward == -1 and context_backward == -1:
        return torch.ones((max_F, max_F), dtype=torch.int32, device=device)
    fwd = context_forward if context_forward >= 0 else max_F
    back = context_backward if context_backward >= 0 else max_F
    i = torch.arange(max_F, device=device)[:, None]
    j = torch.arange(max_F, device=device)[None, :]
    mask = j <= i + fwd
    if back > 0:
        mask = mask & (j >= i - back)
    return mask.to(torch.int32)


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """0/1 (or bool) attention mask -> f32 additive bias (0 / NEG_INF)."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask.bool(), zero, zero + NEG_INF)


def spec_operands(spec: Optional[MaskSpec], B: int, Tq: int, Tk: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel operands of a ``MaskSpec``: contiguous int32
    ``key_pad (B, Tk)`` and ``static (Tq, Tk)``. With no pad term the pad is
    all 0 when a static term exists and all 1 otherwise; with no static
    term the static is all 0 (JAX ``multi_head_attention``, :629-639)."""
    spec = spec or MaskSpec()
    if spec.key_pad is not None:
        key_pad = spec.key_pad.reshape(B, Tk).to(torch.int32)
    else:
        fill = 0 if spec.static is not None else 1
        key_pad = torch.full((B, Tk), fill, dtype=torch.int32, device=device)
    if spec.static is not None:
        static = spec.static.reshape(Tq, Tk).to(torch.int32)
    else:
        static = torch.zeros((Tq, Tk), dtype=torch.int32, device=device)
    return key_pad.contiguous(), static.contiguous()


def spec_to_bias(spec: MaskSpec, B: int, Tq: int, Tk: int,
                 device=None) -> torch.Tensor:
    """(B, Tq, Tk) additive bias from a MaskSpec, a missing term adding
    nothing attendable (JAX ``spec_to_bias``; unlike the kernel operands,
    an empty spec masks everything)."""
    attend = torch.zeros((B, Tq, Tk), dtype=torch.bool, device=device)
    if spec.static is not None:
        attend = attend | spec.static.bool()[None]
    if spec.key_pad is not None:
        attend = attend | spec.key_pad.reshape(B, Tk).bool()[:, None, :]
    return mask_to_bias(attend)


# ---------------------------------------------------------------------------
# dropout bits: Philox4x32-10 in torch integer operations
# ---------------------------------------------------------------------------

def dropout_threshold(rate: float) -> int:
    """JAX's keep test is ``bits > uint32(rate * (2^32 - 1))``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate {rate} outside [0, 1)")
    return int(rate * float(2 ** 32 - 1))


def philox_bits(seed: SeedLike, B: int, H: int, Tq: int, Tk: int,
                device=None, b0: int = 0, h0: int = 0) -> torch.Tensor:
    """(B, H, Tq, Tk) int64 tensor of the uint32 Philox words the kernels
    draw for score (b, h, q, k): word k % 4 of philox(counter =
    (k // 4, q, h0 + h, b0 + b), key = (seed's low 32 bits, 0)). ``seed``: a
    host int or a seed-table entry (a one-element int64 tensor)."""
    nw = -(-Tk // 4)
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(()).to(device) & _MASK32
    else:
        seed = int(seed) & _MASK32

    def ar(n, dim, start=0):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(start, start + n, dtype=torch.int64,
                            device=device).view(shape)

    full = (B, H, Tq, nw)
    words = philox4x32_10(ar(nw, 3).expand(full), ar(Tq, 2).expand(full),
                          ar(H, 1, h0).expand(full), ar(B, 0, b0).expand(full),
                          seed, 0)
    return torch.stack(words, dim=-1).reshape(B, H, Tq, 4 * nw)[..., :Tk]


def philox_keep(seed: SeedLike, B: int, H: int, Tq: int, Tk: int, rate: float,
                device=None, b0: int = 0, h0: int = 0) -> torch.Tensor:
    """(B, H, Tq, Tk) bool keep mask of K1/K2's dropout: the same bits as
    the kernels' Philox (``csrc/philox.cuh``), offset by ``(b0, h0)``."""
    return philox_bits(seed, B, H, Tq, Tk, device, b0, h0) \
        > dropout_threshold(rate)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, hidden = x.shape
    return x.float().reshape(B, T, n_heads, hidden // n_heads).transpose(1, 2)


def _merge(o: torch.Tensor, dtype) -> torch.Tensor:
    B, H, T, D = o.shape
    return o.transpose(1, 2).reshape(B, T, H * D).to(dtype)


def _biased_attention(q, k, v, bias, n_heads: int, scale: float,
                      with_lse: bool, dropout_rate: float = 0.0,
                      seed: SeedLike = 0, dots_dtype=torch.float32,
                      draw_offset: Tuple[int, int] = (0, 0)):
    """Softmax attention of (B, T, H*D) operands under an additive
    ``bias`` broadcastable to (B, Tq, Tk); f32 math, q pre-scaled as K1
    does; probability dropout from ``philox_keep``. The operands of the two
    products are rounded to ``dots_dtype`` where JAX's K1 on its hardware
    rounds them (``q * scale``, k, v, and the dropped, rescaled p), both
    products accumulating in f32; ``draw_offset`` (b0, h0) offsets the
    dropout bits. Returns (out in q's dtype, lse (B, H, Tq) f32 or
    None)."""
    B, Tq, _ = q.shape
    Tk = k.shape[1]

    def rnd(x):
        return x.to(dots_dtype).float()

    qs = rnd(_heads(q, n_heads) * scale)
    s = qs @ rnd(_heads(k, n_heads)).transpose(-1, -2)
    s = s + bias.float()[:, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = philox_keep(seed, B, n_heads, Tq, Tk, dropout_rate, q.device,
                           *draw_offset)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    o = (rnd(p) @ rnd(_heads(v, n_heads))) / l
    lse = None
    if with_lse:
        lse = (m.clamp_min(_LSE_FLOOR) + torch.log(l))[..., 0]
    return _merge(o, q.dtype), lse


def _attend_bias(key_pad, static) -> torch.Tensor:
    return mask_to_bias(static.bool()[None] | key_pad.bool()[:, None, :])


def attention_reference(q, k, v, key_pad, static, n_heads: int,
                        scale: float, with_lse: bool = False,
                        dropout_rate: float = 0.0, seed: SeedLike = 0,
                        dots_dtype=torch.float32,
                        draw_offset: Tuple[int, int] = (0, 0)):
    """Plain PyTorch version of K1 on the kernel's operands: q (B, Tq, H*D),
    k/v (B, Tk, H*D), key_pad (B, Tk) int, static (Tq, Tk) int. Returns
    (out, lse or None); ``lse`` (B, H, Tq) = max(m, -1e6) + log(l).
    ``draw_offset`` (b0, h0): the dropout bits of (b0 + b, h0 + h).

    ``dots_dtype`` rounds the products' operands as JAX's K1 on its
    hardware does: there its DEFAULT-precision f32 dots feed the matrix
    unit bf16 operands (JAX ``ops/attention.py:189-191``, ``:213-216``), so
    ``s = bf16(f32(q) * scale) . bf16(k)`` and ``o = bf16(pd) . bf16(v) /
    l`` with ``pd`` the dropped p scaled by 1/(1 - rate) (JAX scales before
    the dot, :207-208) and ``l`` the sum of the unrounded, undropped f32 p.
    f32 (the default, JAX's interpret mode) is what the CPU path runs;
    bf16 is what the tensor-core bf16 K1 computes."""
    return _biased_attention(q, k, v, _attend_bias(key_pad, static),
                             n_heads, scale, with_lse, dropout_rate, seed,
                             dots_dtype, draw_offset)


def attention_bwd_reference(q, k, v, key_pad, static, g, lse, n_heads: int,
                            scale: float, dropout_rate: float = 0.0,
                            seed: SeedLike = 0, dots_dtype=torch.float32,
                            draw_offset: Tuple[int, int] = (0, 0)):
    """Plain PyTorch version of K2 (JAX ``_attn_bwd_kernel``, :221-307):
    probabilities recovered from the forward's ``lse``, dropout replayed
    from ``philox_keep`` (offset by ``draw_offset``, as K1's). Returns
    (dq, dk, dv) in q's dtype.

    ``dots_dtype`` is JAX's (:224): the operands of the five products are
    rounded to it where JAX's kernel rounds them (``q * scale``, k, v, g,
    and ``ds``, ``pd``), every product accumulating in f32. f32 (the
    default, JAX's interpret mode) is what the CPU path runs; bf16 is what
    JAX's K2 runs on its hardware (:431) and what the tensor-core bf16 K2
    computes.

    Written from the lse formula, not from autograd of
    ``attention_reference``: a fully-masked query row has scores of -1e30
    and lse = -1e6 + log(Tk), so ``pn = 0`` and the row gets ZERO
    gradient, the kernels' contract, where autograd would give it the
    uniform row's gradient."""
    B, Tq, _ = q.shape
    Tk = k.shape[1]

    def rnd(x):
        return x.to(dots_dtype).float()

    qs = rnd(_heads(q, n_heads) * scale)
    kh, vh, gh = (rnd(_heads(x, n_heads)) for x in (k, v, g))
    s = qs @ kh.transpose(-1, -2) + _attend_bias(key_pad, static)[:, None]
    pn = torch.exp(s - lse.float()[..., None])
    dpd = gh @ vh.transpose(-1, -2)
    if dropout_rate > 0.0:
        keep = philox_keep(seed, B, n_heads, Tq, Tk, dropout_rate, q.device,
                           *draw_offset)
        ms = torch.where(keep, 1.0 / (1.0 - dropout_rate), 0.0)
        pd, dpn = pn * ms, dpd * ms
    else:
        pd, dpn = pn, dpd
    ds = rnd(pn * (dpn - (dpn * pn).sum(dim=-1, keepdim=True)))
    pd = rnd(pd)
    dq = (ds @ kh) * scale
    dk = ds.transpose(-1, -2) @ qs
    dv = pd.transpose(-1, -2) @ gh
    return (_merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype))


# ---------------------------------------------------------------------------
# K1 / K2 wrappers
# ---------------------------------------------------------------------------

def kernel_head_dim(D: int) -> int:
    """The compiled head width that runs head width ``D``: the least of
    ``HEAD_DIMS`` at or above it (``D`` itself where it is one of them).
    Above 128, ``ValueError``."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    raise ValueError(f"head width {D}: the attention kernels take head "
                     f"widths up to {HEAD_DIMS[-1]}")


def _library(kernel: str, head_dim: int) -> str:
    return kernel if head_dim == 32 else f"{kernel}_d{head_dim}"


def pad_heads(x: torch.Tensor, n_heads: int, width: int) -> torch.Tensor:
    """(B, T, H*D) -> contiguous (B, T, H*width): each head's D columns,
    then ``width - D`` zero columns."""
    B, T, hidden = x.shape
    D = hidden // n_heads
    return F.pad(x.reshape(B, T, n_heads, D), (0, width - D)).reshape(
        B, T, n_heads * width)


def unpad_heads(x: torch.Tensor, n_heads: int, D: int) -> torch.Tensor:
    """(B, T, H*width) -> contiguous (B, T, H*D): each head's first D
    columns."""
    B, T, _ = x.shape
    # a reshape copies where heads > 1; at one head it keeps the strided
    # view, hence contiguous()
    return x.reshape(B, T, n_heads, -1)[..., :D].reshape(
        B, T, n_heads * D).contiguous()


def padded_attention_fwd(fwd, width: int, q, k, v, key_pad, static,
                         n_heads: int, scale: float, with_lse: bool = False,
                         dropout_rate: float = 0.0, seed: SeedLike = 0,
                         draw_offset: Tuple[int, int] = (0, 0)):
    """``fwd`` (K1's launch, or a plain version in its place) on q/k/v
    whose heads are padded with zero columns to ``width``; returns (out with
    the padding dropped, lse). ``scale`` is the caller's, the true head
    width's. Exact: a zero column adds 0 to every score and gives a zero
    output column, and the dropout bits do not depend on the width."""
    D = q.shape[-1] // n_heads
    qp, kp, vp = (pad_heads(x, n_heads, width) for x in (q, k, v))
    out, lse = fwd(qp, kp, vp, key_pad, static, n_heads, scale, with_lse,
                   dropout_rate, seed, draw_offset=draw_offset)
    return unpad_heads(out, n_heads, D), lse


def padded_attention_bwd(bwd, width: int, q, k, v, key_pad, static, g, lse,
                         n_heads: int, scale: float, dropout_rate: float = 0.0,
                         seed: SeedLike = 0,
                         draw_offset: Tuple[int, int] = (0, 0)):
    """``bwd`` (K2's launch, or a plain version in its place) on q/k/v/g
    padded as ``padded_attention_fwd`` pads them; returns (dq, dk, dv) with
    the padding dropped (its gradient columns are zero)."""
    D = q.shape[-1] // n_heads
    qp, kp, vp, gp = (pad_heads(x, n_heads, width) for x in (q, k, v, g))
    grads = bwd(qp, kp, vp, key_pad, static, gp, lse, n_heads, scale,
                dropout_rate, seed, draw_offset=draw_offset)
    return tuple(unpad_heads(x, n_heads, D) for x in grads)


def _k1_lib(head_dim: int = 32):
    from . import build

    fn = build.load(_library("attention_fwd", head_dim)).mmfm_attention_fwd
    if fn.argtypes is None:
        p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint)
        f = ctypes.c_float
        fn.argtypes = ([p] * 8 + [i] * 5 + [ll] * 6
                       + [f, p, u, f, i, i, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _k2_lib(head_dim: int = 32):
    from . import build

    fn = build.load(_library("attention_bwd", head_dim)).mmfm_attention_bwd
    if fn.argtypes is None:
        p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint)
        f = ctypes.c_float
        fn.argtypes = ([p] * 11 + [i] * 5 + [ll] * 8
                       + [f, p, u, f, i, i, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def k1_route(dtype, head_dim: int) -> str:
    """Which K1 runs ``dtype`` at head width ``head_dim``: ``"wgmma"`` (TMA
    tiles, the keep bits drawn by a kernel of their own) for both dtypes at
    every compiled width (and the widths padded to them): bf16 the kernel
    of ``csrc/attention_fwd_bf16.cuh`` at 16, 32 and 64 and of
    ``csrc/attention_fwd_bf16_d128.cuh`` at 128, f32 the 3xTF32 kernel of
    ``csrc/attention_fwd_f32.cuh`` at 16-64 and of
    ``csrc/attention_fwd_f32_d128.cuh`` at 128. Above 128,
    ``ValueError``."""
    kernel_head_dim(head_dim)
    return "wgmma"


def k2_route(dtype, head_dim: int) -> str:
    """Which K2 runs ``dtype`` at head width ``head_dim``: ``"wgmma"`` (TMA
    tiles, the keep bits drawn by a kernel of their own) for both dtypes at
    every compiled width (and the widths padded to them): bf16 the kernel
    of ``csrc/attention_bwd_bf16.cuh`` at 16, 32 and 64 and of
    ``csrc/attention_bwd_bf16_d128.cuh`` at 128, f32 the 3xTF32 kernel of
    ``csrc/attention_bwd_f32.cuh`` at 16-64 and of
    ``csrc/attention_bwd_f32_d128.cuh`` at 128. Above 128,
    ``ValueError``."""
    kernel_head_dim(head_dim)
    return "wgmma"


def _k1_scratch_bytes(B: int, H: int, Tq: int, Tk: int,
                      route: str = "wgmma") -> int:
    """Bytes of K1's scratch with dropout: the keep bytes that
    ``attn_fwd_keep_kernel`` draws and the kernel's stages read by TMA
    (``csrc/attention_fwd_bf16.cuh``), one bit per (b, h, query, key):
    (B, H, ceil(Tk / 8), Tq rounded up to 16), a byte holding 8 keys of one
    query (a row of 16-byte multiples: the stride of the TMA copies), as
    the wgmma K2's. ``route`` is ``k1_route``'s, ``"wgmma"`` for every
    dtype and width; any other raises ``ValueError``."""
    if route != "wgmma":
        raise ValueError(f"K1 route {route!r}")
    return B * H * (-(-Tk // 8)) * (-(-Tq // 16) * 16)


def _k2_scratch_floats(B: int, H: int, Tq: int, Tk: int,
                       route: str = "wgmma") -> int:
    """f32 words of K2's scratch: rowsum (B, H, Tq), then, 16-byte aligned,
    the keep bytes that ``attn_bwd_keep_kernel`` draws and both passes read
    (``csrc/attention_bwd.cu``, ``mmfm_attention_bwd``), one bit per (b, h,
    query, key): bytes (B, H, ceil(Tk / 8), Tq rounded up to 16), a byte
    holding 8 keys of one query (a row of 16-byte multiples: the stride of
    the passes' TMA copies). ``route`` is ``k2_route``'s, ``"wgmma"`` for
    every dtype and width; any other raises ``ValueError``."""
    if route != "wgmma":
        raise ValueError(f"K2 route {route!r}")
    return (B * H * Tq
            + (B * H * (-(-Tk // 8)) * (-(-Tq // 16) * 16) + 16) // 4)


def _check_operands(name, q, k, v, key_pad, static, n_heads, dtypes):
    B, Tq, hidden = q.shape
    Tk = k.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors only")
    if any(t.device != dev for t in (k, v, key_pad, static)):
        raise ValueError(f"{name}: operands on different devices")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share one dtype of "
                        f"{sorted(map(str, dtypes))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.dim() != 3 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2] != hidden:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hidden % n_heads:
        raise ValueError(f"{name}: hidden {hidden} not divisible by "
                         f"{n_heads} heads")
    if hidden // n_heads > HEAD_DIMS[-1]:
        raise ValueError(f"{name}: head width {hidden // n_heads}; the "
                         f"kernels take head widths up to {HEAD_DIMS[-1]}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: q/k/v need unit stride in the "
                         "last dimension")
    if key_pad.shape != (B, Tk) or static.shape != (Tq, Tk) \
            or key_pad.dtype != torch.int32 or static.dtype != torch.int32 \
            or not key_pad.is_contiguous() or not static.is_contiguous():
        raise ValueError(f"{name}: key_pad (B, Tk) and static "
                         "(Tq, Tk) must be contiguous int32")
    return B, Tq, Tk, hidden


def _check_aligned(name, **tensors):
    """The tensor-core kernels copy their tiles by TMA, whose tensor maps
    take 16-byte aligned addresses and strides: data pointers and batch
    and row strides must be
    16-byte aligned (a multiple of 8 bf16 or 4 f32 elements), or
    ``ValueError``."""
    for arg, t in tensors.items():
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or t.stride(0) % per or t.stride(1) % per:
            raise ValueError(
                f"{name}: {t.dtype} {arg} needs a 16-byte aligned data "
                f"pointer and batch and row strides, got offset "
                f"{t.data_ptr() % 16} and strides {t.stride()[:2]}")


def _dropout_key(dropout_rate: float, seed: SeedLike, dev):
    """The Philox key the kernels read, a one-element int64 tensor on
    ``dev`` (a seed-table entry as it is; a host int copied there), or None
    without dropout."""
    return None if dropout_rate == 0.0 else seed_tensor(seed, dev)


def _dropout_args(dropout_rate: float, key: Optional[torch.Tensor],
                  draw_offset: Tuple[int, int]):
    """(key pointer, threshold, keep_scale, on, b0, h0) as the kernels take
    them: the kernels read the low 32 bits of ``key`` on the device."""
    b0, h0 = (int(x) for x in draw_offset)
    if b0 < 0 or h0 < 0:
        raise ValueError(f"draw offset {draw_offset} must be >= 0")
    if key is None:
        return None, 0, 1.0, 0, b0, h0
    return (key.data_ptr(), dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate), 1, b0, h0)


def attention_fwd(q, k, v, key_pad, static, n_heads: int, scale: float,
                  with_lse: bool = False, dropout_rate: float = 0.0,
                  seed: SeedLike = 0, draw_offset: Tuple[int, int] = (0, 0)):
    """Launch K1 on CUDA tensors.

    q/k/v: f32 or bf16, one dtype, unit stride in the last dimension; any
    batch and row strides (the column views of a fused (B, T, 3*H*D) QKV
    product go in without a copy). key_pad (B, Tk) and static (Tq, Tk):
    contiguous int32. Head width D up to 128: at 16, 32, 64 and 128 the
    operands go in as they are, any other width through
    ``padded_attention_fwd`` to the next of ``HEAD_DIMS``. ``seed`` is a
    seed-table entry (a one-element int64 tensor on q's device) or a host
    int copied there; the kernel reads its low 32 bits, the Philox key,
    from device memory, so a CUDA graph of the launch draws the key the
    entry holds at replay. ``draw_offset`` (b0, h0) draws the bits of
    (b0 + b, h0 + h), a rank's slice of the whole batch's and heads' bits.
    Returns a contiguous output in q's dtype and, with ``with_lse``, an f32
    (B, H, Tq) lse.

    Both dtypes run on the tensor cores. f32 computes each product as
    three TF32 products of operands split into hi and lo parts (3xTF32),
    f32 math to about f32 accuracy: the contract of
    ``attention_reference``, with the scores the f32 K2 recomputes. bf16
    takes bf16 operands as JAX's K1 on its hardware: the contract of
    ``attention_reference(..., dots_dtype=torch.bfloat16)``, and the lse
    the bf16 K2 recomputes its probabilities against. Both run on Hopper's
    wgmma with TMA copies at every width (``k1_route``), their keep bits
    drawn by a kernel of their own first. The kernels copy their tiles by
    TMA, so q/k/v need 16-byte aligned data
    pointers and batch and row strides (a multiple of 4 f32 or 8 bf16
    elements; the fused-QKV column views have them); anything else raises
    ``ValueError``."""
    _, _, _, hidden = _check_operands("attention_fwd", q, k, v, key_pad,
                                      static, n_heads, _DTYPE_CODE)
    D = hidden // n_heads
    width = kernel_head_dim(D)
    if width != D:
        return padded_attention_fwd(_k1_launch, width, q, k, v, key_pad,
                                    static, n_heads, scale, with_lse,
                                    dropout_rate, seed, draw_offset)
    return _k1_launch(q, k, v, key_pad, static, n_heads, scale, with_lse,
                      dropout_rate, seed, draw_offset)


def _k1_launch(q, k, v, key_pad, static, n_heads: int, scale: float,
               with_lse: bool = False, dropout_rate: float = 0.0,
               seed: SeedLike = 0, draw_offset: Tuple[int, int] = (0, 0)):
    """K1's launch on checked operands whose head width is one of
    ``HEAD_DIMS``."""
    global K1_LAUNCHES, K1_LSE_LAUNCHES
    _check_aligned("attention_fwd", q=q, k=k, v=v)
    B, Tq, hidden = q.shape
    Tk = k.shape[1]
    dev = q.device
    key = _dropout_key(dropout_rate, seed, dev)
    fn = _k1_lib(hidden // n_heads)
    out = torch.empty((B, Tq, hidden), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, n_heads, Tq), dtype=torch.float32, device=dev)
           if with_lse else None)
    scratch = None
    if key is not None:
        scratch = torch.empty(
            _k1_scratch_bytes(B, n_heads, Tq, Tk,
                              k1_route(q.dtype, hidden // n_heads)),
            dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_pad.data_ptr(),
                static.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                scratch.data_ptr() if scratch is not None else None,
                B, Tq, Tk, n_heads, hidden // n_heads,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), float(scale),
                *_dropout_args(dropout_rate, key, draw_offset),
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    K1_LAUNCHES += 1
    K1_LSE_LAUNCHES += with_lse
    return out, lse


def attention_bwd(q, k, v, key_pad, static, g, lse, n_heads: int,
                  scale: float, dropout_rate: float = 0.0,
                  seed: SeedLike = 0, draw_offset: Tuple[int, int] = (0, 0)):
    """Launch K2 on CUDA tensors. q/k/v/g share one dtype, f32 or bf16, with
    unit inner stride and any batch and row strides; lse the f32
    (B, H, Tq) of K1 on the same operands, dropout rate, seed and draw
    offset. Head widths as ``attention_fwd`` (any other than 16, 32, 64 and
    128 up to 128 through ``padded_attention_bwd``). Returns contiguous
    (dq, dk, dv) in q's dtype.

    Both dtypes run on the tensor cores. f32 computes each product as
    three TF32 products of operands split into hi and lo parts (3xTF32),
    f32 math to about f32 accuracy: the contract of
    ``attention_bwd_reference``. bf16 takes bf16 operands as JAX's K2 on
    its hardware: the contract of ``attention_bwd_reference(...,
    dots_dtype=torch.bfloat16)``. Both run on Hopper's wgmma with TMA
    copies at every width (``k2_route``), their keep bits drawn by a kernel
    of their own first. The kernels copy their tiles by TMA, so q/k/v/g
    need 16-byte aligned data
    pointers and batch and row strides (a multiple of 4 f32 or 8 bf16
    elements; the fused-QKV column views have them); anything else raises
    ``ValueError``."""
    B, Tq, Tk, hidden = _check_operands("attention_bwd", q, k, v, key_pad,
                                        static, n_heads, _DTYPE_CODE)
    dev = q.device
    if g.shape != q.shape or g.dtype != q.dtype or g.device != dev:
        raise ValueError(f"attention_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, n_heads, Tq) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError("attention_bwd: lse must be contiguous f32 "
                         "(B, H, Tq)")
    D = hidden // n_heads
    width = kernel_head_dim(D)
    if width != D:
        return padded_attention_bwd(_k2_launch, width, q, k, v, key_pad,
                                    static, g, lse, n_heads, scale,
                                    dropout_rate, seed, draw_offset)
    return _k2_launch(q, k, v, key_pad, static, g, lse, n_heads, scale,
                      dropout_rate, seed, draw_offset)


def _k2_launch(q, k, v, key_pad, static, g, lse, n_heads: int, scale: float,
               dropout_rate: float = 0.0, seed: SeedLike = 0,
               draw_offset: Tuple[int, int] = (0, 0)):
    """K2's launch on checked operands whose head width is one of
    ``HEAD_DIMS``."""
    global K2_LAUNCHES
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_aligned("attention_bwd", q=q, k=k, v=v, g=g)
    B, Tq, hidden = q.shape
    Tk = k.shape[1]
    dev = q.device
    key = _dropout_key(dropout_rate, seed, dev)
    fn = _k2_lib(hidden // n_heads)
    dq = torch.empty((B, Tq, hidden), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Tk, hidden), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Tk, hidden), dtype=q.dtype, device=dev)
    route = k2_route(q.dtype, hidden // n_heads)
    rowsum = torch.empty(_k2_scratch_floats(B, n_heads, Tq, Tk, route),
                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                key_pad.data_ptr(), static.data_ptr(), lse.data_ptr(),
                rowsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, Tq, Tk, n_heads, hidden // n_heads,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), g.stride(0), g.stride(1),
                float(scale), *_dropout_args(dropout_rate, key, draw_offset),
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    K2_LAUNCHES += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the forward and backward as operators a dispatch mode sees whole
# ---------------------------------------------------------------------------

def _run_fwd(q, k, v, key_pad, static, seed, n_heads: int, scale: float,
             with_lse: bool, dropout_rate: float, use_kernel: bool,
             draw_offset):
    """K1 (``use_kernel``) or its plain version; (out, lse or None)."""
    fwd = attention_fwd if use_kernel else attention_reference
    return fwd(q, k, v, key_pad, static, n_heads, scale, with_lse=with_lse,
               dropout_rate=dropout_rate, seed=seed,
               draw_offset=tuple(draw_offset))


def _run_bwd(q, k, v, key_pad, static, g, lse, seed, n_heads: int,
             scale: float, dropout_rate: float, use_kernel: bool,
             draw_offset):
    """K2 (``use_kernel``) or its plain version; (dq, dk, dv)."""
    bwd = attention_bwd if use_kernel else attention_bwd_reference
    return bwd(q, k, v, key_pad, static, g, lse, n_heads, scale,
               dropout_rate, seed, draw_offset=tuple(draw_offset))


_OPS = "mmfm_attention"
if not hasattr(getattr(torch.ops, _OPS), "fwd"):   # one definition a process
    _LIB = torch.library.Library(_OPS, "DEF")
    _LIB.define("fwd(Tensor q, Tensor k, Tensor v, Tensor key_pad, "
                "Tensor static, Tensor? seed, int n_heads, float scale, "
                "bool with_lse, float dropout_rate, bool use_kernel, "
                "int[] draw_offset) -> (Tensor, Tensor)")
    _LIB.define("bwd(Tensor q, Tensor k, Tensor v, Tensor key_pad, "
                "Tensor static, Tensor g, Tensor lse, Tensor? seed, "
                "int n_heads, float scale, float dropout_rate, "
                "bool use_kernel, int[] draw_offset) "
                "-> (Tensor, Tensor, Tensor)")

    def _op_fwd(*args):
        out, lse = _run_fwd(*args)
        # an operator returns tensors: no lse is an empty one
        return out, (out.new_empty(0, dtype=torch.float32)
                     if lse is None else lse)

    _LIB.impl("fwd", _op_fwd, "CompositeExplicitAutograd")
    _LIB.impl("bwd", lambda *args: tuple(_run_bwd(*args)),
              "CompositeExplicitAutograd")

    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(getattr(torch.ops, _OPS).fwd)
    def _fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
        """The two products: B Tq Tk (H D) multiply-adds each."""
        B, Tq, hidden = q_shape
        return 4 * B * Tq * k_shape[1] * hidden

    @register_flop_formula(getattr(torch.ops, _OPS).bwd)
    def _bwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
        """dq, dk, dv and the probabilities' gradient: four products (the
        recompute of the scores is not the model's work)."""
        B, Tq, hidden = q_shape
        return 8 * B * Tq * k_shape[1] * hidden


def _attention_fwd_op(q, k, v, key_pad, static, seed, n_heads, scale,
                      with_lse, dropout_rate, use_kernel, draw_offset):
    """``_run_fwd``, as the ``fwd`` operator while a dispatch mode is
    active (module docstring)."""
    if not torch._C._len_torch_dispatch_stack():
        return _run_fwd(q, k, v, key_pad, static, seed, n_heads, scale,
                        with_lse, dropout_rate, use_kernel, draw_offset)
    out, lse = getattr(torch.ops, _OPS).fwd(
        q, k, v, key_pad, static, seed, n_heads, scale, with_lse,
        dropout_rate, use_kernel, list(draw_offset))
    return out, (lse if with_lse else None)


def _attention_bwd_op(*args):
    """``_run_bwd``, as the ``bwd`` operator while a dispatch mode is
    active."""
    if not torch._C._len_torch_dispatch_stack():
        return _run_bwd(*args)
    return getattr(torch.ops, _OPS).bwd(*args[:-1], list(args[-1]))


class _FlashAttention(torch.autograd.Function):
    """K1 (with ``lse``) forward, K2 backward: the port of JAX's
    ``_flash_mha`` custom VJP (:394-456). ``use_kernel=False`` runs the
    plain versions in the same two places (CPU tensors, ``impl="xla"``).
    Saves the operands, the masks, ``lse`` and the dropout key (the seed
    table's entry, a tensor), so the backward replays the forward's
    dropout."""

    @staticmethod
    def forward(ctx, q, k, v, key_pad, static, n_heads, scale, dropout_rate,
                seed, use_kernel, draw_offset):
        out, lse = _attention_fwd_op(q, k, v, key_pad, static, seed,
                                     n_heads, scale, True, dropout_rate,
                                     use_kernel, draw_offset)
        ctx.save_for_backward(q, k, v, key_pad, static, lse, seed)
        ctx.args = (n_heads, scale, dropout_rate, use_kernel, draw_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_pad, static, lse, seed = ctx.saved_tensors
        n_heads, scale, dropout_rate, use_kernel, draw_offset = ctx.args
        dq, dk, dv = _attention_bwd_op(q, k, v, key_pad, static, g, lse,
                                       seed, n_heads, scale, dropout_rate,
                                       use_kernel, draw_offset)
        return dq, dk, dv, None, None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def multi_head_attention(
    q: torch.Tensor,                         # (B, Tq, hidden)
    k: torch.Tensor,                         # (B, Tk, hidden)
    v: torch.Tensor,                         # (B, Tk, hidden)
    n_heads: int,
    mask: Optional[torch.Tensor] = None,     # (B, Tq, Tk) 1=attend (full)
    bias: Optional[torch.Tensor] = None,     # additive, overrides mask
    mask_spec: Optional[MaskSpec] = None,    # decomposed (kernel-native)
    dropout_rate: float = 0.0,
    seed: Optional[SeedLike] = None,         # keys the dropout
    impl: str = "pallas",
    draw_offset: Tuple[int, int] = (0, 0),   # (b0, h0) of the dropout bits
) -> torch.Tensor:
    """MHA over already-projected q/k/v; returns (B, Tq, hidden).

    ``impl="pallas"`` (the default, the JAX package's name) runs the
    kernels on CUDA tensors and the plain versions on CPU tensors;
    ``"xla"`` takes the plain versions on either device. Dropout needs a
    ``seed`` (JAX needs a ``dropout_key``): a seed-table entry (a
    one-element int64 tensor on q's device) or a host int. ``draw_offset``
    (b0, h0): the operands are rows ``b0..`` and heads ``h0..`` of a larger
    call (a data- and tensor-parallel rank's slice), whose dropout bits
    they draw."""
    B, Tq, hidden = q.shape
    Tk = k.shape[1]
    if hidden % n_heads:
        raise ValueError("hidden size not divisible by n_heads")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    dropout_rate = float(dropout_rate)
    # the key as a tensor on q's device (a host int is copied there)
    seed = seed_tensor(seed, q.device) if dropout_rate > 0.0 else None
    scale = 1.0 / math.sqrt(hidden // n_heads)

    if mask is not None or bias is not None:       # full masks: plain path
        if bias is None:
            bias = mask_to_bias(mask)
        return _biased_attention(q, k, v, bias, n_heads, scale, False,
                                 dropout_rate, seed,
                                 draw_offset=draw_offset)[0]

    key_pad, static = spec_operands(mask_spec, B, Tq, Tk, q.device)
    use_kernel = impl == "pallas" and q.device.type == "cuda"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, key_pad, static, n_heads,
                                     scale, dropout_rate, seed, use_kernel,
                                     tuple(draw_offset))
    return _attention_fwd_op(q, k, v, key_pad, static, seed, n_heads, scale,
                             False, dropout_rate, use_kernel,
                             tuple(draw_offset))[0]
