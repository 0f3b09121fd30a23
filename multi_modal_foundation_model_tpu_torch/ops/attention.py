"""Fused multi-head attention: the K1 kernel for Hopper + its plain version.

Port of ``multi_modal_foundation_model_tpu/ops/attention.py``. What stays:

- **Natural layout.** q/k/v arrive as ``(B, T, H*D)`` exactly as the
  projections produce them; the kernel splits heads itself, and takes a
  row stride so the column views of a fused QKV product need no copy.
- **Masks as (key_pad, static) decompositions.** Every mask the model uses
  is ``attend(b, q, k) = static(q, k) OR key_pad(b, k)`` (``MaskSpec``);
  the kernel rebuilds the additive bias from a ``(B, Tk)`` and a
  ``(Tq, Tk)`` int32 array and never sees a ``(B, Tq, Tk)`` tensor.
- **Finite NEG_INF.** ``-1e30`` instead of ``-inf``, so fully-masked rows
  (padded trials) come out uniform (the mean of V) instead of NaN.

Dispatch (``multi_head_attention``): CPU tensors take the plain version
``attention_reference``; CUDA tensors with a ``MaskSpec`` launch K1
(``attention_fwd``, ``csrc/attention_fwd.cu``) or raise — there is no
fallback. A full ``mask``/``bias`` takes the plain path on either device,
as in JAX; no module on the model's path passes one. ``impl="xla"`` asks
for the plain path explicitly (the JAX package's name for its oracle).
Attention dropout (in-kernel Philox) lands with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30
# floor of the row max in the lse statistic: max(m, _LSE_FLOOR) + log(l).
# A raw m + log(l) is absorbed to m = -1e30 on fully-masked rows.
_LSE_FLOOR = -1e6

# launches of the K1 kernel, counted by its wrapper where it launches
K1_LAUNCHES = 0

_HEAD_DIM = 32                     # the head width csrc/attention_fwd.cu takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
# plain version
# ---------------------------------------------------------------------------

def _biased_attention(q, k, v, bias, n_heads: int, scale: float,
                      with_lse: bool):
    """Softmax attention of (B, T, H*D) operands under an additive
    ``bias`` broadcastable to (B, Tq, Tk); f32 math, q pre-scaled as K1
    does. Returns (out in q's dtype, lse (B, H, Tq) f32 or None)."""
    B, Tq, hidden = q.shape
    Tk = k.shape[1]
    D = hidden // n_heads

    def heads(x, T):
        return x.float().reshape(B, T, n_heads, D).transpose(1, 2)

    s = (heads(q, Tq) * scale) @ heads(k, Tk).transpose(-1, -2)
    s = s + bias.float()[:, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ heads(v, Tk)) / l
    out = o.transpose(1, 2).reshape(B, Tq, hidden).to(q.dtype)
    lse = None
    if with_lse:
        lse = (m.clamp_min(_LSE_FLOOR) + torch.log(l))[..., 0]
    return out, lse


def attention_reference(q, k, v, key_pad, static, n_heads: int,
                        scale: float, with_lse: bool = False):
    """Plain PyTorch version of K1 on the kernel's operands: q (B, Tq, H*D),
    k/v (B, Tk, H*D), key_pad (B, Tk) int, static (Tq, Tk) int. Returns
    (out, lse or None); ``lse`` (B, H, Tq) = max(m, -1e6) + log(l)."""
    attend = static.bool()[None] | key_pad.bool()[:, None, :]
    return _biased_attention(q, k, v, mask_to_bias(attend), n_heads, scale,
                             with_lse)


# ---------------------------------------------------------------------------
# K1 wrapper
# ---------------------------------------------------------------------------

def _k1_lib():
    from . import build

    lib = build.load("attention_fwd")
    fn = lib.mmfm_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 7 + [i] * 5 + [ll] * 6
                       + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
    return fn


def attention_fwd(q, k, v, key_pad, static, n_heads: int, scale: float,
                  with_lse: bool = False):
    """Launch K1 on CUDA tensors; same contract as ``attention_reference``.

    q/k/v: f32 or bf16, one dtype, unit stride in the last dimension; any
    batch and row strides (the column views of a fused (B, T, 3*H*D) QKV
    product go in without a copy). key_pad (B, Tk) and static (Tq, Tk):
    contiguous int32. Head width D = 32. Returns a contiguous
    output in q's dtype and, with ``with_lse``, an f32 (B, H, Tq) lse."""
    global K1_LAUNCHES
    B, Tq, hidden = q.shape
    Tk = k.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("attention_fwd runs on CUDA tensors only")
    if any(t.device != dev for t in (k, v, key_pad, static)):
        raise ValueError("attention_fwd: operands on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention_fwd: q/k/v must share dtype f32 or bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.dim() != 3 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2] != hidden:
        raise ValueError(f"attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hidden != n_heads * _HEAD_DIM:
        raise ValueError(f"attention_fwd: head width {hidden}/{n_heads}, "
                         f"the kernel takes {_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention_fwd: q/k/v need unit stride in the "
                         "last dimension")
    if key_pad.shape != (B, Tk) or static.shape != (Tq, Tk) \
            or key_pad.dtype != torch.int32 or static.dtype != torch.int32 \
            or not key_pad.is_contiguous() or not static.is_contiguous():
        raise ValueError("attention_fwd: key_pad (B, Tk) and static "
                         "(Tq, Tk) must be contiguous int32")

    fn = _k1_lib()
    out = torch.empty((B, Tq, hidden), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, n_heads, Tq), dtype=torch.float32, device=dev)
           if with_lse else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_pad.data_ptr(),
                static.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                B, Tq, Tk, n_heads, hidden // n_heads,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), float(scale), _DTYPE_CODE[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    K1_LAUNCHES += 1
    return out, lse


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
    impl: str = "pallas",
) -> torch.Tensor:
    """MHA over already-projected q/k/v; returns (B, Tq, hidden).

    ``impl="pallas"`` (the default, the JAX package's name) launches K1 on
    CUDA tensors and takes the plain version on CPU tensors; ``"xla"`` takes
    the plain version on either device."""
    B, Tq, hidden = q.shape
    Tk = k.shape[1]
    if hidden % n_heads:
        raise ValueError("hidden size not divisible by n_heads")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout lands with the training slice")
    scale = 1.0 / math.sqrt(hidden // n_heads)

    if mask is not None or bias is not None:       # full masks: plain path
        if bias is None:
            bias = mask_to_bias(mask)
        return _biased_attention(q, k, v, bias, n_heads, scale, False)[0]

    key_pad, static = spec_operands(mask_spec, B, Tq, Tk, q.device)
    if impl == "xla" or q.device.type == "cpu":
        return attention_reference(q, k, v, key_pad, static, n_heads,
                                   scale)[0]
    return attention_fwd(q, k, v, key_pad, static, n_heads, scale)[0]
