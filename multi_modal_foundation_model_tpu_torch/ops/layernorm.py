"""LayerNorm with the JAX package's fast-variance formula, and its kernels.

Port of ``multi_modal_foundation_model_tpu/ops/layernorm.py`` (:43-247):
f32 statistics with ``var = relu(E[x^2] - mu^2)``, eps 1e-5, output in
``dtype`` (else x's dtype promoted with f32, :82-83). Torch's
``F.layer_norm`` computes the variance in two passes, which differs in the
last bits, so the formula is written out here and in the kernels.

- ``layer_norm`` (forward) and ``layer_norm_bwd_reference`` (backward,
  written from JAX's ``_ln_bwd_kernel`` formula, :109-120, not from
  autograd) are the plain versions.
- ``layernorm_fwd`` (K3) and ``layernorm_bwd`` (K4) launch the hand-written
  kernels of ``csrc/layernorm.cu`` on CUDA tensors, counted in
  ``K3_LAUNCHES`` / ``K4_LAUNCHES`` where they launch.
- ``PALLAS_LAYERNORM`` is JAX's switch with its three values: ``"off"``
  (the plain form, forward and autograd backward), ``"bwd"`` (plain
  forward, K4 backward) and ``"full"`` (K3 forward, K4 backward), through
  the autograd Functions ``_BwdKernelLayerNorm`` / ``_KernelLayerNorm``,
  the twins of ``_bwdonly_layernorm`` / ``_pallas_layernorm`` (:145-219).

Dispatch follows ``ops/attention.py``: under ``"bwd"``/``"full"`` CPU
tensors take the plain versions inside the same Functions, and CUDA tensors
launch the kernel or raise; nothing falls back. The launch is keyed on the
switch and the device, not on JAX's ``H % 128`` rule (:236), a TPU tiling
fact: the kernels take any H that is a multiple of 32 up to 1024, and one
dtype (f32 or bf16) for x and the output, as every norm of the model has.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import nn

# "off" | "bwd" | "full", read at every call (JAX ops/layernorm.py:73).
# JAX keeps "off": on the TPU, XLA fuses the plain form into its neighbours.
# Eager PyTorch fuses nothing, and on the H100 (700 W) the mm.yaml (bf16)
# step at B=256 took 148.2 ms under "full", 170.4 under "bwd" and 197.7
# under "off", interleaved in one process with spreads of 2.4-13.7 ms
# (chip_smoke.py's layernorm_ab; PERF.md): the default is "full".
PALLAS_LAYERNORM = "full"
MODES = ("off", "bwd", "full")

# launches of the K3 / K4 kernels, counted by their wrappers where they
# launch
K3_LAUNCHES = 0
K4_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_H = 1024


def _out_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, torch.float32)


def _stats(x32: torch.Tensor, eps: float):
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.relu((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu)
    return mu, torch.rsqrt(var + eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fast-variance LayerNorm over the last axis, f32 math; output in
    ``dtype`` (default: x's dtype promoted with f32). The plain version of
    K3."""
    x32 = x.float()
    mu, rsigma = _stats(x32, eps)
    y = (x32 - mu) * (rsigma * weight.float()) + bias.float()
    return y.to(_out_dtype(x, dtype))


def layer_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                             g: torch.Tensor, eps: float = 1e-5
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of K4 (JAX ``_ln_bwd_kernel``, :109-120), all f32:
    dxhat = g * weight; dx = rsigma * (dxhat - mean(dxhat) - xhat *
    mean(dxhat * xhat)) in x's dtype; dweight = sum g * xhat and dbias =
    sum g over every leading axis, f32."""
    x32, g32 = x.float(), g.float()
    mu, rsigma = _stats(x32, eps)
    xhat = (x32 - mu) * rsigma
    dxhat = g32 * weight.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rsigma * (dxhat - m1 - xhat * m2)
    lead = tuple(range(x.dim() - 1))
    return dx.to(x.dtype), (g32 * xhat).sum(lead), g32.sum(lead)


# ---------------------------------------------------------------------------
# K3 / K4 wrappers
# ---------------------------------------------------------------------------

def _lib():
    from . import build

    lib = build.load("layernorm")
    if lib.mmfm_layernorm_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mmfm_layernorm_fwd.argtypes = [p] * 4 + [i, i, f, i, p]
        lib.mmfm_layernorm_fwd.restype = i
        lib.mmfm_layernorm_bwd.argtypes = [p] * 8 + [i, i, f, i, p]
        lib.mmfm_layernorm_bwd.restype = i
        lib.mmfm_layernorm_bwd_rows_per_block.argtypes = []
        lib.mmfm_layernorm_bwd_rows_per_block.restype = i
    return lib


def _rows(name: str, x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """x as a contiguous, 16-byte aligned (rows, H) matrix, after the
    checks every kernel argument passes."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors only")
    if any(t.device != x.device for t in others):
        raise ValueError(f"{name}: operands on different devices")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    H = x.shape[-1]
    if H % 32 or not 32 <= H <= _MAX_H:
        raise ValueError(f"{name}: width {H}; the kernel takes a multiple "
                         f"of 32 up to {_MAX_H}")
    x2 = x.reshape(-1, H).contiguous()
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def _param(name: str, p: torch.Tensor, H: int) -> torch.Tensor:
    if p.shape != (H,):
        raise ValueError(f"{name}: parameter of shape {tuple(p.shape)}, "
                         f"want ({H},)")
    p = p.float().contiguous()
    return p if p.data_ptr() % 16 == 0 else p.clone()


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def layernorm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch K3 on a CUDA tensor; same contract as ``layer_norm``, with the
    output dtype equal to x's (f32 or bf16) and H a multiple of 32 up to
    1024. Returns a contiguous tensor of x's shape."""
    global K3_LAUNCHES
    x2 = _rows("layernorm_fwd", x, weight, bias)
    if _out_dtype(x, dtype) != x.dtype:
        raise TypeError(f"layernorm_fwd: output {_out_dtype(x, dtype)} from "
                        f"{x.dtype} input; the kernel keeps x's dtype")
    rows, H = x2.shape
    w, b = _param("layernorm_fwd", weight, H), _param("layernorm_fwd", bias, H)
    y = torch.empty_like(x2)
    if rows:
        with torch.cuda.device(x2.device):
            stream = torch.cuda.current_stream(x2.device).cuda_stream
            _check_rc("layernorm_fwd", _lib().mmfm_layernorm_fwd(
                x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                rows, H, float(eps), _DTYPE_CODE[x2.dtype], stream))
        K3_LAUNCHES += 1
    return y.reshape(x.shape)


def layernorm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K4 on CUDA tensors; same contract as
    ``layer_norm_bwd_reference``, with g in x's dtype. Returns (dx in x's
    dtype and shape, dweight f32, dbias f32); dweight and dbias are summed
    in a fixed order, so they are the same bits on every run."""
    global K4_LAUNCHES
    x2 = _rows("layernorm_bwd", x, weight, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise TypeError(f"layernorm_bwd: g {tuple(g.shape)} {g.dtype} must "
                        f"match x {tuple(x.shape)} {x.dtype}")
    g2 = _rows("layernorm_bwd", g)
    rows, H = x2.shape
    w = _param("layernorm_bwd", weight, H)
    dev = x2.device
    dx = torch.empty_like(x2)
    dw = torch.empty(H, dtype=torch.float32, device=dev)
    db = torch.empty(H, dtype=torch.float32, device=dev)
    if not rows:
        dw.zero_()
        db.zero_()
    else:
        lib = _lib()
        per_block = lib.mmfm_layernorm_bwd_rows_per_block()
        parts = torch.empty((2, -(-rows // per_block), H),
                            dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _check_rc("layernorm_bwd", lib.mmfm_layernorm_bwd(
                x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr(), dw.data_ptr(),
                db.data_ptr(), rows, H, float(eps), _DTYPE_CODE[x2.dtype],
                stream))
        K4_LAUNCHES += 1
    return dx.reshape(x.shape), dw, db


# ---------------------------------------------------------------------------
# autograd Functions and dispatch
# ---------------------------------------------------------------------------

class _BwdKernelLayerNorm(torch.autograd.Function):
    """``"bwd"``: the plain forward, K4 backward (JAX
    ``_bwdonly_layernorm``). Saves x and the weight; the statistics are
    recomputed in the backward, as on the TPU. CPU tensors run the plain
    versions in both places."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm(x, weight, bias, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        bwd = (layernorm_bwd if x.device.type == "cuda"
               else layer_norm_bwd_reference)
        dx, dw, db = bwd(x, weight, g, ctx.eps)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None, None


class _KernelLayerNorm(_BwdKernelLayerNorm):
    """``"full"``: K3 forward, K4 backward (JAX ``_pallas_layernorm``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        fwd = layernorm_fwd if x.device.type == "cuda" else layer_norm
        return fwd(x, weight, bias, eps, dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm under the current ``PALLAS_LAYERNORM``."""
    mode = PALLAS_LAYERNORM
    if mode == "off":
        return layer_norm(x, weight, bias, eps, dtype)
    if mode == "bwd":
        return _BwdKernelLayerNorm.apply(x, weight, bias, eps, dtype)
    if mode == "full":
        return _KernelLayerNorm.apply(x, weight, bias, eps, dtype)
    raise ValueError(f"PALLAS_LAYERNORM {mode!r} not in {MODES}")


class LayerNorm(nn.Module):
    """``weight``/``bias`` LayerNorm (reference state_dict names); output in
    ``dtype``, else x's dtype promoted with f32 (JAX ``FusedLayerNorm``)."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps, self.dtype)
