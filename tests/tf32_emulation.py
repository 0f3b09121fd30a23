"""The f32 tensor-core K2's arithmetic (3xTF32) in plain torch, on any device.

The f32 K2 (``csrc/attention_bwd.cu``, ``Tc<float>``) computes each of its
products as TF32 ``mma.sync.m16n8k8`` products: every f32 operand x splits
into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with ties away
(``cvt.rna.tf32.f32``), and each k-step of 8 of a . b sums al . bh, ah .
bl, then ah . bh from zero on the tensor cores before an f32 add into the
accumulator (``mma_3xtf32``). ``k2`` is K2's formula with every product
through such a ``dot``; with ``dot=torch.matmul`` and ``dtype=float64`` it
is an f64 evaluation of the same formula. Imports torch and the port only,
so ``scripts/torch_k2_f32_accuracy.py`` runs it on the card's inputs and
``tests/test_torch_attention_bwd_f32.py`` on the CPU.
"""

import torch

from multi_modal_foundation_model_tpu_torch.ops import attention as tatt


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half an ulp to the magnitude's bits, clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tensor-core step c + a . b over 8 k: the products of TF32 values
    exact, their sum rounded to f32 toward zero. Truncation is the
    pessimistic model of the tensor cores' f32 sums (Fasi et al., "Numerical
    behavior of NVIDIA tensor cores", PeerJ CS 2021, found them truncating)
    and what the card showed: chaining every term into the running sum
    missed the gate there as ``dot_3xtf32_chained`` does here."""
    d = c.double() + a.double() @ b.double()
    f = d.float()
    return torch.where(f.double().abs() > d.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def dot_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's ``mma_3xtf32``: per k-step of 8 the terms
    al . bh, ah . bl, then ah . bh summed from zero on the tensor cores,
    then added to the f32 accumulator (rounded to nearest)."""
    (ah, al), (bh, bl) = split(a), split(b)
    c = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                    device=a.device)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        p = mma(torch.zeros_like(c), al[..., ks], bh[..., ks, :])
        p = mma(p, ah[..., ks], bl[..., ks, :])
        c = c + mma(p, ah[..., ks], bh[..., ks, :])
    return c


def dot_3xtf32_chained(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The three terms of every k-step chained into the running sum, each
    mma truncating it: the first design, which missed the gate on the
    card."""
    (ah, al), (bh, bl) = split(a), split(b)
    c = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                    device=a.device)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        c = mma(c, al[..., ks], bh[..., ks, :])
        c = mma(c, ah[..., ks], bl[..., ks, :])
        c = mma(c, ah[..., ks], bh[..., ks, :])
    return c


def dot_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with one TF32 term (plain TF32 tensor-core math)."""
    return tf32(a) @ tf32(b)


def k2(q, k, v, key_pad, static, g, lse, n_heads, scale, rate=0.0, seed=0,
       dot=dot_3xtf32, dtype=torch.float32):
    """K2's formula (``csrc/attention_bwd.cu``'s note) on the kernel's
    operands, every product through ``dot``, elementwise math in
    ``dtype``: (dq, dk, dv) as (B, T, H*D) in ``dtype``."""
    B, Tq, _ = q.shape
    Tk = k.shape[1]

    def heads(x):
        b, t, hidden = x.shape
        return x.to(dtype).reshape(b, t, n_heads,
                                   hidden // n_heads).transpose(1, 2)

    qs = heads(q) * scale
    kh, vh, gh = heads(k), heads(v), heads(g)
    bias = tatt._attend_bias(key_pad, static).to(dtype)[:, None]
    s = dot(qs, kh.transpose(-1, -2)) + bias
    pn = torch.exp(s - lse.to(dtype)[..., None])
    del s
    dpn = dot(gh, vh.transpose(-1, -2))
    pd = pn
    if rate > 0.0:
        keep = tatt.philox_keep(seed, B, n_heads, Tq, Tk, rate, q.device)
        ms = torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(dtype)
        del keep
        pd, dpn = pn * ms, dpn * ms
    ds = pn * (dpn - (dpn * pn).sum(-1, keepdim=True))
    del dpn
    dq = dot(ds, kh) * scale
    dk = dot(ds.transpose(-1, -2), qs)
    dv = dot(pd.transpose(-1, -2), gh)
    return tuple(tatt._merge(x, dtype) for x in (dq, dk, dv))
