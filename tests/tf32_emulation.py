"""The f32 tensor-core K2's arithmetic (3xTF32) in plain torch, on any device.

The f32 K2 computes each of its products as TF32 tensor-core products:
every f32 operand x splits into hi = tf32(x) and lo = tf32(x - hi), rounded
to nearest with ties away (``cvt.rna.tf32.f32``), and each k-step of 8 of
a . b sums al . bh, ah . bl, then ah . bh from zero on the tensor cores
before an f32 add into the accumulator: ``mma_3xtf32`` of the first mma.sync
kernels, and the same k-steps on wgmma: at widths 16 to 64
(``csrc/attention_bwd_f32.cuh``) the output products split their k-steps
between two warpgroups (``dot_3xtf32_wg``); at 128
(``csrc/attention_bwd_f32_d128.cuh``) each warpgroup owns half of D, so
every output element is one running sum in ``dot_3xtf32``'s order. ``k2``
is K2's formula with every product through such a ``dot``; with
``dot=torch.matmul`` and ``dtype=float64`` it is an f64 evaluation of the
same formula. The f32 K1 takes the same products: ``k1`` is its formula
with both products through ``dot`` and its online softmax over chunks of
keys; ``k1_wgmma`` the kernel at 16-64 (``csrc/attention_fwd_f32.cuh``:
chunks of 104 keys, 56 at 64, one output sum, ``K1_WGMMA_CHUNK``);
``k1_wgmma128`` the
kernel at 128 (``csrc/attention_fwd_f32_d128.cuh``: chunks of 128, its
output product taken transposed, so each k-step's two middle terms come
in the other order, ``dot_3xtf32(..., transposed=True)``). Imports torch
and the port only, so
``scripts/torch_k2_f32_accuracy.py`` runs it on the card's inputs and
``tests/test_torch_attention_bwd_f32.py`` and
``tests/test_torch_attention_fwd_f32.py`` on the CPU.
"""

import torch

from multi_modal_foundation_model_tpu_torch.ops import attention as tatt


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half an ulp to the magnitude's bits, clear the low 13; a NaN
    stays a NaN, so that a NaN operand gives NaN products, as the kernels'
    ``split_tf32`` (``csrc/mma_tf32.cuh``) makes it."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), float("nan"), r)


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


def dot_3xtf32(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor = None,
               transposed: bool = False) -> torch.Tensor:
    """c + a @ b (c = 0 by default) as the kernel's ``mma_3xtf32``: per
    k-step of 8 the terms al . bh, ah . bl, then ah . bh summed from zero
    on the tensor cores, then added to the f32 accumulator c (rounded to
    nearest). ``transposed``: a kernel that takes the product as (b^T .
    a^T)^T, whose first two terms are then bl . ah (= ah . bl here) and bh
    . al, in that order."""
    (ah, al), (bh, bl) = split(a), split(b)
    if c is None:
        c = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                        device=a.device)
    first, second = ((ah, bl), (al, bh)) if transposed else \
        ((al, bh), (ah, bl))
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        p = mma(torch.zeros_like(c), first[0][..., ks], first[1][..., ks, :])
        p = mma(p, second[0][..., ks], second[1][..., ks, :])
        c = c + mma(p, ah[..., ks], bh[..., ks, :])
    return c


# The f32 K2 on wgmma (csrc/attention_bwd_f32.cuh, Layout<D, pass>::kCols):
# columns a warpgroup takes of a chunk of two warpgroups', pass A's (the
# keys of dq = ds . k) and pass B's (the queries of dk and dv), by head
# width. At 128 (csrc/attention_bwd_f32_d128.cuh) the output products are
# split by D, not by K: None.
WGMMA_COLS = {16: (104, 104), 32: (104, 56), 64: (40, 24), 128: None}


def perm_k(j: int) -> int:
    """The k position of column j of a block of 8 in the f32 wgmma K2's
    permuted k order (``wgtf::perm_k``): column 2 t at t, 2 t + 1 at t + 4,
    so that an accumulator's registers are the next product's A fragment."""
    return (j & 1) * 4 + (j >> 1)


def dot_3xtf32_wg(a: torch.Tensor, b: torch.Tensor,
                  cols: int) -> torch.Tensor:
    """a @ b as the f32 wgmma K2 sums its output products (dq = ds . k,
    dk = ds^T . qs, dv = pd^T . g) over K, the columns of a chunk: K in
    chunks of 2 ``cols``, warpgroup 0 taking the first ``cols`` of each and
    warpgroup 1 the rest; each warpgroup's k-steps of 8 (the k order within
    each permuted by ``perm_k``: the model sums a step exactly, so the order
    within it moves nothing) summed from zero on the tensor cores (al . bh,
    ah . bl, then ah . bh) and added in f32 to the warpgroup's running sum,
    chunk after chunk; then warpgroup 0's sum plus warpgroup 1's."""
    n = a.shape[-1]
    chunk = 2 * cols
    pad = -n % chunk
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    order = torch.tensor([8 * (i // 8) + [0, 2, 4, 6, 1, 3, 5, 7][i % 8]
                          for i in range(chunk)])
    assert all(perm_k(int(order[i]) % 8) == i % 8 for i in range(chunk))
    c = [torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                     device=a.device) for _ in range(2)]
    for c0 in range(0, a.shape[-1], chunk):
        idx = order + c0
        xh, xl = ah[..., idx], al[..., idx]
        yh, yl = bh[..., idx, :], bl[..., idx, :]
        for w in range(2):
            for k0 in range(w * cols, w * cols + cols, 8):
                ks = slice(k0, k0 + 8)
                p = mma(torch.zeros_like(c[w]), xl[..., ks], yh[..., ks, :])
                p = mma(p, xh[..., ks], yl[..., ks, :])
                c[w] = c[w] + mma(p, xh[..., ks], yh[..., ks, :])
    return c[0] + c[1]


def wgmma_dots(head_dim: int):
    """``k2``'s ``out_dots`` for the f32 wgmma K2 at ``head_dim``: dq's
    over pass A's columns, dk's and dv's over pass B's. At 128 the kernel
    takes the output products transposed (dq^T = k^T . ds^T, dk^T = qs^T .
    ds, dv^T = g^T . pd), each warpgroup owning 64 of the 128 columns of D
    over the whole of K: every output element is one running sum of the
    k-steps of 8 keys or queries in order, chunk after chunk (64 keys in
    pass A, 48 queries in pass B), ``dot_3xtf32``'s order."""
    if WGMMA_COLS[head_dim] is None:
        return dot_3xtf32, dot_3xtf32
    cols_a, cols_b = WGMMA_COLS[head_dim]
    return (lambda a, b: dot_3xtf32_wg(a, b, cols_a),
            lambda a, b: dot_3xtf32_wg(a, b, cols_b))


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


def dot_1xtf32(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor = None) -> torch.Tensor:
    """c + a @ b with one TF32 term (plain TF32 tensor-core math)."""
    p = tf32(a) @ tf32(b)
    return p if c is None else c + p


def k1(q, k, v, key_pad, static, n_heads, scale, rate=0.0, seed=0,
       dot=dot_3xtf32, chunk=128, out_dot=None):
    """The f32 K1's formula (``csrc/attention_fwd.cu``'s note) on the
    kernel's operands, as a kernel with one output sum computes it: per
    chunk of ``chunk`` keys, s = (q * scale) . k through ``dot`` (q * scale rounded to f32
    first), the masked scores replaced by -1e30; an online softmax: the new
    row max m, the correction exp(m_old - m) of l and of the O accumulator,
    p = exp(s - m) summed undropped into l; then the dropped and rescaled
    pd . v added to the rescaled accumulator through ``out_dot`` (``dot``
    unless given). out = o / l, lse = max(m, -1e6) + log(l). Returns (out
    (B, Tq, H*D) f32, lse (B, H, Tq))."""
    out_dot = out_dot or dot
    B, Tq, _ = q.shape
    Tk = k.shape[1]
    qs = tatt._heads(q, n_heads) * scale
    kh, vh = tatt._heads(k, n_heads), tatt._heads(v, n_heads)
    attend = (static.bool()[None] | key_pad.bool()[:, None, :])[:, None]
    keep = None
    if rate > 0.0:
        keep = tatt.philox_keep(seed, B, n_heads, Tq, Tk, rate, q.device)
    m = torch.full(qs.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qs)
    for k0 in range(0, Tk, chunk):
        ks = slice(k0, k0 + chunk)
        s = dot(qs, kh[..., ks, :].transpose(-1, -2))
        s = torch.where(attend[..., ks], s, tatt.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., ks], p * (1.0 / (1.0 - rate)), 0.0)
        o = out_dot(p, vh[..., ks, :], o * corr)
        m = m_new
    lse = (m.clamp_min(tatt._LSE_FLOOR) + torch.log(l))[..., 0]
    return tatt._merge(o / l, torch.float32), lse


# The f32 K1 on wgmma at 16-64 (csrc/attention_fwd_f32.cuh,
# Layout<D>::kChunk): keys a block takes at once
K1_WGMMA_CHUNK = {16: 104, 32: 104, 64: 56}


def k1_wgmma(q, k, v, key_pad, static, n_heads, scale, rate=0.0, seed=0,
             dot=dot_3xtf32):
    """``k1`` as the f32 K1 at head widths 16, 32 and 64 computes it
    (``csrc/attention_fwd_f32.cuh``): s as the f32 K2 at these widths
    recomputes it (``dot``, ``dot_3xtf32``'s order over D); an online
    softmax over chunks of ``K1_WGMMA_CHUNK[D]`` keys; o = pd . v one
    running sum, rescaled between chunks and added k-step by k-step
    (``dot(pd, v, o * corr)``); out = o * (1 / l), lse = max(m, -1e6) +
    log(l). Returns (out (B, Tq, H*D) f32, lse (B, H, Tq))."""
    Tq, Tk = q.shape[1], k.shape[1]
    chunk = K1_WGMMA_CHUNK[q.shape[-1] // n_heads]
    qs = tatt._heads(q, n_heads) * scale
    kh, vh = tatt._heads(k, n_heads), tatt._heads(v, n_heads)
    attend = (static.bool()[None] | key_pad.bool()[:, None, :])[:, None]
    keep = None
    if rate > 0.0:
        keep = tatt.philox_keep(seed, q.shape[0], n_heads, Tq, Tk, rate,
                                q.device)
    m = torch.full(qs.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qs)
    for k0 in range(0, Tk, chunk):
        ks = slice(k0, k0 + chunk)
        s = dot(qs, kh[..., ks, :].transpose(-1, -2))
        s = torch.where(attend[..., ks], s, tatt.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., ks], p * (1.0 / (1.0 - rate)), 0.0)
        o = dot(p, vh[..., ks, :], o * corr)
        m = m_new
    lse = (m.clamp_min(tatt._LSE_FLOOR) + torch.log(l))[..., 0]
    return tatt._merge(o * (1.0 / l), torch.float32), lse


def k1_wgmma128(q, k, v, key_pad, static, n_heads, scale, rate=0.0,
                seed=0):
    """``k1`` as the f32 K1 at head width 128 computes it
    (``csrc/attention_fwd_f32_d128.cuh``): s as the f32 K2 at 128
    recomputes it (``dot_3xtf32``), the online softmax over chunks of 128
    keys (one sweep up to 128), and o^T = v^T . pd^T, each output element
    one running sum of k-steps of 8 keys in order, chunk after chunk, the
    terms of the transposed product."""
    return k1(q, k, v, key_pad, static, n_heads, scale, rate, seed,
              chunk=128,
              out_dot=lambda a, b, c: dot_3xtf32(a, b, c, transposed=True))


def k2(q, k, v, key_pad, static, g, lse, n_heads, scale, rate=0.0, seed=0,
       dot=dot_3xtf32, dtype=torch.float32, out_dots=None):
    """K2's formula (``csrc/attention_bwd.cu``'s note) on the kernel's
    operands, every product through ``dot`` (s and dP, and the output
    products unless ``out_dots`` = (dq's dot, dk's and dv's dot), as
    ``wgmma_dots`` gives them), elementwise math in ``dtype``: (dq, dk, dv)
    as (B, T, H*D) in ``dtype``."""
    dot_q, dot_kv = out_dots or (dot, dot)
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
    dq = dot_q(ds, kh) * scale
    dk = dot_kv(ds.transpose(-1, -2), qs)
    dv = dot_kv(pd.transpose(-1, -2), gh)
    return tuple(tatt._merge(x, dtype) for x in (dq, dk, dv))
