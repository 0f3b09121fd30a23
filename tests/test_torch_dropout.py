"""Dropout in the port: the attention's Philox keep mask and the layers'
u8 policy.

- ``philox_keep`` draws Philox4x32-10's bits: bit for bit against an
  independent numpy (uint64) version and against Random123's published
  known-answer vectors. The CUDA kernels draw the same bits
  (``tests/test_torch_kernels.py`` reads K1's back on the card).
- The keep rate is within 4 sigma of 1 - rate; averaged over 400 seeds
  the dropped forward is within 5 standard errors of the undropped one.
- With a fixed seed the plain backward (the lse formula) equals autograd
  of the plain forward under the same mask, f32 atol 1e-5.
- Layer dropout keeps with probability (256 - t) / 256, t = round(rate *
  256) clamped to 255, and its mean is unbiased (4 sigma).
"""

import math

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu_torch.models import layers as tl
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

_M32 = np.uint64(0xFFFFFFFF)


def np_philox(c, key):
    """Philox4x32-10 in numpy uint64: ``c`` a list of 4 uint arrays."""
    c = [np.asarray(x, np.uint64) for x in c]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    for _ in range(10):
        p0, p1 = m0 * c[0], m1 * c[2]         # < 2^64: exact in uint64
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & _M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & _M32]
        k0 = (k0 + np.uint64(0x9E3779B9)) & _M32
        k1 = (k1 + np.uint64(0xBB67AE85)) & _M32
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32 with 10 rounds."""
    got = tatt.philox4x32_10(*(torch.tensor([x]) for x in ctr), *key)
    assert tuple(int(x) for x in got) == want
    assert tuple(int(x[0]) for x in np_philox([[x] for x in ctr], key)) \
        == want


def test_philox_keep_matches_numpy_bit_for_bit():
    B, H, Tq, Tk, seed = 3, 2, 7, 13, 2 ** 32 + 987654321  # Tk % 4 != 0
    bits = tatt.philox_bits(seed, B, H, Tq, Tk).numpy()
    b, h, q, k = np.meshgrid(np.arange(B), np.arange(H), np.arange(Tq),
                             np.arange(Tk), indexing="ij")
    words = np_philox([k // 4, q, h, b], (seed & 0xFFFFFFFF, 0))
    want = np.choose(k % 4, words)
    np.testing.assert_array_equal(bits, want.astype(np.int64))
    thr = tatt.dropout_threshold(0.4)
    assert thr == int(np.uint32(0.4 * np.float64(2 ** 32 - 1)))
    np.testing.assert_array_equal(
        tatt.philox_keep(seed, B, H, Tq, Tk, 0.4).numpy(), want > thr)


@pytest.mark.parametrize("rate", [0.1, 0.4, 0.9])
def test_keep_rate_within_four_sigma(rate):
    keep = tatt.philox_keep(5, 8, 8, 64, 64, rate)
    n = keep.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma


def test_rate_out_of_range_raises():
    with pytest.raises(ValueError):
        tatt.dropout_threshold(1.0)
    q = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError):                 # dropout needs a seed
        tatt.multi_head_attention(q, q, q, 2, dropout_rate=0.1)


def _operands(seed=0, B=2, T=20, H=2, D=16):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H * D))
                                .astype(np.float32)) for _ in range(3))
    pad = torch.ones(B, T, dtype=torch.int32)
    pad[0, T - 4:] = 0
    pad[1] = 0                                      # a fully masked trial
    return q, k, v, pad, torch.eye(T, dtype=torch.int32), H


def test_dropped_forward_averages_to_the_undropped_one():
    """Over 400 seeds the mean is within 5 standard errors of the
    undropped output, elementwise: var = sum_k pn_k^2 v_k^2 r / (1 - r)
    for independent keeps."""
    q, k, v, pad, _, H = _operands()
    static = torch.zeros(20, 20, dtype=torch.int32)
    scale, rate, n = 0.25, 0.4, 400
    want = tatt.attention_reference(q, k, v, pad, static, H, scale)[0]
    mean = sum(tatt.attention_reference(q, k, v, pad, static, H, scale,
                                        dropout_rate=rate, seed=s)[0]
               for s in range(n)) / n
    s_ = (tatt._heads(q, H) * scale) @ tatt._heads(k, H).transpose(-1, -2)
    pn = torch.softmax(s_ + tatt._attend_bias(pad, static)[:, None], -1)
    var = (pn ** 2) @ tatt._heads(v, H) ** 2 * rate / (1 - rate)
    se = tatt._merge(var.sqrt(), torch.float32) / math.sqrt(n)
    assert ((mean - want).abs() <= 5 * se + 1e-6).all()
    one = tatt.attention_reference(q, k, v, pad, static, H, scale,
                                   dropout_rate=rate, seed=3)[0]
    assert (one - want).abs().max() > 0.1          # it does drop


@pytest.mark.parametrize("static_kind", ["eye", "none"])
def test_plain_backward_is_autograd_under_the_same_mask(static_kind):
    """Same seed on both: the lse backward equals autograd through the
    dropped plain forward, except on fully-masked rows (trial 1 with no
    static term), where it gives zero by contract."""
    q, k, v, pad, eye, H = _operands(1)
    static = eye if static_kind == "eye" else torch.zeros_like(eye)
    scale, rate, seed = 0.25, 0.4, 99
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=q.shape).astype(np.float32))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    out, lse = tatt.attention_reference(qr, kr, vr, pad, static, H, scale,
                                        True, rate, seed)
    auto = torch.autograd.grad(out, (qr, kr, vr), g)
    got = tatt.attention_bwd_reference(q, k, v, pad, static, g,
                                       lse.detach(), H, scale, rate, seed)
    rows = slice(None) if static_kind == "eye" else slice(0, 1)
    for a, b in zip(got, auto):
        torch.testing.assert_close(a[rows], b[rows], atol=1e-5, rtol=0)
    if static_kind == "none":
        assert not got[0][1].any()


def test_mha_dropout_is_a_function_of_the_seed():
    q, k, v, pad, eye, H = _operands(3)
    spec = tatt.MaskSpec(key_pad=pad, static=eye)
    a = tatt.multi_head_attention(q, k, v, H, mask_spec=spec,
                                  dropout_rate=0.4, seed=7)
    b = tatt.multi_head_attention(q, k, v, H, mask_spec=spec,
                                  dropout_rate=0.4, seed=7)
    c = tatt.multi_head_attention(q, k, v, H, mask_spec=spec,
                                  dropout_rate=0.4, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("rate,t", [(0.1, 26), (0.2, 51), (0.4, 102),
                                    (0.999, 255)])
def test_u8_dropout_keep_probability_and_unbiased_mean(rate, t):
    """t = round(rate * 256), clamped to 255 (t = 256 would overflow the
    byte); keep probability (256 - t) / 256; survivors divided by it."""
    assert tl.dropout_keep_threshold(rate) == (t, (256 - t) / 256)
    n = 1 << 20
    out = tl.dropout_u8(torch.ones(n), rate, seed=11)
    keep_p = (256 - t) / 256
    kept = (out != 0).float().mean().item()
    assert abs(kept - keep_p) < 4 * math.sqrt(keep_p * (1 - keep_p) / n)
    # mean of (kept / keep_p): sd sqrt((1 - p) / (p n))
    assert abs(out.mean().item() - 1.0) < 4 * math.sqrt(
        (1 - keep_p) / (keep_p * n))
    torch.testing.assert_close(out[out != 0],
                               torch.full_like(out[out != 0], 1 / keep_p))


def test_u8_dropout_edges():
    x = torch.randn(100)
    assert tl.dropout_u8(x, 0.4, None) is x          # eval: no seed
    assert tl.dropout_u8(x, 0.0, 3) is x
    assert not tl.dropout_u8(x, 1.0, 3).any()
    assert torch.equal(tl.dropout_u8(x, 0.4, 3), tl.dropout_u8(x, 0.4, 3))
