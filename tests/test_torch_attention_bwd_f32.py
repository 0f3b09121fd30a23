"""The arithmetic of the f32 tensor-core K2 (3xTF32), on the CPU.

The card cannot be reached from here, so this file holds the f32 K2's
arithmetic before it reaches one: ``tf32_emulation.k2`` is K2's formula
with each product emulated as the kernel computes it (TF32 by bit masking,
the three terms in the kernel's order, each mma's sum truncated to f32 as
the tensor cores do), held within the kernel's gate, atol 1e-5 on dq, dk
and dv,

- against JAX's K2 (``_attn_bwd_kernel`` in interpret mode, f32 dots,
  through ``jax.grad`` of ``multi_head_attention(impl="pallas")``) at
  D = 32 for the encoder-eye-pad, padded-trial and cross cases;
- against the port's f32 ``attention_bwd_reference`` at the smoke run's
  magnitudes (randn operands, T = 200, dropout 0 and 0.4 on the same
  Philox bits), and at Tq = 200, Tk = 17, where few keys make dk and dv
  sums of 200 large terms.

Negative controls show the tests see what matters: one-term TF32
(``tf32(a) . tf32(b)``) misses the gate, and so does chaining the three
terms into the running sum (the first design, which missed on the card).
The wgmma K2 of head widths 16 to 64 (``csrc/attention_bwd_f32.cuh``) sums
the same k-steps, its output products split between two warpgroups
(``emu.wgmma_dots``): held the same way, at each of its widths for the
few-keys case. The wgmma K2 of head width 128
(``csrc/attention_bwd_f32_d128.cuh``: each warpgroup owns half of D of the
transposed output products, so each output element is one running sum in
the mma.sync order) is held at 2 heads of 128 against JAX's K2 and the
plain version in the three mask cases, and in the few-keys case. The emulation takes exp from torch, where the kernel takes
``ex2.approx``;
``scripts/torch_k2_f32_accuracy.py`` runs the same emulation on the card
at the smoke run's full inputs beside the kernel, an accurate-exp build of
it and an f64 evaluation.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf32_emulation as emu
import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

ATOL = 1e-5          # the f32 K2's gate on the card (chip_smoke.py)
H, D = 4, 32


def _k2(q, k, v, key_pad, static, g, lse, scale, rate=0.0, seed=0,
        dot=emu.dot_3xtf32, heads=H, out_dots=None):
    """K2's formula with every product through ``dot`` (the output
    products through ``out_dots`` where given): (dq, dk, dv) as (B, T,
    H*D) f32."""
    return emu.k2(q, k, v, key_pad, static, g, lse, heads, scale, rate, seed,
                  dot=dot, out_dots=out_dots)


def _case(case, B=3, tq=70, seed=0, tk=None, hidden=H * D):
    """numpy q, k, v, g, key_pad (B, Tk) and static (Tq, Tk) or None; 70
    rows cross a 64-row tile."""
    tk = tk or (28 if case == "cross" else tq)
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, tq, hidden)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, tk, hidden)).astype(np.float32)
            for _ in range(2))
    pad = np.ones((B, tk), np.int32)
    pad[1, tk - 5:] = 0
    if case == "encoder_eye_pad":
        static = np.eye(tq, tk, dtype=np.int32)
    elif case == "decoder_pad_padded_trial":
        pad[2] = 0                          # every key of trial 2 masked
        static = None
    else:                                   # cross, Tq != Tk
        static = (rng.random((tq, tk)) > 0.7).astype(np.int32)
    return q, k, v, g, pad, static


def _jax_grads(q, k, v, g, pad, static, heads=H):
    spec = jatt.MaskSpec(
        key_pad=jnp.asarray(pad),
        static=None if static is None else jnp.asarray(static))

    def f(q, k, v):
        out = jatt.multi_head_attention(q, k, v, heads, mask_spec=spec,
                                        impl="pallas")
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _operands(q, k, v, g, pad, static, heads=H):
    """torch operands, the kernel's masks and the port's f32 lse."""
    tq, tk_, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    spec = tatt.MaskSpec(
        key_pad=torch.from_numpy(pad),
        static=None if static is None else torch.from_numpy(static))
    key_pad, stat = tatt.spec_operands(spec, q.shape[0], q.shape[1],
                                       k.shape[1], "cpu")
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    _, lse = tatt.attention_reference(tq, tk_, tv, key_pad, stat, heads,
                                      scale, with_lse=True)
    return tq, tk_, tv, key_pad, stat, tg, lse, scale


def _worst(got, want) -> float:
    return max(float((a - torch.as_tensor(np.array(b))).abs().max())
               for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["encoder_eye_pad",
                                  "decoder_pad_padded_trial", "cross"])
def test_3xtf32_k2_matches_jax_k2(case):
    """The 3xTF32 emulation against JAX's K2 in interpret mode, D = 32,
    atol 1e-5 (measured 1.2e-6 to 1.4e-6); a padded trial's rows get
    exactly zero dq, as in JAX."""
    q, k, v, g, pad, static = _case(case)
    want = _jax_grads(q, k, v, g, pad, static)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static)
    got = _k2(tq, tk_, tv, key_pad, stat, tg, lse, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0,
                                   err_msg=name)
    if case == "decoder_pad_padded_trial":
        assert not got[0][2].any() and not want[0][2].any()


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_3xtf32_k2_matches_f32_plain_at_smoke_magnitudes(rate):
    """At the smoke run's magnitudes (randn q, k, v, g; T = 200 = 3 x 64 +
    8; 8 heads of 32 there, 4 here; the encoder's eye-and-pad mask) the
    3xTF32 emulation stays within 1e-5 of the port's f32 plain version on
    the same lse and Philox bits: measured 1.07e-6 at rate 0 and 1.01e-6 at
    0.4 (the chained sums of the first design, 3.6e-6 and 6.9e-6). This is
    the worst of B = 2 trials and 4 heads: at the smoke run's full inputs
    (B = 256, 8 heads) on an H100 the same emulation reads up to 5.0e-6
    from the plain version, as the kernel does (4.8e-6), both within
    3.3e-6 of an f64 evaluation (``scripts/torch_k2_f32_accuracy.py``)."""
    q, k, v, g, pad, static = _case("encoder_eye_pad", B=2, tq=200, seed=4)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static)
    want = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                        H, scale, rate, 77)
    got = _k2(tq, tk_, tv, key_pad, stat, tg, lse, scale, rate, 77)
    worst = _worst(got, want)
    assert worst <= ATOL, worst


def test_3xtf32_k2_few_keys_where_chained_sums_miss():
    """Tq = 200 queries over Tk = 17 keys: dk and dv are sums of 200 large
    terms (|dk| up to ~7). The kernel's sums (each k-step from zero, then
    an f32 add) stay within 1e-5 of the f32 plain version (measured
    4.8e-6), where chaining all three terms of every k-step into the
    truncating running sum misses (2.0e-5), as the first design did on the
    card at this shape."""
    q, k, v, g, pad, static = _case("cross", tq=200, tk=17, seed=4)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static)
    want = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                        H, scale)
    kernel = _worst(_k2(tq, tk_, tv, key_pad, stat, tg, lse, scale), want)
    chained = _worst(_k2(tq, tk_, tv, key_pad, stat, tg, lse, scale,
                         dot=emu.dot_3xtf32_chained), want)
    assert kernel <= ATOL, kernel
    assert chained > ATOL, chained


MASKS = ["encoder_eye_pad", "decoder_pad_padded_trial", "cross"]


@pytest.mark.parametrize("case", MASKS)
def test_wgmma_order_k2_matches_jax_k2(case):
    """The f32 wgmma K2's sums (``csrc/attention_bwd_f32.cuh``: every
    k-step of 8 from zero, then an f32 add; the output products' k-steps
    split between two warpgroups, ``emu.dot_3xtf32_wg``) against JAX's K2
    in interpret mode at D = 32, atol 1e-5; a padded trial's rows get
    exactly zero dq, as in JAX."""
    q, k, v, g, pad, static = _case(case)
    want = _jax_grads(q, k, v, g, pad, static)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static)
    got = _k2(tq, tk_, tv, key_pad, stat, tg, lse, scale,
              out_dots=emu.wgmma_dots(D))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0,
                                   err_msg=name)
    if case == "decoder_pad_padded_trial":
        assert not got[0][2].any() and not want[0][2].any()


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case", MASKS)
def test_wgmma_order_k2_matches_f32_plain_at_smoke_magnitudes(case, rate):
    """The wgmma K2's sums at the smoke run's magnitudes (randn operands,
    T = 200 = 3 x 64 + 8, the three mask cases, dropout 0 and 0.4 on the
    same Philox bits; 4 heads of 32, 3 trials) within 1e-5 of the port's
    f32 plain version, as the kernel is held on the card."""
    q, k, v, g, pad, static = _case(case, tq=200, seed=4,
                                    tk=180 if case == "cross" else None)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static)
    want = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                        H, scale, rate, 77)
    got = _k2(tq, tk_, tv, key_pad, stat, tg, lse, scale, rate, 77,
              out_dots=emu.wgmma_dots(D))
    worst = _worst(got, want)
    assert worst <= ATOL, worst


# 2 heads of 128: the D = 128 kernel's width (mm.yaml's hidden 256)
H128, D128 = 2, 128


@pytest.mark.parametrize("case", MASKS)
def test_wgmma_order_k2_d128_matches_jax_k2(case):
    """The D = 128 wgmma K2's sums (``csrc/attention_bwd_f32_d128.cuh``:
    every k-step of 8 from zero, then an f32 add; each warpgroup owning
    half of D of the transposed output products, ``emu.wgmma_dots(128)``)
    against JAX's K2 in interpret mode at 2 heads of 128, atol 1e-5; a
    padded trial's rows get exactly zero dq, as in JAX."""
    q, k, v, g, pad, static = _case(case, hidden=H128 * D128)
    want = _jax_grads(q, k, v, g, pad, static, heads=H128)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static, H128)
    got = _k2(tq, tk_, tv, key_pad, stat, tg, lse, scale, heads=H128,
              out_dots=emu.wgmma_dots(D128))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0,
                                   err_msg=name)
    if case == "decoder_pad_padded_trial":
        assert not got[0][2].any() and not want[0][2].any()


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case", MASKS)
def test_wgmma_order_k2_d128_matches_f32_plain_at_smoke_magnitudes(case,
                                                                  rate):
    """The D = 128 wgmma K2's sums at the smoke run's magnitudes (randn
    operands, T = 200: pass A's chunks of 64 keys and pass B's of 48
    queries, the last one partly past the end; the three mask cases,
    dropout 0 and 0.4 on the same Philox bits; 2 heads of 128, 3 trials)
    within 1e-5 of the port's f32 plain version, as the kernel is held on
    the card."""
    q, k, v, g, pad, static = _case(case, tq=200, seed=4,
                                    tk=180 if case == "cross" else None,
                                    hidden=H128 * D128)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static, H128)
    want = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                        H128, scale, rate, 77)
    got = _k2(tq, tk_, tv, key_pad, stat, tg, lse, scale, rate, 77,
              heads=H128, out_dots=emu.wgmma_dots(D128))
    worst = _worst(got, want)
    assert worst <= ATOL, worst


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_wgmma_order_few_keys_where_chained_sums_miss(width, rate):
    """Tq = 200 queries over Tk = 17 keys at each width the wgmma K2
    compiles (128 columns: 8, 4, 2 heads and 1): dk and dv are sums of 200
    large terms, over two chunks of pass B's columns at widths 32 and 64,
    and over five (each a running sum, one warpgroup's half of D) at 128.
    The wgmma K2's sums stay within 1e-5 of the f32 plain version, where
    chaining every term of every product into the truncating running sum
    misses at widths 32 and 64 (as the first mma.sync design did on the
    card)."""
    heads = 128 // width
    q, k, v, g, pad, static = _case("cross", tq=200, tk=17, seed=4,
                                    hidden=128)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static, heads)
    want = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                        heads, scale, rate, 5)
    got = _k2(tq, tk_, tv, key_pad, stat, tg, lse, scale, rate, 5,
              heads=heads, out_dots=emu.wgmma_dots(width))
    worst = _worst(got, want)
    assert worst <= ATOL, worst
    if width > 16:
        chained = _worst(_k2(tq, tk_, tv, key_pad, stat, tg, lse, scale,
                             rate, 5, dot=emu.dot_3xtf32_chained,
                             heads=heads), want)
        assert chained > ATOL, chained


def test_wgmma_order_splits_k_as_the_kernel():
    """``dot_3xtf32_wg`` on exact small integers equals the plain product
    (every split and order sums them exactly), at K past one chunk and
    not a multiple of 8; and the permuted k order puts column 2 t at t and
    2 t + 1 at t + 4."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-8, 8, (5, 250)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 8, (250, 7)).astype(np.float32))
    for cols in (104, 56, 40, 24):
        assert torch.equal(emu.dot_3xtf32_wg(a, b, cols), a @ b)
    assert [emu.perm_k(j) for j in range(8)] == [0, 4, 1, 5, 2, 6, 3, 7]


@pytest.mark.parametrize("case", ["encoder_eye_pad", "cross"])
def test_one_term_tf32_misses_the_gate(case):
    """Negative control: the same formula with one TF32 term a product
    (no lo parts) lands outside 1e-5 of the f32 plain version, so the
    tests above can tell 3xTF32 from plain TF32."""
    q, k, v, g, pad, static = _case(case, B=2, tq=200, seed=5)
    tq, tk_, tv, key_pad, stat, tg, lse, scale = _operands(
        q, k, v, g, pad, static)
    want = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                        H, scale)
    one = _worst(_k2(tq, tk_, tv, key_pad, stat, tg, lse, scale,
                     dot=emu.dot_1xtf32), want)
    three = _worst(_k2(tq, tk_, tv, key_pad, stat, tg, lse, scale), want)
    assert one > 10 * ATOL, one
    assert three <= ATOL, three


def test_tf32_rounding_is_to_nearest_ties_away():
    """``tf32`` rounds as ``cvt.rna.tf32.f32``: to the nearest value with
    10 mantissa bits, halfway cases away from zero, for either sign; the
    split x = hi + lo is exact."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, -(one + ulp / 2), 3.0e-3, -7.7],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + 2 * ulp, -(one + ulp)],
                        dtype=torch.float32)
    got = emu.tf32(x)
    assert torch.equal(got[:4], want)
    mant = got.view(torch.int32) & 0x1FFF
    assert not mant.any()
    hi = emu.tf32(x)
    assert torch.equal(hi + (x - hi), x)
    assert ((x - got).abs() <= got.abs() * 2.0 ** -11).all()


def test_tf32_rounding_keeps_nan_and_infinity():
    """``tf32`` of a NaN is a NaN, whatever its bits (half an ulp added to
    0x7FFFFFFF would carry into the sign and give -0, to 0xFFFFFFFF +0, to
    0x7F800001 an infinity); an infinity stays itself, and a finite value
    past the largest TF32 rounds to an infinity, as ``cvt.rna`` gives."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7F800001, 0x7FC00000,
                         0x7F800000, -0x800000, 0x7F7FFFFF],
                        dtype=torch.int32)
    got = emu.tf32(bits.view(torch.float32))
    assert torch.isnan(got[:4]).all()
    assert got[4].item() == math.inf and got[5].item() == -math.inf
    assert got[6].item() == math.inf


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k2_alignment_rule(dtype):
    """The wrapper's ``cp.async`` rule, on either dtype: data pointer and
    batch and row strides 16-byte aligned; the fused-QKV column views pass,
    a view one element off or a row stride half a chunk off raises
    ``ValueError``."""
    hidden = H * D
    qkv = torch.zeros(2, 9, 3 * hidden, dtype=dtype)
    q, k, v = qkv.split(hidden, dim=-1)
    tatt._check_aligned("attention_bwd", q=q, k=k, v=v)
    per = 16 // qkv.element_size()
    off = torch.zeros(2, 9, hidden + per, dtype=dtype)[..., 1:1 + hidden]
    odd = torch.zeros(2, 9, hidden + per // 2, dtype=dtype)[..., :hidden]
    for bad in (off, odd):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tatt._check_aligned("attention_bwd", q=q, k=bad, v=v)


def test_k2_scratch_holds_the_mask_bytes_for_both_dtypes():
    """K2's scratch, the wgmma kernels' of both dtypes at every width (the
    default route, ``k2_route``'s only one since the mma.sync pair's
    removal): rowsum (B, H, Tq) f32, then the keep bytes both passes read
    (one bit per query and key: ceil(Tk / 8) rows of Tq rounded up to 16
    bytes) and 16 bytes of alignment slack. Every route is held in
    ``tests/test_torch_k2_plan.py``."""
    B, Hh, Tq, Tk = 256, 8, 200, 200
    for dtype in (torch.float32, torch.bfloat16):
        assert tatt.k2_route(dtype, 128) == "wgmma"
    n = tatt._k2_scratch_floats(B, Hh, Tq, Tk)
    mask_bytes = B * Hh * 25 * 208             # ceil(200 / 8) rows of 208
    assert n * 4 >= B * Hh * Tq * 4 + mask_bytes + 12
    assert n == B * Hh * Tq + (mask_bytes + 16) // 4
