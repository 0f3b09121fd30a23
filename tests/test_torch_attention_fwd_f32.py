"""The arithmetic of the f32 tensor-core K1 (3xTF32), on the CPU.

The card cannot be reached from here, so this file holds the f32 K1's
arithmetic before it reaches one: ``tf32_emulation.k1_wgmma`` is the
formula of the f32 K1 at head widths 16, 32 and 64
(``csrc/attention_fwd_f32.cuh``) with both products emulated as the kernel
computes them (TF32 by bit masking, the three terms of a k-step summed from
zero, each mma's sum truncated to f32 as the tensor cores do) and its
online softmax over chunks of 104 keys (56 at 64), held within the
kernel's gate, atol 1e-5 on out and lse,

- against JAX's K1 (``_attn_fwd_kernel`` in interpret mode, f32 dots,
  through ``_mha_impl(with_lse=True)``) at D = 32 for the
  encoder-eye-pad, padded-trial and cross cases, with 70 query rows so
  that a 64-row tile is crossed, and at D = 8, 16, 24, 32 and 64 (8 and 24
  through the wrapper's zero padding to 16 and 32) at dropout 0 and 0.4
  (JAX's draw replaced, in the test only, by the same Philox bits computed
  in jnp inside the kernel, ``_jnp_keep``);
- against the port's f32 ``attention_reference`` at the smoke run's
  magnitudes (randn operands, T = 200, dropout 0 and 0.4 on the same
  Philox bits) and at key lengths around the kernel's chunks.

A negative control shows the tests see what matters: one-term TF32
(``tf32(a) . tf32(b)``) misses the gate. The emulation takes exp from
torch, where the kernel takes ``ex2.approx``. Beside them: a padded trial
comes out as the mean of the kept V with lse -1e6 + log(Tk); K1's lse is
built from the very scores the f32 K2 recomputes (pass A's 3xTF32
products on the same operands, ``csrc/tiles_f32.cuh``); and
``attention_fwd`` checks the TMA alignment rule in both dtypes before it
reaches the kernel.

The f32 K1 at head width 128 (``csrc/attention_fwd_f32_d128.cuh``: chunks
of 128 keys split between two warpgroups that keep their own softmax
statistics until a head's end, o taken transposed;
``tf32_emulation.k1_wgmma128``) is held
the same way at 1 and 2 heads of 128: against JAX's K1 in interpret mode
at dropout 0 and 0.4, against the f32 plain version at the smoke's
magnitudes and at key lengths around its chunks, and its lse against the
scores the f32 K2 at 128 recomputes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tf32_emulation as emu
import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

ATOL = 1e-5          # the f32 K1's gate on the card (chip_smoke.py)
H, D = 4, 32
SCALE = 1.0 / math.sqrt(D)


def _case(case, B=3, tq=70, seed=0, tk=None):
    """numpy q, k, v, key_pad (B, Tk) and static (Tq, Tk) or None; 70
    rows cross a 64-row tile."""
    tk = tk or (28 if case == "cross" else tq)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, tq, H * D)).astype(np.float32)
    k, v = (rng.normal(size=(B, tk, H * D)).astype(np.float32)
            for _ in range(2))
    pad = np.ones((B, tk), np.int32)
    pad[1, tk - 5:] = 0
    if case == "encoder_eye_pad":
        static = np.eye(tq, tk, dtype=np.int32)
    elif case == "decoder_pad_padded_trial":
        pad[B - 1] = 0                      # every key of the last trial
        static = None
    else:                                   # cross, Tq != Tk
        static = (rng.random((tq, tk)) > 0.7).astype(np.int32)
    return q, k, v, pad, static


def _operands(q, k, v, pad, static):
    """torch q, k, v and the kernel's masks."""
    spec = tatt.MaskSpec(
        key_pad=torch.from_numpy(pad),
        static=None if static is None else torch.from_numpy(static))
    key_pad, stat = tatt.spec_operands(spec, q.shape[0], q.shape[1],
                                       k.shape[1], "cpu")
    return (*(torch.from_numpy(x) for x in (q, k, v)), key_pad, stat)


def _k1(q, k, v, key_pad, static, rate=0.0, seed=0, dot=emu.dot_3xtf32):
    return emu.k1_wgmma(q, k, v, key_pad, static, H, SCALE, rate, seed,
                        dot=dot)


def _worst(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["encoder_eye_pad",
                                  "decoder_pad_padded_trial", "cross"])
def test_3xtf32_k1_matches_jax_k1(case):
    """The 3xTF32 emulation against JAX's K1 in interpret mode (f32 dots,
    the lse sidecar's row 0), D = 32, dropout 0: out and lse within atol
    1e-5."""
    q, k, v, pad, static = _case(case)
    tq_, tk_, tv, key_pad, stat = _operands(q, k, v, pad, static)
    B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
    out, ml = jatt._mha_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(key_pad.numpy()).reshape(B, 1, Tk),
        jnp.asarray(stat.numpy()).reshape(1, Tq, Tk),
        jnp.zeros((1, 1), jnp.int32), SCALE, 0.0, H, D, with_lse=True)
    got, lse = _k1(tq_, tk_, tv, key_pad, stat)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL,
                               rtol=0, err_msg="out")
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ml)[:, 0, :].reshape(B, H, Tq),
                               atol=ATOL, rtol=0, err_msg="lse")


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_3xtf32_k1_matches_f32_plain_at_smoke_magnitudes(rate):
    """At the smoke run's magnitudes (randn q, k, v; T = 200, two chunks of
    the kernel; 8 heads of 32 there, 4 here; the encoder's eye-and-pad
    mask) the 3xTF32 emulation stays within 1e-5 of the port's f32 plain
    version on the same Philox bits, out and lse."""
    q, k, v, pad, static = _case("encoder_eye_pad", B=2, tq=200, seed=4)
    ops = _operands(q, k, v, pad, static)
    want = tatt.attention_reference(*ops, H, SCALE, True, rate, 77)
    got = _k1(*ops, rate, 77)
    worst = _worst(got, want)
    assert worst <= ATOL, worst


@pytest.mark.parametrize("case", ["encoder_eye_pad", "cross"])
def test_one_term_tf32_misses_the_k1_gate(case):
    """Negative control: the same formula with one TF32 term a product
    (no lo parts) lands outside 1e-5 of the f32 plain version by more than
    10x (measured 3e-4 to 1.4e-3), so the tests above can tell 3xTF32
    from plain TF32."""
    q, k, v, pad, static = _case(case, B=2, tq=200, seed=5)
    ops = _operands(q, k, v, pad, static)
    want = tatt.attention_reference(*ops, H, SCALE, True)
    one = _worst(_k1(*ops, dot=emu.dot_1xtf32), want)
    three = _worst(_k1(*ops), want)
    assert one > 10 * ATOL, one
    assert three <= ATOL, three


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_3xtf32_k1_padded_trial_is_the_mean_of_the_kept_v(rate):
    """A padded trial (every key masked, pad-only mask): every score is
    -1e30, each chunk's p is exactly 1 and l = Tk, so the rows are the mean
    of V (of the kept V / (1 - rate) with dropout) and lse is exactly
    the plain version's -1e6 + log(Tk)."""
    q, k, v, pad, static = _case("decoder_pad_padded_trial", B=2, tq=70,
                                 seed=6)
    ops = _operands(q, k, v, pad, static)
    got, lse = _k1(*ops, rate, 9)
    _, want_lse = tatt.attention_reference(*ops, H, SCALE, True, rate, 9)
    vh = ops[2][1].reshape(70, H, D).transpose(0, 1)          # (H, Tk, D)
    keep = torch.ones(H, 70, 70, dtype=torch.bool)
    if rate > 0.0:
        keep = tatt.philox_keep(9, 2, H, 70, 70, rate)[1]
    mean = (keep.float() * (1.0 / (1.0 - rate))) @ vh / 70   # (H, Tq, D)
    torch.testing.assert_close(got[1].reshape(70, H, D).transpose(0, 1),
                               mean, atol=ATOL, rtol=0)
    assert torch.equal(lse[1], want_lse[1])
    assert torch.equal(lse[1], torch.full((H, 70), -1e6) + math.log(70))


def test_3xtf32_k1_lse_is_built_from_the_scores_k2_recomputes():
    """K2's pass A recomputes s with the same 3xTF32 products of the same
    operands (q * scale and k split alike), so K1's lse summarises exactly
    those scores: with one key, lse equals that s bit for bit (m = s, p =
    1, log l = 0), where the plain version's cuBLAS-order s can differ in
    the last bits; with 70 keys every row of exp(s - lse) sums to 1
    within 1e-6."""
    for tk, tol in ((1, 0.0), (70, 1e-6)):
        q, k, v, pad, static = _case("cross", B=2, tq=70, seed=8, tk=tk)
        pad[:] = 1                                   # every row attends
        tq_, tk_, tv, key_pad, stat = _operands(q, k, v, pad, static)
        _, lse = _k1(tq_, tk_, tv, key_pad, stat)
        qs = tatt._heads(tq_, H) * SCALE
        s = emu.dot_3xtf32(qs, tatt._heads(tk_, H).transpose(-1, -2))
        if tk == 1:
            assert torch.equal(lse, s[..., 0])
        sums = torch.exp(s - lse[..., None]).sum(-1)
        assert (sums - 1).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k1_alignment_rule(dtype, monkeypatch):
    """``attention_fwd`` checks the TMA alignment rule in both dtypes before
    it reaches the kernel: the fused-QKV column views pass (and go on to
    the library, stubbed here), a view one element off or a row stride
    half a chunk off raises ``ValueError``. The device check is stubbed so
    that CPU tensors get that far."""
    class Reached(Exception):
        pass

    def lib(head_dim=32):
        raise Reached

    monkeypatch.setattr(tatt, "_check_operands",
                        lambda name, q, k, *args: (q.shape[0], q.shape[1],
                                                   k.shape[1], q.shape[2]))
    monkeypatch.setattr(tatt, "_k1_lib", lib)
    hidden = H * D
    qkv = torch.zeros(2, 9, 3 * hidden, dtype=dtype)
    q, k, v = qkv.split(hidden, dim=-1)
    key_pad, static = tatt.spec_operands(None, 2, 9, 9, "cpu")
    n0 = tatt.K1_LAUNCHES
    with pytest.raises(Reached):
        tatt.attention_fwd(q, k, v, key_pad, static, H, 1.0)
    per = 16 // qkv.element_size()
    off = torch.zeros(2, 9, hidden + per, dtype=dtype)[..., 1:1 + hidden]
    odd = torch.zeros(2, 9, hidden + per // 2, dtype=dtype)[..., :hidden]
    for bad in (off, odd):
        for args in ((bad, k, v), (q, bad, v), (q, k, bad)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                tatt.attention_fwd(*args, key_pad, static, H, 1.0)
    assert tatt.K1_LAUNCHES == n0


# ---------------------------------------------------------------------------
# the f32 K1 at head width 128 (csrc/attention_fwd_f32_d128.cuh)
# ---------------------------------------------------------------------------

D128 = 128
SCALE128 = 1.0 / math.sqrt(D128)


def _case128(case, heads, tq=70, tk=None, B=2, seed=0):
    """numpy q, k, v (B, T, heads*128), key_pad, static for the cases of
    ``_case``; ``cross`` with a random mask over its own key length."""
    tk = tk or tq
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, tq, heads * D128)).astype(np.float32)
    k, v = (rng.normal(size=(B, tk, heads * D128)).astype(np.float32)
            for _ in range(2))
    pad = np.ones((B, tk), np.int32)
    pad[B - 1, max(tk - 5, 1):] = 0
    if case == "encoder_eye_pad":
        static = np.eye(tq, tk, dtype=np.int32)
    elif case == "decoder_pad_padded_trial":
        pad[B - 1] = 0                      # every key of the last trial
        static = None
    else:
        static = (rng.random((tq, tk)) > 0.7).astype(np.int32)
    return q, k, v, pad, static


def _mulhi(a, b):
    """The high 32 bits of the 64-bit product of uint32 arrays, from 16-bit
    halves (no 64-bit integers)."""
    al, ah, bl, bh = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    ll, hl, lh = al * bl, ah * bl, al * bh
    mid = (ll >> 16) + (hl & 0xFFFF) + (lh & 0xFFFF)
    return ah * bh + (hl >> 16) + (lh >> 16) + (mid >> 16)


def _jnp_keep(seed, b, h, q, k, rate):
    """``tatt.philox_keep``'s bits (``csrc/philox.cuh``: word k % 4 of
    Philox4x32-10 at counter (k / 4, q, h, b), key (seed, 0)) in jnp uint32
    arithmetic, so that they can be drawn inside a Pallas kernel."""
    u = jnp.uint32
    c0, c1, c2, c3 = ((k >> 2).astype(u), q.astype(u), h.astype(u),
                      b.astype(u))
    k0, k1 = u(seed & 0xFFFFFFFF), u(0)
    for _ in range(10):
        hi0, lo0 = _mulhi(u(0xD2511F53), c0), u(0xD2511F53) * c0
        hi1, lo1 = _mulhi(u(0xCD9E8D57), c2), u(0xCD9E8D57) * c2
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = k0 + u(0x9E3779B9), k1 + u(0xBB67AE85)
    j = k & 3
    word = jnp.where(j == 0, c0, jnp.where(j == 1, c1,
                                           jnp.where(j == 2, c2, c3)))
    return word > u(tatt.dropout_threshold(rate))


def test_jnp_keep_is_philox_keep():
    """The jnp draw gives ``philox_keep``'s bits, keys past a multiple of
    4 and a 63-bit seed included."""
    B, heads, tq, tk, seed = 2, 2, 9, 13, 2 ** 40 + 77
    grid = jnp.meshgrid(*(jnp.arange(n) for n in (B, heads, tq, tk)),
                        indexing="ij")
    got = np.asarray(_jnp_keep(seed, *grid, 0.4))
    want = tatt.philox_keep(seed, B, heads, tq, tk, 0.4).numpy()
    assert (got == want).all()


def _jax_k1_128(q, k, v, pad, static, heads, rate, seed, monkeypatch):
    """``_jax_k1`` at head width 128."""
    return _jax_k1(q, k, v, pad, static, heads, D128, rate, seed,
                   monkeypatch)


def _jax_k1(q, k, v, pad, static, heads, d, rate, seed, monkeypatch):
    """JAX's K1 (``_mha_impl(with_lse=True)``, interpret mode) at head
    width d, scale 1 / sqrt(d): (out, lse (B, H, Tq)). With dropout its keep mask is the
    port's Philox draw: the kernel's ``_dropout_mask`` is replaced for this
    call by ``_jnp_keep`` over the grid step's (batch, head-stacked row,
    key) and its TPU seeding by nothing (interpret mode on the CPU has no
    ``prng_seed``)."""
    B, tq, _ = q.shape
    tk = k.shape[1]
    if static is None:
        static = np.zeros((tq, tk), np.int32)
    if rate > 0.0:
        def keep(shape, r):
            iota = [jax.lax.broadcasted_iota(jnp.int32, shape, i)
                    for i in range(3)]
            b = pl.program_id(0) * shape[0] + iota[0]
            return _jnp_keep(seed, b, iota[1] // tq, iota[1] % tq, iota[2],
                             r)

        monkeypatch.setattr(jatt, "_dropout_mask", keep)
        monkeypatch.setattr(jatt.pltpu, "prng_seed", lambda *args: None)
    out, ml = jatt._mha_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pad).reshape(B, 1, tk),
        jnp.asarray(static).reshape(1, tq, tk), jnp.zeros((1, 1), jnp.int32),
        1.0 / math.sqrt(d), rate, heads, d, with_lse=True)
    return np.asarray(out), np.asarray(ml)[:, 0, :].reshape(B, heads, tq)


def _k1_128(q, k, v, pad, static, heads, rate=0.0, seed=0):
    ops = _operands(q, k, v, pad, static)
    return ops, emu.k1_wgmma128(*ops, heads, SCALE128, rate, seed)


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("heads,case,tq,tk", [
    (1, "encoder_eye_pad", 140, 140),
    (2, "decoder_pad_padded_trial", 70, 70),
    (2, "cross", 70, 150)])
def test_wgmma128_k1_matches_jax_k1(heads, case, tq, tk, rate, monkeypatch):
    """The head-width-128 kernel's order (chunks of 128 keys, 64 a
    warpgroup: at 70 keys one chunk with the second warpgroup's 6 keys, at
    140 and 150 a rescale of each warpgroup's statistics; 64-query tiles
    crossed at 70 and 140) against JAX's K1 in interpret mode on the same
    numpy inputs and the same Philox bits: out and lse within atol 1e-5."""
    q, k, v, pad, static = _case128(case, heads, tq, tk, seed=tq + tk)
    want, want_lse = _jax_k1_128(q, k, v, pad, static, heads, rate, 21,
                                 monkeypatch)
    _, (got, lse) = _k1_128(q, k, v, pad, static, heads, rate, 21)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                               err_msg="out")
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=0,
                               err_msg="lse")


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_wgmma128_k1_matches_f32_plain_at_smoke_magnitudes(rate):
    """At the smoke's magnitudes (randn q, k, v; T = 200 = 128 + 72, two
    chunks; 2 heads of 128, the mm.yaml model's; the encoder's eye-and-pad
    mask) the head-width-128 kernel's order stays within 1e-5 of the f32
    plain version on the same Philox bits, out and lse."""
    q, k, v, pad, static = _case128("encoder_eye_pad", 2, 200, seed=4)
    ops, got = _k1_128(q, k, v, pad, static, 2, rate, 77)
    want = tatt.attention_reference(*ops, 2, SCALE128, True, rate, 77)
    worst = _worst(got, want)
    assert worst <= ATOL, worst


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tk", [1, 63, 64, 65, 200, 209, 520])
def test_wgmma128_k1_key_lengths(tk, rate):
    """Key lengths below, at and past the kernel's 64 keys a warpgroup and
    128 a chunk (up to 64 the second warpgroup has no key and its
    statistics drop out of the combination; 209: a last chunk of 81 keys,
    the second warpgroup's 17, whose last k-step of 8 holds one; 520: five
    chunks), 2 heads of 128, a random mask and a padded key tail: within
    1e-5 of the f32 plain version, out and lse."""
    q, k, v, pad, static = _case128("cross", 2, 37, tk, seed=tk)
    ops, got = _k1_128(q, k, v, pad, static, 2, rate, 5)
    want = tatt.attention_reference(*ops, 2, SCALE128, True, rate, 5)
    worst = _worst(got, want)
    assert worst <= ATOL, worst


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_wgmma128_k1_padded_trial_is_the_mean_of_the_kept_v(rate):
    """A padded trial at head width 128 over two chunks: every score is
    -1e30, so both warpgroups' maxima are -1e30, p is 1 on every key and
    l = Tk; the rows are the mean of (the kept) V and lse is -1e6 +
    log(Tk) exactly."""
    tq = tk = 140
    q, k, v, pad, static = _case128("decoder_pad_padded_trial", 2, tq,
                                    seed=6)
    ops, (got, lse) = _k1_128(q, k, v, pad, static, 2, rate, 9)
    vh = ops[2][1].reshape(tk, 2, D128).transpose(0, 1)        # (H, Tk, D)
    keep = torch.ones(2, tq, tk, dtype=torch.bool)
    if rate > 0.0:
        keep = tatt.philox_keep(9, 2, 2, tq, tk, rate)[1]
    mean = (keep.float() * (1.0 / (1.0 - rate))) @ vh / tk    # (H, Tq, D)
    torch.testing.assert_close(got[1].reshape(tq, 2, D128).transpose(0, 1),
                               mean, atol=ATOL, rtol=0)
    assert torch.equal(lse[1], torch.full((2, tq), -1e6) + math.log(tk))


@pytest.mark.parametrize("tk", [1, 200])
def test_wgmma128_k1_lse_is_what_the_k2_recompute_sums_to_one(tk):
    """The f32 K2 at 128 recomputes s as ``dot_3xtf32`` of the same splits
    (``emu.k2`` with ``wgmma_dots(128)``), the products the head-width-128
    K1 summarised: with one key its lse equals that s bit for bit; over
    two chunks every row of exp(s - lse) sums to 1 within 1e-6, and K2's
    emulation on this lse stays within 1e-5 of the plain backward."""
    q, k, v, pad, static = _case128("cross", 2, 70, tk, seed=8)
    pad[:] = 1                                   # every row attends
    ops, (_, lse) = _k1_128(q, k, v, pad, static, 2)
    qs = tatt._heads(ops[0], 2) * SCALE128
    s = emu.dot_3xtf32(qs, tatt._heads(ops[1], 2).transpose(-1, -2))
    if tk == 1:
        assert torch.equal(lse, s[..., 0])
    sums = torch.exp(s - lse[..., None]).sum(-1)
    assert (sums - 1).abs().max().item() <= 1e-6
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=q.shape).astype(np.float32))
    got = emu.k2(*ops, g, lse, 2, SCALE128, out_dots=emu.wgmma_dots(128))
    want = tatt.attention_bwd_reference(*ops, g, lse, 2, SCALE128)
    assert _worst(got, want) <= ATOL


# ---------------------------------------------------------------------------
# the f32 K1 at head widths 16-64 (csrc/attention_fwd_f32.cuh), and 8 and 24
# through the wrapper's padding
# ---------------------------------------------------------------------------


def _case_w(case, heads, d, tq, tk, B=2, seed=0):
    """numpy q, k, v (B, T, heads*d), key_pad, static for the cases of
    ``_case``; ``cross`` with a random mask over its own key length."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, tq, heads * d)).astype(np.float32)
    k, v = (rng.normal(size=(B, tk, heads * d)).astype(np.float32)
            for _ in range(2))
    pad = np.ones((B, tk), np.int32)
    pad[B - 1, max(tk - 5, 1):] = 0
    if case == "encoder_eye_pad":
        static = np.eye(tq, tk, dtype=np.int32)
    elif case == "decoder_pad_padded_trial":
        pad[B - 1] = 0                      # every key of the last trial
        static = None
    else:
        static = (rng.random((tq, tk)) > 0.7).astype(np.int32)
    return q, k, v, pad, static


def _k1_wg(q, k, v, pad, static, heads, d, rate=0.0, seed=0):
    """The torch operands and the kernel's order at head width d: widths
    other than 16, 32 and 64 zero-padded to the next of them as
    ``padded_attention_fwd`` pads them, the scale the true width's, and
    the padding dropped from out."""
    ops = _operands(q, k, v, pad, static)
    width = tatt.kernel_head_dim(d)
    qp, kp, vp = (tatt.pad_heads(x, heads, width) for x in ops[:3])
    out, lse = emu.k1_wgmma(qp, kp, vp, ops[3], ops[4], heads,
                            1.0 / math.sqrt(d), rate, seed)
    return ops, (tatt.unpad_heads(out, heads, d), lse)


# (head width, mask case, Tq, Tk): 8 and 24 run padded; 24 over 90 keys is
# one chunk of 104, 32 over 230 three, 64 over 150 three of 56
WG_JAX_CASES = [(8, "encoder_eye_pad", 70, 70),
                (16, "decoder_pad_padded_trial", 70, 70),
                (24, "cross", 70, 90),
                (32, "cross", 70, 230),
                (64, "cross", 70, 150)]


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("d,case,tq,tk", WG_JAX_CASES)
def test_wgmma_k1_matches_jax_k1(d, case, tq, tk, rate, monkeypatch):
    """The kernel's order at head widths 8-64 (its chunks and their online
    rescale; 64-query tiles crossed at 70) against JAX's K1 in
    interpret mode at the true width on the same numpy inputs and the same
    Philox bits, 2 heads: out and lse within atol 1e-5."""
    q, k, v, pad, static = _case_w(case, 2, d, tq, tk, seed=d + tk)
    want, want_lse = _jax_k1(q, k, v, pad, static, 2, d, rate, 31,
                             monkeypatch)
    _, (got, lse) = _k1_wg(q, k, v, pad, static, 2, d, rate, 31)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                               err_msg="out")
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=0,
                               err_msg="lse")


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 64])
def test_wgmma_k1_matches_f32_plain_at_smoke_magnitudes(d, rate):
    """At the smoke's magnitudes (randn q, k, v; T = 200: two chunks at D <=
    32, four at 64; 256 // D heads, the mm.yaml model's; the encoder's
    eye-and-pad mask) the kernel's order stays within 1e-5 of the f32
    plain version on the same Philox bits, out and lse."""
    heads = 256 // d
    q, k, v, pad, static = _case_w("encoder_eye_pad", heads, d, 200, 200,
                                   seed=4)
    ops, got = _k1_wg(q, k, v, pad, static, heads, d, rate, 77)
    want = tatt.attention_reference(*ops, heads, 1.0 / math.sqrt(d), True,
                                    rate, 77)
    worst = _worst(got, want)
    assert worst <= ATOL, worst


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tk", [1, 8, 200, 208, 209, 256, 520])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wgmma_k1_key_lengths(d, tk, rate):
    """Key lengths below, at and past the kernel's chunks (104 keys at D <=
    32, 56 at 64; 1 and 8: part of a k-step group; 208: two chunks at D <=
    32; 209: a last chunk of one key; 520: five and ten chunks), 2 heads, a
    random mask and a padded key tail: within 1e-5 of the f32 plain
    version, out and lse."""
    q, k, v, pad, static = _case_w("cross", 2, d, 37, tk, seed=tk + d)
    ops, got = _k1_wg(q, k, v, pad, static, 2, d, rate, 5)
    want = tatt.attention_reference(*ops, 2, 1.0 / math.sqrt(d), True, rate,
                                    5)
    worst = _worst(got, want)
    assert worst <= ATOL, worst


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("d", [16, 64])
def test_wgmma_k1_padded_trial_is_the_mean_of_the_kept_v(d, rate):
    """A padded trial over 140 keys (two chunks at 16, three at 64): every
    score is -1e30, so p is 1 on every key and l = Tk; the rows are the
    mean of (the kept) V and lse is -1e6 + log(Tk) exactly."""
    tq = tk = 140
    q, k, v, pad, static = _case_w("decoder_pad_padded_trial", 2, d, tq,
                                   tk, seed=6)
    ops, (got, lse) = _k1_wg(q, k, v, pad, static, 2, d, rate, 9)
    vh = ops[2][1].reshape(tk, 2, d).transpose(0, 1)           # (H, Tk, D)
    keep = torch.ones(2, tq, tk, dtype=torch.bool)
    if rate > 0.0:
        keep = tatt.philox_keep(9, 2, 2, tq, tk, rate)[1]
    mean = (keep.float() * (1.0 / (1.0 - rate))) @ vh / tk    # (H, Tq, D)
    torch.testing.assert_close(got[1].reshape(tq, 2, d).transpose(0, 1),
                               mean, atol=ATOL, rtol=0)
    assert torch.equal(lse[1], torch.full((2, tq), -1e6) + math.log(tk))


@pytest.mark.parametrize("tk", [1, 200])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wgmma_k1_lse_is_what_the_k2_recompute_sums_to_one(d, tk):
    """The f32 K2 at 16-64 recomputes s as ``dot_3xtf32`` of the same
    splits (``emu.k2`` with ``wgmma_dots(d)``), the products this K1
    summarised: with one key its lse equals that s bit for bit; over 200
    keys every row of exp(s - lse) sums to 1 within 1e-6, and K2's
    emulation on this lse stays within 1e-5 of the plain backward."""
    q, k, v, pad, static = _case_w("cross", 2, d, 70, tk, seed=8 + d)
    pad[:] = 1                                   # every row attends
    ops, (_, lse) = _k1_wg(q, k, v, pad, static, 2, d)
    scale = 1.0 / math.sqrt(d)
    qs = tatt._heads(ops[0], 2) * scale
    s = emu.dot_3xtf32(qs, tatt._heads(ops[1], 2).transpose(-1, -2))
    if tk == 1:
        assert torch.equal(lse, s[..., 0])
    sums = torch.exp(s - lse[..., None]).sum(-1)
    assert (sums - 1).abs().max().item() <= 1e-6
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=q.shape).astype(np.float32))
    got = emu.k2(*ops, g, lse, 2, scale, out_dots=emu.wgmma_dots(d))
    want = tatt.attention_bwd_reference(*ops, g, lse, 2, scale)
    assert _worst(got, want) <= ATOL
