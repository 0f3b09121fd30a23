"""The arithmetic of the f32 tensor-core K1 (3xTF32), on the CPU.

The card cannot be reached from here, so this file holds the f32 K1's
arithmetic before it reaches one: ``tf32_emulation.k1`` is K1's formula
with both products emulated as the kernel computes them (TF32 by bit
masking, the three terms in ``mma_3xtf32``'s order, each mma's sum
truncated to f32 as the tensor cores do) and its online softmax over
64-key tiles, held within the kernel's gate, atol 1e-5 on out and lse,

- against JAX's K1 (``_attn_fwd_kernel`` in interpret mode, f32 dots,
  through ``_mha_impl(with_lse=True)``) at D = 32 for the
  encoder-eye-pad, padded-trial and cross cases, with 70 query rows so
  that a 64-row tile is crossed;
- against the port's f32 ``attention_reference`` at the smoke run's
  magnitudes (randn operands, T = 200, dropout 0 and 0.4 on the same
  Philox bits).

A negative control shows the tests see what matters: one-term TF32
(``tf32(a) . tf32(b)``) misses the gate. The emulation takes exp from
torch, where the kernel takes ``ex2.approx``. Beside them: a padded trial
comes out as the mean of the kept V with lse -1e6 + log(Tk); K1's lse is
built from the very scores the f32 K2 recomputes (pass A's 3xTF32
products on the same operands); and ``attention_fwd`` checks the
``cp.async`` alignment rule in both dtypes before it reaches the kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    return emu.k1(q, k, v, key_pad, static, H, SCALE, rate, seed, dot=dot)


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
    """At the smoke run's magnitudes (randn q, k, v; T = 200 = 3 x 64 + 8;
    8 heads of 32 there, 4 here; the encoder's eye-and-pad mask) the
    3xTF32 emulation stays within 1e-5 of the port's f32 plain version on
    the same Philox bits, out and lse (measured 6.6e-7 / 9.5e-7 at rate 0,
    1.4e-6 / 9.5e-7 at 0.4)."""
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
    -1e30, each tile's p is exactly 1 and l = Tk, so the rows are the mean
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
    """``attention_fwd`` checks the ``cp.async`` rule in both dtypes before
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
