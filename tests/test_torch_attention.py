"""Port attention (``ops/attention.py``) against the JAX package.

The plain version ``attention_reference`` and the ``multi_head_attention``
dispatch run on the CPU against JAX ``multi_head_attention`` with the
Pallas kernel K1 (interpret mode) and with the XLA oracle, and the lse
statistic against ``_mha_impl(with_lse=True)``; f32, atol 1e-5 (the two
sides sum the same f32 products in different orders). The K1/K2 kernels
themselves are CUDA-only: ``tests/test_torch_kernels.py`` holds them
against the plain versions on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

ATOL = 1e-5
B, TQ, TK, H, D = 3, 20, 20, 4, 16


def _spec_arrays(case, rng, b=B, tq=TQ, tk=TK):
    """(key_pad (B, Tk) or None, static (Tq, Tk) or None) numpy int32."""
    pad = np.ones((b, tk), np.int32)
    pad[1, tk - 5:] = 0                              # a padded tail
    if case == "enc_eye_pad":
        return pad, np.eye(tq, tk, dtype=np.int32)
    if case == "dec_pad":
        return pad, None
    if case == "causal":
        return (np.zeros((b, tk), np.int32),
                np.tril(np.ones((tq, tk), np.int32)))
    if case == "sep":
        half = np.repeat([0, 1], [tq // 2, tq - tq // 2])
        return pad, (half[:, None] != half[None, :tk]).astype(np.int32)
    if case == "fully_masked_row":
        pad = pad.copy()
        pad[2] = 0                                   # a padded trial
        return pad, None
    if case == "random":
        return ((rng.random((b, tk)) > 0.4).astype(np.int32),
                (rng.random((tq, tk)) > 0.7).astype(np.int32))
    if case == "no_spec":
        return None, None
    raise ValueError(case)


CASES = ("enc_eye_pad", "dec_pad", "causal", "sep", "fully_masked_row",
         "random", "no_spec")


def _qkv(seed, b=B, tq=TQ, tk=TK, hidden=H * D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, hidden)).astype(np.float32),
            rng.normal(size=(b, tk, hidden)).astype(np.float32),
            rng.normal(size=(b, tk, hidden)).astype(np.float32), rng)


def _both(case, impl, seed=0, tk=TK):
    q, k, v, rng = _qkv(seed, tk=tk)
    pad, static = _spec_arrays(case, rng, tk=tk)
    jspec = None if case == "no_spec" else jatt.MaskSpec(
        key_pad=None if pad is None else jnp.asarray(pad),
        static=None if static is None else jnp.asarray(static))
    tspec = None if case == "no_spec" else tatt.MaskSpec(
        key_pad=None if pad is None else torch.from_numpy(pad),
        static=None if static is None else torch.from_numpy(static))
    want = np.asarray(jatt.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, mask_spec=jspec,
        impl=impl))
    got = tatt.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
        mask_spec=tspec).numpy()
    return want, got, v, pad


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES)
def test_attention_matches_jax(case, impl):
    want, got, _, _ = _both(case, impl)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["enc_eye_pad", "dec_pad", "random"])
def test_cross_attention_tq_ne_tk_matches_jax(case):
    """Cross attention with Tk != Tq (static (Tq, Tk) rectangular)."""
    want, got, _, _ = _both(case, "pallas", seed=1, tk=28)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fully_masked_row_is_uniform():
    """A padded trial under a pad-only mask: every key is at -1e30, so the
    row is the plain mean of V (finite NEG_INF, not -inf -> NaN)."""
    _, got, v, _ = _both("fully_masked_row", "pallas")
    mean_v = v[2].mean(axis=0)
    np.testing.assert_allclose(got[2], np.broadcast_to(mean_v, got[2].shape),
                               atol=ATOL, rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("case", ["enc_eye_pad", "dec_pad", "causal",
                                  "fully_masked_row", "random"])
def test_lse_matches_jax_mha_impl(case):
    """lse (B, H, Tq) = max(m, -1e6) + log(l) against the Pallas forward's
    row-0 sidecar, laid out (B, 8, H*Tq)."""
    q, k, v, rng = _qkv(2)
    pad, static = _spec_arrays(case, rng)
    key_pad, stat = tatt.spec_operands(
        tatt.MaskSpec(None if pad is None else torch.from_numpy(pad),
                      None if static is None else torch.from_numpy(static)),
        B, TQ, TK, "cpu")
    scale = 1.0 / math.sqrt(D)
    out, ml = jatt._mha_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(key_pad.numpy()).reshape(B, 1, TK),
        jnp.asarray(stat.numpy()).reshape(1, TQ, TK),
        jnp.zeros((1, 1), jnp.int32), scale, 0.0, H, D, with_lse=True)
    got, lse = tatt.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_pad, stat, H, scale, with_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.reshape(B, H * TQ).numpy(),
                               np.asarray(ml)[:, 0, :], atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("form", ["mask", "bias"])
def test_full_mask_takes_plain_path(form):
    """A full (B, Tq, Tk) mask or bias rides the plain path, as in JAX."""
    q, k, v, rng = _qkv(3)
    mask = (rng.random((B, TQ, TK)) > 0.3).astype(np.int32)
    kw_j = {form: jnp.asarray(mask if form == "mask"
                              else np.where(mask, 0.0, -1e30))}
    kw_t = {form: torch.from_numpy(mask if form == "mask"
                                   else np.where(mask, 0.0, -1e30))}
    want = np.asarray(jatt.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, **kw_j))
    got = tatt.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
        **kw_t).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_spec_helpers_match_jax():
    rng = np.random.default_rng(4)
    for pad, static in [_spec_arrays(c, rng) for c in CASES]:
        jspec = jatt.MaskSpec(
            None if pad is None else jnp.asarray(pad),
            None if static is None else jnp.asarray(static))
        tspec = tatt.MaskSpec(
            None if pad is None else torch.from_numpy(pad),
            None if static is None else torch.from_numpy(static))
        np.testing.assert_array_equal(
            tatt.spec_to_bias(tspec, B, TQ, TK).numpy(),
            np.asarray(jatt.spec_to_bias(jspec, B, TQ, TK)))
    for fwd, back in [(-1, -1), (0, -1), (2, 3), (-1, 0), (5, 0)]:
        np.testing.assert_array_equal(
            tatt.create_context_mask(fwd, back, 12).numpy(),
            np.asarray(jatt.create_context_mask(fwd, back, 12)))


def test_fused_qkv_views_match_contiguous():
    """The q/k/v column views of one (B, T, 3*H*D) product (row stride
    3*H*D) give what contiguous copies give."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(B, TQ, 3 * H * D))
                           .astype(np.float32))
    q, k, v = qkv.split(H * D, dim=-1)
    assert q.stride(1) == 3 * H * D and not q.is_contiguous()
    spec = tatt.MaskSpec(key_pad=torch.ones(B, TQ, dtype=torch.int32),
                         static=torch.eye(TQ, dtype=torch.int32))
    a = tatt.multi_head_attention(q, k, v, H, mask_spec=spec)
    b = tatt.multi_head_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), H, mask_spec=spec)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_dropout_and_cpu_kernel_launch_raise():
    """Dropout runs on the CPU (the plain version, the kernels' Philox
    bits); a CPU tensor still cannot launch a kernel."""
    q = torch.randn(1, 4, 32, generator=torch.Generator().manual_seed(0))
    out = tatt.multi_head_attention(q, q, q, 2, dropout_rate=0.1, seed=3)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert not torch.equal(out, tatt.multi_head_attention(q, q, q, 2))
    pad, static = tatt.spec_operands(None, 1, 4, 4, "cpu")
    with pytest.raises(ValueError):
        tatt.attention_fwd(q, q, q, pad, static, 2, 0.25)
    with pytest.raises(ValueError):
        tatt.attention_bwd(q, q, q, pad, static, q, torch.zeros(1, 2, 4), 2,
                           0.25)
