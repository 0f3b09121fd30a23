"""The port's attention backward (K2's plain version and the autograd
Function) against JAX's, on the CPU.

``attention_bwd_reference`` on the port's forward ``lse`` and the whole
``_FlashAttention`` (through ``multi_head_attention`` with grad) are held
against ``jax.grad`` through JAX's ``multi_head_attention(impl="pallas")``,
which runs JAX's K2 (``_attn_bwd_kernel``) in interpret mode with f32 dots
(``ops/attention.py:431`` there). f32, atol 1e-5: the same f32 products
summed in other orders. Dropout is 0 on this comparison (JAX's interpret
mode draws no TPU bits); ``test_torch_dropout.py`` holds the dropout path.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

ATOL = 1e-5
B, TQ, H, D = 3, 20, 4, 16


def _case(case, seed=0):
    """numpy q, k, v, g, key_pad (B, Tk) and static (Tq, Tk) or None."""
    tk = 28 if case == "cross" else TQ
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, TQ, H * D)).astype(np.float32)
    k = rng.normal(size=(B, tk, H * D)).astype(np.float32)
    v = rng.normal(size=(B, tk, H * D)).astype(np.float32)
    g = rng.normal(size=(B, TQ, H * D)).astype(np.float32)
    pad = np.ones((B, tk), np.int32)
    pad[1, tk - 5:] = 0
    if case == "encoder_eye_pad":
        static = np.eye(TQ, tk, dtype=np.int32)
    elif case == "decoder_pad_padded_trial":
        pad[2] = 0                          # every key of trial 2 masked
        static = None
    else:                                   # cross, Tq != Tk
        static = (rng.random((TQ, tk)) > 0.7).astype(np.int32)
    return q, k, v, g, pad, static


def _jax_grads(q, k, v, g, pad, static):
    spec = jatt.MaskSpec(
        key_pad=jnp.asarray(pad),
        static=None if static is None else jnp.asarray(static))

    def f(q, k, v):
        out = jatt.multi_head_attention(q, k, v, H, mask_spec=spec,
                                        impl="pallas")
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _tspec(pad, static):
    return tatt.MaskSpec(
        key_pad=torch.from_numpy(pad),
        static=None if static is None else torch.from_numpy(static))


CASES = ["encoder_eye_pad", "decoder_pad_padded_trial", "cross"]


@pytest.mark.parametrize("case", CASES)
def test_bwd_reference_matches_jax_k2(case):
    q, k, v, g, pad, static = _case(case)
    want = _jax_grads(q, k, v, g, pad, static)
    tq, tk_, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    key_pad, stat = tatt.spec_operands(_tspec(pad, static), B, TQ,
                                       k.shape[1], "cpu")
    scale = 1.0 / math.sqrt(D)
    _, lse = tatt.attention_reference(tq, tk_, tv, key_pad, stat, H, scale,
                                      with_lse=True)
    got = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                       H, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0,
                                   err_msg=name)
    if case == "decoder_pad_padded_trial":
        # JAX's contract, kept: a fully-masked row gets zero gradient
        assert not got[0][2].any() and not want[0][2].any()
        assert not got[1][2].any() and not got[2][2].any()


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_function_matches_jax_grad(case):
    """The autograd Function as the model runs it (on the CPU it runs the
    plain versions), q/k/v as column views of one fused product."""
    q, k, v, g, pad, static = _case(case, seed=1)
    want = _jax_grads(q, k, v, g, pad, static)
    if case == "cross":
        tq = torch.from_numpy(q).requires_grad_(True)
        kv = torch.from_numpy(np.concatenate([k, v], -1))
        kv.requires_grad_(True)
        tk_, tv = kv.split(H * D, dim=-1)
        leaves, want = (tq, kv), [want[0], np.concatenate(want[1:], -1)]
    else:
        qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
        qkv.requires_grad_(True)
        tq, tk_, tv = qkv.split(H * D, dim=-1)
        leaves, want = (qkv,), [np.concatenate(want, -1)]
    out = tatt.multi_head_attention(tq, tk_, tv, H,
                                    mask_spec=_tspec(pad, static))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0)


def test_function_uses_the_lse_backward_not_autograd():
    """On a fully-masked row (a padded trial) the lse backward gives zero
    gradient; autograd through the plain forward would give the uniform
    row's: dv of that trial = mean over its queries of g, not zero."""
    q, k, v, g, pad, static = _case("decoder_pad_padded_trial", seed=2)
    spec = _tspec(pad, static)
    tq, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    tv = torch.from_numpy(v).requires_grad_(True)
    tg = torch.from_numpy(g)
    out = tatt.multi_head_attention(tq, tk_, tv, H, mask_spec=spec)
    (dv,) = torch.autograd.grad(out, tv, tg)
    key_pad, stat = tatt.spec_operands(spec, B, TQ, TQ, "cpu")
    ref = tatt.attention_reference(tq, tk_, tv, key_pad, stat, H,
                                   1.0 / math.sqrt(D))[0]
    (dv_auto,) = torch.autograd.grad(ref, tv, tg)
    assert not dv[2].any()
    torch.testing.assert_close(dv_auto[2], tg[2].mean(0).expand(TQ, -1),
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(dv[:2], dv_auto[:2], atol=ATOL, rtol=0)
