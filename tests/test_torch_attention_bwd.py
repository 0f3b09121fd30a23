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


def _case(case, seed=0, tq=TQ, hidden=H * D):
    """numpy q, k, v, g, key_pad (B, Tk) and static (Tq, Tk) or None, Tq
    queries of ``hidden`` columns (Tk = Tq + 8 for cross attention)."""
    tk = tq + 8 if case == "cross" else tq
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, tq, hidden)).astype(np.float32)
    k = rng.normal(size=(B, tk, hidden)).astype(np.float32)
    v = rng.normal(size=(B, tk, hidden)).astype(np.float32)
    g = rng.normal(size=(B, tq, hidden)).astype(np.float32)
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


# JAX's K2 with bf16 dots: what its hardware runs (``ops/attention.py:431``
# there). ``_flash_mha_bwd`` ties the dots to ``_should_interpret()``, so
# the test builds the same ``pl.pallas_call`` (its specs, :433-450) with
# ``dots_dtype=bf16`` and ``interpret=True``. Both sides round q * scale,
# k, v, g, ds and pd to bf16 at the same places and sum in f32 in other
# orders, so they stay within BF16_DOTS_ATOL; the f32-dots plain version
# sits ~1e-2 away (one bf16 rounding of every product operand) and must
# fall outside it.
BF16_DOTS_ATOL = 1e-3


def _jax_bf16_dots_k2(q, k, v, g, pad, static, n_heads=H):
    """dq, dk, dv of JAX's ``_attn_bwd_kernel`` with bf16 dots, and the
    lse (B, H, Tq) of JAX's forward that it read, at ``n_heads`` heads of
    q's columns over them."""
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tq, tk, hidden = q.shape[1], k.shape[1], q.shape[2]
    d = hidden // n_heads
    key_pad = jnp.asarray(pad).reshape(B, 1, tk)
    stat = (jnp.zeros((1, tq, tk), jnp.int32) if static is None
            else jnp.asarray(static).reshape(1, tq, tk))
    seed = jnp.zeros((1, 1), jnp.int32)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    _, ml = jatt._mha_impl(jq, jk, jv, key_pad, stat, seed, scale, 0.0,
                           n_heads, d, with_lse=True)
    kernel = functools.partial(jatt._attn_bwd_kernel, scale=scale,
                               dropout_rate=0.0, n_heads=n_heads, d_head=d,
                               dots_dtype=jnp.bfloat16)
    blk_q = pl.BlockSpec((B, tq, hidden), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM)
    blk_k = pl.BlockSpec((B, tk, hidden), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM)
    blk_ml = pl.BlockSpec((B, 8, n_heads * tq), lambda i: (i, 0, 0),
                          memory_space=pltpu.VMEM)
    grads = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=jatt._specs(B, tq, tk, hidden) + [blk_q, blk_ml],
        out_specs=[blk_q, blk_k, blk_k],
        out_shape=[jax.ShapeDtypeStruct(jq.shape, jq.dtype),
                   jax.ShapeDtypeStruct(jk.shape, jk.dtype),
                   jax.ShapeDtypeStruct(jv.shape, jv.dtype)],
        scratch_shapes=[pltpu.VMEM((B, n_heads * tq, tk), jnp.float32),
                        pltpu.VMEM((B, n_heads * tq, tk), jnp.float32)],
        interpret=True,
    )(seed, jq, jk, jv, key_pad, stat, jg, ml)
    lse = np.array(ml[:, 0, :]).reshape(B, n_heads, tq)
    return [np.asarray(x) for x in grads], lse


# (case, heads, head width, Tq): the 4 heads of 16 at Tq = 20 the test
# began with (their ids unchanged), and 1 and 2 heads of 128, the width of
# the bf16 K2 of csrc/attention_bwd_bf16_d128.cuh (the mm.yaml model with 2
# heads), at Tq = 70 (Tk 70, 78 cross): past one 64-row tile
BF16_DOTS_CASES = ([pytest.param(c, H, D, TQ, id=c) for c in CASES]
                   + [pytest.param(c, h, 128, 70, id=f"{c}-{h}x128")
                      for h in (1, 2) for c in CASES])


@pytest.mark.parametrize("case,n_heads,d_head,tq", BF16_DOTS_CASES)
def test_bf16_dots_reference_matches_jax_bf16_dots_k2(case, n_heads, d_head,
                                                     tq):
    """``attention_bwd_reference(dots_dtype=bf16)`` against JAX's K2 with
    bf16 dots on the same numpy inputs and JAX's own lse, dropout 0: the
    yardstick of the tensor-core bf16 K2, at the widths its kernels run (16
    and 128). The f32-dots version is held to the same inputs and must fall
    outside the tolerance, so the test tells the two apart."""
    q, k, v, g, pad, static = _case(case, seed=3, tq=tq,
                                    hidden=n_heads * d_head)
    want, lse = _jax_bf16_dots_k2(q, k, v, g, pad, static, n_heads)
    tq_, tk_, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    key_pad, stat = tatt.spec_operands(_tspec(pad, static), B, tq,
                                       k.shape[1], "cpu")
    args = (tq_, tk_, tv, key_pad, stat, tg, torch.from_numpy(lse), n_heads,
            1.0 / math.sqrt(d_head))
    got = tatt.attention_bwd_reference(*args, dots_dtype=torch.bfloat16)
    f32 = tatt.attention_bwd_reference(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=BF16_DOTS_ATOL, rtol=0,
                                   err_msg=name)
    worst_f32 = max(np.abs(a.numpy() - b).max() for a, b in zip(f32, want))
    assert worst_f32 > 2 * BF16_DOTS_ATOL, worst_f32
    if case == "decoder_pad_padded_trial":
        assert not got[0][2].any() and not want[0][2].any()
