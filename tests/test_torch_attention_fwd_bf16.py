"""The plain K1 with JAX's bf16 dots (``attention_reference(...,
dots_dtype=torch.bfloat16)``), the yardstick of the tensor-core bf16 K1,
against JAX's K1 on the CPU.

On its hardware JAX's ``_attn_fwd_kernel`` (``ops/attention.py:144``
there) runs DEFAULT-precision f32 dots, which feed the matrix unit bf16
operands: ``s = bf16(f32(q) * scale) . bf16(k)`` and ``o = bf16(pd) .
bf16(v) / l`` (``pd`` the dropped p scaled by 1/(1 - rate), ``l`` the sum of
the undropped f32 p). Interpret mode on the CPU keeps true f32 dots and
the kernel has no ``dots_dtype``, so this file writes the kernel's function
down in jnp (``_mirror``), with the bf16 rounding of the two products'
operands as an option and the keep mask as an input:

- without rounding the mirror equals JAX's ``_mha_impl(with_lse=True)`` in
  interpret mode, at dropout 0, within 1e-6 (the same f32 products summed
  in other orders), so it is JAX's function;
- with rounding it equals the port's bf16-dots plain version within 1e-3
  on out and 1e-5 on lse, at dropout 0 and 0.4 on ``philox_keep``'s bits
  (the same roundings; a last-bit difference of an f32 p can move its bf16
  value by one step);
- the port's f32-dots plain version falls more than 2e-3 from the rounded
  mirror on out, so the test tells the two apart.

Each case runs at the head geometries (H, D) = (4, 32) and at head width
128, the bf16 K1 of ``csrc/attention_fwd_bf16_d128.cuh``, with 1 and 2
heads; the cases include cross attention (Tq != Tk) and a key row of 300,
longer than the 208 keys the wgmma kernels take at once.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

B, TQ = 3, 20
MIRROR_ATOL = 1e-6
BF16_DOTS_ATOL, LSE_ATOL = 1e-3, 1e-5
CASES = ["encoder_eye_pad", "decoder_pad_padded_trial", "cross", "random",
         "long_row"]
# (heads, head width): the D <= 64 kernels' width and the D = 128 kernel's
GEOMS = [(4, 32), (1, 128), (2, 128)]
GEOM_IDS = [f"h{h}d{d}" for h, d in GEOMS]
KEYS = {"cross": 28, "long_row": 300}


def _case(case, seed=0, H=4, D=32):
    """numpy q, k, v (B, T, H*D) f32, key_pad (B, Tk), static (Tq, Tk)."""
    tk = KEYS.get(case, TQ)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, TQ, H * D)).astype(np.float32)
    k = rng.normal(size=(B, tk, H * D)).astype(np.float32)
    v = rng.normal(size=(B, tk, H * D)).astype(np.float32)
    pad = np.ones((B, tk), np.int32)
    pad[1, tk - 5:] = 0
    static = np.zeros((TQ, tk), np.int32)
    if case == "encoder_eye_pad":
        static = np.eye(TQ, tk, dtype=np.int32)
    elif case == "decoder_pad_padded_trial":
        pad[2] = 0                          # every key of trial 2 masked
    elif case == "cross":                   # Tq != Tk
        static = (rng.random((TQ, tk)) > 0.7).astype(np.int32)
    elif case == "long_row":
        # 300 keys, two of the wgmma kernels' 208-key chunks: a band of 49
        # keys around key 15 q (across the chunks' boundary for the later
        # queries) or one key in ten by the pad, so that a row's max lies
        # in either chunk
        pad = (rng.random((B, tk)) > 0.9).astype(np.int32)
        qi, ki = np.arange(TQ)[:, None], np.arange(tk)[None]
        static = (np.abs(15 * qi - ki) <= 24).astype(np.int32)
    else:
        pad = (rng.random((B, tk)) > 0.4).astype(np.int32)
        static = (rng.random((TQ, tk)) > 0.7).astype(np.int32)
    return q, k, v, pad, static


def _mirror(q, k, v, pad, static, keep=None, rate=0.0, bf16_dots=False,
            H=4, D=32):
    """``_attn_fwd_kernel``'s function (:144-217 there) in jnp, per head:
    scale folded into q, bias 0 / NEG_INF from ``static | key_pad``, the
    row max m, p = exp(s - m), l = sum p (undropped), ``lse = max(m,
    -1e6) + log(l)``, dropout ``where(keep, p, 0) / (1 - rate)`` before the
    second product, ``o = pd . v / l``. ``bf16_dots`` rounds ``q * scale``,
    k, v and pd to bf16, as the hardware's DEFAULT-precision dots do."""
    def rnd(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32) if bf16_dots else x

    def heads(x):
        b, t, _ = x.shape
        return jnp.asarray(x).reshape(b, t, H, D).transpose(0, 2, 1, 3)

    scale = 1.0 / math.sqrt(D)
    hi = jnp.float32
    attend = (jnp.asarray(static) > 0)[None] | (jnp.asarray(pad) > 0)[:, None]
    bias = jnp.where(attend, 0.0, jatt.NEG_INF).astype(hi)
    qs = rnd(heads(q) * scale)
    s = jnp.einsum("bhqd,bhkd->bhqk", qs, rnd(heads(k)),
                   precision="highest") + bias[:, None]
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    lse = (jnp.maximum(m, jatt._LSE_FLOOR) + jnp.log(l))[..., 0]
    if rate > 0.0:
        p = jnp.where(jnp.asarray(keep), p, 0.0) * (1.0 / (1.0 - rate))
    o = jnp.einsum("bhqk,bhkd->bhqd", rnd(p), rnd(heads(v)),
                   precision="highest") / l
    out = o.transpose(0, 2, 1, 3).reshape(B, TQ, H * D)
    return np.asarray(out), np.asarray(lse)


def _jax_k1(q, k, v, pad, static, H=4, D=32):
    """JAX's K1 in interpret mode with its lse: (out, lse (B, H, Tq))."""
    tk = k.shape[1]
    out, ml = jatt._mha_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pad).reshape(B, 1, tk),
        jnp.asarray(static).reshape(1, TQ, tk), jnp.zeros((1, 1), jnp.int32),
        1.0 / math.sqrt(D), 0.0, H, D, with_lse=True)
    return np.asarray(out), np.asarray(ml[:, 0, :]).reshape(B, H, TQ)


def _port(q, k, v, pad, static, rate, dots_dtype, H=4, D=32):
    args = [torch.from_numpy(x) for x in (q, k, v, pad, static)]
    out, lse = tatt.attention_reference(*args, H, 1.0 / math.sqrt(D),
                                        with_lse=True, dropout_rate=rate,
                                        seed=99, dots_dtype=dots_dtype)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("case", CASES)
def test_mirror_without_rounding_is_jax_k1(case, geom):
    H, D = geom
    q, k, v, pad, static = _case(case, H=H, D=D)
    want, want_lse = _jax_k1(q, k, v, pad, static, H, D)
    got, lse = _mirror(q, k, v, pad, static, H=H, D=D)
    np.testing.assert_allclose(got, want, atol=MIRROR_ATOL, rtol=0)
    np.testing.assert_allclose(lse, want_lse, atol=MIRROR_ATOL, rtol=0)
    if case == "decoder_pad_padded_trial":
        # a fully-masked row: the mean of V, lse = -1e6 + log(Tk)
        np.testing.assert_allclose(
            got[2], np.broadcast_to(v[2].mean(0), got[2].shape),
            atol=MIRROR_ATOL, rtol=0)
        np.testing.assert_allclose(lse[2], -1e6 + np.log(TQ), rtol=1e-7)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case", CASES)
def test_bf16_dots_reference_matches_rounded_mirror(case, rate, geom):
    """The port's bf16-dots plain K1 on ``philox_keep``'s bits against the
    mirror with rounding on the same bits; the f32-dots one differs."""
    H, D = geom
    q, k, v, pad, static = _case(case, seed=1, H=H, D=D)
    keep = tatt.philox_keep(99, B, H, TQ, k.shape[1], rate).numpy() \
        if rate > 0.0 else None
    want, want_lse = _mirror(q, k, v, pad, static, keep, rate,
                             bf16_dots=True, H=H, D=D)
    got, lse = _port(q, k, v, pad, static, rate, torch.bfloat16, H, D)
    np.testing.assert_allclose(got, want, atol=BF16_DOTS_ATOL, rtol=0)
    np.testing.assert_allclose(lse, want_lse, atol=LSE_ATOL, rtol=0)
    f32, _ = _port(q, k, v, pad, static, rate, torch.float32, H, D)
    assert np.abs(f32 - want).max() > 2 * BF16_DOTS_ATOL
    # and the f32-dots plain K1 is the unrounded mirror
    plain, plain_lse = _mirror(q, k, v, pad, static, keep, rate, H=H, D=D)
    np.testing.assert_allclose(f32, plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_bf16_dots_rows_sum_to_one_against_their_lse(geom):
    """What the bf16 K2 relies on: with the bf16-dots scores, ``exp(s -
    lse)`` of every row that attends anything sums to 1 against the
    bf16-dots lse, while against the f32-dots lse it does not."""
    H, D = geom
    q, k, v, pad, static = _case("random", seed=2, H=H, D=D)
    tq, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    key_pad, stat = torch.from_numpy(pad), torch.from_numpy(static)
    scale = 1.0 / math.sqrt(D)
    heads = lambda x: x.reshape(B, -1, H, D).transpose(1, 2)  # noqa: E731
    s = ((heads(tq) * scale).bfloat16().float()
         @ heads(tk_).bfloat16().float().transpose(-1, -2)
         + tatt._attend_bias(key_pad, stat)[:, None])
    rows = (stat.bool()[None] | key_pad.bool()[:, None]).any(-1)
    sums = {}
    for dt in (torch.bfloat16, torch.float32):
        _, lse = _port(q, k, v, pad, static, 0.0, dt, H, D)
        sums[dt] = torch.exp(s - torch.from_numpy(lse)[..., None]).sum(-1)
    err = (sums[torch.bfloat16] - 1).abs()[rows[:, None].expand_as(
        sums[torch.bfloat16])]
    assert err.max().item() <= 1e-5
    assert (sums[torch.float32] - 1).abs().max().item() > 1e-4
