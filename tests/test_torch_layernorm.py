"""The port's LayerNorm (``ops/layernorm.py``) against the JAX package's.

The plain forward and backward (``layer_norm``, ``layer_norm_bwd_reference``,
the plain versions of K3 and K4) are held against JAX's
``_pallas_layernorm`` forward and ``_pallas_ln_bwd`` in interpret mode (the
Pallas kernels K3/K4 as the JAX package's tests run them on the CPU), at
37x4 and 50x4 tokens, H = 64 and 256, bf16 -> bf16 and f32 -> f32, with the
JAX tests' tolerances (``tests/test_layernorm.py``: f32 1e-5, bf16 2e-2, as
atol = rtol). The ``"bwd"``/``"full"`` autograd Functions run the plain
versions on CPU tensors and must give autograd-of-the-plain-form's
gradients; all three ``PALLAS_LAYERNORM`` values give the toy model the same
loss. The kernels themselves run on the card (``test_torch_kernels.py``).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TOY, make_batch, torch_inputs
from multi_modal_foundation_model_tpu.ops import layernorm as jln
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import layernorm as tln

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
EPS = 1e-5


def _operands(tokens, width, dtype, seed=0):
    """numpy x (4, tokens/4, H), scale, bias, g; x and g rounded to
    ``dtype`` so both sides see the same values."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, tokens // 4, width)) * 2.0 + 0.3)
    g = rng.normal(size=x.shape)
    scale = (rng.normal(size=width) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=width) * 0.1).astype(np.float32)
    jd = getattr(jnp, dtype)
    x, g = (np.asarray(jnp.asarray(a, jnp.float32).astype(jd)) for a in (x, g))
    return x, scale, bias, g


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch,
                                                                  dtype))


@contextlib.contextmanager
def ln_mode(mode):
    old = tln.PALLAS_LAYERNORM
    tln.PALLAS_LAYERNORM = mode
    try:
        yield
    finally:
        tln.PALLAS_LAYERNORM = old


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=name)


CASES = [(tokens, width, dtype) for tokens in (37 * 4, 50 * 4)
         for width in (64, 256) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("tokens,width,dtype", CASES)
def test_plain_forward_matches_jax_k3(tokens, width, dtype):
    x, scale, bias, _ = _operands(tokens, width, dtype)
    jd = getattr(jnp, dtype)
    want = jln._pallas_layernorm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), EPS, jd)
    got = tln.layer_norm(_torch(x, dtype), torch.from_numpy(scale),
                         torch.from_numpy(bias), EPS, getattr(torch, dtype))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("tokens,width,dtype", CASES)
def test_plain_backward_matches_jax_k4(tokens, width, dtype):
    x, scale, _, g = _operands(tokens, width, dtype, seed=1)
    jd = getattr(jnp, dtype)
    want = jln._pallas_ln_bwd(EPS, jd, (jnp.asarray(x), jnp.asarray(scale)),
                              jnp.asarray(g))
    got = tln.layer_norm_bwd_reference(_torch(x, dtype),
                                       torch.from_numpy(scale),
                                       _torch(g, dtype), EPS)
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        _close(a, b, TOL[dtype], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bwd", "full"])
def test_functions_give_autograd_gradients_on_cpu(mode, dtype):
    """On CPU tensors the "bwd"/"full" Functions run the plain versions:
    the forward is the plain form's to the bit, and the gradients agree
    with autograd of the plain form (``"off"``)."""
    x, scale, bias, g = _operands(50 * 4, 64, dtype, seed=2)
    dt = getattr(torch, dtype)
    results = []
    for m in (mode, "off"):
        xx = _torch(x, dtype).requires_grad_(True)
        w = torch.from_numpy(scale).requires_grad_(True)
        b = torch.from_numpy(bias).requires_grad_(True)
        with ln_mode(m):
            y = tln.layernorm(xx, w, b, EPS, dt)
        results.append((y,) + torch.autograd.grad(y, (xx, w, b),
                                                  _torch(g, dtype)))
    (y, dx, dw, db), (y0, dx0, dw0, db0) = results
    assert torch.equal(y, y0) and dx.dtype == dt
    tol = TOL[dtype]
    for name, a, b in (("dx", dx, dx0), ("dw", dw, dw0), ("db", db, db0)):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=name)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_switch_values_give_the_toy_model_one_loss(compute_dtype):
    """The toy model, one training forward and backward under each
    ``PALLAS_LAYERNORM`` value (CPU: the plain versions everywhere): the
    same loss to the bit, the same gradients to f32 summation order."""
    spikes, beh, attn, ts = make_batch(3, 3)
    zeros = (np.zeros_like(spikes, np.int32), np.zeros_like(beh, np.int32))
    inputs = torch_inputs(spikes, beh, attn, ts, *zeros)
    cfg = tmm.MultiModalConfig(**TOY, compute_dtype=compute_dtype,
                               dropout=0.0, embed_dropout=0.0)
    runs = {}
    for mode in tln.MODES:
        with ln_mode(mode):
            model = tmm.MultiModal(cfg, device="cpu")
            out = model(inputs, masking_mode="temporal", training=True,
                        seed=5)
            out.loss.backward()
        runs[mode] = (out.loss.item(), {
            n: p.grad for n, p in model.named_parameters()})
    # per parameter, normwise: f32 summation order, or in bf16 one bf16
    # rounding of dx that may land on the other side (key biases left out:
    # their exact gradient is 0, softmax being shift-invariant, so both
    # sides hold rounding noise)
    tol = 1e-4 if compute_dtype == "float32" else 2e-2
    loss0, grads0 = runs["off"]
    for mode in ("bwd", "full"):
        loss, grads = runs[mode]
        assert loss == loss0, mode
        for n, gr in grads.items():
            if not n.endswith("key.bias"):
                rel = (gr - grads0[n]).norm() / grads0[n].norm()
                assert rel <= tol, (mode, n, rel)


@pytest.mark.parametrize("x_dtype,ln_dtype", [
    ("float32", None), ("bfloat16", "bfloat16"), ("bfloat16", None),
    ("float32", "bfloat16")])
def test_module_dtype_matches_fused_layernorm(x_dtype, ln_dtype):
    """``LayerNorm(dtype=...)``: output in ``dtype``, else x's dtype
    promoted with f32, as JAX ``FusedLayerNorm``."""
    x, scale, bias, _ = _operands(37 * 4, 64, x_dtype, seed=3)
    jmod = jln.FusedLayerNorm(
        epsilon=EPS, dtype=getattr(jnp, ln_dtype) if ln_dtype else None)
    want = jmod.apply({"params": {"scale": scale, "bias": bias}},
                      jnp.asarray(x).astype(getattr(jnp, x_dtype)))
    ln = tln.LayerNorm(64, dtype=getattr(torch, ln_dtype) if ln_dtype
                       else None)
    ln.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    got = ln(_torch(x, x_dtype))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got.detach(), want, TOL["bfloat16" if "bfloat16" in (
        x_dtype, ln_dtype) else "float32"])


def test_wrappers_and_switch_refuse_what_they_do_not_run():
    """The K3/K4 wrappers launch on CUDA tensors only (dispatch, not the
    wrapper, sends CPU tensors to the plain versions); an unknown switch
    value raises."""
    x = torch.randn(4, 64)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm_fwd(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm_bwd(x, w, x)
    with ln_mode("on"), pytest.raises(ValueError):
        tln.layernorm(x, w, b)
    n3, n4 = tln.K3_LAUNCHES, tln.K4_LAUNCHES
    xx = x.clone().requires_grad_(True)
    with ln_mode("full"):
        tln.layernorm(xx, w, b).sum().backward()
    assert (tln.K3_LAUNCHES, tln.K4_LAUNCHES) == (n3, n4)
