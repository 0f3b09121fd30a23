"""Port layers (``models/layers.py``, ``ops/layernorm.py``,
``ops/losses.py``) against the flax modules on the same weights and
inputs; f32, atol 1e-5.

Traps held here: GELU is flax's tanh approximation (torch's default is
the exact erf form), and LayerNorm is the fast-variance form
``relu(E[x^2] - mu^2)`` (``F.layer_norm`` is two-pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import TOY, load_flax_params
from multi_modal_foundation_model_tpu.models import layers as jl
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops import layernorm as jln
from multi_modal_foundation_model_tpu.ops import losses as jlosses
from multi_modal_foundation_model_tpu.ops.attention import MaskSpec as JSpec
from multi_modal_foundation_model_tpu_torch.models import layers as tl
from multi_modal_foundation_model_tpu_torch.ops import layernorm as tln
from multi_modal_foundation_model_tpu_torch.ops import losses as tlosses
from multi_modal_foundation_model_tpu_torch.ops.attention import (
    MaskSpec as TSpec)

ATOL = 1e-5
B, T, HID = 3, 20, TOY["hidden_size"]


def _x(seed, shape, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + offset).astype(np.float32)


@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_layernorm_fast_variance_matches_jax(offset):
    x = _x(0, (B, T, HID), scale=2.0, offset=offset)
    w, b = _x(1, (HID,)), _x(2, (HID,))
    want = np.asarray(jln._xla_layernorm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), 1e-5, None))
    ln = tln.LayerNorm(HID)
    ln.load_state_dict({"weight": torch.from_numpy(w),
                        "bias": torch.from_numpy(b)})
    got = ln(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the module form FusedLayerNorm takes by default is the same math
    fused = jln.FusedLayerNorm(epsilon=1e-5)
    want2 = fused.apply({"params": {"scale": w, "bias": b}}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want2), atol=ATOL, rtol=0)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "softsign", "tanh",
                                 "identity"])
def test_activations_match_flax(act):
    x = _x(3, (64,), scale=3.0)
    want = np.asarray(jl.ACT2FN[act](jnp.asarray(x)))
    got = tl.ACT2FN[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    torch.testing.assert_close(tl.ACT2FN["gelu"](x),
                               F.gelu(x, approximate="tanh"))
    assert (tl.ACT2FN["gelu"](x) - F.gelu(x)).abs().max() > 1e-4


def test_scalenorm_matches_jax():
    x = _x(4, (B, T, HID))
    mod = jl.ScaleNorm(HID ** 0.5)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    got = tl.ScaleNorm(HID ** 0.5)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["poisson", "mse"])
def test_masked_losses_match_jax(kind):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, 6)).astype(np.float32)
    y = rng.poisson(1.0, (B, T, 6)).astype(np.float32)
    mask = (rng.random((B, T, 6)) > 0.5).astype(np.int32)
    jf, tf = ((jlosses.masked_poisson_nll, tlosses.masked_poisson_nll)
              if kind == "poisson" else
              (jlosses.masked_mse, tlosses.masked_mse))
    ws, wn = jf(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    gs, gn = tf(torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(mask))
    np.testing.assert_allclose(gs.item(), float(ws), rtol=1e-6)
    assert gn.item() == float(wn)


@pytest.mark.parametrize("act", ["softsign", "gelu"])
def test_tokenizer_matches_flax(act):
    n_ch = TOY["n_channels"]["ap"]
    x = np.random.default_rng(6).poisson(1.0, (B, T, n_ch)).astype(np.float32)
    jmod = jl.ModalityTokenizer(n_channels=n_ch, hidden_size=HID, mult=2,
                                act=act, scale=1.5, use_bias=True,
                                dropout=0.2)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tl.ModalityTokenizer(n_ch, HID, 2, act, 1.5, True)
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    got = tmod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _cfgs(**over):
    jcfg = jmm.MultiModalConfig(**{**TOY, **over})
    return jmm._TransformerCfg(jcfg, 2), jcfg


def _masks():
    pad = np.ones((B, T), np.int32)
    pad[1, -6:] = 0
    pad[2] = 0                              # a padded trial
    eye = np.eye(T, dtype=np.int32)
    return ((JSpec(jnp.asarray(pad), jnp.asarray(eye)),
             TSpec(torch.from_numpy(pad), torch.from_numpy(eye))),
            (JSpec(jnp.asarray(pad), None), TSpec(torch.from_numpy(pad),
                                                   None)))


@pytest.mark.parametrize("use_scalenorm", [False, True])
def test_encoder_layer_matches_flax(use_scalenorm):
    tcfg, jcfg = _cfgs(use_scalenorm=use_scalenorm)
    x = _x(7, (B, T, HID))
    (jenc, tenc), _ = _masks()
    jmod = jl.EncoderLayer(tcfg, attn_impl="pallas")
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jenc)["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jenc))
    tmod = tl.EncoderLayer(jcfg)
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    got = tmod(torch.from_numpy(x), tenc).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_decoder_layer_matches_flax():
    tcfg, jcfg = _cfgs()
    x, ctx = _x(8, (B, T, HID)), _x(9, (B, T, HID))
    (jenc, tenc), (jdec, tdec) = _masks()
    jmod = jl.DecoderLayer(tcfg, attn_impl="pallas")
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x),
                       jnp.asarray(ctx), jdec, jenc)["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(ctx), jdec, jenc))
    tmod = tl.DecoderLayer(jcfg)
    assert {n for n, _ in tmod.named_children()} >= {"query_norm",
                                                     "context_norm"}
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    got = tmod(torch.from_numpy(x), torch.from_numpy(ctx), tdec,
               tenc).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_reset_parameters_is_torch_default_and_seeded():
    """Init draws from the given generator: same seed, same weights;
    Linear weights within +-1/sqrt(fan_in), embeddings ~N(0, 1)."""
    def build(seed):
        mod = tl.ModalityTokenizer(24, HID, 2, "softsign", 1.0, True)
        mod.emb = torch.nn.Embedding(100, HID)
        tl.reset_parameters_(mod, torch.Generator().manual_seed(seed))
        return mod
    a, b, c = build(0), build(0), build(1)
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
        assert not torch.equal(pa, pc), n
    bound = 1 / np.sqrt(24)
    assert a.token_embed.weight.abs().max() <= bound
    assert abs(a.emb.weight.std().item() - 1.0) < 0.05
