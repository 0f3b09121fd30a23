"""Shared helpers for the port-vs-JAX tests (``tests/test_torch_*.py``).

Both sides get the same numpy inputs, made from a seed; JAX params go to
the port through ``params_from_jax``. The JAX side runs the Pallas
attention kernel (``attn_impl="pallas"``, interpret mode on the CPU, as the
JAX package's own tests run it) unless a test says otherwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

# tier-1 runs pytest-xdist with 6 workers: one thread each
torch.set_num_threads(1)

# toy geometry of the port tests
N_AP, N_BEH, T = 24, 2, 20
TOY = dict(n_channels={"ap": N_AP, "behavior": N_BEH}, max_F=T,
           hidden_size=64, n_heads=4, n_enc_layers=2, n_dec_layers=2,
           inter_size=128)
# the full width of the reference model (ROADMAP: N=668, T=100, H=256,
# 8 heads, 5+5 layers, FFN 512)
FULL = dict(n_channels={"ap": 668, "behavior": 2}, max_F=100,
            hidden_size=256, n_heads=8, n_enc_layers=5, n_dec_layers=5,
            inter_size=512)


def make_batch(seed: int, B: int, t: int = T, n_ap: int = N_AP,
               n_beh: int = N_BEH, pad_tail: int = 0):
    """numpy (spikes, behavior, attn, timestamps); the last ``pad_tail``
    trials are padding (attention mask all zero)."""
    rng = np.random.default_rng(seed)
    spikes = rng.poisson(1.0, (B, t, n_ap)).astype(np.float32)
    beh = rng.normal(size=(B, t, n_beh)).astype(np.float32)
    attn = np.ones((B, t), np.int64)
    if pad_tail:
        attn[-pad_tail:] = 0
    ts = np.tile(np.arange(t, dtype=np.int64), (B, 1))
    return spikes, beh, attn, ts


def jax_inputs(spikes, beh, attn, ts, ap_eval, beh_eval):
    def mi(x, ev):
        return jmm.ModalityInput(
            inputs=jnp.asarray(x), targets=jnp.asarray(x),
            attn_mask=jnp.asarray(attn), timestamps=jnp.asarray(ts),
            eval_mask=jnp.asarray(ev))
    return {"ap": mi(spikes, ap_eval), "behavior": mi(beh, beh_eval)}


def torch_inputs(spikes, beh, attn, ts, ap_eval, beh_eval, device="cpu"):
    def mi(x, ev):
        return tmm.ModalityInput(
            inputs=torch.as_tensor(x, device=device),
            targets=torch.as_tensor(x, device=device),
            attn_mask=torch.as_tensor(attn, device=device),
            timestamps=torch.as_tensor(ts, device=device),
            eval_mask=torch.as_tensor(ev, device=device))
    return {"ap": mi(spikes, ap_eval), "behavior": mi(beh, beh_eval)}


def jax_model(attn_impl: str = "pallas", seed: int = 0, geometry=TOY,
              **over):
    """(JAX MultiModal, its params) at ``geometry``, init from ``seed``.
    The param tree does not depend on the attention impl, so init runs the
    fast XLA form; the returned model runs ``attn_impl``."""
    cfg = jmm.MultiModalConfig(**{**geometry, "attn_impl": attn_impl,
                                  **over})
    t, n_ap = cfg.max_F, cfg.n_channels["ap"]
    spikes, beh, attn, ts = make_batch(seed, 2, t, n_ap)
    inputs = jax_inputs(spikes, beh, attn, ts, np.zeros_like(spikes, np.int32),
                        np.zeros_like(beh, np.int32))
    init_model = jmm.MultiModal(dataclasses.replace(cfg, attn_impl="xla"))
    params = jax.jit(init_model.init)({"params": jax.random.PRNGKey(seed)},
                                      inputs)
    return (jmm.MultiModal(cfg),
            jax.tree_util.tree_map(np.asarray, params["params"]))


def port_model(jax_params, geometry=TOY, device="cpu", **over):
    """The port's MultiModal of the same config, carrying ``jax_params``."""
    cfg = tmm.MultiModalConfig(**{**geometry, **over})
    model = tmm.MultiModal(cfg, device=device)
    model.load_state_dict(params_from_jax(jax_params, cfg), strict=True)
    return model


def load_flax_params(module: torch.nn.Module, params) -> None:
    """Load a flax sub-tree into a port module whose parameter paths equal
    the flax ones (Linear weight = kernel transposed, LayerNorm weight =
    scale)."""
    sd = {}
    for name in module.state_dict():
        *path, leaf = name.split(".")
        node = params
        for p in path:
            node = node[p]
        if leaf == "weight":
            value = node["kernel"].T if "kernel" in node else node["scale"]
        else:
            value = node[leaf]
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    module.load_state_dict(sd, strict=True)
