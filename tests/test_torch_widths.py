"""Widths the JAX package runs beyond the reference model's: attention head
widths other than 32, LayerNorm widths outside 32..1024. Port against the
JAX package on the CPU.

- K1/K2's plain versions at head widths 8, 16 and 64 against JAX's
  ``multi_head_attention(impl="pallas")`` (``_flash_mha``: K1 in interpret
  mode, its VJP K2) and K1's lse against ``_mha_impl(with_lse=True)``,
  f32, atol 1e-5 (the same f32 products summed in other orders; dropout 0,
  as JAX's interpret mode draws no TPU bits).
- The zero-padded path (``padded_attention_fwd`` / ``_bwd``, how the card
  runs a head width it has no library of) with the plain versions in the
  kernels' place, at head widths 8 and 24 (padded to 16 and 32), dropout 0
  and 0.4: the plain versions at the true width within atol 1e-6 (zero
  columns add exact zeros; only the products' summation order moves).
- One AdamW step of the trainer in lockstep with JAX's at dropout 0 (the
  co-smooth / forward-pred menu), JAX's initial parameters carried in by
  ``params_from_jax``, at hidden 64 with 4 heads (D = 16) and hidden 128
  with 2 heads (D = 64), 2 + 2 layers: the step's loss within rtol 2e-5
  and the parameters after it within atol 2e-5 (``test_torch_trainer``'s
  gates; the attention key biases left out, as there).
- LayerNorm forward and gradients (the plain versions of K3/K4) at H = 48,
  100 and 2048 against JAX's ``FusedLayerNorm`` (its XLA form on the CPU)
  and ``jax.vjp``: f32 1e-5, bf16 2e-2 (atol = rtol, the JAX package's
  LayerNorm tolerances).
- The planners: ``ln_plan``'s layout at each width (a row a warp up to
  1024, a row a block above, the widest aligned vector) and
  ``kernel_head_dim``'s compiled width; the build key of a width's library
  follows the source it includes.

The kernels themselves run on the card (``test_torch_kernels.py``).
"""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TOY
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu.ops import layernorm as jln
from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt
from multi_modal_foundation_model_tpu_torch.ops import build
from multi_modal_foundation_model_tpu_torch.ops import layernorm as tln
from multi_modal_foundation_model_tpu_torch.ops.masking import (
    MaskParams as TMP)
from multi_modal_foundation_model_tpu_torch.train import (
    MultiModalTrainer, OptimizerConfig, TrainerConfig)
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

ATOL = 1e-5
B, TQ, TK = 3, 20, 28


def _attention_case(D, H, seed=0):
    """numpy q (B, Tq, H*D), k/v (B, Tk, H*D), g, a key pad with a padded
    tail and a random static mask."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, TQ, H * D)).astype(np.float32)
    k = rng.normal(size=(B, TK, H * D)).astype(np.float32)
    v = rng.normal(size=(B, TK, H * D)).astype(np.float32)
    g = rng.normal(size=(B, TQ, H * D)).astype(np.float32)
    pad = np.ones((B, TK), np.int32)
    pad[1, TK - 6:] = 0
    static = (rng.random((TQ, TK)) > 0.7).astype(np.int32)
    return q, k, v, g, pad, static


@pytest.mark.parametrize("D,H", [(8, 4), (16, 4), (64, 2)])
def test_plain_k1_k2_match_jax_flash_mha(D, H):
    q, k, v, g, pad, static = _attention_case(D, H, seed=D)
    spec = jatt.MaskSpec(key_pad=jnp.asarray(pad), static=jnp.asarray(static))

    def f(q, k, v):
        return jatt.multi_head_attention(q, k, v, H, mask_spec=spec,
                                         impl="pallas")

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    scale = 1.0 / math.sqrt(D)
    _, ml = jatt._mha_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pad).reshape(B, 1, TK),
        jnp.asarray(static).reshape(1, TQ, TK), jnp.zeros((1, 1), jnp.int32),
        scale, 0.0, H, D, with_lse=True)
    tq, tk_, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    key_pad, stat = torch.from_numpy(pad), torch.from_numpy(static)
    got, lse = tatt.attention_reference(tq, tk_, tv, key_pad, stat, H, scale,
                                        with_lse=True)
    grads = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                         H, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.reshape(B, H * TQ).numpy(),
                               np.asarray(ml)[:, 0, :], atol=ATOL, rtol=1e-6)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("D,H", [(8, 4), (24, 3)])
def test_padded_path_equals_the_plain_versions(D, H, rate):
    """What the card runs at a head width it has no library of, with the
    plain versions in the kernels' place: the operands padded to the next
    compiled width, the true width's scale, the padding dropped."""
    q, k, v, g, pad, static = _attention_case(D, H, seed=D + 1)
    tq, tk_, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    key_pad, stat = torch.from_numpy(pad), torch.from_numpy(static)
    scale = 1.0 / math.sqrt(D)
    width = tatt.kernel_head_dim(D)
    assert width == {8: 16, 24: 32}[D]
    got, got_lse = tatt.padded_attention_fwd(
        tatt.attention_reference, width, tq, tk_, tv, key_pad, stat, H,
        scale, True, rate, 5)
    want, lse = tatt.attention_reference(tq, tk_, tv, key_pad, stat, H,
                                         scale, True, rate, 5)
    assert got.shape == tq.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(got_lse, lse, atol=1e-6, rtol=0)
    grads = tatt.padded_attention_bwd(
        tatt.attention_bwd_reference, width, tq, tk_, tv, key_pad, stat, tg,
        lse, H, scale, rate, 5)
    want_grads = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg,
                                              lse, H, scale, rate, 5)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        assert a.shape == b.shape and a.is_contiguous(), name
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


def test_pad_heads_round_trip():
    """Each head's columns, then zeros; dropping them gives the input back,
    also from a column view of a fused product."""
    x = torch.arange(2 * 3 * 3 * 8 * 3, dtype=torch.float32).reshape(
        2, 3, 3 * 24)[..., :24]                       # 3 heads of 8
    p = tatt.pad_heads(x, 3, 16)
    assert p.shape == (2, 3, 48) and p.is_contiguous()
    heads = p.reshape(2, 3, 3, 16)
    assert torch.equal(heads[..., :8], x.reshape(2, 3, 3, 8))
    assert not heads[..., 8:].any()
    assert torch.equal(tatt.unpad_heads(p, 3, 8), x)


def test_kernel_head_dim_and_the_limit():
    assert [tatt.kernel_head_dim(d) for d in (1, 8, 16, 17, 24, 32, 33, 40,
                                              64, 65, 96, 128)] == [
        16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="up to 128"):
        tatt.kernel_head_dim(129)


def test_width_libraries_follow_the_source_they_include(tmp_path,
                                                        monkeypatch):
    """``attention_fwd_d64.cu`` is ``attention_fwd.cu`` at another head
    width: an edit of the included source builds a new library for every
    width, and every width is a source of its own."""
    assert {f"{k}{w}" for k in ("attention_fwd", "attention_bwd")
            for w in ("", "_d16", "_d64", "_d128")} | {
        "layernorm", "layernorm_wide"} <= set(build.kernel_sources())
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("attention_fwd_d64")
    assert before.name.startswith("libattention_fwd_d64-")
    src = csrc / "attention_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("attention_fwd_d64") != before


# ---------------------------------------------------------------------------
# one AdamW step in lockstep with JAX at head widths 16 and 64
# ---------------------------------------------------------------------------

MASK = dict(channels=(1, 5, 20), timesteps=(12, 15, 19))
MENU = ("co-smooth", "forward-pred")
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
# 10 trials: 8 train trials, one batch, one step an epoch; the schedule
# sized for 14 epochs (14 updates, as test_torch_trainer's: the OneCycle
# warm-up at least 2 steps) of which the first runs
N_TRIALS, EPOCHS = 10, 14


def _loaders(loader_mod, session_mod):
    sp = session_mod.synthetic_splits(seed=0, n_trials=N_TRIALS,
                                      n_neurons=TOY["n_channels"]["ap"],
                                      n_timesteps=TOY["max_F"])
    kw = dict(batch_size=8, max_time_length=TOY["max_F"],
              max_space_length=TOY["n_channels"]["ap"])
    return (loader_mod.make_loader(sp.train, **kw),
            loader_mod.make_loader(sp.val, shuffle=False, **kw))


def _tcfg(cls, tmp):
    return cls(num_epochs=EPOCHS, log_dir=str(tmp), seed=0,
               mask_type="input", mask_mode=MENU, mixed_training=True,
               eval_every=10 ** 9)


@pytest.mark.parametrize("hidden,heads", [(64, 4), (128, 2)],
                         ids=["d16", "d64"])
def test_one_adamw_step_in_lockstep_with_jax(hidden, heads, tmp_path):
    geometry = dict(TOY, hidden_size=hidden, n_heads=heads,
                    inter_size=2 * hidden)
    jcfg = jmm.MultiModalConfig(**geometry, dropout=0.0, embed_dropout=0.0,
                                mask_params=JMP(**MASK))
    jtr = jtrainer.MultiModalTrainer(
        jmm.MultiModal(jcfg), *_loaders(jloader, jsession), JOC(lr=1e-3),
        _tcfg(jtrainer.TrainerConfig, tmp_path / "j"))
    init = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    jmodes, jlosses = [], []
    sample = jtr._sample_modes
    jtr._sample_modes = lambda: jmodes.append(sample()) or jmodes[-1]
    get_step = jtr._get_train_step

    def recording(training_mode, use_mtm):
        step = get_step(training_mode, use_mtm)

        def run(*args):
            state, loss = step(*args)
            jlosses.append(float(loss))
            return state, loss
        return run

    jtr._get_train_step = recording
    jtr.train_epoch(0)
    jfinal = jax.tree_util.tree_map(np.asarray, jtr.state.params)

    cfg = tmm.MultiModalConfig(**geometry, dropout=0.0, embed_dropout=0.0,
                               mask_params=TMP(**MASK))
    model = tmm.MultiModal(cfg, device="cpu")
    model.load_state_dict(params_from_jax(init, cfg))
    tr = MultiModalTrainer(model, *_loaders(tloader, tsession),
                           OptimizerConfig(lr=1e-3),
                           _tcfg(TrainerConfig, tmp_path / "t"))
    modes = []
    sample_t = tr._sample_modes
    tr._sample_modes = lambda: modes.append(sample_t()) or modes[-1]
    losses = tr.train_epoch(0)["step_losses"]
    assert len(losses) == len(jlosses) == 1
    assert modes == jmodes                     # the same host draw
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    want = params_from_jax(jfinal, cfg)
    for name, p in tr.model.state_dict().items():
        if name.endswith("key.bias"):
            continue        # exact gradient 0: Adam steps on f32 noise
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# LayerNorm at widths outside 32..1024
# ---------------------------------------------------------------------------

LN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [48, 100, 2048])
def test_plain_layernorm_matches_jax_at_width(width, dtype):
    rng = np.random.default_rng(width)
    jd = getattr(jnp, dtype)
    x, g = (np.asarray(jnp.asarray(rng.normal(size=(4, 9, width)) * 2.0
                                   + 0.3, jnp.float32).astype(jd))
            for _ in range(2))
    scale = (rng.normal(size=width) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=width) * 0.1).astype(np.float32)
    module = jln.FusedLayerNorm(epsilon=1e-5, dtype=jd)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}

    def f(x, scale, bias):
        return module.apply({"params": {"scale": scale, "bias": bias}}, x)

    want, vjp = jax.vjp(f, jnp.asarray(x), params["params"]["scale"],
                        params["params"]["bias"])
    want_grads = vjp(jnp.asarray(g))
    dt = getattr(torch, dtype)
    tx, tg = (torch.from_numpy(np.array(a, np.float32)).to(dt)
              for a in (x, g))
    got = tln.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                         1e-5, dt)
    grads = tln.layer_norm_bwd_reference(tx, torch.from_numpy(scale), tg,
                                         1e-5)
    tol = LN_TOL[dtype]
    assert got.dtype == dt and grads[0].dtype == dt
    for name, a, b in zip(("y", "dx", "dscale", "dbias"), (got, *grads),
                          (want, *want_grads)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


# (width, dtype) -> (variant, lanes, values a lane, vector width)
LN_PLANS = {
    (1, "float32"): ("warp", 32, 1, 1),
    (48, "float32"): ("warp", 32, 2, 2),
    (48, "bfloat16"): ("warp", 32, 2, 2),
    (100, "float32"): ("warp", 32, 4, 4),
    (100, "bfloat16"): ("warp", 32, 4, 4),
    (256, "float32"): ("warp", 32, 8, 4),
    (256, "bfloat16"): ("warp", 32, 8, 8),
    (1001, "bfloat16"): ("warp", 32, 32, 1),
    (1024, "float32"): ("warp", 32, 32, 4),
    (1025, "float32"): ("block", 256, 8, 1),
    (1280, "float32"): ("block", 256, 8, 4),
    (1280, "bfloat16"): ("block", 256, 8, 8),
    (2048, "bfloat16"): ("block", 256, 8, 8),
    (2050, "bfloat16"): ("block", 256, 16, 2),
    (4096, "float32"): ("block", 256, 16, 4),
    (4096, "bfloat16"): ("block", 256, 16, 8),
}


@pytest.mark.parametrize("width,dtype", sorted(LN_PLANS))
def test_ln_plan_at_width(width, dtype):
    assert tuple(tln.ln_plan(width, getattr(torch, dtype))) == \
        LN_PLANS[width, dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ln_plan_covers_every_width(dtype):
    """At every width from 1 to 4096 the lanes' chunks cover the row, every
    access is aligned (the vector width divides H, at most 16 bytes); at a
    multiple of 32 up to 1024 the layout is the one the kernels had when
    they took only those widths (vector width min(values a lane, 16
    bytes)). Wider raises."""
    elem = torch.empty((), dtype=dtype).element_size()
    for H in range(1, 4097):
        p = tln.ln_plan(H, dtype)
        assert p.variant == ("warp" if H <= 1024 else "block")
        assert p.lanes == (32 if H <= 1024 else 256)
        assert p.epl & (p.epl - 1) == 0 and p.lanes * p.epl >= H
        assert H % p.vec == 0 and p.vec * elem <= 16 and p.epl % p.vec == 0
        assert p.lanes * p.epl < 2 * H or p.epl == 1
        if H % 32 == 0 and H <= 1024:
            assert p.vec == min(p.epl, 16 // elem)
    for H in (0, 4097):
        with pytest.raises(ValueError, match="4096"):
            tln.ln_plan(H, dtype)
