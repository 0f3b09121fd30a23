"""The port's bf16 compute path (mm.yaml's ``compute_dtype: bfloat16``)
against the JAX package's, on the CPU.

bf16 rounds at other places in the two frameworks: XLA's CPU backend may
keep bf16 intermediates in f32 inside a fusion where torch rounds after
every op, and ``F.linear`` adds its bias before the one rounding where JAX
rounds the product and then the sum. So the port's bf16 run is held two
ways:

- **against JAX's f32 run**: the port's bf16 error there is at most twice
  JAX's own bf16-vs-f32 error (relative L2 over each modality's preds, or
  over the step losses), ``TWO_SIDED = 2``;
- **against JAX's bf16 run directly**: relative L2 of the preds within
  2e-2, the loss within 1e-2 relative.

Covered: K2's plain version on bf16 operands against JAX's interpreted K2
(``_attn_bwd_kernel``, which reads bf16 and does f32 math, as the port's
kernel does), the toy model's eval forward, a 3-step trainer lockstep
(dropout 0, the deterministic MtM menu, constant learning rate), the
checkpoint round trip through ``load_model_data_local`` and
``params_from_jax`` into a bf16-configured model.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (TOY, jax_inputs, jax_model, make_batch,
                          port_model, torch_inputs)
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.eval import EvalForward
from multi_modal_foundation_model_tpu_torch.eval import loading as tload
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt
from multi_modal_foundation_model_tpu_torch.ops.masking import (
    MaskParams as TMP)
from multi_modal_foundation_model_tpu_torch.train import (
    MultiModalTrainer, OptimizerConfig, TrainerConfig)
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

TWO_SIDED = 2.0
PRED_REL, LOSS_REL = 2e-2, 1e-2
BF16_TOL = 2e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# K2's plain version on bf16 operands
# ---------------------------------------------------------------------------

B, TQ, H, D = 3, 20, 4, 16


def _attn_case(case, seed=0):
    """numpy f32 q, k, v, g holding bf16 values; key_pad (B, Tk); static
    or None."""
    tk = 28 if case == "cross" else TQ
    rng = np.random.default_rng(seed)

    def bf(shape):
        x = rng.normal(size=shape).astype(np.float32)
        return np.array(jnp.asarray(x).astype(jnp.bfloat16)
                        .astype(jnp.float32))

    q, k, v = bf((B, TQ, H * D)), bf((B, tk, H * D)), bf((B, tk, H * D))
    g = bf((B, TQ, H * D))
    pad = np.ones((B, tk), np.int32)
    pad[1, tk - 5:] = 0
    if case == "encoder_eye_pad":
        static = np.eye(TQ, tk, dtype=np.int32)
    elif case == "decoder_pad_padded_trial":
        pad[2] = 0
        static = None
    else:
        static = (rng.random((TQ, tk)) > 0.7).astype(np.int32)
    return q, k, v, g, pad, static


@pytest.mark.parametrize("case", ["encoder_eye_pad",
                                  "decoder_pad_padded_trial", "cross"])
def test_bf16_bwd_reference_matches_jax_k2(case):
    """bf16 in, bf16 dq/dk/dv out: the port's plain K2 on its own forward's
    lse against ``jax.grad`` through JAX's Pallas attention (K1/K2 in
    interpret mode) on the same bf16 values; atol = rtol = 2e-2 (f32 math
    on both sides, one bf16 rounding of each output)."""
    q, k, v, g, pad, static = _attn_case(case)
    spec = jatt.MaskSpec(
        key_pad=jnp.asarray(pad),
        static=None if static is None else jnp.asarray(static))
    jq, jk, jv, jg = (jnp.asarray(x).astype(jnp.bfloat16)
                      for x in (q, k, v, g))

    def f(q_, k_, v_):
        out = jatt.multi_head_attention(q_, k_, v_, H, mask_spec=spec,
                                        impl="pallas")
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    assert all(w.dtype == jnp.bfloat16 for w in want)
    tq, tk_, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    tspec = tatt.MaskSpec(
        key_pad=torch.from_numpy(pad),
        static=None if static is None else torch.from_numpy(static))
    key_pad, stat = tatt.spec_operands(tspec, B, TQ, k.shape[1], "cpu")
    scale = 1.0 / math.sqrt(D)
    _, lse = tatt.attention_reference(tq, tk_, tv, key_pad, stat, H, scale,
                                      with_lse=True)
    got = tatt.attention_bwd_reference(tq, tk_, tv, key_pad, stat, tg, lse,
                                       H, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=BF16_TOL,
                                   rtol=BF16_TOL, err_msg=name)
    # the Function as the model runs it passes autograd's bf16 g through
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk_, tv)]
    out = tatt.multi_head_attention(*leaves, H, mask_spec=tspec)
    assert out.dtype == torch.bfloat16
    for a, b in zip(torch.autograd.grad(out, leaves, tg), got):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the eval forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(JAX bf16 model, JAX f32 model, their params, the port's bf16
    model carrying them)."""
    jbf, params = jax_model(compute_dtype=jnp.bfloat16)
    jf32 = jmm.MultiModal(dataclasses.replace(jbf.config,
                                              compute_dtype=jnp.float32))
    return jbf, jf32, params, port_model(params, compute_dtype="bfloat16")


@pytest.mark.parametrize("kind", ["random", "forward_pred"])
def test_bf16_eval_forward_matches_jax(models, kind):
    jbf, jf32, params, tmodel = models
    spikes, beh, attn, ts = make_batch(21, 4, pad_tail=1)
    rng = np.random.default_rng(22)
    if kind == "random":
        ap_ev = (rng.random(spikes.shape) > 0.5).astype(np.int32)
    else:
        ap_ev = np.zeros_like(spikes, np.int32)
        ap_ev[:, -6:] = 1
    beh_ev = (rng.random(beh.shape) > 0.5).astype(np.int32)
    jin = jax_inputs(spikes, beh, attn, ts, ap_ev, beh_ev)
    want_bf = jax.jit(jbf.apply)({"params": params}, jin)
    want_32 = jax.jit(jf32.apply)({"params": params}, jin)
    with torch.inference_mode():
        got = tmodel(torch_inputs(spikes, beh, attn, ts, ap_ev, beh_ev))
    for mod in ("ap", "behavior"):
        p, b, f = (np.asarray(x.mod_preds[mod], np.float32)
                   for x in (got, want_bf, want_32))
        assert got.mod_preds[mod].dtype == torch.float32
        assert _rel(p, b) <= PRED_REL, mod
        assert _rel(p, f) <= TWO_SIDED * _rel(b, f), mod
    assert abs(got.loss.item() - float(want_bf.loss)) <= LOSS_REL * abs(
        float(want_bf.loss))


# ---------------------------------------------------------------------------
# a 3-step trainer lockstep
# ---------------------------------------------------------------------------

N_AP, T = TOY["n_channels"]["ap"], TOY["max_F"]
MASK = dict(channels=(1, 5, 20, 30), timesteps=(12, 15, 19))
MENU = ("co-smooth", "forward-pred")


def _loaders(loader_mod, session_mod):
    sp = session_mod.synthetic_splits(seed=0, n_trials=30, n_neurons=N_AP,
                                      n_timesteps=T)
    kw = dict(batch_size=8, max_time_length=T, max_space_length=N_AP)
    return (loader_mod.make_loader(sp.train, **kw),
            loader_mod.make_loader(sp.val, shuffle=False, **kw))


def _tcfg(cls, tmp):
    return cls(num_epochs=1, log_dir=str(tmp), seed=0, mask_type="input",
               mask_mode=MENU, mixed_training=True, eval_every=10 ** 9)


def _jax_run(tmp, compute_dtype):
    """One epoch of the JAX trainer (its plain attention): initial params,
    per-step losses, host draws, final params."""
    cfg = jmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=JMP(**MASK), attn_impl="xla",
                               compute_dtype=compute_dtype)
    train, val = _loaders(jloader, jsession)
    tr = jtrainer.MultiModalTrainer(
        jmm.MultiModal(cfg), train, val, JOC(lr=1e-3, scheduler="constant"),
        _tcfg(jtrainer.TrainerConfig, tmp))
    init = jax.tree_util.tree_map(np.asarray, tr.state.params)
    losses, modes = [], []
    get_step, sample = tr._get_train_step, tr._sample_modes

    def recording(training_mode, use_mtm):
        step = get_step(training_mode, use_mtm)

        def run(*args):
            state, loss = step(*args)
            losses.append(float(loss))
            return state, loss
        return run

    tr._get_train_step = recording
    tr._sample_modes = lambda: modes.append(sample()) or modes[-1]
    tr.train_epoch(0)
    return init, losses, modes, jax.tree_util.tree_map(np.asarray,
                                                       tr.state.params)


def _port_trainer(tmp, init_params=None):
    cfg = tmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=TMP(**MASK),
                               compute_dtype="bfloat16")
    model = tmm.MultiModal(cfg, device="cpu")
    if init_params is not None:
        model.load_state_dict(params_from_jax(init_params, cfg))
    train, val = _loaders(tloader, tsession)
    return MultiModalTrainer(model, train, val,
                             OptimizerConfig(lr=1e-3, scheduler="constant"),
                             _tcfg(TrainerConfig, tmp))


def test_bf16_trainer_lockstep_with_jax(tmp_path):
    """The same init, batches and host draws: the port's bf16 step losses
    and parameter updates against JAX's bf16 and f32 runs."""
    init, l_bf, modes_bf, fin_bf = _jax_run(tmp_path / "jbf", jnp.bfloat16)
    init32, l_32, modes_32, fin_32 = _jax_run(tmp_path / "j32", jnp.float32)
    jax.tree_util.tree_map(np.testing.assert_array_equal, init, init32)
    tr = _port_trainer(tmp_path / "t", init)
    modes = []
    sample = tr._sample_modes
    tr._sample_modes = lambda: modes.append(sample()) or modes[-1]
    losses = tr.train_epoch(0)["step_losses"]
    assert modes == modes_bf == modes_32 and len(losses) >= 3
    assert all(math.isfinite(x) for x in losses)
    assert _rel(losses, l_bf) <= LOSS_REL
    assert _rel(losses, l_32) <= TWO_SIDED * _rel(l_bf, l_32)
    # the parameters' updates (final - initial), all parameters but the
    # key biases (their exact gradient is 0: Adam steps on rounding noise)
    cfg = tr.model.config
    start = params_from_jax(init, cfg)
    ends = {name: params_from_jax(p, cfg) for name, p in
            (("bf16", fin_bf), ("f32", fin_32))}
    names = [n for n in start if not n.endswith("key.bias")]

    def delta(sd):
        return np.concatenate([(sd[n] - start[n]).numpy().ravel()
                               for n in names])

    got = np.concatenate([(tr.model.state_dict()[n] - start[n]).numpy()
                          .ravel() for n in names])
    d_bf, d_32 = delta(ends["bf16"]), delta(ends["f32"])
    assert _rel(got, d_32) <= TWO_SIDED * _rel(d_bf, d_32)


# ---------------------------------------------------------------------------
# checkpoints and converted weights
# ---------------------------------------------------------------------------

def test_bf16_checkpoint_round_trip_through_eval_reload(tmp_path):
    """A bf16 model trains, saves, and comes back from
    ``load_model_data_local`` as a bf16-configured model with f32 master
    weights that gives the same eval forward."""
    tr = _port_trainer(tmp_path)
    losses = tr.train_epoch(0)["step_losses"]
    assert all(math.isfinite(x) for x in losses)
    tr.save_model("last", epoch=0)
    test = tsession.synthetic_splits(seed=0, n_trials=30, n_neurons=N_AP,
                                     n_timesteps=T).test
    model, loader = tload.load_model_data_local(
        model_dir=str(tmp_path), test_session=test, checkpoint_name="last",
        max_time_length=T, max_space_length=N_AP, device="cpu")
    assert model.config.compute_dtype == "bfloat16"
    assert tload.load_model_config(str(tmp_path)).compute_dtype == "bfloat16"
    for (n, a), b in zip(tr.model.state_dict().items(),
                         model.state_dict().values()):
        assert b.dtype == torch.float32, n
        assert torch.equal(a, b), n
    batch = next(iter(loader))
    got = EvalForward(model, batch).forward()
    want = EvalForward(tr.model, batch).forward()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and np.isfinite(a).all()


def test_params_from_jax_into_a_bf16_model(models):
    """JAX's bf16 model keeps f32 params; they load unchanged into the
    port's bf16-configured model, which keeps them f32."""
    jbf, _, params, tmodel = models
    assert all(np.asarray(p).dtype == np.float32
               for p in jax.tree_util.tree_leaves(params))
    sd = params_from_jax(params, tmodel.config)
    for name, p in tmodel.state_dict().items():
        assert p.dtype == torch.float32, name
        assert torch.equal(p, sd[name]), name
    assert tmodel.compute_dtype == torch.bfloat16
    assert np.array_equal(
        sd["decoder_proj_context.weight"].numpy(),
        np.asarray(params["decoder_proj_context"]["kernel"]).T)
