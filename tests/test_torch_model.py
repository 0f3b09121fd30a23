"""Port ``MultiModal`` against the JAX package on converted weights.

Eval forward (``training=False``, explicit eval masks): preds within atol
1e-4 (ten residual blocks of f32 GEMMs summed in other orders), loss,
``mod_loss`` and ``mod_n_examples`` within rtol 1e-5. The JAX side runs
the Pallas attention kernel in interpret mode. The full geometry of the
reference model is marked slow.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (FULL, TOY, jax_inputs, jax_model, make_batch,
                          port_model, torch_inputs)
from multi_modal_foundation_model_tpu.eval import loading as jload
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
from multi_modal_foundation_model_tpu_torch.eval import loading as tload
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm

PRED_ATOL, LOSS_RTOL = 1e-4, 1e-5


def _eval_masks(kind, spikes, beh, rng):
    B, T, N = spikes.shape
    if kind == "none":
        return (np.zeros_like(spikes, np.int32),
                np.zeros_like(beh, np.int32))
    if kind == "random":
        return ((rng.random(spikes.shape) > 0.5).astype(np.int32),
                (rng.random(beh.shape) > 0.5).astype(np.int32))
    if kind == "forward_pred":
        ap = np.zeros_like(spikes, np.int32)
        ap[:, T - 6:] = 1
        return ap, np.zeros_like(beh, np.int32)
    if kind == "modal_behavior":
        return np.zeros_like(spikes, np.int32), np.ones_like(beh, np.int32)
    raise ValueError(kind)


def _compare(jmodel, jparams, tmodel, seed, B, kind, pad_tail=0,
             geometry=TOY):
    t, n_ap = geometry["max_F"], geometry["n_channels"]["ap"]
    spikes, beh, attn, ts = make_batch(seed, B, t, n_ap, pad_tail=pad_tail)
    ap_ev, beh_ev = _eval_masks(kind, spikes, beh,
                                np.random.default_rng(seed + 1))
    want = jax.jit(jmodel.apply)(
        {"params": jparams}, jax_inputs(spikes, beh, attn, ts, ap_ev, beh_ev))
    with torch.inference_mode():
        got = tmodel(torch_inputs(spikes, beh, attn, ts, ap_ev, beh_ev))
    for mod in ("ap", "behavior"):
        np.testing.assert_allclose(got.mod_preds[mod].numpy(),
                                   np.asarray(want.mod_preds[mod]),
                                   atol=PRED_ATOL, rtol=0, err_msg=mod)
        np.testing.assert_allclose(got.mod_loss[mod].item(),
                                   float(want.mod_loss[mod]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=mod)
        assert got.mod_n_examples[mod].item() == float(
            want.mod_n_examples[mod])
        np.testing.assert_array_equal(got.mod_targets[mod].numpy(),
                                      np.asarray(want.mod_targets[mod]))
    np.testing.assert_allclose(got.loss.item(), float(want.loss),
                               rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def toy():
    jmodel, jparams = jax_model()
    return jmodel, jparams, port_model(jparams)


@pytest.mark.parametrize("kind", ["none", "random", "forward_pred",
                                  "modal_behavior"])
def test_forward_matches_jax(toy, kind):
    _compare(*toy, seed=10, B=4, kind=kind)


def test_forward_with_padded_trial_matches_jax(toy):
    """The last trial is padding: fully-masked decoder rows (uniform
    attention) and zero loss weight."""
    _compare(*toy, seed=11, B=4, kind="random", pad_tail=1)


@pytest.mark.parametrize("over", [
    dict(decoder_sep_mask=True),
    dict(decoder_causal_mask=True),
    dict(decoder_causal_mask=True, decoder_sep_mask=True),
    dict(mod_loss_weights={"ap": 1.0, "behavior": 20.0}),
    dict(share_modality_embeddings=False),
    dict(use_pos=False, embed_act="gelu", embed_scale=2.0),
    dict(use_scalenorm=True),
], ids=["sep", "causal", "causal_sep", "loss_weights", "unshared_emb",
        "no_pos", "scalenorm"])
def test_config_variants_match_jax(over):
    jmodel, jparams = jax_model(seed=1, **over)
    _compare(jmodel, jparams, port_model(jparams, **over), seed=12, B=3,
             kind="random", pad_tail=1)


@pytest.mark.slow
def test_forward_full_geometry_matches_jax():
    jmodel, jparams = jax_model(geometry=FULL)
    _compare(jmodel, jparams, port_model(jparams, geometry=FULL), seed=13,
             B=4, kind="random", geometry=FULL)


def test_token_zero_groups_equal_separate_forwards(toy):
    """A batch of G stacked variants zeroed per group gives what G
    separate forwards give; zeroing by the batch's row 0 alone does not
    (variant 0's mask would flip the other variants' tokens)."""
    _, _, tmodel = toy
    spikes, beh, attn, ts = make_batch(14, 3)
    rng = np.random.default_rng(15)
    variants = [_eval_masks("random", spikes, beh, rng) for _ in range(4)]
    with torch.inference_mode():
        sep = [tmodel(torch_inputs(spikes, beh, attn, ts, a, b))
               .mod_preds["ap"] for a, b in variants]
        stacked = [np.concatenate(x) for x in zip(*[
            (spikes, beh, attn, ts, a, b) for a, b in variants])]
        grouped = tmodel(torch_inputs(*stacked), token_zero_groups=4)
        flat = tmodel(torch_inputs(*stacked))
    torch.testing.assert_close(grouped.mod_preds["ap"], torch.cat(sep),
                               atol=1e-5, rtol=0)
    assert not torch.allclose(flat.mod_preds["ap"], torch.cat(sep),
                              atol=1e-3)


def test_state_dict_names_are_the_reference_names(toy):
    """Reference names, separate q/k/v, the shared modality table under
    both the encoder and the decoder key (one tensor)."""
    _, _, tmodel = toy
    sd = tmodel.state_dict()
    for k in ("encoder_embeddings.ap.embedder.token_embed.weight",
              "encoder_embeddings.ap.embedder.mod_emb.weight",
              "decoder_embeddings.behavior.embedder.pos_embed.weight",
              "decoder_embeddings.ap.out.weight",
              "encoder.1.attn.value.bias", "decoder.0.cross_attn.key.weight",
              "decoder.1.query_norm.weight", "decoder.1.context_norm.bias",
              "encoder_norm.weight", "decoder_proj_context.bias"):
        assert k in sd, k
    enc = tmodel.encoder_embeddings["ap"].embedder.mod_emb
    assert tmodel.decoder_embeddings["ap"].embedder.mod_emb is enc


def test_config_json_round_trip_both_ways(tmp_path):
    """The port reads the JAX package's model_config.json and back."""
    jcfg = jmm.MultiModalConfig(
        **TOY, mask_params=JMP(ratio=0.2, channels=(1, 2), timesteps=(3,)),
        mod_loss_weights={"behavior": 5.0}, compute_dtype=jnp.bfloat16,
        decoder_sep_mask=True)
    jload.save_model_config(str(tmp_path / "j"), jcfg)
    tcfg = tload.load_model_config(str(tmp_path / "j"))
    assert tcfg.compute_dtype == "bfloat16"
    assert tcfg.mask_params.channels == (1, 2)
    assert json.loads(json.dumps(tcfg.to_json_dict())) == json.loads(
        json.dumps(jcfg.to_json_dict()))
    tload.save_model_config(str(tmp_path / "t"), tcfg)
    assert jload.load_model_config(str(tmp_path / "t")) == jcfg
    assert tmm.MultiModalConfig.from_json_dict(tcfg.to_json_dict()) == tcfg


def test_unported_paths_raise(toy):
    """What is still unported raises: session stitching, the
    device-resident trainer data and the loader's samplers. bf16 compute,
    unported in the first two slices, now builds; another compute dtype
    is refused."""
    from multi_modal_foundation_model_tpu_torch.data import loader, session
    from multi_modal_foundation_model_tpu_torch.train import (
        MultiModalTrainer, OptimizerConfig, TrainerConfig)

    _, _, tmodel = toy
    with pytest.raises(NotImplementedError):
        tmm.MultiModal(tmm.MultiModalConfig(**TOY, n_sessions=2),
                       device="cpu")
    bf16 = tmm.MultiModal(tmm.MultiModalConfig(**TOY,
                                               compute_dtype="bfloat16"),
                          device="cpu")
    assert bf16.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tmm.MultiModal(tmm.MultiModalConfig(**TOY, compute_dtype="float16"),
                       device="cpu")
    sess = session.synthetic_session(seed=0, n_trials=8,
                                     n_neurons=TOY["n_channels"]["ap"],
                                     n_timesteps=TOY["max_F"])
    kw = dict(batch_size=4, max_time_length=TOY["max_F"],
              max_space_length=TOY["n_channels"]["ap"])
    for sampler in ("length_grouped", "stitch"):
        with pytest.raises(NotImplementedError):
            loader.make_loader(sess, sampler=sampler, **kw)
    train = loader.make_loader(sess, **kw)
    with pytest.raises(NotImplementedError):
        MultiModalTrainer(tmodel, train, None, OptimizerConfig(),
                          TrainerConfig(mixed_session_batches=True,
                                        log_dir="unused"))
    # the masker and training, unported in the first slice, now run
    spikes, beh, attn, ts = make_batch(16, 2)
    inputs = torch_inputs(spikes, beh, attn, ts,
                          *_eval_masks("none", spikes, beh, None))
    inputs["ap"] = dataclasses.replace(inputs["ap"], eval_mask=None)
    out = tmodel(inputs, masking_mode="temporal", training=True, seed=0)
    assert torch.isfinite(out.loss)
    with pytest.raises(ValueError):                 # sampling needs a seed
        tmodel(inputs)


def test_port_init_is_seeded():
    cfg = tmm.MultiModalConfig(**TOY)
    a = tmm.MultiModal(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    b = tmm.MultiModal(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), n
