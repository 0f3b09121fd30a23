"""The port's ``utils/profiling.py`` against the JAX package's, and its FLOP
count of a training step.

``StepTimer`` reads the same times as JAX's on the same (simulated)
clock; the peak table names the H100 and falls back to the CPU entry;
``MFUTracker`` counts JAX's test case, a 128 x 128 product, exactly. One
training step of the TOY model (the forward, the loss's backward) counts
exactly ``step_flops``, with remat on and off, at dropout 0 and 0.4, on
the plain path and through ``_FlashAttention``'s kernel branch (the
launches replaced by the plain versions); JAX's XLA count of the same
step (``attn_impl="xla"``, the same converted weights) reads 1.06-1.21
times it, measured (XLA also counts elementwise work), and is held to
[1, 1.25]. ``profile_model`` prints JAX's six keys on the CPU.
"""

import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from multi_modal_foundation_model_tpu.utils import profiling as jprof
from multi_modal_foundation_model_tpu_torch import utils as tutils
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import attention as att
from multi_modal_foundation_model_tpu_torch.scripts import profile_model
from multi_modal_foundation_model_tpu_torch.utils import profiling as prof

B = 4
XLA_RATIO = (1.0, 1.25)


class _Clock:
    """A ``time.perf_counter`` that advances by the given sleeps."""

    def __init__(self, sleeps):
        self.t, self.sleeps = 0.0, list(sleeps)

    def __call__(self):
        return self.t

    def sleep(self):
        self.t += self.sleeps.pop(0)


@pytest.mark.parametrize("warmup", [0, 2, 7])
def test_step_timer_matches_jax(warmup, monkeypatch):
    sleeps = [0.5, 0.25, 0.125, 0.2, 0.3, 0.1]
    got = []
    for cls in (jprof.StepTimer, prof.StepTimer):
        clock = _Clock(sleeps)
        monkeypatch.setattr(time, "perf_counter", clock)
        timer = cls(warmup=warmup)
        for _ in sleeps:
            with timer:
                clock.sleep()
        got.append((timer.times, timer.mean_step_s, timer.steps_per_sec()))
    assert got[0] == got[1]
    assert len(got[1][0]) == max(len(sleeps) - warmup, 0)


def test_chip_peak_flops_table(monkeypatch):
    assert prof.chip_peak_flops() == 1e11
    assert prof.chip_peak_flops(torch.device("cpu")) == 1e11
    assert prof.chip_peak_flops("cpu") == 1e11
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4e12),
                       ("NVIDIA A100-SXM4-80GB", 1e11),
                       ("some other card", 1e11)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        assert prof.chip_peak_flops(torch.device("cuda")) == peak
        assert prof.chip_peak_flops("cuda:0") == peak
    assert jprof.CHIP_PEAK_FLOPS["cpu"] == prof.CHIP_PEAK_FLOPS["cpu"]


def test_mfu_tracker_counts_jax_case():
    """JAX's ``test_mfu_from_compiled_step``: a 128 x 128 product."""
    x = torch.ones(128, 128)

    def f(a):
        return a @ a

    flops = tutils.MFUTracker.flops_of(f, x)
    assert flops == 2 * 128 ** 3
    mfu = tutils.MFUTracker(flops, peak_flops=1e12)
    assert 0 < mfu.mfu(1e-3) < 1.0
    assert mfu.mfu(0.0) == 0.0
    assert tutils.MFUTracker(flops, n_devices=2, peak_flops=1e12).mfu(
        1e-3) == mfu.mfu(1e-3) / 2
    assert tutils.MFUTracker(flops).peak == 1e11
    jx = jax.numpy.ones((128, 128))
    assert jprof.MFUTracker.flops_of(lambda a: a @ a, jx) == flops


def _port_step(remat, dropout, state=None):
    """(a TOY training step's function, its model's config); the model
    carries ``state`` where one is given."""
    cfg = tmm.MultiModalConfig(**tp.TOY, dropout=dropout, embed_dropout=0.2,
                               remat_layers=remat)
    model = tmm.MultiModal(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    spikes, beh, attn, ts = tp.make_batch(0, B)
    inputs = {m: dataclasses.replace(x, eval_mask=None) for m, x in
              tp.torch_inputs(spikes, beh, attn, ts, spikes, beh).items()}

    def step():
        model(inputs, training=True, seed=3).loss.backward()
    return step, cfg


def _want(cfg, remat):
    # no eval masks: the masker draws a temporal mask on both modalities
    return prof.step_flops(cfg, B, temporal_masks=2)[
        "step_flops_with_remat" if remat else "step_flops"]


@pytest.mark.parametrize("dropout", [0.0, 0.4])
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_step_count_is_the_analytic_count(remat, dropout):
    step, cfg = _port_step(remat, dropout)
    assert tutils.MFUTracker.flops_of(step) == _want(cfg, remat)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_kernel_branch_counts_as_the_plain_path(remat, monkeypatch):
    """``_FlashAttention`` forced onto its kernel branch, K1 and K2's
    launches replaced by the plain versions: the same count, and the
    branch ran."""
    plain_step, cfg = _port_step(remat, 0.4)
    plain = tutils.MFUTracker.flops_of(plain_step)
    calls = []

    def stub(fn):
        def launch(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return launch

    monkeypatch.setattr(att, "attention_fwd", stub(att.attention_reference))
    monkeypatch.setattr(att, "attention_bwd",
                        stub(att.attention_bwd_reference))
    apply = att._FlashAttention.apply
    monkeypatch.setattr(att._FlashAttention, "apply",
                        lambda *a: apply(*a[:9], True, a[10]))
    kernel_step, _ = _port_step(remat, 0.4)
    assert tutils.MFUTracker.flops_of(kernel_step) == plain == \
        _want(cfg, remat)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    assert calls.count("attention_bwd_reference") == n_attn
    assert calls.count("attention_reference") == n_attn * (1 + remat)


def test_no_dispatch_mode_runs_the_functions_directly(monkeypatch):
    """Without a dispatch mode the operators are not looked up (a missing
    namespace in their place breaks nothing): the eager and graph paths
    run as they did; under the counter they are."""
    monkeypatch.setattr(att, "_OPS", "mmfm_attention_absent")
    step, _ = _port_step(True, 0.4)
    step()
    with pytest.raises(AttributeError):
        tutils.MFUTracker.flops_of(step)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_xla_counts_at_least_the_port(remat):
    """JAX's ``MFUTracker.flops_of`` of the same step on the same weights
    (XLA attention), embedding dropout 0.2: measured 1.113 / 1.206 (no
    remat, layer dropout 0 / 0.4) and 1.058 / 1.184 (remat) times the
    port's count on the CPU."""
    jmodel, jparams = tp.jax_model(attn_impl="xla", seed=0, dropout=0.4,
                                   embed_dropout=0.2, remat_layers=remat)
    spikes, beh, attn, ts = tp.make_batch(0, B)
    inputs = {m: dataclasses.replace(x, eval_mask=None) for m, x in
              tp.jax_inputs(spikes, beh, attn, ts, spikes, beh).items()}

    def loss(params, inputs):
        key = jax.random.PRNGKey(3)
        return jmodel.apply({"params": params}, inputs, training=True,
                            rngs={"mask": key, "dropout": key}).loss

    xla = jprof.MFUTracker.flops_of(jax.value_and_grad(loss), jparams,
                                    inputs)
    cfg = tmm.MultiModalConfig(**tp.TOY, dropout=0.4, embed_dropout=0.2,
                               remat_layers=remat)
    step, _ = _port_step(remat, 0.4, tp.params_from_jax(jparams, cfg))
    port = tutils.MFUTracker.flops_of(step)
    ratio = xla / port
    assert XLA_RATIO[0] <= ratio <= XLA_RATIO[1], ratio


def test_profile_model_prints_jax_keys(capsys, tmp_path, monkeypatch):
    """JAX's arguments on the CPU, the flagship cut to one layer a side
    and 64 wide (the full depth takes minutes a step here)."""
    flagship = profile_model._flagship
    small = dict(hidden_size=64, n_heads=4, inter_size=128, n_enc_layers=1,
                 n_dec_layers=1)
    monkeypatch.setattr(profile_model, "_flagship",
                        lambda *a, **k: flagship(*a, **k, **small))
    rec = profile_model.main(["--device", "cpu", "--batch_size", "2",
                              "--n_neurons", "24", "--n_steps", "2",
                              "--trace_dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert set(line) == {"step_time_ms", "seq_per_sec", "flops_per_step",
                         "chip_peak_flops", "mfu", "loss"}
    cfg = flagship(n_neurons=24, device="cpu", **small).config
    assert line["flops_per_step"] == prof.step_flops(
        cfg, 2, temporal_masks=2)["step_flops_with_remat"]
    assert line["chip_peak_flops"] == 1e11
    assert 0 < line["mfu"] and np.isfinite(line["loss"])
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_example_batch_is_jax_draws():
    import __graft_entry__ as graft

    ours = profile_model._example_batch(np.random.default_rng(0), 3, 10, 5)
    theirs = graft._example_batch(np.random.default_rng(0), 3, 10, 5)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
