"""The port's optimizer (``train/schedule.py``) against the JAX package's
``make_optimizer`` (optax AdamW, torch-exact OneCycle with beta1 cycling,
global-norm clipping, ``MultiSteps`` accumulation).

Both get the same initial parameters (scale 0.1) and the same numpy
gradients for 50 mini-steps at lr 3e-3; the parameters agree within 1e-6
after every update (f32 AdamW arithmetic in two orders: torch decays the
parameter before adding the step, optax adds the two), and the learning
rate the port reports is the schedule JAX evaluates at the same update
count (rtol 1e-4, as JAX's own ``test_one_cycle_matches_torch``: JAX
evaluates the cosine in f32, torch in f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.train import schedule as js
from multi_modal_foundation_model_tpu_torch.train import schedule as ts

SHAPES = {"w": (6, 5), "b": (5,), "emb": (3, 4)}


def _run(cfg_kw, n_steps=50, grad_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    init = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * grad_scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(n_steps)]
    k = cfg_kw.get("gradient_accumulation_steps", 1)
    total = n_steps // k

    jcfg = js.OptimizerConfig(**cfg_kw)
    tx, schedule = js.make_optimizer(jcfg, total)
    jp = {n: jnp.asarray(v) for n, v in init.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)

    tparams = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for n, v in init.items()}
    opt = ts.Optimizer(tparams.values(), ts.OptimizerConfig(**cfg_kw),
                       total)
    updates_done = 0
    for g in grads:
        lr_before = opt.lr
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n].copy())
        updated = opt.step()
        upd, state = update({n: jnp.asarray(v) for n, v in g.items()},
                            state, jp)
        jp = optax.apply_updates(jp, upd)
        if updated:
            np.testing.assert_allclose(lr_before,
                                       float(schedule(updates_done)),
                                       rtol=1e-4)
            updates_done += 1
        for n, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[n]), atol=1e-6, rtol=0,
                                       err_msg=f"{n} after {updates_done}")
    assert updates_done == total
    return opt


@pytest.mark.parametrize("cfg_kw", [
    dict(lr=3e-3, wd=0.01),                                   # momentum cycle
    dict(lr=3e-3, wd=0.1, cycle_momentum=False),
    dict(lr=3e-3, wd=0.01, max_grad_norm=1.0),                # clipping
    dict(lr=3e-3, wd=0.01, gradient_accumulation_steps=2),
    dict(lr=3e-3, wd=0.01, max_grad_norm=2.0,
         gradient_accumulation_steps=2),
    dict(lr=1e-3, wd=0.01, scheduler="constant"),
], ids=["onecycle", "no_cycle", "clip", "accum2", "clip_accum2",
        "constant"])
def test_optimizer_matches_optax_for_50_steps(cfg_kw):
    _run(cfg_kw)


def test_clip_triggers_and_matches_optax():
    """Large gradients: every update is clipped, as optax computes it."""
    grads = [torch.full((3,), 3.0), torch.full((4,), -4.0)]
    norm = ts.clip_by_global_norm_(grads, 1.0)
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.full((3,), 3.0), jnp.full((4,), -4.0)], None)[0]
    assert abs(norm.item() - np.sqrt(9 * 3 + 16 * 4)) < 1e-5
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    _run(dict(lr=3e-3, max_grad_norm=0.5), n_steps=20, grad_scale=10.0)


def test_state_dict_round_trip_resumes_the_schedule():
    """A fresh optimizer loading the state of one 10 updates in continues
    exactly where it was, on the same schedule position."""
    cfg = ts.OptimizerConfig(lr=1e-2, gradient_accumulation_steps=2)
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=(4,)).astype(np.float32) for _ in range(30)]

    def make():
        p = torch.nn.Parameter(torch.ones(4))
        return p, ts.Optimizer([p], cfg, 15)

    pa, oa = make()
    for g in grads:
        pa.grad = torch.from_numpy(g.copy())
        oa.step()
    pb, ob = make()
    for g in grads[:21]:                      # mid-accumulation
        pb.grad = torch.from_numpy(g.copy())
        ob.step()
    state = ob.state_dict()
    pc, oc = make()
    with torch.no_grad():
        pc.copy_(pb)
    oc.load_state_dict(state)
    assert oc.lr == ob.lr and oc.count == 10 and oc.mini_step == 1
    for g in grads[21:]:
        pc.grad = torch.from_numpy(g.copy())
        oc.step()
    torch.testing.assert_close(pc, pa, atol=0, rtol=0)
