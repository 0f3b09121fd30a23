"""AdamW + OneCycle, global-norm clipping and gradient accumulation.

Port of ``multi_modal_foundation_model_tpu/train/schedule.py``, whose
optax chain is ``MultiSteps(chain(clip_by_global_norm, adamw))`` with the
learning rate and beta1 from torch-exact OneCycle schedules (JAX's own
``test_one_cycle_matches_torch`` holds them against torch). Here the same
update runs on torch's own pieces:

- ``torch.optim.AdamW`` (b2 0.999; optax's adamw and torch's compute the
  same update, weight decay on every parameter);
- ``torch.optim.lr_scheduler.OneCycleLR`` (cosine, two phases,
  ``cycle_momentum`` cycling beta1 0.95 -> 0.85 -> 0.95);
- clipping as optax computes it: ``g`` kept when the global norm is below
  ``max_grad_norm``, else ``g / norm * max_grad_norm`` (torch's
  ``clip_grad_norm_`` adds 1e-6 to the norm);
- ``MultiSteps`` accumulation: the running mean of ``k`` mini-step
  gradients, one optimizer update (and one schedule step) every ``k``.

The update itself is written in torch's foreach operations and reads
every per-update scalar from a small f32 device buffer (``hyper``): the
decay factor 1 - lr * wd, beta1 and 1 - beta1, the step size -lr / (1 -
beta1^t), sqrt(1 - beta2^t), and the accumulation divisor. The host
computes them in f64 from the schedule at the update count, as
``torch.optim.AdamW`` does with its Python scalars (``host_hyper``), and
the trainer uploads them with the step's other inputs. So the update holds
no host float and allocates nothing that outlives it: the moments and the
accumulator are allocated once and ``load_state_dict`` copies into them;
the trainer hands it the step's gradients from ``torch.autograd.grad``
(in a CUDA graph of the step they sit at fixed addresses of its pool, and
no gradient is accumulated into a ``.grad`` and zeroed again), so a graph
replays the update with each step's own scalars. It computes torch's AdamW in another order (beta1 m +
(1 - beta1) g where torch lerps; the scalars rounded to f32 before use),
within f32 rounding of ``torch.optim.AdamW``.

The schedule is a function of the update count, as optax's is: a restored
run rebuilds it for the current total and advances it to the count. Two
departures from JAX's own formula, both outside real runs: past the end of
the schedule the learning rate stays at its last value (optax's formula
keeps going; torch's scheduler refuses to step), and with
``warmup_pct * total_steps < 2`` torch's warm-up phase is shorter than one
step where JAX clamps it to one (``schedule.py:75`` there).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

BETA2 = 0.999
# the per-update scalars of the ``hyper`` buffer
HYPER = ("decay", "beta1", "one_minus_beta1", "neg_step", "bc2_sqrt",
         "acc_div")
(_DECAY, _BETA1, _W1, _NEG_STEP, _BC2_SQRT, _ACC_DIV) = range(len(HYPER))


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1.0e-4
    wd: float = 0.01
    eps: float = 1.0e-8
    warmup_pct: float = 0.15
    div_factor: float = 10.0
    final_div_factor: float = 1.0e4
    scheduler: str = "cosine"          # "cosine" (OneCycle) | "constant"
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    gradient_accumulation_steps: int = 1
    max_grad_norm: Optional[float] = None


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``, in place, without a host sync:
    returns the global norm (a device scalar)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


class Optimizer:
    """JAX ``make_optimizer``'s optax chain over ``params``.

    ``step()`` after each backward pass accumulates (when
    ``gradient_accumulation_steps > 1``), clips, updates, advances the
    schedule, and zeroes the gradients in place; it returns whether it
    updated. A captured training step splits it: the host takes
    ``will_update()`` and ``host_hyper()`` before the step and ``advance()``
    after it, and the step itself runs ``apply(hyper, update)``, device
    operations only."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimizerConfig, total_steps: int):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.total_steps = max(int(total_steps), 1)
        self.k = int(cfg.gradient_accumulation_steps)
        self.one_cycle = cfg.scheduler == "cosine" and self.total_steps > 1
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else [])
        dev = self.params[0].device if self.params else None
        self.hyper = torch.zeros(len(HYPER), dtype=torch.float32, device=dev)
        self._zero_grads: Dict[int, torch.Tensor] = {}
        self.count = 0        # updates applied (optax's inner count)
        self.mini_step = 0    # mini-steps accumulated toward the next one
        self._rebuild_schedule()

    # ------------------------------------------------------------------
    # the schedule, on the host
    # ------------------------------------------------------------------

    def _rebuild_schedule(self) -> None:
        """OneCycleLR for ``total_steps`` on a holder optimizer (it only
        carries the schedule's lr and betas); its values are read by update
        count as the count advances."""
        self._sched_vals: List[Tuple[float, float]] = []
        self.sched = None
        if not self.one_cycle:
            return
        cfg = self.cfg
        self._holder = torch.optim.AdamW([torch.zeros(1)], lr=cfg.lr,
                                         betas=(0.9, BETA2))
        self.sched = torch.optim.lr_scheduler.OneCycleLR(
            self._holder, max_lr=cfg.lr, total_steps=self.total_steps,
            pct_start=cfg.warmup_pct, anneal_strategy="cos",
            cycle_momentum=cfg.cycle_momentum,
            base_momentum=cfg.base_momentum, max_momentum=cfg.max_momentum,
            div_factor=cfg.div_factor, final_div_factor=cfg.final_div_factor)

    def schedule_at(self, count: int) -> Tuple[float, float]:
        """(lr, beta1) of the update with count ``count``; past the end of
        the schedule its last value."""
        if self.sched is None:
            return self.cfg.lr, 0.9
        vals = self._sched_vals
        while len(vals) <= min(count, self.total_steps):
            if vals:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    self.sched.step()
            group = self._holder.param_groups[0]
            vals.append((float(group["lr"]), float(group["betas"][0])))
        return vals[min(count, len(vals) - 1)]

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule_at(self.count)[0]

    def will_update(self) -> bool:
        """Whether the next mini-step applies an update."""
        return self.mini_step + 1 == self.k

    def host_hyper(self) -> np.ndarray:
        """The ``hyper`` scalars of the next mini-step (f32, ``HYPER``
        order), computed in f64 as torch's AdamW computes its scalars."""
        lr, beta1 = self.schedule_at(self.count)
        t = self.count + 1
        out = np.zeros(len(HYPER), dtype=np.float32)
        out[_DECAY] = 1.0 - lr * self.cfg.wd
        out[_BETA1], out[_W1] = beta1, 1.0 - beta1
        out[_NEG_STEP] = -lr / (1.0 - beta1 ** t)
        out[_BC2_SQRT] = math.sqrt(1.0 - BETA2 ** t)
        out[_ACC_DIV] = self.mini_step + 1
        return out

    def advance(self) -> None:
        """Count the mini-step just run (host only)."""
        self.mini_step += 1
        if self.mini_step == self.k:
            self.mini_step = 0
            self.count += 1

    # ------------------------------------------------------------------
    # the update, on the device
    # ------------------------------------------------------------------

    @torch.no_grad()
    def apply(self, hyper: torch.Tensor, update: bool,
              grads: Optional[Sequence[Optional[torch.Tensor]]] = None
              ) -> None:
        """One mini-step on the device from the scalars in ``hyper``:
        accumulate (``k > 1``), and with ``update`` clip and apply AdamW.
        ``grads`` (one per parameter, None for one without a gradient) are
        used as scratch; without them the parameters' ``.grad`` are used and
        zeroed in place after. Nothing here reads the host."""
        owned: List[torch.Tensor] = []      # .grad tensors, zeroed after
        if grads is None:
            grads = owned = [p.grad for p in self.params]
        else:
            grads = [self._zeros(i) if g is None else g
                     for i, g in enumerate(grads)]
        if self.k > 1:
            diff = torch._foreach_sub(grads, self.acc)   # optax running mean
            torch._foreach_div_(diff, hyper[_ACC_DIV])
            torch._foreach_add_(self.acc, diff)
            if owned:
                torch._foreach_zero_(owned)
            if not update:
                return
            grads = self.acc                 # the mean is the update's
        if self.cfg.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.cfg.max_grad_norm)
        torch._foreach_mul_(self.params, hyper[_DECAY])
        torch._foreach_mul_(self.exp_avg, hyper[_BETA1])
        torch._foreach_add_(self.exp_avg,
                            torch._foreach_mul(grads, hyper[_W1]))
        torch._foreach_mul_(self.exp_avg_sq, BETA2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads,
                                value=1.0 - BETA2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, hyper[_BC2_SQRT])
        torch._foreach_add_(denom, self.cfg.eps)
        upd = torch._foreach_div(self.exp_avg, denom)
        torch._foreach_mul_(upd, hyper[_NEG_STEP])
        torch._foreach_add_(self.params, upd)
        if self.k > 1:
            torch._foreach_zero_(self.acc)
        elif owned:
            torch._foreach_zero_(owned)

    def _zeros(self, i: int) -> torch.Tensor:
        """The gradient of a parameter that got none (optax decays it):
        zeros, allocated once (clipping rescales them in place, and they
        stay zero)."""
        z = self._zero_grads.get(i)
        if z is None:
            z = self._zero_grads[i] = torch.zeros_like(self.params[i])
        return z

    @torch.no_grad()
    def step(self) -> bool:
        """``apply`` with this mini-step's scalars, copied into ``hyper``
        eagerly, then ``advance``."""
        for p in self.params:
            if p.grad is None:            # optax decays params without grad
                p.grad = torch.zeros_like(p)
        update = self.will_update()
        self.hyper.copy_(torch.from_numpy(self.host_hyper()))
        self.apply(self.hyper, update)
        self.advance()
        return update

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"exp_avg": [t.clone() for t in self.exp_avg],
                "exp_avg_sq": [t.clone() for t in self.exp_avg_sq],
                "acc": [t.clone() for t in self.acc],
                "count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copies into the tensors this optimizer holds (a CUDA graph that
        reads them stays valid) and advances the schedule to the count."""
        for name in ("exp_avg", "exp_avg_sq", "acc"):
            mine, theirs = getattr(self, name), state[name]
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state {name}: {len(theirs)} "
                                 f"tensors for {len(mine)}")
            for dst, src in zip(mine, theirs):
                dst.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self._rebuild_schedule()
