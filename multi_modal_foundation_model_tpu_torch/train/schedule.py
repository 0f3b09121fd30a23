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
import warnings
from typing import Any, Dict, Iterable, List, Optional

import torch


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

    Call ``step()`` after each backward pass: it accumulates (when
    ``gradient_accumulation_steps > 1``), clips, updates, advances the
    schedule, and zeroes the gradients. Returns whether it updated."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimizerConfig, total_steps: int):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.total_steps = max(int(total_steps), 1)
        self.k = int(cfg.gradient_accumulation_steps)
        self.one_cycle = cfg.scheduler == "cosine" and self.total_steps > 1
        self.adamw = torch.optim.AdamW(self.params, lr=cfg.lr,
                                       betas=(0.9, 0.999), eps=cfg.eps,
                                       weight_decay=cfg.wd)
        self.count = 0        # updates applied (optax's inner count)
        self.mini_step = 0    # mini-steps accumulated toward the next one
        self.acc: Optional[List[torch.Tensor]] = None
        self._rebuild_schedule()

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return float(self.adamw.param_groups[0]["lr"])

    def _rebuild_schedule(self) -> None:
        """OneCycleLR for ``total_steps``, advanced to ``count``."""
        self.sched = None
        group = self.adamw.param_groups[0]
        if not self.one_cycle:
            group["lr"], group["betas"] = self.cfg.lr, (0.9, 0.999)
            return
        cfg = self.cfg
        self.sched = torch.optim.lr_scheduler.OneCycleLR(
            self.adamw, max_lr=cfg.lr, total_steps=self.total_steps,
            pct_start=cfg.warmup_pct, anneal_strategy="cos",
            cycle_momentum=cfg.cycle_momentum,
            base_momentum=cfg.base_momentum, max_momentum=cfg.max_momentum,
            div_factor=cfg.div_factor, final_div_factor=cfg.final_div_factor)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for _ in range(min(self.count, self.total_steps)):
                self.sched.step()

    @torch.no_grad()
    def step(self) -> bool:
        grads = []
        for p in self.params:
            if p.grad is None:            # optax decays params without grad
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))          # optax's running mean
            self.mini_step += 1
            if self.mini_step < self.k:
                self.adamw.zero_grad(set_to_none=True)
                return False
            for a, g in zip(self.acc, grads):
                g.copy_(a)
            self.acc, self.mini_step = None, 0
        if self.cfg.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.cfg.max_grad_norm)
        self.adamw.step()
        self.count += 1
        if self.sched is not None and self.sched.last_epoch < self.total_steps:
            self.sched.step()
        self.adamw.zero_grad(set_to_none=True)
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.acc = state["acc"]
        self._rebuild_schedule()

