"""Masked reconstruction losses (Poisson NLL on log-rates, MSE).

Port of ``multi_modal_foundation_model_tpu/ops/losses.py``. The training
loss is ``torch.nn.PoissonNLLLoss(log_input=True, full=False)``'s
``exp(x) - y*x`` with NO Stirling term; the eval bits-per-spike uses the
full NLL (``eval/metrics.py``) — the two differ on purpose. Each loss is a
masked sum plus a masked count, combined by the model.
"""

from __future__ import annotations

import torch


def poisson_nll_elementwise(log_rates: torch.Tensor,
                            targets: torch.Tensor) -> torch.Tensor:
    """``exp(x) - y * x`` per element (log-input Poisson NLL, no Stirling)."""
    return torch.exp(log_rates) - targets * log_rates


def masked_poisson_nll(log_rates: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor):
    """(sum of masked NLL, number of masked elements)."""
    mask = mask.to(log_rates.dtype)
    return (poisson_nll_elementwise(log_rates, targets) * mask).sum(), \
        mask.sum()


def masked_mse(preds: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor):
    """(sum of masked squared error, number of masked elements)."""
    mask = mask.to(preds.dtype)
    return (torch.square(preds - targets) * mask).sum(), mask.sum()
