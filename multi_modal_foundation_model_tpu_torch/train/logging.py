"""Metric logging to ``<log_dir>/metrics.jsonl``.

Port of ``multi_modal_foundation_model_tpu/train/logging.py``: one JSON
row per call, epoch rows echoed to stdout. wandb logging is not ported:
``use_wandb=True`` raises, so ``log_figures`` is JAX's no-op without
wandb (the trainers save the same figures to disk either way).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    """JAX's ``MetricLogger`` signature (``train/logging.py:18-22``);
    ``wandb_project``, ``wandb_run_name`` and ``config`` only ever reach
    wandb, so they are accepted and unused."""

    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 stdout: bool = True):
        if use_wandb:
            raise NotImplementedError("wandb logging is not ported")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.stdout = stdout

    def log(self, row: Dict[str, Any]) -> None:
        row = {k: _scalar(v) for k, v in row.items() if _loggable(v)}
        row.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.stdout and "epoch" in row:
            keys = [k for k in ("epoch", "train_loss", "eval_loss",
                                "eval_trial_avg_r2") if k in row]
            print(" ".join(f"{k}={row[k]:.6g}" if isinstance(row[k], float)
                           else f"{k}={row[k]}" for k in keys), flush=True)

    def log_figures(self, figs: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> None:
        """JAX's wandb image logging of figures (``train/logging.py:49-58``):
        a no-op without wandb."""


def _loggable(v) -> bool:
    if isinstance(v, dict):
        return all(_loggable(x) for x in v.values())
    return isinstance(v, (int, float, str, bool)) or hasattr(v, "item")


def _scalar(v):
    if isinstance(v, dict):
        return {k: _scalar(x) for k, x in v.items()}
    if hasattr(v, "item") and not isinstance(v, (int, float, str, bool)):
        return v.item()
    return v


class NullLogger:
    """The logger of a rank that does not log (every rank but 0 under a
    mesh): ``log`` does nothing."""

    def log(self, row: Dict[str, Any]) -> None:
        pass

    def log_figures(self, figs: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> None:
        pass
