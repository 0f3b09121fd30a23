"""Evaluation metrics, bit-compatible with the reference / NLB formulas.

The port's copy of ``multi_modal_foundation_model_tpu/eval/metrics.py``:
pure numpy on the host (the forwards are the device's work).

Parity targets (file:line into the reference repository):
- ``neg_log_likelihood`` / ``bits_per_spike``: NLB formulas at
  ``src/utils/eval_utils.py:1052-1119`` — note the *full* Poisson NLL with
  the ``gammaln(n+1)`` term (the training loss intentionally omits it,
  matching ``nn.PoissonNLLLoss(log_input=True)``; see ops/losses.py).
- PSTH machinery: ``compute_PSTH``/``compute_all_psth``/``compute_R2_psth``/
  ``compute_R2_main`` at ``src/utils/eval_utils.py:1490-1553``.
- behavior-condition matrix: ``create_behave_list`` at
  ``src/utils/eval_utils.py:1126-1151``.
- trainer eval metric: ``metrics_list`` at ``src/utils/utils.py:107-132``.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
from scipy.special import gammaln

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Poisson NLL / bits-per-spike (NLB-compatible)
# ---------------------------------------------------------------------------

def neg_log_likelihood(rates: np.ndarray, spikes: np.ndarray,
                       zero_warning: bool = True) -> float:
    """Total Poisson negative log likelihood of ``spikes`` under ``rates``.

    ``nll = sum(r - n*log(r) + log(n!))``; NaN spikes are dropped, zero rates
    are floored at 1e-9 — identical behavior to the NLB reference
    implementation (``eval_utils.py:1052-1092``).
    """
    rates = np.asarray(rates, dtype=np.float64)
    spikes = np.asarray(spikes, dtype=np.float64)
    assert spikes.shape == rates.shape, (
        f"neg_log_likelihood: shape mismatch rates {rates.shape} vs spikes {spikes.shape}")

    nan_mask = np.isnan(spikes)
    if nan_mask.any():
        rates = rates[~nan_mask]
        spikes = spikes[~nan_mask]

    assert not np.any(np.isnan(rates)), "neg_log_likelihood: NaN rate predictions found"
    assert np.all(rates >= 0), "neg_log_likelihood: negative rate predictions found"
    if np.any(rates == 0):
        if zero_warning:
            logger.warning("neg_log_likelihood: zero rates found; replacing with 1e-9")
        rates = np.where(rates == 0, 1e-9, rates)

    return float(np.sum(rates - spikes * np.log(rates) + gammaln(spikes + 1.0)))


def bits_per_spike(rates: np.ndarray, spikes: np.ndarray) -> float:
    """Bits/spike of rate predictions vs the per-neuron mean-rate null model.

    ``bps = (nll_null - nll_model) / (total_spikes * ln 2)`` with the null
    model tiling each neuron's mean rate over all leading axes
    (``eval_utils.py:1095-1119``).
    """
    spikes = np.asarray(spikes, dtype=np.float64)
    nll_model = neg_log_likelihood(rates, spikes)
    null_rates = np.tile(
        np.nanmean(spikes, axis=tuple(range(spikes.ndim - 1)), keepdims=True),
        spikes.shape[:-1] + (1,),
    )
    nll_null = neg_log_likelihood(null_rates, spikes, zero_warning=False)
    return float((nll_null - nll_model) / np.nansum(spikes) / np.log(2))


# ---------------------------------------------------------------------------
# R² machinery
# ---------------------------------------------------------------------------

def r2_score_nanable(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Coefficient of determination; NaN when y_true has zero variance.

    Matches sklearn's ``r2_score`` on the non-degenerate path; the degenerate
    (constant-target) path returns NaN so downstream ``masked_invalid`` /
    ``nanmean`` reductions skip it — the same net effect as the reference's
    torcheval wrapper + ``np.ma.masked_invalid`` (``utils/utils.py:110-115``).
    """
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else float("nan")
    return 1.0 - ss_res / ss_tot


def compute_PSTH(X: np.ndarray, y: np.ndarray, axis: Sequence[int],
                 value: np.ndarray) -> np.ndarray:
    """Mean of ``y`` over trials whose condition variables match ``value``."""
    trials = np.all(X[:, 0, axis] == value, axis=-1)
    return y[trials].mean(0)


def compute_all_psth(X: np.ndarray, y: np.ndarray,
                     idxs_psth: Sequence[int]) -> Dict[tuple, np.ndarray]:
    """PSTH per unique task-condition tuple found in ``X[:, 0, idxs_psth]``."""
    uni_vs = np.unique(X[:, 0, idxs_psth], axis=0)
    psth_vs = {}
    for v in uni_vs:
        psth_vs[tuple(v)] = compute_PSTH(X, y, axis=idxs_psth, value=v)
    return psth_vs


def compute_R2_psth(psth_xy: Dict[tuple, np.ndarray],
                    psth_pred_xy: Dict[tuple, np.ndarray],
                    clip: bool = True):
    """R² between condition-averaged PSTHs, stacked over conditions."""
    psth_xy_array = np.array([psth_xy[x] for x in psth_xy])
    psth_pred_xy_array = np.array([psth_pred_xy[x] for x in psth_xy])
    K, T = psth_xy_array.shape[:2]
    psth_xy_array = psth_xy_array.reshape((K * T, -1))
    psth_pred_xy_array = psth_pred_xy_array.reshape((K * T, -1))
    r2s = np.array([
        r2_score_nanable(psth_xy_array[:, ni], psth_pred_xy_array[:, ni])
        for ni in range(psth_xy_array.shape[1])
    ])
    if clip:
        r2s = np.clip(r2s, 0.0, 1.0)
    if len(r2s) == 1:
        return r2s[0]
    return r2s


def compute_R2_main(y: np.ndarray, y_pred: np.ndarray, clip: bool = True) -> np.ndarray:
    """Per-unit single-trial R² over flattened (trial, time) samples."""
    N = y.shape[-1]
    y = y.reshape((-1, N))
    y_pred = y_pred.reshape((-1, N))
    r2s = np.asarray([
        r2_score_nanable(y[:, n], y_pred[:, n]) for n in range(N)
    ])
    if clip:
        return np.clip(r2s, 0.0, 1.0)
    return r2s


def create_behavior_conditions(choice: np.ndarray, reward: np.ndarray,
                               block: np.ndarray, T: int = 100):
    """Build the (K, T, 3) task-condition matrix + metadata.

    Column order [choice, reward, block] matches the reference
    ``create_behave_list`` (``eval_utils.py:1126-1151``), which is what the
    PSTH conditioning keys off.
    """
    K = np.asarray(choice).shape[0]
    cols = []
    for v in (choice, reward, block):
        v = np.asarray(v, dtype=np.float64).reshape(K, 1)
        cols.append(np.tile(v, (1, T)))
    behavior_set = np.stack(cols, axis=-1)

    var_name2idx = {"block": [2], "choice": [0], "reward": [1], "wheel": [3]}
    var_value2label = {
        "block": {(0.2,): "p(left)=0.2", (0.5,): "p(left)=0.5", (0.8,): "p(left)=0.8"},
        "choice": {(-1.0,): "right", (1.0,): "left"},
        "reward": {(0.0,): "no reward", (1.0,): "reward"},
    }
    var_tasklist = ["block", "choice", "reward"]
    var_behlist: List = []
    return behavior_set, var_name2idx, var_tasklist, var_value2label, var_behlist


def psth_and_trial_r2(X: np.ndarray, y: np.ndarray, y_pred: np.ndarray,
                      var_tasklist: Sequence[str],
                      var_name2idx: Dict[str, Sequence[int]],
                      ) -> Tuple[float, float]:
    """(r2_psth, r2_trial) for one unit — the metric path of the reference's
    ``viz_single_cell``/``plot_psth`` (``eval_utils.py:1198-1209``), without
    any plotting.

    ``y``/``y_pred`` are (K, T) single-unit traces; ``X`` is the condition
    matrix from :func:`create_behavior_conditions`.
    """
    idxs_psth = np.concatenate([np.asarray(var_name2idx[var]) for var in var_tasklist])
    psth_xy = compute_all_psth(X, y, idxs_psth)
    psth_pred_xy = compute_all_psth(X, y_pred, idxs_psth)
    r2_psth = compute_R2_psth(psth_xy, psth_pred_xy, clip=False)
    r2_trial = compute_R2_main(y.reshape(-1, 1), y_pred.reshape(-1, 1), clip=False)[0]
    return float(np.asarray(r2_psth).mean()), float(r2_trial)


# ---------------------------------------------------------------------------
# Trainer-loop metrics (reference ``metrics_list``, utils/utils.py:107-132)
# ---------------------------------------------------------------------------

def metrics_list(gt: np.ndarray, pred: np.ndarray,
                 metrics: Iterable[str] = ("r2",)) -> Dict[str, float]:
    """Aggregate metrics over a stacked (units/trials, T, channels) block.

    For ``"r2"``: per leading index i, R² is computed for every column of
    ``gt[i].T`` (i.e. per trailing-channel trace over time), invalid values
    masked, averaged — then averaged over i. Mirrors the reference loop
    structure exactly so trainer model-selection behaves identically.
    """
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    results: Dict[str, float] = {}
    if "r2" in metrics:
        r2_list = []
        for i in range(gt.shape[0]):
            gt_t = gt[i].T
            pred_t = pred[i].T
            r2s = [r2_score_nanable(gt_t[k], pred_t[k]) for k in range(len(gt_t))]
            r2_list.append(np.ma.masked_invalid(r2s).mean())
        results["r2"] = float(np.mean(r2_list))
    if "rsquared" in metrics:
        r2_list = [r2_score_nanable(gt[i], pred[i]) for i in range(gt.shape[0])]
        results["rsquared"] = float(np.mean(r2_list))
    if "mse" in metrics:
        results["mse"] = float(np.mean((gt - pred) ** 2))
    if "mae" in metrics:
        results["mae"] = float(np.mean(np.abs(gt - pred)))
    if "acc" in metrics:
        results["acc"] = float(np.mean(gt == pred))
    return results
