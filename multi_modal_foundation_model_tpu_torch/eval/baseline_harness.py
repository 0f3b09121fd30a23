"""Eval harness for the linear baseline models.

Port of ``multi_modal_foundation_model_tpu/eval/baseline_harness.py:27-123``.
Only two modes exist for the baselines: ``modal_spike`` (behavior ->
spikes, bits/spike and R² per neuron) and ``modal_behavior`` (spikes ->
behavior, R² per covariate). The model holds its weights (JAX passes
``params`` beside it) and runs on its own device. The reference's quirks
are kept:

- spike predictions are ``exp``'d, then min-shifted (``pred - pred.min()``)
  before bits-per-spike, but the R² uses the unshifted predictions;
- an infinite bits-per-spike becomes NaN;
- ``modal_behavior`` saves ``bps.npy`` as NaN.

With ``save_plot=True``, ``modal_spike`` also saves the multimodal
harness's per-neuron figure (``viz_single_cell_figure``) for the first
``max_plots`` neurons, as ``{region}_{n}_{r2_trial:.2f}_{method_name}.png``
under ``save_path`` (JAX :80-100); without matplotlib the first figure
raises ``ImportError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .harness import _first_batch, _real_n
from .metrics import (bits_per_spike, create_behavior_conditions,
                      psth_and_trial_r2)


def co_smoothing_eval_baseline(
    model: torch.nn.Module,
    test_dataloader,
    mode: str,
    *,
    modal_filter: Dict[str, Sequence[str]],
    save_path: str = "eval_results",
    held_out_list: Optional[Sequence[int]] = None,
    avail_beh: Sequence[str] = ("wheel-speed", "whisker-motion-energy"),
    is_aligned: bool = True,
    n_time_steps: int = 100,
    save_plot: bool = False,
    max_plots: int = 20,
    method_name: str = "linear",
) -> Dict[str, Any]:
    """Run ``mode`` over the full test split (the loader's first batch);
    returns the metric dict and saves ``bps.npy``/``r2.npy`` under
    ``save_path``."""
    batch = _first_batch(test_dataloader)
    T = n_time_steps
    N = _real_n(batch)

    if "ap" in modal_filter["output"]:
        inputs, targets = batch["target"], batch["spikes_data"]
    else:
        inputs, targets = batch["spikes_data"], batch["target"]
    dev = next(model.parameters()).device
    with torch.inference_mode():
        out = model({"inputs": torch.as_tensor(np.asarray(inputs)).to(dev),
                     "targets": torch.as_tensor(np.asarray(targets)).to(dev)})
        preds = out.preds.cpu().numpy()
        gt = out.targets.cpu().numpy()

    if is_aligned:
        X, var_name2idx, var_tasklist, _, _ = create_behavior_conditions(
            batch["choice"], batch["reward"], batch["block"], T=T)

    def _r2_pair(y, y_pred, t_idx):
        r2_psth, r2_trial = psth_and_trial_r2(
            X[:, t_idx, :], y, y_pred, var_tasklist, var_name2idx)
        return np.array([r2_psth, r2_trial])

    if held_out_list is None:
        raise ValueError(
            f"{mode} requires specific target time points to predict")
    hd = np.asarray(held_out_list)
    os.makedirs(save_path, exist_ok=True)

    if mode == "modal_spike":
        bps_result_list = [float("nan")] * N
        r2_result_list = [np.array([np.nan, np.nan])] * N
        gt_n = gt[:, :, :N]
        preds_n = np.exp(preds[:, :, :N])
        pred_held_out = preds_n[:, hd] - np.min(preds_n[:, hd])
        regions = [str(r) for r in batch.get("neuron_regions", [])]
        for n_i in range(N):
            bps = bits_per_spike(pred_held_out[:, :, [n_i]],
                                 gt_n[:, hd][:, :, [n_i]])
            bps_result_list[n_i] = np.nan if np.isinf(bps) else bps
            pair = _r2_pair(gt_n[:, hd, n_i], preds_n[:, hd, n_i], hd)
            r2_result_list[n_i] = pair
            if save_plot and n_i < max_plots:
                from ..utils.plotting import _pyplot, viz_single_cell_figure

                region = (regions[n_i].replace("/", "-")
                          if n_i < len(regions) else "pad")
                fig = viz_single_cell_figure(
                    X[:, hd, :], gt_n[:, hd, n_i], preds_n[:, hd, n_i],
                    var_tasklist, var_name2idx, neuron_idx=n_i,
                    neuron_region=region, method=method_name, r2_pair=pair)
                fig.savefig(os.path.join(
                    save_path,
                    f"{region}_{n_i}_{pair[1]:.2f}_{method_name}.png"))
                _pyplot().close(fig)
        bps_all = np.array(bps_result_list)
        r2_all = np.array(r2_result_list)
        np.save(os.path.join(save_path, "bps.npy"), bps_all)
        np.save(os.path.join(save_path, "r2.npy"), r2_all)
        return {
            f"{mode}_mean_bps": np.nanmean(bps_all),
            f"{mode}_mean_r2_psth": np.nanmean(r2_all[:, 0]),
            f"{mode}_mean_r2_trial": np.nanmean(r2_all[:, 1]),
        }

    if mode == "modal_behavior":
        behav_results: Dict[str, float] = {}
        for i in range(len(avail_beh)):
            pair = _r2_pair(gt[:, hd, i], preds[:, hd, i], hd)
            behav_results[f"{avail_beh[i]}_r2_psth"] = float(pair[0])
            behav_results[f"{avail_beh[i]}_r2_trial"] = float(pair[1])
        np.save(os.path.join(save_path, "r2.npy"), behav_results)
        np.save(os.path.join(save_path, "bps.npy"), np.nan)
        return {f"{mode}_behav_results": behav_results}

    raise NotImplementedError("mode not implemented")
