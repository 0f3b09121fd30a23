"""Co-smoothing eval harness: the six reference eval modes.

Port of ``multi_modal_foundation_model_tpu/eval/harness.py``. Each mode
builds static held-out masks (``eval/heldout.py``), runs forwards of the
model over the whole test split on the model's device, and scores every
neuron's bits/spike and R² on the host (``eval/metrics.py``).

- ``per_neuron``     leave-one-neuron-out co-smoothing; bps + R² per neuron
- ``forward_pred``   timesteps ``held_out_list`` held out
- ``inter_region``   per region: all its neurons held out, predicted from
                     the rest
- ``intra_region``   per region: LOO within the region, other regions fully
                     masked
- ``modal_spike``    all-timestep spike heldout, behavior visible (encoding)
- ``modal_behavior`` behavior held out, spikes visible (decoding); returns
                     per-covariate ``{beh}_r2_psth`` / ``{beh}_r2_trial``

The leave-one-out sweeps (``EvalForward.sweep``) run ``chunk`` variants of
the K test trials as ONE batch of ``chunk * K`` trials, where the JAX
package vmaps one K-trial forward per variant. The batch keeps the variant
axis for the model's row-0 token zeroing (``token_zero_groups``): each
variant is zeroed by its own first trial, not by variant 0's.

``use_mtm=False`` reproduces the reference quirk that inputs stay unmasked
(only token-level zeroing via eval_mask applies): all sweep variants then
share one forward per distinct token mask.

Artifacts: ``bps.npy``/``r2.npy`` per mode and the ``{mode}_mean_bps`` /
``{mode}_mean_r2_psth`` / ``{mode}_mean_r2_trial`` result keys. With
``save_plot=True`` the ``per_neuron``, ``inter_region`` and
``intra_region`` modes also save a figure per scored neuron, up to
``max_plots`` a call (JAX :237-290): ``viz_single_cell_figure`` (aligned)
or ``viz_single_cell_unaligned_figure``, named
``{region}_{neuron}_{r2:.2f}_{method_name}.png`` under ``save_path``.
Without matplotlib the first figure raises ``ImportError``.

A session-stitched model (``n_sessions > 1``) is scored one session at a
time: ``session_id`` (JAX :61-93, :209-233) routes every forward through
that session's stitched tokenizer and head, as it trained.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.multimodal import ModalityInput
from .heldout import heldout_mask
from .metrics import (bits_per_spike, create_behavior_conditions,
                      psth_and_trial_r2, r2_score_nanable)


class EvalForward:
    """Full-test-set forwards and a chunked channel sweep of ``model`` on
    the device its parameters live on; ``session_id`` (a host int) selects
    a stitched model's session, None keeps the single-session path."""

    def __init__(self, model: torch.nn.Module, batch, chunk: int = 16,
                 session_id: Optional[int] = None):
        self.model = model
        self.chunk = chunk
        self.session_id = session_id
        dev = next(model.parameters()).device
        self.spikes = torch.as_tensor(batch["spikes_data"],
                                      dtype=torch.float32, device=dev)
        self.behavior = torch.as_tensor(batch["target"],
                                        dtype=torch.float32, device=dev)
        self.attn = torch.as_tensor(batch["time_attn_mask"], device=dev)
        self.ts = torch.as_tensor(batch["spikes_timestamps"], device=dev)

    @torch.inference_mode()
    def _forward(self, ap_inputs, ap_eval, beh_inputs, beh_eval,
                 groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward of ``groups`` stacked copies of the K trials, each copy
        with its own inputs/eval masks (leading axis groups * K)."""
        def rep(x):
            return x.repeat((groups,) + (1,) * (x.dim() - 1))

        attn, ts = rep(self.attn), rep(self.ts)
        mod_inputs = {
            "ap": ModalityInput(inputs=ap_inputs, targets=rep(self.spikes),
                                attn_mask=attn, timestamps=ts,
                                eval_mask=ap_eval),
            "behavior": ModalityInput(inputs=beh_inputs,
                                      targets=rep(self.behavior),
                                      attn_mask=attn, timestamps=ts,
                                      eval_mask=beh_eval),
        }
        out = self.model(mod_inputs, training=False, token_zero_groups=groups,
                         session_id=self.session_id)
        return out.mod_preds["ap"], out.mod_preds["behavior"]

    # -- single forward ---------------------------------------------------

    def forward(self, ap_inputs=None, ap_eval=None, beh_inputs=None,
                beh_eval=None) -> Tuple[np.ndarray, np.ndarray]:
        """Full-set forward; None masks default to zeros (nothing held)."""
        dev = self.spikes.device

        def put(x, default, dtype):
            if x is None:
                return default
            return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

        ap_inputs = put(ap_inputs, self.spikes, torch.float32)
        beh_inputs = put(beh_inputs, self.behavior, torch.float32)
        ap_eval = put(ap_eval, torch.zeros_like(self.spikes, dtype=torch.int32),
                      torch.int32)
        beh_eval = put(beh_eval,
                       torch.zeros_like(self.behavior, dtype=torch.int32),
                       torch.int32)
        ap_preds, beh_preds = self._forward(ap_inputs, ap_eval, beh_inputs,
                                            beh_eval)
        return ap_preds.cpu().numpy(), beh_preds.cpu().numpy()

    # -- channel-visibility sweep ------------------------------------------

    def sweep(self, visible: np.ndarray, target_idx: np.ndarray,
              use_mtm: bool) -> np.ndarray:
        """Per-variant spike predictions at each variant's target neuron.

        ``visible (V, N)``: per-variant channel visibility (0 = held out).
        ``target_idx (V,)``: the neuron whose predictions to return.
        Returns ``(V, K, T)`` predicted log-rates.

        With ``use_mtm=False`` the model inputs don't vary across variants
        (only eval_mask does, and for channel heldouts eval_mask feeds
        nothing but column 0 of the token mask), so one forward serves
        every variant whose ``visible[:, 0]`` agrees.
        """
        visible = np.asarray(visible, dtype=np.float32)
        target_idx = np.asarray(target_idx, dtype=np.int64)
        K, T, N = self.spikes.shape

        if not use_mtm:
            out = np.empty((len(visible), K, T), dtype=np.float32)
            for col0 in np.unique(visible[:, 0]):
                rows = np.where(visible[:, 0] == col0)[0]
                ap_eval = np.broadcast_to(
                    (1.0 - visible[rows[0]]).astype(np.int32),
                    self.spikes.shape)
                ap_preds, _ = self.forward(ap_eval=ap_eval)
                out[rows] = ap_preds[:, :, target_idx[rows]].transpose(2, 0, 1)
            return out

        dev = self.spikes.device
        beh_eval = torch.zeros_like(self.behavior, dtype=torch.int32)
        outs = []
        for start in range(0, len(visible), self.chunk):
            vis = torch.as_tensor(visible[start:start + self.chunk],
                                  device=dev)                   # (c, N)
            tgt = torch.as_tensor(target_idx[start:start + self.chunk],
                                  device=dev)
            c = vis.shape[0]
            ap_inputs = (self.spikes[None] * vis[:, None, None, :]
                         ).reshape(c * K, T, N)
            ap_eval = (1.0 - vis).to(torch.int32)[:, None, None, :].expand(
                c, K, T, N).reshape(c * K, T, N)
            ap_preds, _ = self._forward(
                ap_inputs, ap_eval, self.behavior.repeat(c, 1, 1),
                beh_eval.repeat(c, 1, 1), groups=c)
            ap_preds = ap_preds.reshape(c, K, T, N)
            outs.append(ap_preds[torch.arange(c, device=dev), :, :, tgt])
        return torch.cat(outs).cpu().numpy()


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def _first_batch(test_dataloader):
    for batch in test_dataloader:
        return batch
    raise ValueError("empty test loader")


def _real_n(batch) -> int:
    space = np.asarray(batch["space_attn_mask"][0])
    zeros = np.nonzero(space == 0)[0]
    return int(zeros.min()) if len(zeros) else space.shape[-1]


def co_smoothing_eval(
    model: torch.nn.Module,
    test_dataloader,
    mode: str = "per_neuron",
    *,
    use_mtm: bool = False,
    save_path: str = "eval_results",
    method_name: str = "mm",
    is_aligned: bool = True,
    target_regions: Sequence[str] = ("all",),
    n_time_steps: int = 100,
    held_out_list: Optional[Sequence[int]] = None,
    avail_beh: Sequence[str] = ("wheel-speed", "whisker-motion-energy"),
    subtract: str = "task",
    onset_alignment: Sequence[int] = (40,),
    chunk: int = 16,
    save_plot: bool = False,
    max_plots: int = 20,
    session_id: Optional[int] = None,
) -> Dict[str, Any]:
    """Run one eval mode over the full test split (the loader's first
    batch) on the model's device; returns the metric dict and saves
    ``bps.npy``/``r2.npy`` under ``save_path``. ``session_id``: the
    session of a session-stitched model (required there, ignored
    otherwise). ``method_name``, ``save_plot`` and ``max_plots`` name and
    bound the figures (module docstring); ``subtract`` and
    ``onset_alignment`` are JAX's arguments, which its figures do not
    read either."""
    batch = _first_batch(test_dataloader)
    T = n_time_steps
    N = _real_n(batch)
    region_list = np.asarray(batch["neuron_regions"])[:N].astype(str)
    spikes = np.asarray(batch["spikes_data"])
    behavior = np.asarray(batch["target"])

    if is_aligned:
        X, var_name2idx, var_tasklist, _, _ = create_behavior_conditions(
            batch["choice"], batch["reward"], batch["block"], T=T)

    fwd = EvalForward(model, batch, chunk=chunk, session_id=session_id)
    N_total = spikes.shape[-1]
    n_plotted = [0]

    def _region(neuron) -> str:
        return (region_list[neuron].replace("/", "-")
                if neuron < len(region_list) else "pad")

    def _save(fig, neuron, r2):
        from ..utils.plotting import _pyplot

        name = f"{_region(neuron)}_{neuron}_{r2:.2f}_{method_name}.png"
        os.makedirs(save_path, exist_ok=True)
        fig.savefig(os.path.join(save_path, name))
        _pyplot().close(fig)
        n_plotted[0] += 1

    def _plot(neuron) -> bool:
        return save_plot and neuron is not None and n_plotted[0] < max_plots

    def _r2_pair(y, y_pred, t_idx=None, neuron=None) -> np.ndarray:
        if not is_aligned:
            r2 = r2_score_nanable(y, y_pred)
            if _plot(neuron):
                from ..utils.plotting import viz_single_cell_unaligned_figure

                _save(viz_single_cell_unaligned_figure(
                    y, y_pred, neuron_idx=neuron,
                    neuron_region=_region(neuron), method=method_name,
                    r2=r2), neuron, r2)
            return np.array([np.nan, r2])
        Xc = X if t_idx is None else X[:, t_idx, :]
        pair = np.array(psth_and_trial_r2(Xc, y, y_pred, var_tasklist,
                                          var_name2idx))
        if _plot(neuron):
            # the reference's viz_single_cell layout (eval_utils.py:
            # 1348-1388), named as it names it (:1385)
            from ..utils.plotting import viz_single_cell_figure

            _save(viz_single_cell_figure(
                Xc, y, y_pred, var_tasklist, var_name2idx,
                neuron_idx=neuron, neuron_region=_region(neuron),
                method=method_name, r2_pair=pair), neuron, pair[1])
        return pair

    bps_result_list = [float("nan")] * N
    r2_result_list = [np.array([np.nan, np.nan])] * N

    def _score(n_i, gt_n, pr_n, t_idx=None, plot=False):
        bps = bits_per_spike(pr_n[:, :, None], gt_n[:, :, None])
        bps_result_list[n_i] = np.nan if np.isinf(bps) else bps
        r2_result_list[n_i] = _r2_pair(gt_n, pr_n, t_idx,
                                       int(n_i) if plot else None)

    if mode == "per_neuron":
        visible = np.ones((N, N_total), dtype=np.float32)
        visible[np.arange(N), np.arange(N)] = 0.0
        preds_at = fwd.sweep(visible, np.arange(N), use_mtm)  # (N, K, T)
        for n_i in range(N):
            _score(n_i, spikes[:, :, n_i], np.exp(preds_at[n_i]), plot=True)

    elif mode == "forward_pred" or mode == "modal_spike":
        assert held_out_list is not None, \
            f"{mode} requires specific target time points to predict"
        hd = np.asarray(held_out_list)
        mask_result = heldout_mask(spikes, mode=mode, heldout_idxs=hd)
        ap_inputs = mask_result["spikes"] if use_mtm else None
        ap_preds, _ = fwd.forward(ap_inputs=ap_inputs,
                                  ap_eval=mask_result["eval_mask"])
        preds = np.exp(ap_preds[:, :, :N])
        for n_i in range(N):
            _score(n_i, spikes[:, hd, n_i], preds[:, hd, n_i], t_idx=hd)

    elif mode == "inter_region":
        assert held_out_list is None, \
            "inter_region does LOO for all neurons in the target region"
        regions = (list(np.unique(region_list)) if "all" in target_regions
                   else list(target_regions))
        for region in regions:
            region_idxs = np.argwhere(region_list == region).flatten()
            mask_result = heldout_mask(
                spikes, mode="inter_region",
                heldout_idxs=np.arange(len(region_idxs)),
                target_regions=[region], neuron_regions=region_list)
            ap_inputs = mask_result["spikes"] if use_mtm else None
            ap_preds, _ = fwd.forward(ap_inputs=ap_inputs,
                                      ap_eval=mask_result["eval_mask"])
            preds = np.exp(ap_preds[:, :, :N])
            for n_i in mask_result["heldout_idxs"]:
                _score(n_i, spikes[:, :, n_i], preds[:, :, n_i], plot=True)

    elif mode == "intra_region":
        assert held_out_list is None, \
            "intra_region does LOO for all neurons in the target region"
        regions = (list(np.unique(region_list)) if "all" in target_regions
                   else list(target_regions))
        vis_rows, tgt_rows = [], []
        for region in regions:
            region_idxs = np.argwhere(region_list == region).flatten()
            for tgt in region_idxs:
                vis = np.zeros(N_total, dtype=np.float32)
                vis[region_idxs] = 1.0
                vis[tgt] = 0.0
                vis_rows.append(vis)
                tgt_rows.append(tgt)
        targets = np.asarray(tgt_rows)
        preds_at = fwd.sweep(np.stack(vis_rows), targets, use_mtm)
        for v, n_i in enumerate(targets):
            _score(n_i, spikes[:, :, n_i], np.exp(preds_at[v]), plot=True)

    elif mode == "modal_behavior":
        N_beh = len(avail_beh)
        assert held_out_list is not None, \
            "modal_behavior requires target time points"
        hd = np.asarray(held_out_list)
        mask_result = heldout_mask(behavior, mode=mode, heldout_idxs=hd)
        beh_inputs = mask_result["spikes"] if use_mtm else None
        _, beh_preds = fwd.forward(
            beh_inputs=beh_inputs, beh_eval=mask_result["eval_mask"])
        gt = behavior[:, :, :N_beh]
        preds = beh_preds[:, :, :N_beh]
        behav_results: Dict[str, float] = {}
        for i in range(N_beh):
            pair = _r2_pair(gt[:, hd, i], preds[:, hd, i], t_idx=hd)
            behav_results[f"{avail_beh[i]}_r2_psth"] = float(pair[0])
            behav_results[f"{avail_beh[i]}_r2_trial"] = float(pair[1])
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, "r2.npy"), behav_results)
        np.save(os.path.join(save_path, "bps.npy"), np.nan)
        return {f"{mode}_behav_results": behav_results}

    else:
        raise NotImplementedError("mode not implemented")

    os.makedirs(save_path, exist_ok=True)
    bps_all = np.array(bps_result_list)
    r2_all = np.array(r2_result_list)
    np.save(os.path.join(save_path, "bps.npy"), bps_all)
    np.save(os.path.join(save_path, "r2.npy"), r2_all)
    return {
        f"{mode}_mean_bps": _nanmean(bps_all),
        f"{mode}_mean_r2_psth": _nanmean(r2_all[:, 0]),
        f"{mode}_mean_r2_trial": _nanmean(r2_all[:, 1]),
    }


def _nanmean(a: np.ndarray) -> float:
    """nanmean that returns NaN silently on an all-NaN column."""
    a = np.asarray(a, dtype=np.float64)
    keep = ~np.isnan(a)
    if not keep.any():
        return float("nan")
    return float(a[keep].mean())
