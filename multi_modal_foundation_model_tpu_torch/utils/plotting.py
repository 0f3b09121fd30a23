"""Diagnostic figures: port of ``multi_modal_foundation_model_tpu/utils/plotting.py``.

The same figures from the same numpy inputs: the same artists, data,
titles and labels (the reference ``src/utils/utils.py:38-104`` and
``eval_utils.py``'s per-neuron layouts); figures are returned, the caller
saves or logs them. matplotlib is imported inside each function, with the
``Agg`` backend so figures render headless, and sklearn only inside
``_cluster_trial_order``: this module imports without either (a card's
machine may have neither), and the first figure asked for without
matplotlib raises ``ImportError``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..eval.metrics import compute_all_psth, r2_score_nanable


def _pyplot():
    """matplotlib's pyplot on the ``Agg`` backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# The two wandb in-loop diagnostics below keep the reference figures'
# CONTENT (same panels, titles, colors — dashboard continuity for users
# migrating runs) but are structured around a shared panel table rather
# than the reference's unrolled per-axis statements.

def plot_gt_pred(gt: np.ndarray, pred: np.ndarray, epoch: int = 0,
                 modality: str = "behavior"):
    """Side-by-side ground-truth / prediction heatmaps."""
    plt = _pyplot()
    panels = {"Ground Truth": np.asarray(gt), "Prediction": np.asarray(pred)}
    fig, axes = plt.subplots(1, len(panels), figsize=(12, 5))
    for ax, (title, mat) in zip(axes, panels.items()):
        image = ax.imshow(mat, aspect="auto", cmap="binary")
        ax.set_title(title)
        fig.colorbar(image, ax=ax)
    fig.suptitle(f"Epoch: {epoch}, Mod: {modality}")
    return fig


def plot_neurons_r2(gt: np.ndarray, pred: np.ndarray, epoch: int = 0,
                    neuron_idx: Sequence[int] = (), modality: str = "behavior"):
    """Per-neuron GT-vs-pred traces with R² annotations, one row per unit."""
    plt = _pyplot()
    gt, pred = np.asarray(gt), np.asarray(pred)
    units = list(neuron_idx)
    scores = [r2_score_nanable(gt[:, u], pred[:, u]) for u in units]
    fig, axes = plt.subplots(len(units), 1, figsize=(12, 5 * len(units)),
                             squeeze=False)
    traces = (("Ground Truth", gt, "blue"), ("Prediction", pred, "red"))
    for ax, unit, r2 in zip(axes[:, 0], units, scores):
        for label, series, color in traces:
            ax.plot(series[:, unit], label=label, color=color)
        ax.set(title=f"Neuron: {unit}, R2: {r2:.4f}",
               xlabel="Time", ylabel="Rate")
        ax.legend()
    fig.suptitle(f"Epoch: {epoch}, Mod: {modality}, "
                 f"Avg R2: {np.nanmean(scores):.4f}")
    return fig


def plot_single_cell_psth(X, y, y_pred, var_tasklist, var_name2idx,
                          var_value2label=None, neuron_idx="",
                          neuron_region="", method="", r2_pair=None):
    """Per-task-variable PSTH traces, GT vs prediction — the figure half of
    the reference ``plot_psth``/``viz_single_cell``
    (``eval_utils.py:1164-1217,1348-1388``); metric math lives in
    eval/metrics.py. ``y``/``y_pred`` are (K, T) single-unit traces."""
    plt = _pyplot()
    ncols = len(var_tasklist)
    fig, axes = plt.subplots(1, ncols, figsize=(3 * ncols, 2.5),
                             squeeze=False)
    for ci, var in enumerate(var_tasklist):
        ax = axes[0][ci]
        psth_xy = compute_all_psth(X, y, var_name2idx[var])
        psth_pred_xy = compute_all_psth(X, y_pred, var_name2idx[var])
        for i, cond in enumerate(psth_xy):
            label = None
            if var_value2label and cond in var_value2label.get(var, {}):
                label = var_value2label[var][cond]
            color = plt.get_cmap("tab10")(i)
            ax.plot(psth_xy[cond], color=color, linewidth=3, alpha=0.3,
                    label=label or f"{var}: {cond[0]:.2f}")
            ax.plot(psth_pred_xy[cond], color=color, linestyle="--")
        ax.set_xlabel("Time bin")
        ax.set_title(var)
        ax.legend(fontsize=6)
        ax.spines[["right", "top"]].set_visible(False)
    title = f"Neuron #{neuron_idx} {neuron_region} {method}"
    if r2_pair is not None:
        title += f"  PSTH R2: {r2_pair[0]:.2f}  Trial R2: {r2_pair[1]:.2f}"
    axes[0][0].set_ylabel("Neural activity")
    fig.suptitle(title, fontsize=9)
    fig.tight_layout()
    return fig


def plot_condition_avg_r2(gt: np.ndarray, pred: np.ndarray, epoch: int = 0,
                          neuron_idx: int = 0, condition_idx: int = 0,
                          first_n: int = 8):
    """Condition-averaged single-neuron trace with trial-range band
    (reference ``plt_condition_avg_r2``)."""
    plt = _pyplot()
    gt, pred = np.asarray(gt), np.asarray(pred)
    _, unique, _ = np.unique(gt, axis=0, return_inverse=True,
                             return_counts=True)
    trial_idx = (unique == condition_idx)
    first_n = min(first_n, int(trial_idx.sum()))
    gt_condition = gt[trial_idx][0, :, neuron_idx]
    pred_condition = pred[trial_idx][:first_n, :, neuron_idx]
    r2 = r2_score_nanable(gt_condition, pred_condition.mean(axis=0))
    fig, ax = plt.subplots()
    ax.plot(gt_condition, label="Ground Truth", color="blue")
    ax.plot(pred_condition.mean(axis=0), label="Prediction", color="red")
    ax.fill_between(np.arange(pred_condition.shape[1]),
                    pred_condition.min(axis=0), pred_condition.max(axis=0),
                    color="red", alpha=0.2)
    ax.set_title(f"R2: {r2:.4f}")
    ax.legend()
    ax.set_xlabel("Time")
    ax.set_ylabel("Rate")
    fig.suptitle(f"Epoch: {epoch}, Neuron: {neuron_idx}, "
                 f"Condition: {condition_idx}, Avg {first_n} trials")
    return fig


def raster_plot(trials_by_time: np.ndarray, vmax: float, vmin: float,
                whether_cbar: bool, ylabel, ax, cmap: str = "bwr",
                aligned_tbins: Sequence[int] = ()):
    """Trial x time raster heatmap, diverging colormap centered at 0
    (reference ``eval_utils.py:1426-1459`` panel style)."""
    plt = _pyplot()
    from matplotlib import colors

    K = trials_by_time.shape[0]
    vmax = max(float(vmax), 1e-6)
    vmin = min(float(vmin), -1e-6)
    norm = colors.TwoSlopeNorm(vmin=vmin, vcenter=0.0, vmax=vmax)
    im = ax.imshow(trials_by_time, aspect="auto", cmap=cmap, norm=norm)
    for tbin in aligned_tbins:
        ax.axvline(x=tbin - 1, c="k", alpha=0.2)
    if whether_cbar:
        cbar = plt.colorbar(im, ax=ax, pad=0.02, shrink=0.6)
        cbar.ax.tick_params(rotation=90)
    if ylabel is not None:
        ax.set_ylabel(f"{ylabel}\n(#trials={K})", fontsize=7)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.spines[["left", "bottom", "right", "top"]].set_visible(False)
    return im


def _cluster_trial_order(y: np.ndarray, n_clus: int = 4) -> np.ndarray:
    """Trial ordering by spectral clustering of single-trial traces (the
    reference clusters with sklearn SpectralClustering and sorts by label,
    ``eval_utils.py:1276-1286``); falls back to first-PC ordering when the
    trial count is too small for the neighbor graph."""
    try:
        from sklearn.cluster import SpectralClustering

        n_neighbors = min(max(2, y.shape[0] - 1), 10)
        labels = SpectralClustering(
            n_clusters=min(n_clus, max(2, y.shape[0] // 2)),
            n_neighbors=n_neighbors, affinity="nearest_neighbors",
            assign_labels="discretize", random_state=0,
        ).fit(y).labels_
        return np.argsort(labels)
    except Exception:
        centered = y - y.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        return np.argsort(centered @ vt[0])


def plot_single_trial_activity(X, y, y_pred, var_name2idx, var_behlist,
                               var_tasklist, axes,
                               subtract_psth: str = "task",
                               clusby: str = "y_pred",
                               aligned_tbins: Sequence[int] = (),
                               vmax_perc: float = 97.0,
                               vmin_perc: float = 3.0):
    """Single-trial panels of the reference's per-neuron figure
    (``eval_utils.py:1239-1345``): PSTH-subtracted observed and predicted
    activity rasters (trials ordered by clustering), behavior rasters,
    residual raster, and a residual raster re-clustered by the residuals.

    ``axes`` must have ``4 + len(var_behlist)`` entries.
    """
    y = np.asarray(y, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    if subtract_psth == "task":
        idxs = np.concatenate([var_name2idx[v] for v in var_tasklist])
        conds = X[:, 0, idxs]                      # static task variables
        _, inv = np.unique(conds, axis=0, return_inverse=True)
        y_psth = np.stack([y[inv == inv[k]].mean(0) for k in range(len(y))])
        y_pred_psth = np.stack(
            [y_pred[inv == inv[k]].mean(0) for k in range(len(y))])
        y = y - y_psth
        y_pred = y_pred - y_pred_psth
    elif subtract_psth == "global":
        y = y - y.mean(0, keepdims=True)
        y_pred = y_pred - y_pred.mean(0, keepdims=True)
    elif subtract_psth is not None:
        raise ValueError(f"unknown subtract_psth: {subtract_psth}")
    y_residual = y_pred - y

    t_sort = _cluster_trial_order(y_pred if clusby == "y_pred" else y)
    vmax = np.percentile(y_pred, vmax_perc)
    vmin = np.percentile(y_pred, vmin_perc)
    raster_plot(y[t_sort], vmax, vmin, True,
                f"obs. act.\n(-psth={subtract_psth})", axes[0],
                aligned_tbins=aligned_tbins)
    raster_plot(y_pred[t_sort], vmax, vmin, True,
                f"pred. act.\n(-psth={subtract_psth})", axes[1],
                aligned_tbins=aligned_tbins)
    for bi, beh in enumerate(var_behlist):
        ts = X[:, :, var_name2idx[beh]].reshape(len(X), -1)[t_sort]
        raster_plot(ts, np.percentile(ts, vmax_perc),
                    np.percentile(ts, vmin_perc), True, beh, axes[2 + bi],
                    aligned_tbins=aligned_tbins)
    rmax = np.percentile(y_residual, vmax_perc)
    rmin = np.percentile(y_residual, vmin_perc)
    raster_plot(y_residual[t_sort], rmax, rmin, True, "residual act.",
                axes[2 + len(var_behlist)], aligned_tbins=aligned_tbins)
    t_sort_rd = _cluster_trial_order(y_residual)
    raster_plot(y_residual[t_sort_rd], rmax, rmin, True,
                "residual act.\n(re-clustered)",
                axes[3 + len(var_behlist)], aligned_tbins=aligned_tbins)


def viz_single_cell_figure(X, y, y_pred, var_tasklist, var_name2idx,
                           var_value2label=None, var_behlist=(),
                           subtract_psth: str = "task",
                           neuron_idx="", neuron_region="", method="",
                           r2_pair=None):
    """Combined per-neuron diagnostic figure: PSTH row on top, single-trial
    raster rows below — the reference ``viz_single_cell`` save_plot layout
    (``eval_utils.py:1348-1388``, 8-row figure)."""
    plt = _pyplot()
    n_single = 4 + len(var_behlist)
    nrows = 1 + n_single
    fig = plt.figure(figsize=(8, 2 * nrows))
    axes_psth = [plt.subplot(nrows, len(var_tasklist), k + 1)
                 for k in range(len(var_tasklist))]
    axes_single = [plt.subplot(nrows, 1, k) for k in range(2, 2 + n_single)]

    for ci, var in enumerate(var_tasklist):
        ax = axes_psth[ci]
        psth_xy = compute_all_psth(X, y, var_name2idx[var])
        psth_pred_xy = compute_all_psth(X, y_pred, var_name2idx[var])
        for i, cond in enumerate(psth_xy):
            label = None
            if var_value2label and cond in (var_value2label.get(var) or {}):
                label = var_value2label[var][cond]
            color = plt.get_cmap("tab10")(i)
            ax.plot(psth_xy[cond], color=color, linewidth=3, alpha=0.3,
                    label=label or f"{var}: {cond[0]:.2f}")
            ax.plot(psth_pred_xy[cond], color=color, linestyle="--")
        ax.set_title(var, fontsize=8)
        ax.legend(fontsize=5)
        ax.spines[["right", "top"]].set_visible(False)

    plot_single_trial_activity(X, y, y_pred, var_name2idx,
                               list(var_behlist), var_tasklist,
                               axes_single, subtract_psth=subtract_psth)
    title = f"Neuron #{neuron_idx} {neuron_region} {method}"
    if r2_pair is not None:
        title += f"  PSTH R2: {r2_pair[0]:.2f}  Trial R2: {r2_pair[1]:.2f}"
    fig.suptitle(title, fontsize=9)
    fig.tight_layout()
    return fig


def viz_single_cell_unaligned_figure(gt: np.ndarray, pred: np.ndarray,
                                     neuron_idx="", neuron_region="",
                                     method="", r2=None,
                                     vmin_perc: float = 10.0,
                                     vmax_perc: float = 90.0):
    """Unaligned-session per-neuron figure: global-mean-subtracted
    obs/pred/residual rasters, trials ordered by clustering the predicted
    activity (reference ``viz_single_cell_unaligned``,
    ``eval_utils.py:1392-1459``)."""
    plt = _pyplot()
    y = gt - gt.mean(0)
    y_pred = pred - pred.mean(0)
    y_resid = y - y_pred
    t_sort = _cluster_trial_order(y_pred, n_clus=8)

    vmax = np.percentile(y_pred, vmax_perc)
    vmin = np.percentile(y_pred, vmin_perc)
    rmax = np.percentile([y, y_pred, y_resid], vmax_perc)
    rmin = np.percentile([y, y_pred, y_resid], vmin_perc)

    fig, axes = plt.subplots(3, 1, figsize=(8, 7))
    raster_plot(y[t_sort], vmax, vmin, True, "obs.", axes[0])
    if r2 is not None:
        axes[0].set_title(f" R2: {r2:.3f}")
    raster_plot(y_pred[t_sort], vmax, vmin, True, "pred.", axes[1])
    raster_plot(y_resid[t_sort], rmax, rmin, True, "resid.", axes[2])
    fig.suptitle(f"Neuron #{neuron_idx} {neuron_region} {method}",
                 fontsize=9)
    fig.tight_layout()
    return fig
