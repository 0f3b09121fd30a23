"""Mask-ratio sweep plot: decoding R² and encoding bits/spike vs mask ratio.

    python -m multi_modal_foundation_model_tpu_torch.scripts.draw_mask_ratio \\
        --result_dir DIR [--mask_ratios 0.1 0.2 ...] [--out FIG.png] \\
        [--show_linear_baseline]

The port of the JAX package's root ``scripts/draw_mask_ratio.py`` (itself
the reference's ``src/draw/draw_mask_ratio.py``), with its published
comparison constants (the reference's only quantitative baselines;
BASELINE.md). It reads the eval artifacts of each ratio,
``<result_dir>/ratio-<r>/modal_behavior/r2.npy`` and
``<result_dir>/ratio-<r>/modal_spike/bps.npy`` (the port's
``scripts/launch/mask_ratio_sweep.sh`` puts them there), skips a ratio
whose artifacts are missing, and draws the same figure. matplotlib is
imported when the figure is drawn: without it that raises ``ImportError``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

BEHAV_MOD = ["wheel-speed", "whisker-motion-energy"]

LINEAR_ENCODING_BASELINE = -1.45
LINEAR_DECODING_BASELINE = {"wheel-speed": 0.46,
                            "whisker-motion-energy": 0.55}
FOURM_ENCODING_BASELINE = 0.19
FOURM_DECODING_BASELINE = {"wheel-speed": 0.64,
                           "whisker-motion-energy": 0.70}


def read_artifacts(result_dir: str, mask_ratios):
    """({ratio: behavior R² dict}, {ratio: mean bits/spike}) of the ratios
    whose two artifacts exist."""
    decoding_res, encoding_res = {}, {}
    for ratio in mask_ratios:
        dec = os.path.join(result_dir, f"ratio-{ratio}", "modal_behavior",
                           "r2.npy")
        enc = os.path.join(result_dir, f"ratio-{ratio}", "modal_spike",
                           "bps.npy")
        if not (os.path.exists(dec) and os.path.exists(enc)):
            print(f"skipping ratio {ratio}: missing artifacts")
            continue
        decoding_res[ratio] = np.load(dec, allow_pickle=True).item()
        encoding_res[ratio] = np.nanmean(np.load(enc, allow_pickle=True))
    return decoding_res, encoding_res


def draw(decoding_res, encoding_res, show_linear_baseline: bool = False):
    """The figure: decoding R² per behavior, encoding bits/spike, each
    beside its published baselines."""
    from ..utils.plotting import _pyplot

    plt = _pyplot()
    fig, ax = plt.subplots(1, 2, figsize=(20, 10))
    colors = plt.get_cmap("tab10")
    for i, behav in enumerate(BEHAV_MOD):
        r2s = [decoding_res[r][f"{behav}_r2_trial"] for r in decoding_res]
        ax[0].plot(list(decoding_res.keys()), r2s, label=behav,
                   color=colors(i))
        ax[0].axhline(y=FOURM_DECODING_BASELINE[behav], color=colors(i),
                      linestyle="--", label=f"{behav} 4M Decoding Baseline")
        if show_linear_baseline:
            ax[0].axhline(y=LINEAR_DECODING_BASELINE[behav], color=colors(i),
                          linestyle=":",
                          label=f"{behav} Linear Decoding Baseline")
    ax[0].set_xlabel("Mask Ratio")
    ax[0].set_ylabel("R2")
    ax[0].set_title("Decoding R2")
    ax[0].legend()
    ax[0].grid()

    ax[1].plot(list(encoding_res.keys()), list(encoding_res.values()),
               color="g")
    ax[1].axhline(y=FOURM_ENCODING_BASELINE, color="g", linestyle="--",
                  label="4M Encoding Baseline")
    if show_linear_baseline:
        ax[1].axhline(y=LINEAR_ENCODING_BASELINE, color="r", linestyle=":",
                      label="Linear Encoding Baseline")
    ax[1].set_xlabel("Mask Ratio")
    ax[1].set_ylabel("BPS")
    ax[1].set_title("Encoding BPS")
    ax[1].legend()

    fig.suptitle("Mask Ratio vs. Decoding R2 and Encoding BPS")
    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    return fig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--result_dir", type=str, required=True,
                    help="dir containing ratio-<r>/ eval artifact subdirs")
    ap.add_argument("--mask_ratios", type=float, nargs="*",
                    default=[0.1, 0.2, 0.3, 0.4, 0.5])
    ap.add_argument("--out", type=str,
                    default="mask_ratio_vs_decoding_r2_encoding_bps.png")
    ap.add_argument("--show_linear_baseline", action="store_true")
    args = ap.parse_args(argv)

    decoding_res, encoding_res = read_artifacts(args.result_dir,
                                                args.mask_ratios)
    if not decoding_res:
        raise SystemExit("no eval artifacts found under --result_dir")
    fig = draw(decoding_res, encoding_res, args.show_linear_baseline)
    fig.savefig(args.out)
    print("saved:", args.out)
    return fig


if __name__ == "__main__":
    main()
