#!/usr/bin/env bash
# Mask-ratio sweep (the workload behind the reference's
# src/draw/draw_mask_ratio.py: ratios 0.1-0.5, mixed training), then the
# comparison figure, through the port's entry points:
#
#   mask_ratio_sweep.sh <eid> | --synthetic [extra args for every script]
#
# --synthetic trains on the offline synthetic session instead of an IBL
# session. RATIOS picks the ratios (default "0.1 0.2 0.3 0.4 0.5", written
# as the scripts print them), BASE_PATH the results root (default
# results), PYTHON the interpreter. Each ratio is trained and evaluated
# (modal_spike, modal_behavior); its two eval artifact folders are copied
# to <BASE_PATH>/sweep-<eid or synthetic>/ratio-<r>/, which
# draw_mask_ratio reads, and the figure is saved there.
set -euo pipefail
SRC="${1:?usage: $0 <eid>|--synthetic [extra args]}"
shift || true
if [ "$SRC" = "--synthetic" ]; then
    SESSION=(--synthetic); TAG=synthetic
    EID=db4df448-e449-4a6f-a0e7-288711e7a75a      # the scripts' default
else
    SESSION=(--eid "$SRC"); TAG="$SRC"; EID="$SRC"
fi
RATIOS="${RATIOS:-0.1 0.2 0.3 0.4 0.5}"
BASE="${BASE_PATH:-results}"
PY="${PYTHON:-python}"
M=multi_modal_foundation_model_tpu_torch.scripts
cd "$(dirname "$0")/../../.."
OUT="$BASE/sweep-$TAG"
for RATIO in $RATIOS; do
    "$PY" -m "$M.train_multi_modal" "${SESSION[@]}" --mask_ratio "$RATIO" \
        --mixed_training --base_path "$BASE" "$@"
    "$PY" -m "$M.eval_multi_modal" "${SESSION[@]}" --mask_ratio "$RATIO" \
        --mixed_training --base_path "$BASE" "$@"
    RUN="$BASE/results/ses-$EID/set-train/inModal-ap-behavior"
    RUN="$RUN/outModal-ap-behavior/mask-temporal_ratio-${RATIO}_mixed-True"
    mkdir -p "$OUT/ratio-$RATIO"
    cp -r "$RUN/eval/modal_behavior" "$RUN/eval/modal_spike" \
        "$OUT/ratio-$RATIO/"
done
# shellcheck disable=SC2086  # one argument a ratio
"$PY" -m "$M.draw_mask_ratio" --result_dir "$OUT" --mask_ratios $RATIOS \
    --out "$OUT/mask_ratio_vs_decoding_r2_encoding_bps.png"
