#!/usr/bin/env bash
# Linear-baseline pair (encoding + decoding), the reference's
# script/train_baseline.sh analog, through the port's entry points:
#
#   baseline_sweep.sh <eid> | --synthetic [extra args for every script]
#
# --synthetic uses the offline synthetic session instead of an IBL
# session; PYTHON picks the interpreter.
set -euo pipefail
SRC="${1:?usage: $0 <eid>|--synthetic [extra args]}"
shift || true
if [ "$SRC" = "--synthetic" ]; then SESSION=(--synthetic)
else SESSION=(--eid "$SRC"); fi
PY="${PYTHON:-python}"
M=multi_modal_foundation_model_tpu_torch.scripts
cd "$(dirname "$0")/../../.."
for DIR in encoding decoding; do
    "$PY" -m "$M.train_baseline" "${SESSION[@]}" --direction "$DIR" \
        --base_path results "$@"
    "$PY" -m "$M.eval_baseline" "${SESSION[@]}" --direction "$DIR" \
        --base_path results "$@"
done
