#!/usr/bin/env bash
# The reference's per-user wrapper (script/ppwang/train.sh) on the port:
# one mixed-training embd-mask run on the default session, mask ratio as
# $1 (default 0.3); further arguments go to the script (--synthetic for
# the offline synthetic session, --device cpu off the card).
set -euo pipefail
RATIO="${1:-0.3}"
cd "$(dirname "$0")/../../../.."
"${PYTHON:-python}" -m multi_modal_foundation_model_tpu_torch.scripts.train_multi_modal \
    --eid db4df448-e449-4a6f-a0e7-288711e7a75a \
    --mask_mode temporal \
    --mask_ratio "$RATIO" \
    --mixed_training \
    --set training.mask_type=embd \
    --seed 42 \
    --base_path results \
    "${@:2}"
