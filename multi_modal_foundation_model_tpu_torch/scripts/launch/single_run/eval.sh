#!/usr/bin/env bash
# The reference's script/ppwang/eval.sh on the port: evaluate the
# mixed-training embd-mask run trained by train.sh (same mask ratio $1),
# with the per-neuron figures; further arguments go to the script
# (--synthetic, --device cpu).
set -euo pipefail
RATIO="${1:-0.3}"
cd "$(dirname "$0")/../../../.."
"${PYTHON:-python}" -m multi_modal_foundation_model_tpu_torch.scripts.eval_multi_modal \
    --eid db4df448-e449-4a6f-a0e7-288711e7a75a \
    --mask_mode temporal \
    --mask_ratio "$RATIO" \
    --mixed_training \
    --seed 42 \
    --save_plot \
    --base_path results \
    "${@:2}"
